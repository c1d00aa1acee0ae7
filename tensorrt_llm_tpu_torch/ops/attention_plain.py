"""Paged KV cache ops and plain PyTorch attention.

Counterpart of the main-path part of `tensorrt_llm_tpu/ops/attention_xla.py`
and of its draft-tree verification (`tree_verify_attention`: plain ops on
the card too, as the JAX package leaves it to XLA).
`paged_prefill_plain` and `paged_decode_plain` are the plain versions of the
two attention kernels (`ops/flash_prefill.py`, `ops/paged_attention.py`): the
CPU path runs them, and the chip check holds the kernels against them.

Pools are head-major pages ``[NB, Hkv, BS, D]``; a token's flat slot is
``block_id * BS + offset``.  Block 0 is reserved: slots past the pool write
there, and table padding points there.  An INT8 pool is a pair ``(data int8
[NB, Hkv, BS, D], scale f32 [NB, Hkv, BS])``: each (token, head) row is
quantized on write (`quantize_kv_token`) and dequantized to the query's dtype
after the gather (`gather_dequant`), as in the JAX package.  An FP8 pool is
float8_e4m3fn pages with no scale: the write casts to e4m3 (nearest even,
saturating at +-448 where the JAX package's cast gives NaN past ~464; a
NaN in K or V would poison every row that reads its page) and scatters
the bytes (PyTorch has no float8 `index_copy_`); the gather upcasts to
bf16, exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from tensorrt_llm_tpu_torch.quantization.quantize import to_e4m3
from tensorrt_llm_tpu_torch.utils import div_scalar

NEG_INF = float(torch.finfo(torch.float32).min)


Pool = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def pool_dims(cache: Pool) -> Tuple[int, int, int, int]:
    """(NB, Hkv, BS, D) of a head-major pool (bf16, FP8, or an INT8
    pair)."""
    nb, h, bs, d = (cache[0] if isinstance(cache, tuple) else cache).shape
    return nb, h, bs, d


def quantize_kv_token(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 quantization of [T, H, D]: returns
    (int8 [T, H, D], f32 scale [T, H]).  The scale is clamped as
    ``max(absmax / 127, 1e-8)``, bit-exact with the JAX package."""
    xf = x.to(torch.float32)
    scale = torch.clamp(div_scalar(xf.abs().amax(dim=-1), 127.0), min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def pool_rows(slot_mapping: torch.Tensor, nb: int, h: int, bs: int
              ) -> torch.Tensor:
    """Flat row index, in a pool ``[NB, H, BS, D]`` viewed as ``[-1, D]``,
    of every (token, head) of `slot_mapping` [T], token-major.  Slots past
    the pool land in reserved page 0."""
    slots = slot_mapping.to(torch.int64)
    oob = slots >= nb * bs
    pages = torch.where(oob, 0, slots // bs)
    offs = torch.where(oob, 0, slots % bs)
    heads = torch.arange(h, device=slots.device)[None, :]
    return ((pages[:, None] * h + heads) * bs + offs[:, None]).reshape(-1)


def write_kv_cache(k_cache: Pool, v_cache: Pool, k_new: torch.Tensor,
                   v_new: torch.Tensor, slot_mapping: torch.Tensor) -> None:
    """Scatter new K/V [T, Hkv, D] into the pools at `slot_mapping` [T],
    IN PLACE (the JAX version returns new pools; updating in place saves a
    pool copy per step).  Out-of-range slots land in reserved page 0.  An
    INT8 pool takes the quantized rows and their scales at the same rows,
    an FP8 pool the rows cast to e4m3, as bytes."""
    nb, h, bs, d = pool_dims(k_cache)
    rows = pool_rows(slot_mapping, nb, h, bs)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        if isinstance(cache, tuple):
            data, scale = cache
            q, s = quantize_kv_token(new)
            data.view(-1, d).index_copy_(0, rows, q.reshape(-1, d))
            scale.view(-1).index_copy_(0, rows, s.reshape(-1))
        elif cache.dtype == torch.float8_e4m3fn:
            cache.view(torch.uint8).view(-1, d).index_copy_(
                0, rows, to_e4m3(new).view(torch.uint8).reshape(-1, d))
        else:
            cache.view(-1, d).index_copy_(
                0, rows, new.to(cache.dtype).reshape(-1, d))


def gather_dequant(cache: Pool, idx: torch.Tensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """``cache[idx]`` pages; an INT8 pool is dequantized after the gather,
    in f32 and then rounded to `out_dtype`, as the JAX package does; FP8
    pages are upcast to `out_dtype` (exact for bf16)."""
    idx = idx.long()
    if isinstance(cache, tuple):
        data, scale = cache
        g = data[idx].to(torch.float32) * scale[idx][..., None]
        return g.to(out_dtype)
    if cache.dtype == torch.float8_e4m3fn:
        return cache.view(torch.uint8)[idx].view(cache.dtype).to(out_dtype)
    return cache[idx]


def _masked_softmax(scores, mask, sinks=None):
    scores = torch.where(mask, scores, NEG_INF)
    if sinks is None:
        return torch.softmax(scores, dim=-1)
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), sinks)
    p = torch.exp(scores - m)
    return p / (p.sum(dim=-1, keepdim=True) + torch.exp(sinks - m))


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
        q_offset=0, kv_len=None, sliding_window: Optional[int] = None,
        logit_cap: Optional[float] = None,
        sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal dense attention for one sequence: q [T, Hq, D] at positions
    q_offset.., k/v [S, Hkv, D] at positions 0..S-1."""
    T, Hq, D = q.shape
    S, Hkv, _ = k.shape
    G = Hq // Hkv
    qf = (q.to(torch.float32) * scale).reshape(T, Hkv, G, D)
    scores = torch.einsum("thgd,shd->hgts", qf, k.to(torch.float32))
    if logit_cap:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    kv_pos = torch.arange(S, device=q.device)[None, :]
    q_pos = q_offset + torch.arange(T, device=q.device)[:, None]
    mask = kv_pos <= q_pos
    if kv_len is not None:
        mask = mask & (kv_pos < kv_len)
    if sliding_window is not None:
        mask = mask & (kv_pos > q_pos - sliding_window)
    sink_r = (sinks.reshape(Hkv, G, 1, 1).to(torch.float32)
              if sinks is not None else None)
    probs = _masked_softmax(scores, mask[None, None], sink_r)
    out = torch.einsum("hgts,shd->thgd", probs, v.to(torch.float32))
    return out.reshape(T, Hq, D).to(q.dtype)


def paged_prefill_plain(q: torch.Tensor, k_cache: Pool, v_cache: Pool,
                        block_table: torch.Tensor,
                        kv_len, q_offset, scale: float,
                        sliding_window: Optional[int] = None,
                        logit_cap: Optional[float] = None,
                        sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chunked-prefill attention for one sequence against its paged KV
    (the chunk is already written).  block_table [MB]."""
    nb, h, bs, d = pool_dims(k_cache)
    k = gather_dequant(k_cache, block_table, q.dtype).permute(0, 2, 1, 3) \
        .reshape(-1, h, d)
    v = gather_dequant(v_cache, block_table, q.dtype).permute(0, 2, 1, 3) \
        .reshape(-1, h, d)
    return mha(q, k, v, scale, q_offset=q_offset, kv_len=kv_len,
               sliding_window=sliding_window, logit_cap=logit_cap,
               sinks=sinks)


def paged_decode_plain(q: torch.Tensor, k_cache: Pool, v_cache: Pool,
                       block_tables: torch.Tensor,
                       kv_lens: torch.Tensor, scale: float,
                       sliding_window: Optional[int] = None,
                       logit_cap: Optional[float] = None,
                       sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One query token per sequence over paged KV.  q [B, Hq, D],
    block_tables [B, MB], kv_lens [B] (including the new token)."""
    nb, hkv, bs, d = pool_dims(k_cache)
    B, Hq, _ = q.shape
    G = Hq // hkv
    S = block_tables.shape[1] * bs
    k = gather_dequant(k_cache, block_tables, q.dtype) \
        .permute(0, 1, 3, 2, 4).reshape(B, S, hkv, d)
    v = gather_dequant(v_cache, block_tables, q.dtype) \
        .permute(0, 1, 3, 2, 4).reshape(B, S, hkv, d)
    qf = (q.to(torch.float32) * scale).reshape(B, hkv, G, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k.to(torch.float32))
    if logit_cap:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    lens = kv_lens.to(q.device).reshape(B, 1, 1, 1)
    kv_pos = torch.arange(S, device=q.device)[None, None, None, :]
    mask = kv_pos < lens
    if sliding_window is not None:
        mask = mask & (kv_pos >= lens - sliding_window)
    sink_r = (sinks.reshape(1, hkv, G, 1).to(torch.float32)
              if sinks is not None else None)
    probs = _masked_softmax(scores, mask, sink_r)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v.to(torch.float32))
    return out.reshape(B, Hq, d).to(q.dtype)


def tree_verify_attention(q: torch.Tensor, k_cache: Pool, v_cache: Pool,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          block_table: torch.Tensor, prefix_len: int,
                          positions: torch.Tensor, tree_mask: torch.Tensor,
                          scale: float,
                          sliding_window: Optional[int] = None,
                          sinks: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Draft-tree verification attention for one sequence (JAX
    `tree_verify_attention_xla`): the pool is read for the `prefix_len`
    committed positions only (so the chunk's own writes are never read
    back), the chunk's K/V [T, Hkv, D] come from the inputs in the query's
    dtype (an INT8 pool's chunk rows are not quantized; an FP8 pool's are
    rounded to e4m3, as the JAX package casts them to the pool's dtype and
    as a chunk written to the pool reads back), and in-chunk
    visibility is the host-built `tree_mask` [T, T] ANDed with causality
    by `positions` [T] (tree rows of one depth share a position).  The
    sliding window and the sinks act as in `mha`."""
    nb, h, bs, d = pool_dims(k_cache)
    kp = gather_dequant(k_cache, block_table, q.dtype).permute(0, 2, 1, 3) \
        .reshape(-1, h, d)
    vp = gather_dequant(v_cache, block_table, q.dtype).permute(0, 2, 1, 3) \
        .reshape(-1, h, d)
    S = kp.shape[0]
    T, Hq, D = q.shape
    G = Hq // h
    s = torch.arange(S, device=q.device)
    kv_pos = torch.cat([torch.where(s < prefix_len, s, -1),
                        positions.to(s.dtype)])
    if not isinstance(k_cache, tuple) and k_cache.dtype == torch.float8_e4m3fn:
        k_new, v_new = to_e4m3(k_new), to_e4m3(v_new)
    k = torch.cat([kp, k_new.to(kp.dtype)])
    v = torch.cat([vp, v_new.to(vp.dtype)])
    qf = (q.to(torch.float32) * scale).reshape(T, h, G, D)
    scores = torch.einsum("thgd,shd->hgts", qf, k.to(torch.float32))
    q_pos = positions.to(s.dtype)[:, None]
    kp_ = kv_pos[None, :]
    mask = (kp_ >= 0) & (kp_ <= q_pos)
    if sliding_window is not None:
        mask = mask & (kp_ > q_pos - sliding_window)
    pair = torch.cat([torch.ones((T, S), dtype=torch.bool, device=q.device),
                      tree_mask.to(device=q.device, dtype=torch.bool)], dim=1)
    sink_r = (sinks.reshape(h, G, 1, 1).to(torch.float32)
              if sinks is not None else None)
    probs = _masked_softmax(scores, (mask & pair)[None, None], sink_r)
    out = torch.einsum("hgts,shd->thgd", probs, v.to(torch.float32))
    return out.reshape(T, Hq, D).to(q.dtype)
