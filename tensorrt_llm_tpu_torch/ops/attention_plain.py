"""Paged KV cache ops and plain PyTorch attention.

Counterpart of `tensorrt_llm_tpu/ops/attention_xla.py` on one device: the
paged prefill and decode, draft-tree verification (`tree_verify_attention`)
and the VSWA cyclic rings (`cyclic_prefill_plain`, `paged_decode_plain(...,
cyclic=True)`), with logit caps and Llama4's chunked attention
(`attention_chunk`).  The shapes and options the JAX package leaves to XLA
run these on the card too (`attention_backend/cuda_backend.py`).

A VSWA ring is a fixed table of R pages (P = R * BS slots) that a sliding
layer writes cyclically: slot s holds position s + floor((L - 1 - s) / P)
* P of a sequence of L tokens (negative: empty).
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
        sinks: Optional[torch.Tensor] = None,
        kv_positions: Optional[torch.Tensor] = None,
        q_positions: Optional[torch.Tensor] = None,
        attention_chunk: Optional[int] = None,
        pair_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal dense attention for one sequence (JAX `mha_xla`): q [T, Hq, D]
    at positions q_offset.. (or `q_positions` [T]), k/v [S, Hkv, D] at
    positions 0..S-1 (or `kv_positions` [S], negative ones masked).
    `attention_chunk` keeps same-chunk keys only; `pair_mask` [T, S] is
    ANDed in."""
    T, Hq, D = q.shape
    S, Hkv, _ = k.shape
    G = Hq // Hkv
    qf = (q.to(torch.float32) * scale).reshape(T, Hkv, G, D)
    scores = torch.einsum("thgd,shd->hgts", qf, k.to(torch.float32))
    if logit_cap:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    kv_pos = (torch.arange(S, device=q.device) if kv_positions is None
              else kv_positions.to(device=q.device, dtype=torch.int64))[None]
    q_pos = (q_offset + torch.arange(T, device=q.device) if q_positions is None
             else q_positions.to(device=q.device, dtype=torch.int64))[:, None]
    mask = (kv_pos >= 0) & (kv_pos <= q_pos)
    if kv_len is not None:
        mask = mask & (kv_pos < kv_len)
    if sliding_window is not None:
        mask = mask & (kv_pos > q_pos - sliding_window)
    if attention_chunk is not None:
        mask = mask & (torch.div(kv_pos, attention_chunk, rounding_mode="floor")
                       == torch.div(q_pos, attention_chunk,
                                    rounding_mode="floor"))
    if pair_mask is not None:
        mask = mask & pair_mask.to(device=q.device, dtype=torch.bool)
    sink_r = (sinks.reshape(Hkv, G, 1, 1).to(torch.float32)
              if sinks is not None else None)
    probs = _masked_softmax(scores, mask[None, None], sink_r)
    out = torch.einsum("hgts,shd->thgd", probs, v.to(torch.float32))
    return out.reshape(T, Hq, D).to(q.dtype)


def _gather_seq(cache: Pool, block_table: torch.Tensor, dtype
                ) -> torch.Tensor:
    """One sequence's pages [MB, Hkv, BS, D] as tokens [MB * BS, Hkv, D]."""
    nb, h, bs, d = pool_dims(cache)
    return gather_dequant(cache, block_table, dtype).permute(0, 2, 1, 3) \
        .reshape(-1, h, d)


def _chunk_kv(cache: Pool, new: torch.Tensor, dtype) -> torch.Tensor:
    """A chunk's K or V taken from the inputs, as its pool would give them
    back: an FP8 pool's rounded to e4m3 (the JAX package casts them to the
    pool's dtype); an INT8 pool's as they are."""
    if not isinstance(cache, tuple) and cache.dtype == torch.float8_e4m3fn:
        new = to_e4m3(new)
    return new.to(dtype)


def ring_positions(n_slots: int, length, device) -> torch.Tensor:
    """The position each of a ring's `n_slots` slots holds once `length`
    tokens were written (negative: empty); `length` an int or a [B]
    tensor (then [B, n_slots])."""
    s = torch.arange(n_slots, device=device)
    if isinstance(length, torch.Tensor):
        L = length.to(device=device, dtype=torch.int64)[:, None]
        return s[None] + torch.div(L - 1 - s[None], n_slots,
                                   rounding_mode="floor") * n_slots
    return s + torch.div(int(length) - 1 - s, n_slots,
                         rounding_mode="floor") * n_slots


def paged_prefill_plain(q: torch.Tensor, k_cache: Pool, v_cache: Pool,
                        block_table: torch.Tensor,
                        kv_len, q_offset, scale: float,
                        sliding_window: Optional[int] = None,
                        logit_cap: Optional[float] = None,
                        sinks: Optional[torch.Tensor] = None,
                        attention_chunk: Optional[int] = None
                        ) -> torch.Tensor:
    """Chunked-prefill attention for one sequence against its paged KV
    (the chunk is already written).  block_table [MB]."""
    k = _gather_seq(k_cache, block_table, q.dtype)
    v = _gather_seq(v_cache, block_table, q.dtype)
    return mha(q, k, v, scale, q_offset=q_offset, kv_len=kv_len,
               sliding_window=sliding_window, logit_cap=logit_cap,
               sinks=sinks, attention_chunk=attention_chunk)


def cyclic_prefill_plain(q: torch.Tensor, k_cache: Pool, v_cache: Pool,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         block_table: torch.Tensor, kv_len, q_offset: int,
                         scale: float, sliding_window: Optional[int] = None,
                         logit_cap: Optional[float] = None,
                         sinks: Optional[torch.Tensor] = None,
                         attention_chunk: Optional[int] = None
                         ) -> torch.Tensor:
    """Chunked prefill against a VSWA ring (JAX `cyclic_prefill_xla`): the
    ring [R] is read BEFORE this chunk's writes land (the chunk may evict
    prefix positions that its early rows still need), and the chunk's own
    K/V [T, Hkv, D] come from the inputs, so the ring holds only the window
    plus a page, whatever the chunk's size."""
    kp = _gather_seq(k_cache, block_table, q.dtype)
    vp = _gather_seq(v_cache, block_table, q.dtype)
    T = q.shape[0]
    prefix_pos = ring_positions(kp.shape[0], q_offset, q.device)
    k = torch.cat([kp, _chunk_kv(k_cache, k_new, kp.dtype)])
    v = torch.cat([vp, _chunk_kv(v_cache, v_new, vp.dtype)])
    kv_positions = torch.cat(
        [prefix_pos, q_offset + torch.arange(T, device=q.device)])
    return mha(q, k, v, scale, q_offset=q_offset, kv_len=kv_len,
               sliding_window=sliding_window, logit_cap=logit_cap,
               sinks=sinks, kv_positions=kv_positions,
               attention_chunk=attention_chunk)


def paged_decode_plain(q: torch.Tensor, k_cache: Pool, v_cache: Pool,
                       block_tables: torch.Tensor,
                       kv_lens: torch.Tensor, scale: float,
                       sliding_window: Optional[int] = None,
                       logit_cap: Optional[float] = None,
                       sinks: Optional[torch.Tensor] = None,
                       cyclic: bool = False,
                       attention_chunk: Optional[int] = None) -> torch.Tensor:
    """One query token per sequence over paged KV.  q [B, Hq, D],
    block_tables [B, MB] (with `cyclic`, VSWA rings), kv_lens [B]
    (including the new token)."""
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
    lens = kv_lens.to(q.device).reshape(B, 1, 1, 1).to(torch.int64)
    if cyclic:
        kv_pos = ring_positions(S, kv_lens, q.device)[:, None, None, :]
    else:
        kv_pos = torch.arange(S, device=q.device)[None, None, None, :]
    mask = (kv_pos >= 0) & (kv_pos < lens)
    if sliding_window is not None:
        mask = mask & (kv_pos >= lens - sliding_window)
    if attention_chunk is not None:
        # the query sits at position kv_len - 1: same-chunk keys only
        first = torch.div(lens - 1, attention_chunk,
                          rounding_mode="floor") * attention_chunk
        mask = mask & (kv_pos >= first)
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
                          sinks: Optional[torch.Tensor] = None,
                          cyclic: bool = False,
                          logit_cap: Optional[float] = None,
                          attention_chunk: Optional[int] = None
                          ) -> torch.Tensor:
    """Draft-tree verification attention for one sequence (JAX
    `tree_verify_attention_xla`): the pool (or, with `cyclic`, the VSWA
    ring) is read for the `prefix_len` committed positions only (so the
    chunk's own writes are never read back), the chunk's K/V [T, Hkv, D]
    come from the inputs in the query's dtype (an INT8 pool's chunk rows
    are not quantized; an FP8 pool's are rounded to e4m3, as the JAX
    package casts them to the pool's dtype and as a chunk written to the
    pool reads back), and in-chunk visibility is the host-built
    `tree_mask` [T, T] ANDed with causality by `positions` [T] (tree rows
    of one depth share a position).  The window, cap, chunking and sinks
    act as in `mha`."""
    kp = _gather_seq(k_cache, block_table, q.dtype)
    vp = _gather_seq(v_cache, block_table, q.dtype)
    S = kp.shape[0]
    T = q.shape[0]
    if cyclic:
        prefix_pos = ring_positions(S, prefix_len, q.device)
    else:
        s = torch.arange(S, device=q.device)
        prefix_pos = torch.where(s < prefix_len, s, -1)
    kv_positions = torch.cat([prefix_pos,
                              positions.to(device=q.device,
                                           dtype=prefix_pos.dtype)])
    k = torch.cat([kp, _chunk_kv(k_cache, k_new, kp.dtype)])
    v = torch.cat([vp, _chunk_kv(v_cache, v_new, vp.dtype)])
    pair = torch.cat([torch.ones((T, S), dtype=torch.bool, device=q.device),
                      tree_mask.to(device=q.device, dtype=torch.bool)], dim=1)
    return mha(q, k, v, scale, sliding_window=sliding_window,
               logit_cap=logit_cap, sinks=sinks, kv_positions=kv_positions,
               q_positions=positions, attention_chunk=attention_chunk,
               pair_mask=pair)
