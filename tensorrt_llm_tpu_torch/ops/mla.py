"""Multi-head Latent Attention (MLA) over a paged latent cache.

Counterpart of `tensorrt_llm_tpu/ops/mla.py` and `ops/mla_pallas.py`.  The
cache holds, per token, one latent row of ``L + R`` channels (the
RMS-normed compressed KV ``c_kv`` of ``L = kv_lora_rank`` channels, then the
roped shared key ``k_pe`` of ``R = qk_rope_head_dim``) in a pool
``[NB, 1, BS, L + R]``: one "head" shared by every query head.  Attention
runs in the absorbed form, MQA with keys of ``L + R`` channels and values
the first ``L`` channels of the same rows:

    q_eff  = [q_nope @ W_uk, rope(q_pe)]          # [T, H, L+R]
    out    = softmax(scale * q_eff . cache) . cache[:, :L]     # [T, H, L]

The caller applies W_uv to the latent output.  The pool row is exactly
``L + R`` = 576 channels wide: the JAX package pads it to 640 for the TPU's
128-lane tile, a layout the port does not keep.

* `mla_prefill_plain` / `mla_decode_plain` are the plain versions (the JAX
  package's `mla_prefill_xla` / `mla_decode_xla`); the prefill takes the
  optional `extra_mask`, with which DSA's sparse prefill restricts each
  query to its indexer top-k (that masked prefill is plain torch on the card
  as well, as it is XLA in the JAX package).
* `mla_decode_attention` (kernel K9) and `mla_prefill_attention` (kernel
  K10) run one Hopper kernel, `csrc/mla_prefill_sm90.cu` (TMA, wgmma, 64
  query rows a block, two consumer warpgroups on alternate latent tiles):
  K10 splits its latent range over blocks by `mla_prefill_plan` and merges
  the splits in a second pass; K9 splits each sequence's latents by
  `mla_decode_plan` into one thread block cluster that merges them inside
  the launch.  Both take the plain versions for CPU tensors and launch
  their kernels for CUDA tensors (or raise); they are the counterparts of
  `mla_decode_pallas` and `mla_prefill_pallas`.  Both kernels scale the
  f32 scores after the dot, as the plain versions scale q in f32 (the
  Pallas decode kernel rounds ``q * scale`` to bf16 first; the port does
  not copy that rounding).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from tensorrt_llm_tpu_torch.ops import cuda_build
from tensorrt_llm_tpu_torch.ops.attention_plain import NEG_INF, pool_rows

__all__ = ["write_latent_cache", "mla_prefill_plain", "mla_decode_plain",
           "mla_decode_attention", "mla_prefill_attention",
           "mla_decode_plan", "mla_decode_split_choices",
           "mla_prefill_splits", "mla_prefill_plan",
           "mla_prefill_split_choices"]

_SMS = 132
MLA_ROWS = 64      # query rows of a K9 or K10 block (wgmma's M)
MLA_TILE = 64      # latent tokens staged per step (K9 and K10)
MLA_DECODE_MAX_SPLITS = 16   # K9's splits of one sequence: one cluster
# K9 blocks the H100 runs at once in clusters of 16: 7 clusters
# (cudaOccupancyMaxActiveClusters at K9's 227 KB of shared memory a block)
MLA_DECODE_BLOCKS = 112
_KERNEL_DIMS = ((512, 576),)   # (L, L + R) the kernels are built for
# `mla_prefill_splits`' cost of one more 64-token tile on a block's run, in
# partial records (512 f32 sums and (max, sum) of one row of one split)
# that K10's merge writes and reads: a least-squares fit of K10's times on
# the H100 at every split of every checked shape (`chip_smoke.py`
# check_mla_splits; 2.28 us a tile, 0.92 us a thousand records)
_K10_TILE_RECORDS = 2500


def write_latent_cache(cache: torch.Tensor, latents: torch.Tensor,
                       slot_mapping: torch.Tensor) -> None:
    """Scatter latent rows [T, L+R] (``c_kv`` then roped ``k_pe``) into the
    pool [NB, 1, BS, L+R] at `slot_mapping` [T], IN PLACE (the JAX version
    returns a new pool).  Slots past the pool land in reserved page 0."""
    nb, h, bs, d = cache.shape
    rows = pool_rows(slot_mapping, nb, h, bs)
    cache.view(-1, d).index_copy_(0, rows, latents.to(cache.dtype))


def _softmax_latent(scores, mask, lat, q_dtype, eq):
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    return torch.einsum(eq, probs, lat).to(q_dtype)


def mla_prefill_plain(q_eff: torch.Tensor, cache: torch.Tensor,
                      block_table: torch.Tensor, kv_len, q_offset,
                      scale: float, kv_lora_rank: int,
                      extra_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Chunked-prefill MLA for one sequence: q_eff [T, H, L+R] at positions
    q_offset.. against its latents through block_table [MB] (the chunk is
    already written).  `extra_mask` [T, MB*BS] bool further restricts the
    keys: DSA's sparse prefill, which runs this plain version on the card
    too, as the JAX package runs `mla_prefill_xla` for it.  Returns
    [T, H, L]."""
    T = q_eff.shape[0]
    dk = cache.shape[-1]
    kvf = cache[block_table.long()][:, 0].reshape(-1, dk).to(torch.float32)
    S = kvf.shape[0]
    qf = q_eff.to(torch.float32) * scale
    scores = torch.einsum("thd,sd->hts", qf, kvf)
    kv_pos = torch.arange(S, device=q_eff.device)[None, :]
    q_pos = q_offset + torch.arange(T, device=q_eff.device)[:, None]
    mask = (kv_pos <= q_pos) & (kv_pos < kv_len)
    if extra_mask is not None:
        mask = mask & extra_mask
    return _softmax_latent(scores, mask[None], kvf[:, :kv_lora_rank],
                           q_eff.dtype, "hts,sl->thl")


def mla_decode_plain(q_eff: torch.Tensor, cache: torch.Tensor,
                     block_tables: torch.Tensor, kv_lens: torch.Tensor,
                     scale: float, kv_lora_rank: int) -> torch.Tensor:
    """Batched decode MLA: q_eff [B, H, L+R], one new token per sequence,
    against the latents of block_tables [B, MB] up to kv_lens [B] (which
    include the new token).  Returns [B, H, L]."""
    B = q_eff.shape[0]
    dk = cache.shape[-1]
    kvf = cache[block_tables.long()][:, :, 0].reshape(B, -1, dk).to(
        torch.float32)
    S = kvf.shape[1]
    qf = q_eff.to(torch.float32) * scale
    scores = torch.einsum("bhd,bsd->bhs", qf, kvf)
    mask = torch.arange(S, device=q_eff.device)[None, None, :] \
        < kv_lens.to(q_eff.device).long()[:, None, None]
    return _softmax_latent(scores, mask, kvf[..., :kv_lora_rank],
                           q_eff.dtype, "bhs,bsl->bhl")


def mla_decode_plan(B: int, H: int, table_tokens: int):
    """(head blocks, n_splits, split_len) of K9.  A block owns `MLA_ROWS`
    heads of one sequence and one split of its latents: split s takes
    tokens [s * split_len, (s + 1) * split_len) of the table, whole 64-token
    tiles, and the splits of a (sequence, head block) are one thread block
    cluster of at most `MLA_DECODE_MAX_SPLITS` blocks, merged inside the
    launch.  The most splits that keep B x head blocks x splits within one
    wave (K9 holds one block an SM, and the card runs at most
    `MLA_DECODE_BLOCKS` of them at once in clusters of 16), at least one,
    and no more than the table has tiles.  Sized from the table width
    only, since kv_lens stay on the device: O(1) host work and no sync;
    the kernel skips the splits past each sequence's kv_len."""
    head_blocks = -(-H // MLA_ROWS)
    tiles = max(1, -(-table_tokens // MLA_TILE))
    want = max(1, min(MLA_DECODE_MAX_SPLITS,
                      MLA_DECODE_BLOCKS // max(1, B * head_blocks), tiles))
    per = -(-tiles // want)        # tiles a split
    return head_blocks, -(-tiles // per), per * MLA_TILE


def mla_decode_split_choices(table_tokens: int):
    """Every split length (tokens) K9 can take at this table width, one per
    distinct split count up to the cluster limit: what the chip check times
    against the plan."""
    tiles = max(1, -(-table_tokens // MLA_TILE))
    return sorted({-(-tiles // n) * MLA_TILE
                   for n in range(1, min(tiles, MLA_DECODE_MAX_SPLITS) + 1)})


@functools.lru_cache(maxsize=1024)
def mla_prefill_splits(T: int, H: int, kv_len: int, q_offset: int):
    """(row blocks, n_splits, split_len) of K10: blocks of
    `MLA_ROWS` stacked rows (row = token * H + head); each block's
    latent range, up to the causal edge of its last row, is cut into
    splits of split_len tokens (whole 64-token tiles).  Of the split
    counts with which blocks x splits stay within one wave of the 132 SMs
    (K10 holds one block an SM; a second wave costs more than the idle
    SMs save), the one of least modelled time: the longest split's tiles,
    plus, with more than one split, the partial records (one row of one
    live split) the merge pass writes and reads, at `_K10_TILE_RECORDS`
    records a tile.  A causal chunk from position 0 leaves half its blocks
    short, so splitting it saves less than the merge costs.  Pure shape
    logic, cached per shape."""
    R = T * H
    blocks = -(-R // MLA_ROWS)
    if blocks == 0:
        return 0, 1, MLA_TILE
    kv_end = min(kv_len, q_offset + (R - 1) // H + 1)
    tiles = max(1, -(-kv_end // MLA_TILE))
    most = min(_SMS // blocks, tiles)
    # each block's tiles, up to the causal edge of its last row
    block_tiles = [-(-min(kv_len, q_offset + (min((b + 1) * MLA_ROWS, R) - 1)
                          // H + 1) // MLA_TILE)
                   for b in range(blocks)] if most > 1 else []
    best, best_cost = tiles, float(tiles)
    for per in sorted({-(-tiles // n) for n in range(2, most + 1)}):
        records = MLA_ROWS * sum(-(-t // per) for t in block_tiles)
        cost = per + records / _K10_TILE_RECORDS
        if cost < best_cost:
            best, best_cost = per, cost
    return blocks, -(-tiles // best), best * MLA_TILE


def mla_prefill_split_choices(T: int, H: int, kv_len: int, q_offset: int):
    """Every split length (tokens) K10 can take at this shape, one per
    distinct split count: what the chip check times against the plan."""
    kv_end = min(kv_len, q_offset + T)
    tiles = max(1, -(-kv_end // MLA_TILE))
    return sorted({-(-tiles // n) * MLA_TILE for n in range(1, tiles + 1)})


def mla_prefill_plan(T: int, H: int, kv_len: int, q_offset: int):
    """(row blocks, n_splits, split_len, tile ranges) of K10, the bounds
    `csrc/mla_prefill_sm90.cu` computes: block b's latent tiles are
    [0, t1_b), up to the causal edge of its last row (bounded by kv_len);
    split s of it takes tiles [s * split_len / 64, (s + 1) * split_len / 64)
    of that range, and does nothing past its end.  Pure shape logic; the
    tests check it on the CPU."""
    blocks, n_splits, split_len = mla_prefill_splits(T, H, kv_len, q_offset)
    R = T * H
    ranges = []
    for b in range(blocks):
        last = min((b + 1) * MLA_ROWS, R) - 1
        kv_end = min(kv_len, q_offset + last // H + 1)
        ranges.append((0, -(-kv_end // MLA_TILE) if kv_end > 0 else 0))
    return blocks, n_splits, split_len, ranges


def _check(name, t, dt, dev):
    if t.device != dev or t.dtype != dt or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dt} on {dev}")


def _kernel_operands(q_eff, cache, kv_lora_rank):
    """Refuse what the kernels are not built for (widths, page sizes),
    then anything but contiguous, 16-byte aligned bf16 CUDA operands:
    never a fallback."""
    dk = q_eff.shape[-1]
    if (kv_lora_rank, dk) not in _KERNEL_DIMS or cache.shape[-1] != dk:
        raise NotImplementedError(
            f"MLA kernels are built for (L, L+R) in {_KERNEL_DIMS}: got "
            f"L={kv_lora_rank}, q {dk}, pool {cache.shape[-1]}")
    if cache.dim() != 4 or cache.shape[1] != 1:
        raise ValueError("cache must be a latent pool [NB, 1, BS, L+R]")
    if cache.shape[2] % 8:
        raise NotImplementedError(
            "the MLA kernels (K9, K10) take pages of a multiple of 8 tokens "
            f"(TMA boxes in the 128-byte swizzle): got {cache.shape[2]}")
    if q_eff.device.type != "cuda":
        raise ValueError(f"unsupported device {q_eff.device}")
    dev = q_eff.device
    _check("q_eff", q_eff, torch.bfloat16, dev)
    _check("cache", cache, torch.bfloat16, dev)
    if q_eff.data_ptr() % 16 or cache.data_ptr() % 16:
        raise ValueError("q_eff and the pool must start 16-byte aligned (TMA)")
    return cache.shape[0], cache.shape[2], dk


def mla_decode_attention(q_eff: torch.Tensor, cache: torch.Tensor,
                         block_tables: torch.Tensor, kv_lens: torch.Tensor,
                         scale: float, kv_lora_rank: int,
                         split_len: Optional[int] = None) -> torch.Tensor:
    """Decode MLA (see `mla_decode_plain`): the plain version for CPU
    tensors, kernel K9 for CUDA tensors (pages of a multiple of 8 tokens).
    `kv_lens` stay on the device; `split_len` (a multiple of 64 tokens,
    at most `MLA_DECODE_MAX_SPLITS` splits of the table) pins the plan's
    latent split."""
    if q_eff.device.type == "cpu":
        return mla_decode_plain(q_eff, cache, block_tables, kv_lens, scale,
                                kv_lora_rank)
    NB, BS, DK = _kernel_operands(q_eff, cache, kv_lora_rank)
    B, H, _ = q_eff.shape
    _check("block_tables", block_tables, torch.int32, q_eff.device)
    _check("kv_lens", kv_lens, torch.int32, q_eff.device)
    MB = block_tables.shape[1]
    if block_tables.shape[0] != B or kv_lens.shape != (B,):
        raise ValueError("table or kv_lens shape mismatch")
    L = kv_lora_rank
    out = torch.empty((B, H, L), dtype=q_eff.dtype, device=q_eff.device)
    if B == 0 or H == 0:
        return out
    if MB == 0:   # no cached token: the plain version's empty sum
        return out.zero_()
    S = MB * BS
    if split_len is None:
        _, n_splits, split_len = mla_decode_plan(B, H, S)
    else:
        if split_len <= 0 or split_len % MLA_TILE:
            raise ValueError("split_len must be a positive multiple of "
                             f"{MLA_TILE}")
        n_splits = -(-S // split_len)
        if n_splits > MLA_DECODE_MAX_SPLITS:
            raise ValueError(f"split_len {split_len} cuts the table into "
                             f"{n_splits} splits, past the cluster's "
                             f"{MLA_DECODE_MAX_SPLITS}")
    lib = cuda_build.load_library()
    err = lib.tllm_mla_decode(
        cuda_build.ptr(q_eff), cuda_build.ptr(cache),
        cuda_build.ptr(block_tables), cuda_build.ptr(kv_lens),
        cuda_build.ptr(out), B, H, L, DK, NB, BS, MB, float(scale), n_splits,
        split_len, cuda_build.stream_of(q_eff))
    cuda_build.check(err, "mla_decode")
    cuda_build.launch_counts["mla_decode"] += 1
    return out


def mla_prefill_attention(q_eff: torch.Tensor, cache: torch.Tensor,
                          block_table: torch.Tensor, kv_len: int,
                          q_offset: int, scale: float, kv_lora_rank: int,
                          split_len: Optional[int] = None) -> torch.Tensor:
    """Chunked-prefill MLA for one sequence (see `mla_prefill_plain`,
    without `extra_mask`): the plain version for CPU tensors, kernel K10
    for CUDA tensors (pages of a multiple of 8 tokens).  `kv_len` and
    `q_offset` are host ints, so the plan costs no device sync;
    `split_len` (a multiple of 64 tokens) pins the plan's latent split."""
    if q_eff.device.type == "cpu":
        return mla_prefill_plain(q_eff, cache, block_table, kv_len, q_offset,
                                 scale, kv_lora_rank)
    NB, BS, DK = _kernel_operands(q_eff, cache, kv_lora_rank)
    T, H, _ = q_eff.shape
    _check("block_table", block_table, torch.int32, q_eff.device)
    if block_table.dim() != 1:
        raise ValueError("block_table must be [MB]")
    L = kv_lora_rank
    out = torch.empty((T, H, L), dtype=q_eff.dtype, device=q_eff.device)
    if T == 0:
        return out
    MB = block_table.shape[0]
    # tokens past the table's MB pages do not exist (the plain version's
    # gather ends there too)
    kv_len = min(int(kv_len), MB * BS)
    if kv_len < 1:
        raise ValueError("kv_len must count at least one cached token")
    if split_len is None:
        _, n_splits, split_len = mla_prefill_splits(T, H, kv_len,
                                                    int(q_offset))
    else:
        if split_len <= 0 or split_len % MLA_TILE:
            raise ValueError("split_len must be a positive multiple of "
                             f"{MLA_TILE}")
        tiles = -(-min(kv_len, int(q_offset) + T) // MLA_TILE)
        n_splits = max(1, -(-tiles * MLA_TILE // split_len))
    ws = (torch.empty((n_splits * T * H * (L + 2),), dtype=torch.float32,
                      device=q_eff.device) if n_splits > 1 else None)
    lib = cuda_build.load_library()
    err = lib.tllm_mla_prefill(
        cuda_build.ptr(q_eff), cuda_build.ptr(cache),
        cuda_build.ptr(block_table), cuda_build.ptr(ws), cuda_build.ptr(out),
        T, H, L, DK, NB, BS, MB, kv_len, int(q_offset), float(scale),
        n_splits, split_len, cuda_build.stream_of(q_eff))
    cuda_build.check(err, "mla_prefill")
    cuda_build.launch_counts["mla_prefill"] += 1
    return out
