"""Paged decode attention: one query token per sequence.

Counterpart of `tensorrt_llm_tpu/ops/paged_attention.py`.
`paged_decode_plain` is the plain version (the JAX package's
`paged_decode_xla`); `paged_decode_attention` takes it for CPU tensors and
for CUDA tensors launches kernel K4 over bf16 or FP8 (e4m3) pools, or K6
over INT8 pools (`csrc/paged_decode.cuh`, one template: head dims 64, 128
and 256, any GQA group from 1 to 16, padded in the kernel to 1, 2, 4, 8 or
16; pages of a multiple of 8 tokens, 4 for int8 and e4m3), split over the KV as `decode_plan` says and merged inside the
one launch.  The launch counts name the instances apart:
``paged_decode``, ``paged_decode_int8``, ``paged_decode_fp8``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from tensorrt_llm_tpu_torch.ops import cuda_build
from tensorrt_llm_tpu_torch.ops.attention_plain import paged_decode_plain
from tensorrt_llm_tpu_torch.utils import cdiv

__all__ = ["paged_decode_attention", "paged_decode_plain", "decode_plan",
           "decode_split_choices", "decode_check", "split_grid",
           "pool_kind", "pool_operands"]

_SMS = 132
DECODE_TILE = 64         # tokens a tile of the kernel (a split is whole tiles)
# the shortest split: two tiles for each of a block's four consumer warps
# (with one a warp, the H100's phase-3 rows at 16 and 32 (sequence, KV
# head) pairs ran 1.26-1.34x slower than at 512 tokens)
DECODE_MIN_SPLIT = 512
# a table of at most this many tiles runs unsplit (at most four tiles a
# warp cost less than the merge of splits)
DECODE_ONE_SPLIT_TILES = 16
# blocks an SM (the kernel's ~100 KB of shared memory: two) a wave holds
_DECODE_BLOCKS_PER_SM = 2
# a longer split (fewer splits to merge) is kept unless a shorter one is
# modelled this much faster (fitted on the H100's phase-3 decode rows)
_DECODE_LONGER_SPLIT_SLACK = 1.05


DECODE_HEAD_DIMS = (64, 128, 256)
DECODE_MAX_GROUP = 16


def decode_check(D: int, G: int, BS: int, kind: str = "bf16") -> None:
    """Raise NotImplementedError on what the kernel does not take: head dims
    64, 128 and 256, 1 to 16 query heads a KV head, and pages of a multiple
    of 8 tokens for bf16 pools (TMA boxes fill whole 8-row swizzle atoms)
    or of 4 tokens for the 1-byte pages of `kind` "int8" and "fp8" (bulk
    copies of runs of at least 4 tokens, which for int8 carry whole 16-byte
    runs of a page's f32 scales)."""
    mult = 8 if kind == "bf16" else 4
    if D not in DECODE_HEAD_DIMS or not 1 <= G <= DECODE_MAX_GROUP \
            or BS <= 0 or BS % mult:
        raise NotImplementedError(
            f"paged_decode kernel: D in {DECODE_HEAD_DIMS}, Hq/Hkv in 1.."
            f"{DECODE_MAX_GROUP}, pages of a multiple of {mult} tokens "
            f"(D={D}, G={G}, BS={BS})")


def decode_split_choices(table_tokens: int) -> tuple:
    """Split lengths the kernel takes for a table of `table_tokens`: whole
    64-token tiles, doubling from one tile up to the first that covers the
    table."""
    out, L = [], DECODE_TILE
    while True:
        out.append(L)
        if L >= table_tokens:
            return tuple(out)
        L *= 2


@functools.lru_cache(maxsize=4096)
def decode_plan(B: int, Hkv: int, table_tokens: int,
                window: Optional[int] = None, n_sms: int = _SMS) -> dict:
    """(n_splits, split_len, grid_x) of a decode call.  kv_lens stay on the
    device, so the split is sized for a sequence at the table's full width:
    one split for a table of at most `DECODE_ONE_SPLIT_TILES` tiles, else
    the longest of `decode_split_choices` (at least `DECODE_MIN_SPLIT`)
    whose modelled time is within `_DECODE_LONGER_SPLIT_SLACK` of the
    least: the tokens a block walks (the split, or the window if shorter)
    times the waves its B x Hkv x `split_grid` blocks take at
    `_DECODE_BLOCKS_PER_SM` blocks an SM, fractional, since a partial
    wave overlaps the tail of the one before.  Shorter sequences' later
    splits exit at once; the grid runs `split_grid` splits from each
    sequence's first live one, so a window counts only the splits it can
    touch (a window past the table: every split, as without one).  `chip_smoke.py` times every
    split length at its decode rows and fails if this pick is more than
    ``DECODE_PLAN_SLACK`` slower than the fastest.  Pure shape logic; the
    tests check it on the CPU."""
    choices = decode_split_choices(table_tokens)
    least = min(DECODE_MIN_SPLIT, choices[-1])
    if cdiv(table_tokens, DECODE_TILE) <= DECODE_ONE_SPLIT_TILES:
        least = choices[-1]
    pairs = max(B * Hkv, 1)
    slots = _DECODE_BLOCKS_PER_SM * n_sms
    cost = {c: min(c, window or c) * max(
        1.0, pairs * split_grid(table_tokens, c, window) / slots)
        for c in choices if c >= least}
    fastest = min(cost.values())
    L = max(c for c, t in cost.items()
            if t <= fastest * _DECODE_LONGER_SPLIT_SLACK)
    return {"n_splits": max(1, cdiv(table_tokens, L)), "split_len": L,
            "grid_x": split_grid(table_tokens, L, window)}


def split_grid(table_tokens: int, split_len: int,
               window: Optional[int] = None) -> int:
    """Blocks a (sequence, KV head) gets: every split of the table, or with
    a window the most splits the window's tokens can touch."""
    n = max(1, cdiv(table_tokens, split_len))
    return min(n, cdiv(window, split_len) + 1) if window else n


def pool_kind(cache) -> str:
    """"int8" for an INT8 pair, "fp8" for e4m3 pages, else "bf16"."""
    if isinstance(cache, tuple):
        return "int8"
    return "fp8" if cache.dtype == torch.float8_e4m3fn else "bf16"


_POOL_DTYPES = {"bf16": (torch.bfloat16,) * 2,
                "fp8": (torch.float8_e4m3fn,) * 2,
                "int8": (torch.int8, torch.float32) * 2}


def pool_operands(k_cache, v_cache, device):
    """Check a K/V pool pair for the attention kernels: bf16 or FP8 (e4m3)
    pools [NB, Hkv, BS, D], or INT8 pairs (int8 data [NB, Hkv, BS, D], f32
    scales [NB, Hkv, BS]).  Returns (`pool_kind`, (NB, Hkv, BS, D), device
    pointers in the C entry points' order: k, v or k_data, k_scale, v_data,
    v_scale)."""
    kind = pool_kind(k_cache)
    if kind != pool_kind(v_cache):
        raise ValueError("K and V pools must be of one kind (bf16, FP8 or "
                         "INT8)")
    int8 = kind == "int8"
    parts = [*k_cache, *v_cache] if int8 else [k_cache, v_cache]
    for t, dt in zip(parts, _POOL_DTYPES[kind]):
        if t.device != device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"KV pools must be contiguous {dt} on {device}")
    shape = tuple(parts[0].shape)
    data, scales = (parts[0::2], parts[1::2]) if int8 else (parts, [])
    if any(tuple(t.shape) != shape for t in data) \
            or any(tuple(t.shape) != shape[:3] for t in scales):
        raise ValueError("K/V pool shapes do not match")
    return kind, shape, [cuda_build.ptr(t) for t in parts]


def paged_decode_attention(q: torch.Tensor, k_cache, v_cache,
                           block_tables: torch.Tensor,
                           kv_lens: torch.Tensor, scale: float,
                           sliding_window: Optional[int] = None,
                           logit_cap: Optional[float] = None,
                           sinks: Optional[torch.Tensor] = None,
                           split_len: Optional[int] = None) -> torch.Tensor:
    """q [B, Hq, D] against pools [NB, Hkv, BS, D] (bf16, FP8, or INT8 pairs)
    through block_tables [B, MB]; kv_lens [B] include the new token.
    `split_len` overrides `decode_plan`'s tokens a split (CUDA only).
    Returns [B, Hq, D]."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_cache, v_cache, block_tables, kv_lens,
                                  scale, sliding_window, logit_cap, sinks)
    # any other device reaches the kernel's checks: a shape it does not take
    # raises NotImplementedError before a device that is not CUDA
    B, Hq, D = q.shape
    _, Hkv, BS, Dk = (k_cache[0] if isinstance(k_cache, tuple)
                      else k_cache).shape
    G = Hq // Hkv if Hkv and Hq % Hkv == 0 else 0
    decode_check(D if Dk == D else -1, G, BS, pool_kind(k_cache))
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    kind, (NB, _, _, _), pools = pool_operands(k_cache, v_cache, q.device)
    int8 = kind == "int8"
    for name, t, dt in (("q", q, torch.bfloat16),
                        ("block_tables", block_tables, torch.int32),
                        ("kv_lens", kv_lens, torch.int32)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {q.device}")
    MB = block_tables.shape[1]
    if block_tables.shape[0] != B or kv_lens.shape != (B,):
        raise ValueError("table or kv_lens shape mismatch")
    if any(t.data_ptr() % 16 for t in (q, *(k_cache if int8 else (k_cache,)),
                                       *(v_cache if int8 else (v_cache,)))):
        raise ValueError("q and the pools must start 16-byte aligned")
    if sinks is not None:
        sinks = sinks.to(device=q.device, dtype=torch.float32).contiguous()
        if sinks.shape != (Hq,):
            raise ValueError(f"sinks must be [{Hq}]")
    out = torch.empty_like(q)
    if B == 0:
        return out
    if split_len is None:
        split_len = decode_plan(B, Hkv, MB * BS, sliding_window or None,
                                cuda_build.num_sms(q.device))["split_len"]
    elif split_len <= 0 or split_len % DECODE_TILE:
        raise ValueError(f"split_len {split_len} must be a positive multiple "
                         f"of {DECODE_TILE}")
    n_splits = max(1, cdiv(MB * BS, split_len))
    ws = (torch.empty((B * Hq * n_splits * (D + 2),), dtype=torch.float32,
                      device=q.device) if n_splits > 1 else None)
    cnt = cuda_build.counters(q.device, B * Hkv)
    lib = cuda_build.load_library()
    name = "paged_decode" if kind == "bf16" else "paged_decode_" + kind
    err = getattr(lib, "tllm_" + name)(
        cuda_build.ptr(q), *pools, cuda_build.ptr(block_tables),
        cuda_build.ptr(kv_lens), cuda_build.ptr(sinks), cuda_build.ptr(ws),
        cuda_build.ptr(cnt), cuda_build.ptr(out), B, Hq, Hkv, D, NB, BS, MB,
        float(scale), int(sliding_window or 0), float(logit_cap or 0.0),
        n_splits, split_len, split_grid(MB * BS, split_len, sliding_window),
        cuda_build.stream_of(q))
    cuda_build.check(err, name)
    cuda_build.count_launch(name)
    return out
