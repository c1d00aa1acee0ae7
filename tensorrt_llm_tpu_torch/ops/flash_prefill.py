"""Flash attention for (chunked) prefill over paged KV.

Counterpart of `tensorrt_llm_tpu/ops/flash_prefill.py`.  `flash_prefill_plain`
is the plain version (the JAX package's `paged_prefill_xla`);
`flash_prefill_attention` takes it for CPU tensors and for CUDA tensors
launches one Hopper kernel, `csrc/flash_prefill_sm90.cu` (a producer warp
loading the pages, two consumer warpgroups on wgmma, at head dims 64 and
128): K3 over bf16 pools (TMA boxes of the pages in the swizzle wgmma
reads; pages of a multiple of 8 tokens) or K7 over INT8 pools (bulk copies
of the int8 pages, converted to bf16 in shared memory).
"""

from __future__ import annotations

from typing import Optional

import torch

from tensorrt_llm_tpu_torch.ops import cuda_build
from tensorrt_llm_tpu_torch.ops.attention_plain import (
    paged_prefill_plain as flash_prefill_plain)
from tensorrt_llm_tpu_torch.ops.paged_attention import pool_operands

__all__ = ["flash_prefill_attention", "flash_prefill_plain"]


PREFILL_ROWS = 64      # stacked query rows of a K3/K7 block (token x G + head)
PREFILL_TILE = 64      # KV tokens a K3/K7 tile takes
BF16_PAGE_MULTIPLE = 8   # K3's TMA boxes fill whole 8-row swizzle atoms


def prefill_tile_ranges(T: int, G: int, kv_len: int, q_offset: int,
                        window: Optional[int] = None) -> list:
    """[(first tile, end tile)] of each K3/K7 block's 64 stacked rows (the
    bounds `csrc/flash_prefill_sm90.cu` computes): up to the causal edge of
    the block's last row, from the sliding window of its first; tiles of
    `PREFILL_TILE` KV tokens.  The tiles outside a block's range hold no
    (row, KV position) pair that the masks keep; within it, the masks cut
    the rest.  Pure shape logic; the tests check it on the CPU."""
    R = T * G
    out = []
    for row0 in range(0, R, PREFILL_ROWS):
        last = min(row0 + PREFILL_ROWS, R) - 1
        kv_end = min(kv_len, q_offset + last // G + 1)
        kv_begin = (max(0, q_offset + row0 // G - window + 1)
                    if window and window > 0 else 0)
        out.append((kv_begin // PREFILL_TILE,
                    -(-kv_end // PREFILL_TILE) if kv_end > 0 else 0))
    return out


def _as_int(v) -> int:
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def flash_prefill_attention(q: torch.Tensor, k_cache, v_cache,
                            block_table: torch.Tensor,
                            kv_len, q_offset, scale: float,
                            sliding_window: Optional[int] = None,
                            logit_cap: Optional[float] = None,
                            sinks: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """One sequence's chunk q [T, Hq, D] (positions q_offset..) against its
    paged KV [NB, Hkv, BS, D] (bf16, or INT8 pairs) through block_table
    [MB]; kv_len counts the prefix plus the chunk, which is already
    written.  Returns [T, Hq, D]."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k_cache, v_cache, block_table, kv_len,
                                   q_offset, scale, sliding_window, logit_cap,
                                   sinks)
    # what the kernels are not built for is refused before the device:
    # never a fallback
    int8 = isinstance(k_cache, tuple)
    NB, Hkv, BS, Dk = (k_cache[0] if int8 else k_cache).shape
    T, Hq, D = q.shape
    if D not in (64, 128) or Dk != D or Hq % Hkv:
        raise NotImplementedError(
            f"flash_prefill kernel: D in (64, 128) and Hq % Hkv == 0 "
            f"(D={D}, Hq={Hq}, Hkv={Hkv})")
    if not int8 and BS % BF16_PAGE_MULTIPLE:
        raise NotImplementedError(
            f"flash_prefill kernel (bf16 pages): pages of a multiple of "
            f"{BF16_PAGE_MULTIPLE} tokens, got {BS}")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    pools = pool_operands(k_cache, v_cache, q.device)[2]
    for name, t, dt in (("q", q, torch.bfloat16),
                        ("block_table", block_table, torch.int32)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {q.device}")
    if block_table.dim() != 1:
        raise ValueError("block_table must be [MB]")
    if any(t.data_ptr() % 16 for t in (
            (*k_cache, *v_cache) if int8 else (k_cache, v_cache))):
        raise ValueError("KV pools must start 16-byte aligned (TMA and bulk "
                         "copies)")
    if sinks is not None:
        sinks = sinks.to(device=q.device, dtype=torch.float32).contiguous()
        if sinks.shape != (Hq,):
            raise ValueError(f"sinks must be [{Hq}]")
    out = torch.empty_like(q)
    if T == 0:
        return out
    lib = cuda_build.load_library()
    name = "flash_prefill_int8" if int8 else "flash_prefill"
    # the bf16 tensor maps need the pools' extent
    dims = (T, Hq, Hkv, D, BS) if int8 else (T, Hq, Hkv, D, NB, BS)
    err = getattr(lib, "tllm_" + name)(
        cuda_build.ptr(q), *pools, cuda_build.ptr(block_table),
        cuda_build.ptr(sinks), cuda_build.ptr(out), *dims,
        block_table.shape[0], _as_int(kv_len), _as_int(q_offset),
        float(scale), int(sliding_window or 0), float(logit_cap or 0.0),
        cuda_build.stream_of(q))
    cuda_build.check(err, name)
    cuda_build.count_launch(name)
    return out
