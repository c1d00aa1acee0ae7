"""Grouped (ragged) W4A16 GEMM for quantized MoE experts.

Counterpart of `tensorrt_llm_tpu/ops/moe_w4a16.py`.  Rows of ``xs`` are
sorted by expert; ``group_sizes[e]`` rows belong to expert ``e``; each row is
multiplied by its expert's int4 weight, dequantized with per-group scales
(and optional zeros).  The output is f32 ``[M, N]``.

* `make_group_metadata` is the work decomposition of the JAX package: the
  M axis cut into `tm`-row tiles, one work unit per (expert, m-tile)
  overlap, at most ``m_tiles + E - 1`` units (a static bound).
* `w4a16_grouped_matmul_plain` is the plain version (the JAX package's
  `w4a16_grouped_matmul_xla`): each expert's weight dequantized to bf16, a
  bf16 product with f32 accumulation, rounded to bf16 as XLA's `ragged_dot`
  returns it.
* `gmm_work_units` computes those units on the device (K5's prologue
  kernel), once per MoE layer; `moe_gmm` wraps kernel K5
  (`csrc/moe_gmm.cu`), which writes each unit's rows only.
* `w4a16_grouped_matmul` dispatches: the plain version for CPU tensors, K5
  for CUDA tensors.

Expert weights keep the JAX layout: packed ``[E, N//BN, K//2, BN]`` int8
(`pack_w4_tiled` per expert) and scales/zeros ``[E, K//G, N]`` f32.  Unlike
the dense linears, the JAX package keeps MoE scales in f32, so the port
does too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tensorrt_llm_tpu_torch.ops import cuda_build
from tensorrt_llm_tpu_torch.quantization.quantize import (
    choose_block_n, dequantize_w4_any, pack_w4_tiled, quantize_w4)

GMM_TM = 64    # rows of K5's output tile, and of its metadata's m-tiles


def make_group_metadata(group_sizes: torch.Tensor, m_tiles: int, tm: int,
                        num_groups: int) -> torch.Tensor:
    """Per-work-unit metadata int32 ``[5, W]``: m-tile id, group id, row
    range within the tile, and whether the unit is the first of its m-tile.
    W = m_tiles + num_groups - 1; padding units have an empty row range.
    Plain torch on the tensor's device (no value is read back)."""
    E = num_groups
    W = m_tiles + E - 1
    dev = group_sizes.device
    sizes = group_sizes.to(torch.int64)
    ends = torch.cumsum(sizes, 0)
    starts = ends - sizes
    nonempty = sizes > 0
    ft = torch.where(nonempty, starts // tm, 0)
    lt = torch.where(nonempty, (ends - 1) // tm, -1)
    tiles_per = torch.where(nonempty, lt - ft + 1, 0)
    wend = torch.cumsum(tiles_per, 0)
    wstart = wend - tiles_per
    num_work = wend[-1]
    w_idx = torch.arange(W, device=dev, dtype=torch.int64)
    g = torch.clamp(torch.searchsorted(wend, w_idx, right=True), 0, E - 1)
    valid = w_idx < num_work
    mt = torch.where(valid, ft[g] + w_idx - wstart[g], m_tiles - 1)
    row_lo = torch.where(valid, torch.clamp(starts[g] - mt * tm, min=0), 0)
    row_hi = torch.where(valid, torch.clamp(ends[g] - mt * tm, max=tm), 0)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       mt[1:] != mt[:-1]])
    first = torch.where(valid, first.to(torch.int64), 0)
    return torch.stack([mt, g, row_lo, row_hi, first]).to(torch.int32)


def quantize_experts_w4(w: torch.Tensor, group_size: int = 128,
                        symmetric: bool = True,
                        block_n: Optional[int] = None, shards: int = 1
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor], int]:
    """Quantize and tile-pack a stack of expert weights ``[E, K, N]``.

    Returns (packed ``[E, n_n, K//2, BN]`` int8, scales ``[E, K//G, N]`` f32,
    zeros or None, BN).  BN is `choose_block_n(N)`, or N itself when no
    128-multiple tile divides N (GPT-OSS down: N = 2880)."""
    E, K, N = w.shape
    G = K if group_size in (-1, 0) or group_size > K else group_size
    bn = block_n or choose_block_n(N, shards) or (N // shards)
    packed, scales, zeros = [], [], []
    for e in range(E):
        q, s, z = quantize_w4(w[e], G, symmetric)
        packed.append(pack_w4_tiled(q, bn))
        scales.append(s)
        zeros.append(z)
    z = None if symmetric else torch.stack(zeros)
    return torch.stack(packed), torch.stack(scales), z, bn


def dequantize_experts_w4(packed: torch.Tensor, scales: torch.Tensor,
                          zeros: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``[E, n_n, K//2, BN]`` -> ``[E, K, N]`` f32."""
    return torch.stack([
        dequantize_w4_any(packed[e], scales[e],
                          None if zeros is None else zeros[e])
        for e in range(packed.shape[0])])


def w4a16_grouped_matmul_plain(xs: torch.Tensor, packed: torch.Tensor,
                               scales: torch.Tensor,
                               group_sizes: torch.Tensor,
                               zeros: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain version: per expert, dequantize to bf16 and multiply its rows
    with f32 accumulation; the result is rounded to bf16 (as `ragged_dot`
    returns it) and returned as f32 ``[M, N]``.  Rows past the groups are
    0.  Reads `group_sizes` on the host (this version is never on the
    CUDA path)."""
    M = xs.shape[0]
    E, n_n, _, bn = packed.shape
    out = torch.zeros((M, n_n * bn), dtype=torch.float32, device=xs.device)
    x = xs.to(torch.bfloat16).to(torch.float32)
    lo = 0
    for e, n in enumerate(group_sizes.tolist()):
        hi = min(lo + int(n), M)
        if hi > lo:
            w = dequantize_w4_any(packed[e], scales[e],
                                  None if zeros is None else zeros[e])
            w = w.to(torch.bfloat16).to(torch.float32)
            out[lo:hi] = (x[lo:hi] @ w).to(torch.bfloat16).to(torch.float32)
        lo = hi
    return out


def _check_operands(xs, packed, scales, zeros, units):
    if xs.device.type != "cuda":
        raise ValueError("CUDA kernel called with a non-CUDA tensor")
    M, K = xs.shape
    E, n_n, half, bn = packed.shape
    N = n_n * bn
    for name, t, dt in (("xs", xs, torch.bfloat16), ("packed", packed,
                        torch.int8), ("scales", scales, torch.float32),
                        ("zeros", zeros, torch.float32),
                        ("units", units, torch.int32)):
        if t is None:
            continue
        if t.device != xs.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {xs.device}")
    if half * 2 != K:
        raise ValueError(f"packed {tuple(packed.shape)} does not match K={K}")
    if scales.dim() != 3 or scales.shape[0] != E or scales.shape[2] != N \
            or K % scales.shape[1]:
        raise ValueError(f"scales must be f32 [{E}, K/G, {N}]")
    if zeros is not None and zeros.shape != scales.shape:
        raise ValueError("zeros must be shaped like scales")
    if units.shape != (5, max(-(-M // GMM_TM) + E - 1, 1)):
        raise ValueError(f"units {tuple(units.shape)} are not those of "
                         f"M={M} rows over E={E} experts")
    G = K // scales.shape[1]
    if bn % 64 or K % 32 or G % 32:
        raise NotImplementedError(
            f"moe_gmm needs BN % 64 == 0, K % 32 == 0 and G % 32 == 0 "
            f"(BN={bn}, K={K}, G={G})")
    return M, N, K, G, E, bn


def gmm_work_units(group_sizes: torch.Tensor, M: int) -> torch.Tensor:
    """The work units of `M` expert-sorted rows (`make_group_metadata` at
    tile `GMM_TM`), int32 ``[5, m_tiles + E - 1]``.  CPU tensors take
    `make_group_metadata`; on CUDA K5's prologue kernel computes them on
    the device, so nothing is read back.  One call serves every product of
    a layer that shares `group_sizes`."""
    E = group_sizes.shape[0]
    m_tiles = -(-M // GMM_TM)
    if group_sizes.device.type == "cpu":
        return make_group_metadata(group_sizes, max(m_tiles, 1), GMM_TM, E)
    if group_sizes.device.type != "cuda":
        raise ValueError(f"unsupported device {group_sizes.device}")
    if group_sizes.dtype != torch.int32 or not group_sizes.is_contiguous():
        raise ValueError("group_sizes must be contiguous int32")
    units = torch.empty((5, max(m_tiles + E - 1, 1)), dtype=torch.int32,
                        device=group_sizes.device)
    if M == 0:
        return units
    err = cuda_build.load_library().tllm_moe_gmm_units(
        cuda_build.ptr(group_sizes), cuda_build.ptr(units), M, E,
        cuda_build.stream_of(group_sizes))
    cuda_build.check(err, "moe_gmm_units")
    cuda_build.launch_counts["moe_gmm_units"] += 1
    return units


def moe_gmm(xs: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
            units: torch.Tensor, zeros: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Launch K5 on CUDA operands: xs ``[M, K]`` bf16 sorted by expert,
    packed ``[E, n_n, K//2, BN]`` int8, scales (zeros) ``[E, K//G, N]`` f32,
    and the work units of these M rows from `gmm_work_units`.  Returns f32
    ``[M, N]``; rows past ``sum(group_sizes)`` are left unwritten, as on
    the TPU."""
    M, N, K, G, E, bn = _check_operands(xs, packed, scales, zeros, units)
    out = torch.empty((M, N), dtype=torch.float32, device=xs.device)
    if M == 0:
        return out
    lib = cuda_build.load_library()
    err = lib.tllm_moe_gmm(
        cuda_build.ptr(xs), cuda_build.ptr(packed), cuda_build.ptr(scales),
        cuda_build.ptr(zeros), cuda_build.ptr(units), cuda_build.ptr(out),
        M, N, K, G, E, bn, cuda_build.stream_of(xs))
    cuda_build.check(err, "moe_gmm")
    cuda_build.launch_counts["moe_gmm"] += 1
    return out


def w4a16_grouped_matmul(xs: torch.Tensor, packed: torch.Tensor,
                         scales: torch.Tensor, group_sizes: torch.Tensor,
                         units: torch.Tensor,
                         zeros: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Grouped ``out[i] = xs[i] @ deq(W[g(i)])`` with rows grouped by
    expert; f32 ``[M, N]``.  `units` are `gmm_work_units(group_sizes, M)`.
    CPU tensors take the plain version (which reads `group_sizes`); CUDA
    tensors launch K5 on `units` (or raise)."""
    if xs.device.type == "cpu":
        return w4a16_grouped_matmul_plain(xs, packed, scales, group_sizes,
                                          zeros)
    if xs.device.type != "cuda":
        raise ValueError(f"unsupported device {xs.device}")
    return moe_gmm(xs.to(torch.bfloat16).contiguous(), packed, scales,
                   units, zeros)
