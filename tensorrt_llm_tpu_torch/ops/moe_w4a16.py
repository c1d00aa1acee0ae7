"""Grouped (ragged) W4A16 GEMM for quantized MoE experts.

Counterpart of `tensorrt_llm_tpu/ops/moe_w4a16.py`.  Rows of ``xs`` are
sorted by expert; ``group_sizes[e]`` rows belong to expert ``e``; each row is
multiplied by its expert's int4 weight, dequantized with per-group scales
(and optional zeros).  The output is f32 ``[M, N]``.

* `make_group_metadata` is the work decomposition of the JAX package: the
  M axis cut into `tm`-row tiles, one work unit per (expert, m-tile)
  overlap, at most ``m_tiles + E - 1`` units (a static bound).  The port
  keeps it as the JAX package's, held against it by the tests; K5 cuts
  the rows otherwise.
* `w4a16_grouped_matmul_plain` is the plain version (the JAX package's
  `w4a16_grouped_matmul_xla`): each expert's weight dequantized to bf16, a
  bf16 product with f32 accumulation, rounded to bf16 as XLA's `ragged_dot`
  returns it.
* K5's units: each hit expert's rows cut into tiles of NTOK tokens
  (`gmm_plan` picks NTOK from M and E), one unit (expert, first row, rows)
  each, at most ``ceil(M / NTOK) + min(E, M)`` of them (a static bound, so
  nothing is read back).  `gmm_units_plain` builds the list in plain
  torch; `gmm_work_units` builds it on the device (K5's prologue kernel),
  once per MoE layer; `moe_gmm` wraps kernel K5 (`csrc/moe_gmm.cu`, the
  grouped layout of the Hopper mainloop), which writes each unit's rows
  only.
* `w4a16_grouped_matmul` dispatches: the plain version for CPU tensors, K5
  for CUDA tensors.

Expert weights keep the JAX layout: packed ``[E, N//BN, K//2, BN]`` int8
(`pack_w4_tiled` per expert) and scales/zeros ``[E, K//G, N]`` f32.  Unlike
the dense linears, the JAX package keeps MoE scales in f32, so the port
does too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import functools
import math

import torch

from tensorrt_llm_tpu_torch.ops import cuda_build
from tensorrt_llm_tpu_torch.quantization.quantize import (
    _split_nibbles, choose_block_n, pack_w4_tiled, quantize_w4)
from tensorrt_llm_tpu_torch.utils import cdiv

GMM_NTOK = (8, 16, 32, 64, 128)   # K5's token tiles (wgmma N)
_SMS = 132                        # H100 SXM streaming multiprocessors
# `gmm_ntok`'s cost of one unit's 64-column tile over one 64-row stage, in
# seconds of the card at each token tile, fitted to K5's times on the H100
# at every tile and checked row (`chip_smoke.py` check_moe, Qwen3-30B-A3B's
# and MiniMax-M2's rows included): the tiles up to 32 tokens run three
# blocks an SM, 64 two, 128 one of 128 columns, so the wider tiles hide
# less of the weight stream (Qwen3-30B-A3B's 16 rows an expert at a
# 256-token chunk run 1.15-1.21x slower at 64 than at 32)
_GMM_COST = {8: 0.217e-6, 16: 0.2257e-6, 32: 0.2430e-6, 64: 0.2886e-6,
             128: 0.3472e-6}


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
    """``[E, n_n, K//2, BN]`` -> ``[E, K, N]`` f32, every expert at once
    (value for value `dequantize_w4_any` of each)."""
    E, n_n, half, bn = packed.shape
    lo, hi = _split_nibbles(packed.permute(0, 2, 1, 3).reshape(
        E, half, n_n * bn))
    K, N = 2 * half, n_n * bn
    G = K // scales.shape[1]
    q = torch.stack([lo, hi], dim=2).reshape(E, K // G, G, N).to(
        torch.float32)
    if zeros is not None:
        q = q - zeros.to(torch.float32)[:, :, None, :]
    return (q * scales.to(torch.float32)[:, :, None, :]).reshape(E, K, N)


# f32 bytes of the experts the plain version dequantizes at a time (its
# temporaries are a few times that: Llama-4-Scout's 16 gate_up experts at
# once, 5.4 GB of f32, ran the card out of memory)
_PLAIN_BYTES = 1 << 30


def w4a16_grouped_matmul_plain(xs: torch.Tensor, packed: torch.Tensor,
                               scales: torch.Tensor,
                               group_sizes: torch.Tensor,
                               zeros: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain version: each expert's weight dequantized to bf16 and its rows
    multiplied with f32 accumulation; the result is rounded to bf16 (as
    `ragged_dot` returns it) and returned as f32 ``[M, N]``.  Rows past
    the groups are 0.  The experts with rows go `_PLAIN_BYTES` of f32
    weights at a time: their weights dequantized together, their rows
    (padded with zero rows to the largest group) in one batched
    product.  Reads
    `group_sizes` on the host (this version is never on the CUDA
    path)."""
    M, K = xs.shape
    E, n_n, _, bn = packed.shape
    dev = xs.device
    out = torch.zeros((M, n_n * bn), dtype=torch.float32, device=dev)
    # a zero row at index M pads each expert's rows
    x = torch.cat([xs.to(torch.bfloat16).to(torch.float32),
                   torch.zeros((1, K), dtype=torch.float32, device=dev)])
    groups, lo = [], 0
    for e, n in enumerate(group_sizes.tolist()):
        hi = min(lo + int(n), M)
        if hi > lo:
            groups.append((e, lo, hi))
        lo = hi
    per = max(1, _PLAIN_BYTES // (K * n_n * bn * 4))
    for c in range(0, len(groups), per):
        chunk = groups[c:c + per]
        R = max(hi - lo for _, lo, hi in chunk)
        rows = torch.full((len(chunk), R), M, dtype=torch.int64)
        for j, (_, lo, hi) in enumerate(chunk):
            rows[j, :hi - lo] = torch.arange(lo, hi)
        rows = rows.to(dev)
        ids = torch.tensor([e for e, _, _ in chunk], device=dev)
        w = dequantize_experts_w4(
            packed[ids], scales[ids], None if zeros is None else zeros[ids])
        w = w.to(torch.bfloat16).to(torch.float32)
        y = torch.bmm(x[rows], w).to(torch.bfloat16).to(torch.float32)
        real = rows < M
        out[rows[real]] = y[real]
    return out


# ------------------------------------------------------------- K5 plan ---
def gmm_units_bound(M: int, E: int, ntok: int) -> int:
    """The static bound of K5's unit list: ceil(M / ntok) + min(E, M) (each
    hit expert adds at most one partial tile)."""
    return cdiv(M, ntok) + min(E, M)


def _poisson_tiles(lam: float, ntok: int) -> float:
    """E[ceil(X / ntok)] for an expert's rows X ~ Poisson(lam)."""
    if lam <= 0:
        return 0.0
    kmax = int(lam + 10 * math.sqrt(lam) + 20)
    pmf, total = math.exp(-lam), 0.0
    for k in range(1, kmax + 1):
        pmf *= lam / k
        total += pmf * cdiv(k, ntok)
    return total


@functools.lru_cache(maxsize=4096)
def gmm_expected_units(M: int, E: int, ntok: int,
                       skewed: bool = False) -> float:
    """Units of M rows over E experts, each expert's rows Poisson: at
    uniform routing a share 1/E each; skewed, half the experts get none
    and the rest a Zipf share (1/i over the live experts, the skew
    `chip_smoke.py` times)."""
    if not skewed:
        return E * _poisson_tiles(M / E, ntok)
    live = max(1, E // 2)
    h = sum(1.0 / i for i in range(1, live + 1))
    return sum(_poisson_tiles(M / (i * h), ntok) for i in range(1, live + 1))


def _gmm_tiles(ntok: int):
    """(consumer warpgroups, blocks an SM holds) of the mainloop at a
    token tile: 64 columns a block up to 64 tokens (three blocks an SM up
    to 32, two at 64), 128 at 128 (one)."""
    if ntok >= 128:
        return 2, 1
    return 1, (3 if ntok <= 32 else 2)


def gmm_ntok_cost(M: int, E: int, ntok: int, skewed: bool = False) -> float:
    """K5's modeled device time per 64-column tile and 64-row stage at a
    token tile: the expected units (`gmm_expected_units`) times a unit's
    cost at that tile (`_GMM_COST`)."""
    return gmm_expected_units(M, E, ntok, skewed) * _GMM_COST[ntok]


@functools.lru_cache(maxsize=4096)
def gmm_ntok(M: int, E: int) -> int:
    """K5's token tile for M rows over E experts: the tile whose modeled
    cost (`gmm_ntok_cost`) is least over the best tile's under both
    routings, uniform and skewed, at worst (the routing is the data's and
    the host does not read it); the smaller tile at a tie.  At decode an
    expert gets 1-3 rows and the smallest tiles win; at a prefill chunk
    the tile grows with the rows an expert gets, more under skew.  It
    depends on M and E only, so that one unit list serves both products of
    a MoE layer.  `chip_smoke.py` times every tile at the checked rows
    under uniform and skewed routing and fails if this pick is more than
    ``GMM_NTOK_SLACK`` slower than the fastest."""
    M = max(M, 1)
    best_of = {sk: min(gmm_ntok_cost(M, E, t, sk) for t in GMM_NTOK)
               for sk in (False, True)}
    best, best_r = GMM_NTOK[0], None
    for ntok in GMM_NTOK:
        r = max(gmm_ntok_cost(M, E, ntok, sk) / best_of[sk]
                for sk in (False, True))
        if best_r is None or r < best_r * (1 - 1e-9):
            best, best_r = ntok, r
    return best


@functools.lru_cache(maxsize=4096)
def gmm_plan(M: int, E: int, K: int, N: int, G: int, n_sms: int = _SMS,
             ntok: Optional[int] = None) -> dict:
    """K5's launch (`csrc/moe_gmm.cu`): the token tile (`gmm_ntok`, unless
    given), the column tiles, the unit list's static bound and the
    persistent grid, one block per (unit, column tile) up to the blocks
    the SMs hold.  Raises NotImplementedError on a shape K5 does not take
    (K % 32 == 0 and G % 32 == 0, or one group; N % 64 == 0).  Pure shape
    logic; the tests check it on the CPU."""
    if K % 32 or N % 64 or N <= 0 or (G < K and G % 32) or K % min(G, K):
        raise NotImplementedError(
            f"moe_gmm needs K % 32 == 0, N % 64 == 0 and G % 32 == 0 "
            f"dividing K (K={K}, N={N}, G={G})")
    ntok = ntok or gmm_ntok(M, E)
    if ntok not in GMM_NTOK:
        raise ValueError(f"token tile {ntok} not in {GMM_NTOK}")
    nwg, per_sm = _gmm_tiles(ntok)
    bound = gmm_units_bound(M, E, ntok)
    n_ct = cdiv(N, 64 * nwg)
    return {"ntok": ntok, "nwg": nwg, "cols": 64 * nwg, "n_ct": n_ct,
            "bound": bound,
            "grid": max(1, min(bound * n_ct, per_sm * n_sms))}


def gmm_units_plain(group_sizes: torch.Tensor, M: int,
                    ntok: int) -> torch.Tensor:
    """K5's unit list in plain torch on the tensor's device (nothing read
    back), as the prologue kernel writes it: int32 ``[bound + 1, 3]``, a
    header row (count, ntok, bound), then (expert, first row, rows) for
    each NTOK-token tile of each hit expert's rows, in expert order, and
    zero rows up to the bound (`gmm_units_bound`)."""
    E = group_sizes.shape[0]
    dev = group_sizes.device
    bound = gmm_units_bound(M, E, ntok)
    sizes = group_sizes.to(torch.int64)
    starts = torch.cumsum(sizes, 0) - sizes
    nu = (sizes + ntok - 1) // ntok
    uend = torch.cumsum(nu, 0)
    count = torch.clamp(uend[-1:], max=bound)
    w = torch.arange(bound, dtype=torch.int64, device=dev)
    e = torch.clamp(torch.searchsorted(uend, w, right=True), 0, E - 1)
    i = w - (uend - nu)[e]
    r = starts[e] + i * ntok
    n = torch.minimum(torch.clamp(sizes[e] - i * ntok, max=ntok), M - r)
    valid = w < count
    ent = torch.stack([torch.where(valid, e, 0), torch.where(valid, r, 0),
                       torch.where(valid, torch.clamp(n, min=0), 0)], 1)
    head = torch.cat([count, torch.full((1,), ntok, dtype=torch.int64,
                                        device=dev),
                      torch.full((1,), bound, dtype=torch.int64,
                                 device=dev)])
    return torch.cat([head[None], ent]).to(torch.int32)


def _check_operands(xs, packed, scales, zeros):
    """Shapes first (NotImplementedError on what K5 does not take, on any
    device), then device, types and contiguity (ValueError)."""
    M, K = xs.shape
    E, n_n, half, bn = packed.shape
    N = n_n * bn
    if half * 2 != K:
        raise ValueError(f"packed {tuple(packed.shape)} does not match K={K}")
    if scales.dim() != 3 or scales.shape[0] != E or scales.shape[2] != N \
            or K % scales.shape[1]:
        raise ValueError(f"scales must be f32 [{E}, K/G, {N}]")
    G = K // scales.shape[1]
    if bn % 64:
        raise NotImplementedError(f"moe_gmm needs BN % 64 == 0 (BN={bn})")
    gmm_plan(M, E, K, N, G)            # K5's reach
    if xs.device.type != "cuda":
        raise ValueError("CUDA kernel called with a non-CUDA tensor")
    for name, t, dt in (("xs", xs, torch.bfloat16), ("packed", packed,
                        torch.int8), ("scales", scales, torch.float32),
                        ("zeros", zeros, torch.float32)):
        if t is None:
            continue
        if t.device != xs.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {xs.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: TMA operands must start 16-byte "
                             f"aligned")
    if zeros is not None and zeros.shape != scales.shape:
        raise ValueError("zeros must be shaped like scales")
    return M, N, K, G, E, bn


def gmm_work_units(group_sizes: torch.Tensor, M: int,
                   ntok: Optional[int] = None) -> torch.Tensor:
    """K5's unit list of `M` expert-sorted rows at token tile `ntok`
    (default `gmm_ntok(M, E)`), int32 ``[bound + 1, 3]``
    (`gmm_units_plain`).  CPU tensors take the plain builder; on CUDA K5's
    prologue kernel builds it on the device, so nothing is read back.  One
    call serves every product of a layer that shares `group_sizes`."""
    E = group_sizes.shape[0]
    ntok = ntok or gmm_ntok(M, E)
    if group_sizes.device.type == "cpu":
        return gmm_units_plain(group_sizes, M, ntok)
    if group_sizes.device.type != "cuda":
        raise ValueError(f"unsupported device {group_sizes.device}")
    if group_sizes.dtype != torch.int32 or not group_sizes.is_contiguous():
        raise ValueError("group_sizes must be contiguous int32")
    bound = gmm_units_bound(M, E, ntok)
    units = torch.empty((bound + 1, 3), dtype=torch.int32,
                        device=group_sizes.device)
    err = cuda_build.load_library().tllm_moe_gmm_units(
        cuda_build.ptr(group_sizes), cuda_build.ptr(units), M, E, ntok,
        bound, cuda_build.stream_of(group_sizes))
    cuda_build.check(err, "moe_gmm_units")
    cuda_build.count_launch("moe_gmm_units")
    return units


def moe_gmm(xs: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
            units: torch.Tensor, zeros: Optional[torch.Tensor] = None,
            ntok: Optional[int] = None) -> torch.Tensor:
    """Launch K5 on CUDA operands: xs ``[M, K]`` bf16 sorted by expert,
    packed ``[E, n_n, K//2, BN]`` int8, scales (zeros) ``[E, K//G, N]`` f32,
    and the unit list of these M rows from `gmm_work_units` at the same
    token tile `ntok` (default `gmm_plan`'s).  Returns f32 ``[M, N]``;
    rows past ``sum(group_sizes)`` are left unwritten, as on the TPU."""
    M, N, K, G, E, bn = _check_operands(xs, packed, scales, zeros)
    plan = gmm_plan(M, E, K, N, G, cuda_build.num_sms(xs.device), ntok)
    if units.dtype != torch.int32 or units.device != xs.device \
            or units.shape != (plan["bound"] + 1, 3) \
            or not units.is_contiguous():
        raise ValueError(f"units {tuple(units.shape)} are not the list of "
                         f"M={M} rows over E={E} experts at token tile "
                         f"{plan['ntok']}")
    out = torch.empty((M, N), dtype=torch.float32, device=xs.device)
    if M == 0:
        return out
    lib = cuda_build.load_library()
    err = lib.tllm_moe_gmm(
        cuda_build.ptr(xs), cuda_build.ptr(packed), cuda_build.ptr(scales),
        cuda_build.ptr(zeros), cuda_build.ptr(units), cuda_build.ptr(out),
        M, N, K, G, E, bn, plan["ntok"], plan["n_ct"], plan["grid"],
        cuda_build.stream_of(xs))
    cuda_build.check(err, "moe_gmm")
    cuda_build.count_launch("moe_gmm")
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
    # any other device goes to the kernel's wrapper, which refuses a shape
    # K5 does not take (NotImplementedError) before a device that is not
    # CUDA (ValueError)
    return moe_gmm(xs.to(torch.bfloat16).contiguous(), packed, scales,
                   units, zeros)
