"""A whole W4A16 gated MLP in one launch:
``down(act(x @ gate + b_g) * (x @ up + b_u)) + b_down``.

Counterpart of `tensorrt_llm_tpu/ops/w4a16_fused.py`, whose Pallas kernel
(`_fused_mlp_kernel`) chains the three weight streams into one grid so the
TPU's weight pipeline never restarts.  Here `w4a16_fused_mlp` launches
kernel K14 (`csrc/w4a16_fused_mlp.cu`): one cooperative launch of thread
block clusters in two phases, gate and up split over K slices (``h``,
rounded once to bf16, into a workspace), then ``h @ down`` split over I
slices, the slices of an item merged in slice order inside its cluster,
one grid barrier between the phases and the down weights streamed across
it.  `fused_mlp_plan` picks the token tile, the column tile, the cluster
and each phase's slices.  CPU tensors take `w4a16_fused_mlp_plain`.

Layouts are the JAX op's: ``gu_packed`` tiled ``[2I/BN, K/2, BN]`` with the
gate columns first (``[gate | up]``, `GatedMLP`'s fused layout),
``gu_scales`` ``[K/G, 2I]``, ``down_packed`` ``[K/BNd, I/2, BNd]``,
``down_scales`` ``[I/G, K]``; scales and zeros are rounded to bf16 (the JAX
op streams them as bf16), biases are f32.  ``block_m`` and ``mixed`` (the
TPU's M block and native s4 MXU feed) are accepted without effect: K14's M
block is its token tile.

As in the JAX package, no layer calls this op: `GatedMLP` runs its two
linears.  `fused_mlp_supported` returns the real eligibility of K14's
shapes (the JAX version's condition ends in ``or True``).
"""

from __future__ import annotations

import ctypes
import itertools
import math
from typing import Callable, Optional

import torch

from tensorrt_llm_tpu_torch.ops import cuda_build
from tensorrt_llm_tpu_torch.ops.w4a16_gemm import (ACTIVATIONS, _ACT_CODE,
                                                   _check_sm90_ptrs)
from tensorrt_llm_tpu_torch.quantization.quantize import dequantize_w4_any
from tensorrt_llm_tpu_torch.utils import cdiv

_TILE = 64        # K14's column unit
_SMS = 132
# K14's launch shape (`csrc/w4a16_fused_mlp.cu`): 8-token tiles a block
# (M blocks of 8, 16 or 32 rows), 64-column tiles a warp per weight (CT =
# 64 or 128 columns), clusters of up to 16 blocks, a ring of eight 4 KB
# stages, at most 227 KB of shared memory a block
FUSED_NTT = (1, 2, 4)
FUSED_CTW = (1, 2)
FUSED_CLUSTERS = (1, 2, 4, 8, 16)
FUSED_RING = 8 * 4096
FUSED_MAX_SMEM = 232448
# The plan's cost model (`_plan_cost`), fitted to K14's times on the H100
# over every candidate at the served shapes (`chip_smoke.py`
# check_fused_mlp_plan): seconds a call takes besides its rounds, and per
# round of a phase; the weight rate the card's blocks share and the most
# one block streams; the weight of an x (h) byte staged from L2 against a
# weight byte; the mma.sync operations a block does a second
_FM_FIXED_S = 5.0e-6
_FM_ROUND_S = 1.0e-6
_FM_BW = 2.0e12
_FM_BLOCK_BW = 10e9
_FM_X_WEIGHT = 0.25
_FM_BLOCK_OPS = 1.5e12


def fused_mlp_supported(K: int, I: int, BN: int, BNd: int, group: int,
                        activation: Optional[str]) -> bool:
    """Whether K14 takes these shapes: 64-multiple tiles and widths, a
    scale group that is a multiple of 32 dividing K and I, a known
    activation."""
    return (activation in ACTIVATIONS
            and BN > 0 and BNd > 0 and BN % _TILE == 0 and BNd % _TILE == 0
            and K % _TILE == 0 and I % _TILE == 0
            and group > 0 and group % 32 == 0
            and K % group == 0 and I % group == 0)


def _bf16(t):
    return None if t is None else t.to(torch.bfloat16).contiguous()


def _f32(t):
    return None if t is None else t.to(torch.float32).contiguous()


def w4a16_fused_mlp_plain(x, gu_packed, gu_scales, down_packed, down_scales,
                          gu_zeros=None, down_zeros=None, gu_bias=None,
                          down_bias=None, activation="silu", out_dtype=None):
    """The kernel's arithmetic in plain PyTorch: f32 gate and up
    accumulators that are not rounded to bf16, ``h = act(g) * u`` rounded
    to bf16, then the down product with f32 accumulation.  (Unlike
    `GatedMLP.forward`, which rounds the gate_up output to bf16 first.)
    The dequantized weights ``(q - z) * s`` are exact in f32; K14 keeps the
    TPU kernel's scale placement (each group's f32 partial times its
    scale), so nothing of the weight is rounded to bf16 there either."""
    out_dtype = out_dtype or x.dtype
    lead, K = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, K).to(torch.bfloat16).to(torch.float32)
    w_gu = dequantize_w4_any(gu_packed, _bf16(gu_scales), _bf16(gu_zeros))
    gu = xf @ w_gu
    if gu_bias is not None:
        gu = gu + _f32(gu_bias)[None, :]
    I = gu.shape[1] // 2
    h = (ACTIVATIONS[activation](gu[:, :I]) * gu[:, I:]).to(torch.bfloat16)
    w_d = dequantize_w4_any(down_packed, _bf16(down_scales),
                            _bf16(down_zeros))
    out = h.to(torch.float32) @ w_d
    if down_bias is not None:
        out = out + _f32(down_bias)[None, :]
    return out.to(out_dtype).reshape(*lead, K)


# ------------------------------------------------------------------ plan ---
def fused_mlp_ntt(M: int) -> int:
    """8-token tiles of K14's M block that cover M rows in one block: 1 up
    to 8 rows, 2 up to 16, then 4 (M blocks of 32)."""
    return 1 if M <= 8 else (2 if M <= 16 else 4)


def fused_mlp_ntts(M: int) -> tuple:
    """The token tiles a plan may take for M rows: `fused_mlp_ntt`'s, and
    up to 64 rows also the smaller ones (more M blocks, each streaming the
    weights again, mostly from L2, at fewer registers and more blocks an
    SM)."""
    top = fused_mlp_ntt(M)
    return tuple(n for n in FUSED_NTT if n <= top and (n == top or M <= 64))


def _flush_group(G: int, K: int) -> int:
    """The rows a scale row covers in the kernel: G, but a per-channel
    scale (G = K) is read as one row (stride 0) for every 128 rows (64
    where 128 does not divide K), so that its K still splits into
    slices."""
    if G >= K:
        return 128 if K % 128 == 0 else 64
    return G


def fused_mlp_smem(ctw: int, ntt: int, K: int, I: int, GA: int, GB: int,
                   sa: int, sb: int, zeros: bool) -> int:
    """Shared memory bytes of one K14 block (`fm_layout` in the source):
    the ring, two side slots of x (h) rows, scale and zero rows, the x row
    sums, two partial buffers, the barriers and the alignment slack."""
    ngsa, ngsb = cdiv(K // GA, sa), cdiv(I // GB, sb)
    xp = max(ngsa * GA, ngsb * GB) + 16
    nsc, ngs = max(2 * ngsa, ngsb), max(ngsa, ngsb)
    ct, mt = 64 * ctw, 8 * ntt
    zs = mt * xp * 2 + nsc * ct * 2
    slot = ((zs + nsc * ct * 2) if zeros else zs) + 15 & ~15
    o = FUSED_RING + 2 * slot + ngs * mt * 4 + 15 & ~15
    o += 2 * (2 * mt * ct * 4) + (2 * 8 + 8) * 8 + 16
    return o + 1024


# clusters of C blocks the H100 (132 SMs) runs at once at one block an SM
# (`cudaOccupancyMaxActiveClusters`, read on the card for K14's instances)
_CLUSTERS_PER_BPS = {16: 7, 8: 15, 4: 31, 2: 66, 1: 132}


def fused_mlp_coresident_model(n_sms: int = _SMS) -> Callable:
    """A stand-in for the card's co-resident bound, which the CUDA path
    asks `cudaOccupancyMaxActiveClusters` for: the H100's clusters at one
    block an SM (scaled to `n_sms`), times the blocks an SM that shared
    memory and registers allow (three at the 8-token tile, two above)."""
    def bound(ctw, ntt, cluster, smem):
        bps = min(3 if ntt == 1 else 2, 233472 // (smem + 1024))
        return _CLUSTERS_PER_BPS[cluster] * bps * n_sms // _SMS
    return bound


def _plan(M, K, I, GA, GB, ntt, ctw, C, sa, sb, cap, smem):
    ct, mt = 64 * ctw, 8 * ntt
    n_mb = cdiv(M, mt)
    items_a, items_b = n_mb * (I // ct), n_mb * (K // ct)
    need = max(cdiv(items_a, C // sa), cdiv(items_b, C // sb))
    clusters = min(cap, need)
    nga, ngb = K // GA, I // GB
    return {"ntt": ntt, "mt": mt, "ctw": ctw, "ct": ct, "cluster": C,
            "sa": sa, "sb": sb, "clusters": clusters, "grid": clusters * C,
            "smem": smem, "GA": GA, "GB": GB, "n_mb": n_mb,
            "items_a": items_a, "items_b": items_b,
            "rounds_a": cdiv(items_a, clusters * (C // sa)),
            "rounds_b": cdiv(items_b, clusters * (C // sb)),
            "a_bounds": tuple(s * nga // sa * GA for s in range(sa + 1)),
            "b_bounds": tuple(s * ngb // sb * GB for s in range(sb + 1)),
            "key": (ntt, ctw, C, sa, sb)}


def fused_mlp_plan_choices(M: int, K: int, I: int, Ga: int, Gd: int,
                           n_sms: int = _SMS,
                           coresident: Optional[Callable] = None,
                           block_n: int = 1024, zeros: bool = False) -> list:
    """Every launch K14 can take for M rows: a token tile of
    `fused_mlp_ntts`; CT = 64 ctw columns dividing K, I and `block_n` (the
    gcd of the two weights' BN); a cluster of C blocks running SA (SB) K
    (I) slices of whole scale groups an item, SA and SB each C or C / 2
    and at most the groups they cut; shared memory within a block's 227
    KB; as many clusters as the work has, within
    ``coresident(ctw, ntt, C, smem)``, the clusters the card runs at once
    (default `fused_mlp_coresident_model`)."""
    coresident = coresident or fused_mlp_coresident_model(n_sms)
    GA, GB = _flush_group(Ga, K), _flush_group(Gd, I)
    nga, ngb = K // GA, I // GB
    out = []
    for ntt, ctw in itertools.product(fused_mlp_ntts(M), FUSED_CTW):
        ct = 64 * ctw
        if K % ct or I % ct or block_n % ct:
            continue
        for C in FUSED_CLUSTERS:
            splits = sorted({C, max(1, C // 2)})
            for sa in splits:
                for sb in splits:
                    if sa > nga or sb > ngb:
                        continue
                    smem = fused_mlp_smem(ctw, ntt, K, I, GA, GB, sa, sb,
                                          zeros)
                    if smem > FUSED_MAX_SMEM:
                        continue
                    cap = coresident(ctw, ntt, C, smem)
                    if cap < 1:
                        continue
                    out.append(_plan(M, K, I, GA, GB, ntt, ctw, C, sa, sb,
                                     cap, smem))
    return out


def _plan_cost(p: dict, M: int) -> float:
    """Modeled seconds of a K14 launch (`_FM_*`): every round of a phase
    streams one item's weight bytes, stages its x (h) rows and does its
    products at a block's share of the card's rate."""
    bw = min(_FM_BW / p["grid"], _FM_BLOCK_BW)
    t = _FM_FIXED_S
    for rounds, bounds, n_w in ((p["rounds_a"], p["a_bounds"], 2),
                                (p["rounds_b"], p["b_bounds"], 1)):
        klen = max(b - a for a, b in zip(bounds, bounds[1:]))
        wbytes = n_w * p["ct"] * klen / 2
        xbytes = min(M, p["mt"]) * klen * 2
        ops = 2 * p["mt"] * n_w * p["ct"] * klen
        t += rounds * (_FM_ROUND_S + (wbytes + _FM_X_WEIGHT * xbytes) / bw
                       + ops / _FM_BLOCK_OPS)
    return t


def fused_mlp_plan(M: int, K: int, I: int, Ga: int, Gd: int,
                   n_sms: int = _SMS, coresident: Optional[Callable] = None,
                   block_n: int = 1024, zeros: bool = False,
                   n_k2: Optional[int] = None) -> dict:
    """K14's launch for M rows: the `fused_mlp_plan_choices` candidate of
    least modeled time (`_plan_cost`), with SB = `n_k2` when given.
    `chip_smoke.py` times every candidate at the served shapes and fails
    if this one is more than 10% slower than the fastest.  Pure shape
    logic; the tests check it on the CPU."""
    pool = fused_mlp_plan_choices(M, K, I, Ga, Gd, n_sms, coresident,
                                  block_n, zeros)
    if n_k2 is not None:
        pool = [p for p in pool if p["sb"] == n_k2]
    if not pool:
        raise ValueError(f"K14 has no launch for M={M}, K={K}, I={I}, "
                         f"groups {Ga}/{Gd}, BN {block_n}, n_k2={n_k2}")
    return min(pool, key=lambda p: (_plan_cost(p, M), p["key"]))


def fused_mlp_units_plain(x, gu_packed, gu_scales, down_packed, down_scales,
                          gu_zeros=None, down_zeros=None, gu_bias=None,
                          down_bias=None, activation="silu", plan=None,
                          out_dtype=None):
    """K14's decomposition walked in plain PyTorch: each slice of the
    plan's phase A sums its scale groups' f32 partials, each times its
    group scale; the slices are summed in slice order; bias, act(g) * u,
    h rounded once to bf16; the same for phase B over the I slices, then
    the down bias and the output dtype.  (The columns and M blocks of the
    items are independent, so they are walked at once.)"""
    out_dtype = out_dtype or x.dtype
    lead, K = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, K).to(torch.bfloat16).to(torch.float32)
    M = xf.shape[0]
    I = gu_packed.shape[0] * gu_packed.shape[2] // 2
    Ga, Gd = K // gu_scales.shape[0], I // down_scales.shape[0]
    plan = plan or fused_mlp_plan(
        max(M, 1), K, I, Ga, Gd,
        zeros=gu_zeros is not None or down_zeros is not None)

    def phase(a, packed, scales, zeros, rows_k, G, Gf, bounds):
        ones = torch.ones_like(scales, dtype=torch.bfloat16)
        w = dequantize_w4_any(packed, ones, _bf16(zeros))   # q - z, exact
        s = _bf16(scales).to(torch.float32)
        per_channel = G >= rows_k
        acc = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float32)
        for k0, k1 in zip(bounds, bounds[1:]):
            part = torch.zeros_like(acc)
            for g0 in range(k0, k1, Gf):
                srow = 0 if per_channel else g0 // G
                part = part + (a[:, g0:g0 + Gf] @ w[g0:g0 + Gf]) * s[srow]
            acc = acc + part
        return acc

    gu = phase(xf, gu_packed, gu_scales, gu_zeros, K, Ga, plan["GA"],
               plan["a_bounds"])
    if gu_bias is not None:
        gu = gu + _f32(gu_bias)[None, :]
    h = (ACTIVATIONS[activation](gu[:, :I]) * gu[:, I:]).to(torch.bfloat16)
    out = phase(h.to(torch.float32), down_packed, down_scales, down_zeros, I,
                Gd, plan["GB"], plan["b_bounds"])
    if down_bias is not None:
        out = out + _f32(down_bias)[None, :]
    return out.to(out_dtype).reshape(*lead, K)


# ------------------------------------------------------------ the launch ---
_CLUSTERS = {}    # (device, ctw, ntt, cluster, smem) -> co-resident clusters
_PLANS = {}       # (device, shape, groups, BN, zeros, n_k2) -> plan


def _coresident(device) -> Callable:
    """`cudaOccupancyMaxActiveClusters` of a K14 instance, cached."""
    def bound(ctw, ntt, cluster, smem):
        key = (device, ctw, ntt, cluster, smem)
        if key not in _CLUSTERS:
            n = ctypes.c_int(0)
            err = cuda_build.load_library().tllm_w4a16_fused_mlp_clusters(
                ctw, ntt, cluster, smem, ctypes.byref(n))
            cuda_build.check(err, "w4a16_fused_mlp occupancy")
            _CLUSTERS[key] = n.value
        return _CLUSTERS[key]
    return bound


def fused_mlp_launch(x, gu_packed, gu_scales, down_packed, down_scales,
                     gu_zeros=None, down_zeros=None, gu_bias=None,
                     down_bias=None, activation="silu", n_k2=None,
                     barrier_stats=False, plan=None):
    """Launch K14 on CUDA operands (x [M, K] bf16 and the op's layouts,
    scales/zeros bf16, biases f32).  Shapes outside K14's reach raise
    NotImplementedError on any device, before the device check.  `plan`
    (one of `fused_mlp_plan_choices`) overrides `fused_mlp_plan`, `n_k2`
    its phase-B slices.  Returns (out [M, K] bf16, plan, stats): with
    `barrier_stats`, stats is int64 [grid, 8], each block's global timer
    (ns; 0 where the block had no item) at its start, its first x rows in
    shared memory, the end of its last phase-A stage, its arrival at the
    grid barrier, the barrier's release seen, its first h rows in shared
    memory, the end of its last phase-B stage, and its end."""
    M, K = x.shape
    n_gu, half_k, BN = gu_packed.shape
    I = n_gu * BN // 2
    n_d, half_i, BNd = down_packed.shape
    if half_k * 2 != K or half_i * 2 != I or n_d * BNd != K \
            or gu_scales.shape[1] != 2 * I or down_scales.shape[1] != K \
            or K % gu_scales.shape[0] or I % down_scales.shape[0] \
            or (gu_zeros is not None and gu_zeros.shape != gu_scales.shape) \
            or (down_zeros is not None
                and down_zeros.shape != down_scales.shape) \
            or (gu_bias is not None and gu_bias.shape != (2 * I,)) \
            or (down_bias is not None and down_bias.shape != (K,)):
        raise ValueError("fused MLP operand shapes do not match")
    Ga = K // gu_scales.shape[0]
    Gd = I // down_scales.shape[0]
    ok_a = Ga >= K or Ga % 32 == 0
    ok_d = Gd >= I or Gd % 32 == 0
    if not (ok_a and ok_d and BN % _TILE == 0 and BNd % _TILE == 0
            and K % _TILE == 0 and I % _TILE == 0
            and activation in ACTIVATIONS):
        raise NotImplementedError(
            f"w4a16_fused_mlp kernel does not take K={K}, I={I}, BN={BN}, "
            f"BNd={BNd}, groups {Ga}/{Gd}, activation {activation}")
    if x.device.type != "cuda":
        raise ValueError("CUDA kernel called with a non-CUDA tensor")
    for name, t, dt in (("x", x, torch.bfloat16),
                        ("gu_packed", gu_packed, torch.int8),
                        ("gu_scales", gu_scales, torch.bfloat16),
                        ("gu_zeros", gu_zeros, torch.bfloat16),
                        ("gu_bias", gu_bias, torch.float32),
                        ("down_packed", down_packed, torch.int8),
                        ("down_scales", down_scales, torch.bfloat16),
                        ("down_zeros", down_zeros, torch.bfloat16),
                        ("down_bias", down_bias, torch.float32)):
        if t is not None and (t.device != x.device or t.dtype != dt
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dt} on {x.device}")
    _check_sm90_ptrs(x, gu_packed, down_packed)
    dev = x.device
    out = torch.empty((M, K), dtype=torch.bfloat16, device=dev)
    if M == 0:
        return out, None, None
    zeros = gu_zeros is not None or down_zeros is not None
    lib = cuda_build.load_library()
    if plan is None:
        bn = math.gcd(BN, BNd)
        key = (dev, M, K, I, Ga, Gd, bn, zeros, n_k2)
        plan = _PLANS.get(key)
        if plan is None:
            plan = fused_mlp_plan(M, K, I, Ga, Gd, cuda_build.num_sms(dev),
                                  _coresident(dev), bn, zeros, n_k2)
            c_smem = lib.tllm_w4a16_fused_mlp_smem(
                plan["ctw"], plan["ntt"], K, I, plan["GA"], plan["GB"],
                plan["sa"], plan["sb"], int(zeros))
            if c_smem != plan["smem"]:
                raise RuntimeError(f"K14 layout mismatch: {c_smem} bytes in "
                                   f"the kernel, {plan['smem']} planned")
            _PLANS[key] = plan
    h = torch.empty((M, I), dtype=torch.bfloat16, device=dev)
    bar = cuda_build.grid_barrier(dev)
    grid = plan["grid"]
    stats = (torch.empty((grid, 8), dtype=torch.int64, device=dev)
             if barrier_stats else None)
    P = cuda_build.ptr
    err = lib.tllm_w4a16_fused_mlp(
        P(x), P(gu_packed), P(gu_scales), P(gu_zeros), P(gu_bias),
        P(down_packed), P(down_scales), P(down_zeros), P(down_bias), P(h),
        P(bar), P(stats), P(out), M, K, I, plan["GA"], plan["GB"],
        2 * I if Ga < K else 0, K if Gd < I else 0, BN, BNd,
        _ACT_CODE[activation], plan["ctw"], plan["ntt"], plan["cluster"],
        plan["sa"], plan["sb"], grid, cuda_build.stream_of(x))
    cuda_build.check(err, "w4a16_fused_mlp")
    cuda_build.count_launch("w4a16_fused_mlp")
    return out, plan, stats


def w4a16_fused_mlp(x, gu_packed, gu_scales, down_packed, down_scales,
                    gu_zeros=None, down_zeros=None, gu_bias=None,
                    down_bias=None, activation="silu", out_dtype=None,
                    block_m=None, n_k2=None, mixed=True):
    """One-launch gated MLP (see the module docstring).  CPU tensors take
    the plain version; other tensors launch K14 (or raise).  `n_k2` is the
    number of I slices of the down phase (default: `fused_mlp_plan`'s)."""
    del block_m, mixed                # no Hopper meaning (module docstring)
    out_dtype = out_dtype or x.dtype
    lead, K = x.shape[:-1], x.shape[-1]
    if x.device.type == "cpu":
        return w4a16_fused_mlp_plain(
            x, gu_packed, gu_scales, down_packed, down_scales, gu_zeros,
            down_zeros, gu_bias, down_bias, activation, out_dtype)
    out, _, _ = fused_mlp_launch(
        x.reshape(-1, K).to(torch.bfloat16).contiguous(), gu_packed,
        _bf16(gu_scales), down_packed, _bf16(down_scales), _bf16(gu_zeros),
        _bf16(down_zeros), _f32(gu_bias), _f32(down_bias), activation, n_k2)
    return out.to(out_dtype).reshape(*lead, K)
