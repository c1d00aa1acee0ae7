"""W4A16 GEMM: ``act(x @ ((q - z) * s) + b)`` with int4 weights.

Counterpart of `tensorrt_llm_tpu/ops/w4a16_gemm.py`:

* `w4a16_matmul_plain` is the plain PyTorch version (the JAX package's
  `w4a16_matmul_xla`): dequantize, bf16 product with f32 accumulation.  It
  is the plain version of every W4A16 kernel below; the CPU path runs it.
* Four kernels, one per TPU kernel of the JAX module:

  ======  ===========================  ==============================
  kernel  wrapper (CUDA source)        TPU kernel it replaces
  ======  ===========================  ==============================
  K1      `w4a16_gemm` (w4a16_gemm)    `_w4a16_kernel_tiled`
  K2      `w4a16_gemv` (w4a16_gemv)    `_w4a16_kernel_stream`
  K12     `w4a16_kpaired` (...kpaired) `_w4a16_kernel` (2-D K-paired)
  K13     `w4a16_ramp` (w4a16_ramp)    `_w4a16_kernel_ramp`
  ======  ===========================  ==============================

* `w4a16_matmul` dispatches as the JAX function does (`w4a16_plan`): a
  2-D K-paired weight runs K12; a tiled weight runs K2 under the
  ``"stream"`` tactic and K13 under ``"ramp"`` when the JAX single-M-block
  rule holds (for K2 also M <= `GEMV_MAX_M`, for the ramp K % 1024 == 0),
  else K1, the JAX package's tiled kernel.  With no tactic given and none
  tuned, the port's own default: K2 at M <= `GEMV_MAX_M` = 16 rows (a
  GEMV that streams the weight by TMA onto mma.sync, K slices merged
  inside its one launch; `gemv_plan`), K1 above.  The warmup's tuner
  times K1 against K2 and K13 at the decode batch.

Tactic arguments keep the JAX signature; on the card they mean:

* ``block_k``: for K12, the K rows of one work unit (K / block_k slices,
  each whole pack groups, summed by the combine pass); for K1, nothing
  more than "the tiled kernel" (K1's K slices are its plan's,
  `k1_plan`).
* ``block_m``: the M block of the single-M-block rule of ``"stream"`` and
  ``"ramp"`` (default ``min(256, round_up(M, 16))``); ``block_m=16`` sends
  only decode-sized calls to K2/K13 and larger ones to K1.  With a K12
  ``block_k`` it is the largest M the slice applies to (larger calls take
  `kpaired_block_k`); without it, every M.
* ``variant``: ``"stream"`` (K2) or ``"ramp"`` (K13); ``ramp_bk0`` and
  ``ramp_bk_big`` set K13's schedule (`ramp_schedule`), whose steps are
  its work units' K ranges (`ramp_bounds`).  For ``"stream"``
  ``ramp_bk0`` was the TPU's DMA slab and has no meaning for K2.
* ``block_n``, ``lookahead`` and ``mixed`` (the TPU's DMA depth and native
  s4 MXU feed) have no Hopper meaning: accepted, without effect, so that a
  JAX tactic file loads unchanged.

K1, K12 and K13 share one Hopper mainloop (`csrc/w4a16_sm90.cuh`: TMA
ring, wgmma on the register-dequantized weight); `sm90_tiles`,
`sm90_check` and `sm90_plan` (K12, K13) and `k1_plan` / `k1_choice` (K1)
are its pure shape logic (token tile, column tile, work units, grid),
which the CPU tests check.

Scales and zeros are rounded to bf16 on every path, as in the JAX package
(its `w4a16_matmul_xla` and the Pallas kernels store half-precision scales).
Both packings reach the kernels as they are stored: no per-call repack.

W4A8 (the JAX package's `w4a8_matmul`, same module): activations are
quantized per token to int8 (`quantize_act_int8`, plain torch ops on every
device, as the JAX package leaves it to XLA), then
``act(s_act * (xq @ deq(q, s, z)) + b)``.  `w4a8_matmul_plain` is the JAX
XLA fallback's math; `w4a8_gemm` wraps kernel K8 (`csrc/w4a8_gemm.cu`,
the s8 instantiation of the Hopper mainloop: exact int8 x int4 products
per scale group on wgmma, tokens as N, K slices summed by the combine
pass), which reads both packings as stored: the tiled one and the 2-D
K-paired one that the JAX package sends to XLA (`w4a8_plan`, which also
plans the launch: token tile, column tile, K slices from a cost model).
W4A8 scales and zeros stay f32 on every path: the JAX package never rounds
them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tensorrt_llm_tpu_torch.ops import cuda_build
from tensorrt_llm_tpu_torch.quantization.quantize import (
    dequantize_w4_any, pack_group_for)
from tensorrt_llm_tpu_torch.utils import cdiv, div_scalar, round_up

GEMV_MAX_M = 16
STREAM_MAX_BM = 256  # the JAX single-M-block rule's largest M block
_SMS = 132          # H100 SXM streaming multiprocessors
# K2 (`gemv_plan`): a block owns 64 * ctw columns (ctw 1, 2 or 4) and one
# K slice of whole scale groups, with x's slice staged in shared memory; the
# slices of a column tile are one thread block cluster of 1 to 16 blocks
GEMV_CTW = (1, 2, 4)
GEMV_SLICES = (1, 2, 4, 8, 16)
_GEMV_X_BYTES = 48 << 10     # x [8 or 16 rows, slice] bf16 in shared memory
# `gemv_plan`'s cost model of a (column tile, K slices) choice, fitted to
# K2's times on the H100 over every slice count at 17 column-tile counts
# of K 4096 and 15 shapes of K 2048, 11008 and 14336, M 1-16
# (`chip_smoke.py gemv_sweep`): a block streams its slice of the weight at
# about _GEMV_BLOCK_BPUS bytes a microsecond after _GEMV_BLOCK_US of
# latency, so a block's time is set by its bytes, not the card's rate; the
# blocks run in waves of (SMs x the blocks an SM holds x _GEMV_WAVE_FILL),
# an SM holding as many as its shared memory and its registers take (ptxas:
# 71 registers a thread at 8 token rows, 127 at 16; 160 threads a block);
# each slice of a cluster adds _GEMV_SLICE_US (the partials' sum)
_GEMV_BLOCK_BPUS = 5000.0
_GEMV_BLOCK_US = 10.0
_GEMV_SLICE_US = 0.4
_GEMV_WAVE_FILL = 0.9
_GEMV_REG_BLOCKS = {8: 5, 16: 3}    # blocks an SM's registers hold, by rows
_SM_SMEM = 233472                   # shared memory of an H100 SM, bytes
RAMP_SLAB = 1024    # K rows per ramp slab (512 packed rows)
RAMP_MAX_STEP = 4   # slabs a K13 schedule step may have
RAMP_MAX_STEPS = 64  # steps a K13 schedule may have
# the Hopper mainloop of K12 and K13 (`csrc/w4a16_sm90.cuh`)
SM90_STAGE_K = 64            # K rows per ring stage
SM90_NTOK = (8, 16, 32, 64, 128)   # token tiles (wgmma N)
SM90_M_BLOCK = 128           # tokens per M block (the largest tile)
SM90_MAX_SLICES = 128        # K slices a call may have
# `kpaired_block_k`'s cost model: a ring stage takes about 0.37 us of one
# block of 64 columns (at most 64 tokens) and 0.45 us of one of 128
# columns, 128 tokens (H100, `chip_smoke.py` phase-3 shapes); the f32
# partials move at about twice HBM's 3.35 TB/s, as most stay in the L2
_SM90_STAGE_S = {1: 0.37e-6, 2: 0.45e-6}
_PARTIAL_BPS = 2 * 3.35e12
# K1 (`k1_plan`): its configurations at 128 tokens, by the index the C
# entry takes (`K1_PRE` in csrc/w4a16_sm90.cuh): the K13 mainloop; x as
# one 64-K box (128-byte swizzle); plus a producer warpgroup that hands
# registers to two accumulator chains; the same with three consumer
# warpgroups (192 columns a block).  `chip_smoke.py` times each at served
# M 256 shapes.
K1_VARIANTS = ("mainloop", "x128", "x128_regs", "x128_regs_wg3")
K1_PATH_VARIANTS = (2, 3)    # the two `k1_plan` chooses between
K1_MAX_SLICES = 32
# K1's cost model (`k1_choice`), fitted to its times on the H100 over every
# slice count at the served shapes (phase 3), by consumer warpgroups (one:
# up to 64 tokens; two or three: 128): seconds per stage of a unit, per
# round of units over the block slots, per byte of f32 partials written
# and read, and per combine pass
_K1_COST = {1: (0.41e-6, 0.0, 0.76e-12, 2.3e-6),
            2: (0.434e-6, 1.823e-6, 0.195e-12, 3.27e-6),
            3: (0.562e-6, 3.824e-6, 0.142e-12, 2.301e-6)}
# K8 (`w4a8_plan`) runs the mainloop's tiles of K1's "x128_regs"
# configuration (a producer warpgroup and two consumer warpgroups at 128
# tokens, one below), and its K slices come from K1's cost model at that
# configuration: `chip_smoke.py` holds the pick within 10% of the fastest
K8_K1_VARIANT = K1_VARIANTS.index("x128_regs")

ACTIVATIONS = {
    None: lambda v: v,
    "silu": F.silu,
    "gelu": lambda v: F.gelu(v, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda v: torch.square(F.relu(v)),
}
_ACT_CODE = {None: 0, "silu": 1, "gelu": 2, "relu": 3, "relu2": 4}


def w4a16_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                       scales: torch.Tensor,
                       zeros: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None,
                       activation: Optional[str] = None,
                       out_dtype=None) -> torch.Tensor:
    """Plain version: dequantize to bf16, multiply with f32 accumulation."""
    out_dtype = out_dtype or x.dtype
    s = scales.to(torch.bfloat16)
    z = zeros.to(torch.bfloat16) if zeros is not None else None
    w = dequantize_w4_any(packed, s, z).to(torch.bfloat16)
    out = x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :]
    return ACTIVATIONS[activation](out).to(out_dtype)


# ------------------------------------------------------------ tactics ---
def _pick_block_k(K: int, G: int, max_block_k: int = 4096) -> int:
    """Largest multiple of G that divides K, capped at max_block_k (the
    JAX package's rule, kept so tactic candidates match)."""
    if G >= K:
        for bk in (512, 256, 128, 64, 32, 16, 8):
            if K % bk == 0 and bk <= max(K, 8):
                return min(bk, K)
        return K
    best = G
    for mult in range(max_block_k // G, 0, -1):
        if K % (mult * G) == 0:
            best = mult * G
            break
    return best


@functools.lru_cache(maxsize=4096)
def ramp_schedule(K: int, bk0: int = RAMP_SLAB,
                  bk_big: int = 4 * RAMP_SLAB) -> tuple:
    """Slabs per K13 step: the first step `bk0` rows (one slab by
    default: the only cold copy), then steps of `bk_big` rows."""
    n_slabs = K // RAMP_SLAB
    sched = [min(max(1, bk0 // RAMP_SLAB), n_slabs)]
    rest = n_slabs - sched[0]
    big = max(1, bk_big // RAMP_SLAB)
    while rest > 0:
        take = min(big, rest)
        sched.append(take)
        rest -= take
    return tuple(sched)


def _ramp_able(K: int, Gp: int) -> bool:
    return K % RAMP_SLAB == 0 and RAMP_SLAB % Gp == 0


def w4a16_tactic_candidates(K: int, N: int, tiled: bool,
                            group: int = 128) -> list:
    """Candidate tactics for a W4A16 weight shape, timed by the engine's
    warmup (`ModelEngine.autotune_kernels`) at its decode batch (at most
    `GEMV_MAX_M` rows).  Every candidate carries ``block_m`` 16, so a
    tactic decides only calls of up to 16 rows, the M range it was timed
    in; prefill-sized calls keep the untuned default.

    Tiled weights: K2 (``"stream"``), the tiled kernel K1 (the JAX
    package's ``block_k`` tactic) and, where K % 1024 == 0, the ramp K13.
    K-paired weights: K12's split-K slice, the JAX package's two
    ``block_k`` values, the whole K, and smaller slices down to 128 rows
    (more blocks for the narrow N of a kv_a projection)."""
    n_groups = max(1, K // group)
    Gp = pack_group_for(K, n_groups)
    G = max(group, 128)
    bk_max = _pick_block_k(K, G)
    if tiled:
        cands = [{"variant": "stream", "block_m": GEMV_MAX_M},
                 {"block_k": bk_max, "block_m": GEMV_MAX_M}]
        if _ramp_able(K, Gp):
            cands.append({"variant": "ramp", "block_m": GEMV_MAX_M})
        return cands
    jax_bks = {bk for bk in {bk_max, max(bk_max // 2, G)} if K % bk == 0}
    bks = jax_bks | {K} | {bk_max >> i for i in range(1, 5)}
    return [{"block_k": bk, "block_m": GEMV_MAX_M}
            for bk in sorted(bks, reverse=True)
            if K % bk == 0 and bk % Gp == 0 and bk >= min(128, K)]


def sm90_tiles(M: int) -> Tuple[int, int]:
    """(token tile, consumer warpgroups) of the Hopper mainloop for M rows:
    the smallest wgmma N that holds min(M, 128) tokens (larger calls run
    M blocks of 128); 128 columns (two warpgroups sharing each x stage) at
    128 tokens, 64 below."""
    ntok = next(t for t in SM90_NTOK if t >= min(M, SM90_M_BLOCK))
    return ntok, (2 if ntok >= 128 else 1)


def sm90_check(K: int, N: int, G: int, kpaired: bool, Gp: int = 0,
               bn: int = 0) -> None:
    """Raise NotImplementedError on a shape the mainloop does not take:
    it needs N % 16 == 0, K % 64 == 0, G 32, a multiple of 64 or one group,
    and a K-paired pack group of 32 or a multiple of 64 dividing K, or a
    tiled BN % 64 dividing N."""
    if N % 16 or K % SM90_STAGE_K or N <= 0:
        raise NotImplementedError(
            f"W4A16 sm90 kernels need N % 16 == 0 and K % 64 == 0 "
            f"(N={N}, K={K})")
    if G < K and G % SM90_STAGE_K and G != 32:
        raise NotImplementedError(
            f"W4A16 sm90 kernels need G 32, G % 64 == 0 or one group "
            f"(G={G})")
    if kpaired and ((Gp % SM90_STAGE_K and Gp != 32) or K % Gp):
        raise NotImplementedError(
            f"w4a16_kpaired needs a pack group of 32 or a multiple of 64 "
            f"dividing K (K={K}, pack group={Gp})")
    if not kpaired and (bn % 64 or N % bn):
        raise NotImplementedError(
            f"w4a16_ramp needs BN % 64 == 0 dividing N (BN={bn}, N={N})")


@functools.lru_cache(maxsize=4096)
def sm90_plan(M: int, K: int, N: int, bounds: tuple,
              n_sms: int = _SMS) -> dict:
    """The launch of the Hopper mainloop: token tile, column tile, M blocks,
    work units and persistent grid.  `bounds` are the K rows where the
    slices start and end (0, ..., K), each a multiple of 64.  A unit is
    (M block, column tile, slice); the grid is one block per unit up to
    the blocks the SMs hold (three of 64 columns up to 32 tokens, two at
    64, one of 128 columns at 128).  Pure shape logic; the tests check it
    on the CPU."""
    if bounds[0] != 0 or bounds[-1] != K or any(
            b <= a or b % SM90_STAGE_K for a, b in zip(bounds, bounds[1:])):
        raise ValueError(f"slices {bounds} must cut K={K} at multiples of "
                         f"{SM90_STAGE_K}")
    n_sl = len(bounds) - 1
    if n_sl > SM90_MAX_SLICES:
        raise ValueError(f"{n_sl} K slices: at most {SM90_MAX_SLICES}")
    ntok, nwg = sm90_tiles(M)
    cols = 64 * nwg
    n_mb = cdiv(M, ntok)
    n_ct = cdiv(N, cols)
    units = n_mb * n_ct * n_sl
    per_sm = 1 if nwg == 2 else (3 if ntok <= 32 else 2)
    return {"ntok": ntok, "nwg": nwg, "cols": cols, "n_mb": n_mb,
            "n_ct": n_ct, "slices": n_sl, "units": units,
            "grid": min(units, per_sm * n_sms),
            "stage_start": tuple(b // SM90_STAGE_K for b in bounds)}


def k1_tiles(M: int, variant: int) -> Tuple[int, int]:
    """(token tile, consumer warpgroups) of K1 for M rows: the mainloop's
    tiles (`sm90_tiles`), with three warpgroups at 128 tokens in the WG3
    configuration."""
    ntok, nwg = sm90_tiles(M)
    if ntok == SM90_M_BLOCK and "wg3" in K1_VARIANTS[variant]:
        nwg = 3
    return ntok, nwg


def k1_slice_choices(K: int) -> tuple:
    """The K slice counts K1 can take: 1 to `K1_MAX_SLICES`, at most one per
    64-row stage (ceil(K / 64) stages; a K % 64 == 32 tail is half a
    stage)."""
    return tuple(range(1, min(cdiv(K, SM90_STAGE_K), K1_MAX_SLICES) + 1))


def _k1_units(M: int, K: int, N: int, n_sl: int, n_sms: int,
              variant: int) -> dict:
    ntok, nwg = k1_tiles(M, variant)
    n_st = cdiv(K, SM90_STAGE_K)
    n_mb, n_ct = cdiv(M, ntok), cdiv(N, 64 * nwg)
    per_sm = 1 if nwg >= 2 else (3 if ntok <= 32 else 2)
    units = n_mb * n_ct * n_sl
    return {"ntok": ntok, "nwg": nwg, "cols": 64 * nwg, "n_mb": n_mb,
            "n_ct": n_ct, "stages": n_st, "slices": n_sl, "units": units,
            "slots": per_sm * n_sms, "grid": min(units, per_sm * n_sms),
            "stage_start": tuple(i * n_st // n_sl for i in range(n_sl + 1))}


def k1_model_s(M: int, K: int, N: int, slices: int, variant: int,
               n_sms: int = _SMS) -> float:
    """K1's modeled time (`_K1_COST`): rounds of units over the SMs' block
    slots, each the stages of the longest slice, plus the f32 partials and
    the combine pass that more than one slice adds."""
    u = _k1_units(M, K, N, slices, n_sms, variant)
    stage_s, round_s, byte_s, comb_s = _K1_COST[u["nwg"]]
    rounds = cdiv(u["units"], u["slots"])
    t = rounds * (cdiv(u["stages"], slices) * stage_s + round_s)
    if slices > 1:
        t += 2 * slices * M * N * 4 * byte_s + comb_s
    return t


@functools.lru_cache(maxsize=4096)
def k1_choice(M: int, K: int, N: int, n_sms: int = _SMS,
              variant: Optional[int] = None) -> Tuple[int, int]:
    """(configuration, K slice count) of K1 with the least modeled time
    (`k1_model_s`) over `K1_PATH_VARIANTS` (or `variant`) and
    `k1_slice_choices`: a unit takes the whole K where (M blocks x column
    tiles) fill the slots in whole rounds, and K is cut where they would
    leave SMs idle.  `chip_smoke.py` times every choice at the served
    shapes and fails if this one is more than ``K1_SLICE_SLACK`` slower
    than the fastest."""
    variants = K1_PATH_VARIANTS if variant is None else (variant,)
    if sm90_tiles(M)[0] < SM90_M_BLOCK:
        variants = variants[:1]      # one configuration below 128 tokens
    best, best_t = None, None
    for v in variants:
        for d in k1_slice_choices(K):
            t = k1_model_s(M, K, N, d, v, n_sms)
            if best_t is None or t < best_t * (1 - 1e-9):
                best, best_t = (v, d), t
    return best


@functools.lru_cache(maxsize=4096)
def k1_plan(M: int, K: int, N: int, n_sms: int = _SMS,
            variant: Optional[int] = None,
            slices: Optional[int] = None) -> dict:
    """K1's launch (`csrc/w4a16_gemm.cu`): M blocks of up to 128 tokens
    (the smallest wgmma N that holds M below), 128 or 192 columns a block
    at 128 tokens (64 below), and K slices of ceil(K / 64) stages, uneven
    by at most one stage, in K order; a unit is (M block, column tile,
    slice), and the persistent grid is one block per unit up to the slots.
    The configuration and slice count are `k1_choice`'s unless given.
    Pure shape logic; the tests check it on the CPU."""
    if variant is not None and not 0 <= variant < len(K1_VARIANTS):
        raise ValueError(f"K1 variant {variant} not in "
                         f"0..{len(K1_VARIANTS) - 1}")
    v, d = k1_choice(M, K, N, n_sms, variant)
    d = slices or d
    if not 1 <= d <= min(cdiv(K, SM90_STAGE_K), K1_MAX_SLICES):
        raise ValueError(f"K1 takes 1..{K1_MAX_SLICES} slices of whole "
                         f"64-row stages (K={K}, slices={d})")
    return dict(_k1_units(M, K, N, d, n_sms, v), variant=v)


@functools.lru_cache(maxsize=4096)
def _c_ints(values: tuple):
    """A ctypes int array of `values`, built once (the C side only reads
    it)."""
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=4096)
def kpaired_slice_choices(K: int, Gp: int) -> tuple:
    """The K slices K12 can take, largest first: K cut into equal slices of
    whole pack groups and stages, at least 128 rows (or the whole K), at
    most `SM90_MAX_SLICES` of them."""
    chunk = max(Gp, SM90_STAGE_K)
    return tuple(K // d for d in range(1, K // chunk + 1)
                 if K % d == 0 and (K // d) % chunk == 0
                 and (K // d >= 128 or d == 1) and d <= SM90_MAX_SLICES)


@functools.lru_cache(maxsize=4096)
def kpaired_block_k(M: int, K: int, N: int, Gp: int) -> int:
    """K12's default K slice (`kpaired_slice_choices`): the one with the
    least modeled time.  The units run in rounds over the blocks the SMs
    hold (`sm90_plan`), each taking its stages one after the other
    (`_SM90_STAGE_S`), and more than one slice adds the f32 partials the
    combine pass writes and reads.  `chip_smoke.py` times every choice at
    the served shapes and fails if this one is not within
    ``KPAIRED_BK_SLACK`` of the fastest."""
    nwg = sm90_tiles(M)[1]
    best, best_t = K, None
    for bk in kpaired_slice_choices(K, Gp):
        d = K // bk
        plan = sm90_plan(M, K, N, tuple(range(0, K + 1, bk)))
        rounds = cdiv(plan["units"], plan["grid"])
        t = rounds * (bk // SM90_STAGE_K) * _SM90_STAGE_S[nwg]
        if d > 1:
            t += 2 * d * M * N * 4 / _PARTIAL_BPS
        if best_t is None or t < best_t * (1 - 1e-9):
            best, best_t = bk, t
    return best


@functools.lru_cache(maxsize=4096)
def w4a16_plan(M: int, K: int, N: int, n_groups: int, tiled: bool,
               block_k: Optional[int] = None,
               block_m: Optional[int] = None,
               variant: Optional[str] = None,
               ramp_bk0: Optional[int] = None,
               ramp_bk_big: Optional[int] = None) -> Tuple[str, dict]:
    """The kernel a CUDA call runs and its parameters, as (launch-count
    name, params): the JAX package's dispatch (`w4a16_matmul`) mapped onto
    the port's kernels.  Pure shape logic; the tests check it on the CPU."""
    Gp = pack_group_for(K, n_groups)
    if not tiled:
        if block_k is None or (block_m is not None and M > block_m):
            block_k = kpaired_block_k(M, K, N, Gp)
        return "w4a16_kpaired", {"block_k": block_k}
    bm = block_m or min(STREAM_MAX_BM, max(16, round_up(M, 16)))
    single = round_up(M, bm) == bm and bm * K * 2 <= (8 << 20)
    if variant == "stream" and single and M <= GEMV_MAX_M:
        return "w4a16_gemv", {}
    if variant == "ramp" and single and _ramp_able(K, Gp):
        return "w4a16_ramp", {"schedule": ramp_schedule(
            K, ramp_bk0 or RAMP_SLAB, ramp_bk_big or 4 * RAMP_SLAB)}
    if variant is None and block_k is None and block_m is None:
        return ("w4a16_gemv" if M <= GEMV_MAX_M else "w4a16_gemm"), {}
    return "w4a16_gemm", {}


# ------------------------------------------------------------ kernels ---
def _check_common(x, packed, scales, zeros, bias, N, K):
    if x.device.type != "cuda":
        raise ValueError("CUDA kernel called with a non-CUDA tensor")
    for name, t in (("packed", packed), ("scales", scales), ("zeros", zeros),
                    ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("x must be contiguous bf16")
    if packed.dtype != torch.int8:
        raise ValueError("packed must be int8")
    if scales.dtype != torch.bfloat16 or scales.shape[1] != N \
            or K % scales.shape[0]:
        raise ValueError(f"scales must be bf16 [K/G, {N}]")
    if zeros is not None and (zeros.dtype != torch.bfloat16
                              or zeros.shape != scales.shape):
        raise ValueError("zeros must be bf16 shaped like scales")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (N,)):
        raise ValueError(f"bias must be f32 [{N}]")
    return K // scales.shape[0]


def tiled_check(K: int, G: int, bn: int) -> None:
    """Raise NotImplementedError on a tiled weight shape the kernels K1, K2
    and K13 do not take: they need BN % 64 == 0, K % 32 == 0 and G % 32 ==
    0 (K1 runs a K % 64 == 32 tail as half a stage, and two scale rows a
    stage where G % 64 != 0)."""
    if bn % 64 or K % 32 or G % 32:
        raise NotImplementedError(
            f"W4A16 kernels need BN % 64 == 0, K % 32 == 0 and G % 32 == 0 "
            f"(BN={bn}, K={K}, G={G})")


def _check_operands(x, packed3, scales, zeros, bias):
    M, K = x.shape
    n_n, half, bn = packed3.shape
    N = n_n * bn
    if half * 2 != K:
        raise ValueError(f"packed {tuple(packed3.shape)} does not match K={K}")
    G = _check_common(x, packed3, scales, zeros, bias, N, K)
    tiled_check(K, G, bn)
    return M, N, K, G, bn


def w4a16_gemm(x: torch.Tensor, packed3: torch.Tensor, scales: torch.Tensor,
               zeros: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None,
               slices: Optional[int] = None,
               variant: Optional[int] = None) -> torch.Tensor:
    """Launch K1 on CUDA operands: x [M, K] bf16, packed3 [N/BN, K/2, BN]
    int8, scales (zeros) [K/G, N] bf16, bias [N] f32; any M, K % 32 == 0,
    G % 32 == 0.  `slices` and `variant` override `k1_plan`'s K slices and
    configuration (`K1_VARIANTS`).  Returns [M, N] bf16."""
    M, N, K, G, bn = _check_operands(x, packed3, scales, zeros, bias)
    _check_sm90_ptrs(x, packed3)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    plan = k1_plan(M, K, N, cuda_build.num_sms(x.device), variant, slices)
    n_sl = plan["slices"]
    ws = (torch.empty((n_sl, M, N), dtype=torch.float32, device=x.device)
          if n_sl > 1 else None)
    lib = cuda_build.load_library()
    err = lib.tllm_w4a16_gemm(
        cuda_build.ptr(x), cuda_build.ptr(packed3), cuda_build.ptr(scales),
        cuda_build.ptr(zeros), cuda_build.ptr(bias), cuda_build.ptr(ws),
        cuda_build.ptr(out), M, N, K, G, bn, _ACT_CODE[activation],
        plan["ntok"], plan["n_mb"], plan["n_ct"],
        _c_ints(plan["stage_start"]), n_sl, plan["grid"], plan["variant"],
        cuda_build.stream_of(x))
    cuda_build.check(err, "w4a16_gemm")
    cuda_build.count_launch("w4a16_gemm")
    return out


def gemv_choices(M: int, K: int, G: int, bn: int) -> tuple:
    """The (ctw, K slices) K2 can take for M rows: 64 * ctw columns a block
    dividing BN, and `GEMV_SLICES` slices (a cluster) of whole scale groups
    (uneven by at most one group), at most one a group, each slice's x (8
    or 16 rows) within `_GEMV_X_BYTES` of shared memory."""
    ng = K // G
    mt = 8 if M <= 8 else 16
    return tuple((ctw, d) for ctw in GEMV_CTW if bn % (64 * ctw) == 0
                 for d in GEMV_SLICES
                 if d <= ng and mt * (cdiv(ng, d) * G + 8) * 2 <= _GEMV_X_BYTES)


def _gemv_smem(ctw: int, mt: int, ksm: int, ngs: int) -> int:
    """K2's shared memory a block (`gv_layout` in csrc/w4a16_gemv.cu): the
    32 KB ring, x [mt, ksm + 8] bf16, scale and zero rows, x's row sums,
    the barriers, 1 KB of alignment slack."""
    o = 32768 + mt * (ksm + 8) * 2 + 2 * ngs * 64 * ctw * 2 + ngs * mt * 4
    return ((o + 15) & ~15) + 2 * 8 * 8 + 16 + 1024


def gemv_cost_us(M: int, K: int, N: int, G: int, ctw: int, slices: int,
                 n_sms: int = _SMS) -> float:
    """`gemv_plan`'s model of K2's time (microseconds) for one choice:
    waves x a block's streaming time, plus the slices' sum."""
    ngs = cdiv(K // G, slices)
    ksm = ngs * G
    mt = 8 if M <= 8 else 16
    per_sm = min(_SM_SMEM // (_gemv_smem(ctw, mt, ksm, ngs) + 1024),
                 _GEMV_REG_BLOCKS[mt])
    wave = max(1, int(n_sms * max(per_sm, 1) * _GEMV_WAVE_FILL))
    waves = cdiv(N // (64 * ctw) * slices, wave)
    return (waves * (_GEMV_BLOCK_US + ksm * 32 * ctw / _GEMV_BLOCK_BPUS)
            + _GEMV_SLICE_US * slices)


@functools.lru_cache(maxsize=4096)
def gemv_plan(M: int, K: int, N: int, G: int, bn: int, n_sms: int = _SMS,
              ctw: Optional[int] = None,
              slices: Optional[int] = None) -> dict:
    """K2's launch (`csrc/w4a16_gemv.cu`): unless given, the widest column
    tile of `gemv_choices` and, of its slice counts, the one
    `gemv_cost_us` puts least (the fewer slices at a tie); grid
    (N / (64 ctw), slices), the slices one cluster.  `chip_smoke.py` times
    every choice at the served shapes and fails if this one is more than
    ``GEMV_PLAN_SLACK`` slower than the fastest.  Pure shape logic; the
    tests check it on the CPU."""
    tiled_check(K, G, bn)
    if not 1 <= M <= GEMV_MAX_M:
        raise ValueError(f"w4a16_gemv takes 1..{GEMV_MAX_M} rows, got {M}")
    choices = gemv_choices(M, K, G, bn)
    pool = [c for c in choices if (ctw is None or c[0] == ctw)
            and (slices is None or c[1] == slices)]
    if not pool:
        raise ValueError(f"K2 does not take ctw={ctw}, slices={slices} for "
                         f"M={M}, K={K}, G={G}, BN={bn}")
    c_best = max(c[0] for c in pool)
    ctw, slices = min((c for c in pool if c[0] == c_best), key=lambda c: (
        gemv_cost_us(M, K, N, G, c[0], c[1], n_sms), c[1]))
    return {"ctw": ctw, "cols": 64 * ctw, "slices": slices,
            "grid": (N // (64 * ctw), slices)}


def w4a16_gemv(x: torch.Tensor, packed3: torch.Tensor, scales: torch.Tensor,
               zeros: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None,
               ctw: Optional[int] = None,
               slices: Optional[int] = None) -> torch.Tensor:
    """Launch K2 on CUDA operands; same contract as `w4a16_gemm`, for M
    up to `GEMV_MAX_M` rows.  `ctw` and `slices` override `gemv_plan`'s
    column tile and K slice count.  One launch: the K slices of a column
    tile are a thread block cluster that sums their partials in K order."""
    K, rows = x.shape[-1], scales.shape[0]
    if rows and K % rows == 0:
        tiled_check(K, K // rows, packed3.shape[-1])   # K2's reach, any device
    M, N, K, G, bn = _check_operands(x, packed3, scales, zeros, bias)
    if M > GEMV_MAX_M:
        raise ValueError(f"w4a16_gemv takes M <= {GEMV_MAX_M}, got {M}")
    _check_sm90_ptrs(x, packed3)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    plan = gemv_plan(M, K, N, G, bn, cuda_build.num_sms(x.device), ctw,
                     slices)
    lib = cuda_build.load_library()
    err = lib.tllm_w4a16_gemv(
        cuda_build.ptr(x), cuda_build.ptr(packed3), cuda_build.ptr(scales),
        cuda_build.ptr(zeros), cuda_build.ptr(bias), cuda_build.ptr(out), M,
        N, K, G, bn, _ACT_CODE[activation], plan["ctw"], plan["slices"],
        cuda_build.stream_of(x))
    cuda_build.check(err, "w4a16_gemv")
    cuda_build.count_launch("w4a16_gemv")
    return out


def _check_sm90_ptrs(*ts):
    for t in ts:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("TMA operands must start 16-byte aligned")


def w4a16_kpaired(x: torch.Tensor, packed2: torch.Tensor,
                  scales: torch.Tensor, zeros: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  activation: Optional[str] = None,
                  block_k: Optional[int] = None) -> torch.Tensor:
    """Launch K12 on CUDA operands: x [M, K] bf16, packed2 [K/2, N] int8
    (K-paired, `pack_w4` with the pack group of `pack_group_for`), scales
    (zeros) [K/G, N] bf16, bias [N] f32.  `block_k` is the K slice of one
    work unit (default `kpaired_block_k`); K / block_k slices are summed by
    the combine pass.  Returns [M, N] bf16."""
    M, K = x.shape
    half, N = packed2.shape
    if half * 2 != K:
        raise ValueError(f"packed {tuple(packed2.shape)} does not match K={K}")
    G = _check_common(x, packed2, scales, zeros, bias, N, K)
    Gp = pack_group_for(K, scales.shape[0])
    sm90_check(K, N, G, True, Gp=Gp)
    bk = block_k or kpaired_block_k(M, K, N, Gp)
    if bk % Gp or K % bk:
        raise ValueError(f"block_k={bk} must be a multiple of the pack "
                         f"group {Gp} that divides K={K}")
    _check_sm90_ptrs(x, packed2)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    plan = sm90_plan(M, K, N, tuple(range(0, K + 1, bk)),
                     cuda_build.num_sms(x.device))
    n_sl = plan["slices"]
    ws = (torch.empty((n_sl, M, N), dtype=torch.float32, device=x.device)
          if n_sl > 1 else None)
    starts = _c_ints(plan["stage_start"])
    lib = cuda_build.load_library()
    err = lib.tllm_w4a16_kpaired(
        cuda_build.ptr(x), cuda_build.ptr(packed2), cuda_build.ptr(scales),
        cuda_build.ptr(zeros), cuda_build.ptr(bias), cuda_build.ptr(ws),
        cuda_build.ptr(out), M, N, K, G, Gp, _ACT_CODE[activation],
        plan["ntok"], plan["n_mb"], plan["n_ct"], starts, n_sl, plan["grid"],
        cuda_build.stream_of(x))
    cuda_build.check(err, "w4a16_kpaired")
    cuda_build.count_launch("w4a16_kpaired")
    return out


@functools.lru_cache(maxsize=4096)
def ramp_bounds(K: int, schedule: Optional[tuple] = None) -> tuple:
    """K13's work-unit K ranges: the ramp steps (`ramp_schedule(K)` by
    default) as K-row bounds, after the validation of the TPU kernel's
    schedule (1..4 slabs a step, at most 64 steps, covering K)."""
    sched = tuple(int(v) for v in (schedule or ramp_schedule(K)))
    if not sched or sum(sched) != K // RAMP_SLAB or min(sched) < 1 \
            or max(sched) > RAMP_MAX_STEP or len(sched) > RAMP_MAX_STEPS:
        raise ValueError(f"ramp schedule {sched} must cover K/{RAMP_SLAB} "
                         f"slabs in <= {RAMP_MAX_STEPS} steps of 1.."
                         f"{RAMP_MAX_STEP} slabs")
    bounds = [0]
    for v in sched:
        bounds.append(bounds[-1] + v * RAMP_SLAB)
    return tuple(bounds)


def w4a16_ramp(x: torch.Tensor, packed3: torch.Tensor, scales: torch.Tensor,
               zeros: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None,
               schedule: Optional[tuple] = None) -> torch.Tensor:
    """Launch K13 on CUDA operands (same contract as `w4a16_gemm`): one M
    block of at most 256 rows, K % 1024 == 0, and `schedule` the slabs of
    each step (default `ramp_schedule(K)`), at most 4 a step; each step is
    one work unit's K range (`ramp_bounds`)."""
    M, N, K, G, bn = _check_operands(x, packed3, scales, zeros, bias)
    Gp = pack_group_for(K, scales.shape[0])
    if not _ramp_able(K, Gp):
        raise NotImplementedError(
            f"w4a16_ramp needs K % {RAMP_SLAB} == 0 and a pack group "
            f"dividing {RAMP_SLAB} (K={K}, pack group={Gp})")
    sm90_check(K, N, G, False, bn=bn)
    if M > STREAM_MAX_BM:
        raise ValueError(f"w4a16_ramp takes one M block of <= "
                         f"{STREAM_MAX_BM} rows, got {M}")
    bounds = ramp_bounds(K, None if schedule is None else tuple(schedule))
    _check_sm90_ptrs(x, packed3)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    plan = sm90_plan(M, K, N, bounds, cuda_build.num_sms(x.device))
    n_sl = plan["slices"]
    ws = (torch.empty((n_sl, M, N), dtype=torch.float32, device=x.device)
          if n_sl > 1 else None)
    starts = _c_ints(plan["stage_start"])
    lib = cuda_build.load_library()
    err = lib.tllm_w4a16_ramp(
        cuda_build.ptr(x), cuda_build.ptr(packed3), cuda_build.ptr(scales),
        cuda_build.ptr(zeros), cuda_build.ptr(bias), cuda_build.ptr(ws),
        cuda_build.ptr(out), M, N, K, G, bn, _ACT_CODE[activation],
        plan["ntok"], plan["n_mb"], plan["n_ct"], starts, n_sl, plan["grid"],
        cuda_build.stream_of(x))
    cuda_build.check(err, "w4a16_ramp")
    cuda_build.count_launch("w4a16_ramp")
    return out


_KERNELS = {"w4a16_gemm": w4a16_gemm, "w4a16_gemv": w4a16_gemv,
            "w4a16_kpaired": w4a16_kpaired, "w4a16_ramp": w4a16_ramp}


def w4a16_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                 zeros: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None,
                 out_dtype=None,
                 block_m: Optional[int] = None,
                 block_k: Optional[int] = None,
                 block_n: Optional[int] = None,
                 variant: Optional[str] = None,
                 ramp_bk0: Optional[int] = None,
                 ramp_bk_big: Optional[int] = None,
                 lookahead: int = 4,
                 mixed: bool = False) -> torch.Tensor:
    """Fused dequant-GEMM ``act(x @ deq(packed, scales, zeros) + bias)``.

    x ``[..., K]``; packed ``[N//BN, K//2, BN]`` (tiled) or ``[K//2, N]``
    (K-paired); scales/zeros ``[K//G, N]``; bias ``[N]``.  CPU tensors take
    the plain version (tactics change nothing there); CUDA tensors launch
    the kernel `w4a16_plan` picks (or raise).  Without `block_k` and
    `variant`, the tactic tuned for ``(K, N, tiled)`` is used (see the
    module docstring for what each tactic key means on the card)."""
    del block_n, lookahead, mixed      # no Hopper meaning (module docstring)
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    if x.device.type == "cpu":
        out = w4a16_matmul_plain(x2, packed, scales, zeros, bias, activation,
                                 out_dtype)
        return out.reshape(*lead, out.shape[-1])
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    tiled = packed.dim() == 3
    N = packed.shape[0] * packed.shape[2] if tiled else packed.shape[1]
    if block_k is None and variant is None:
        from tensorrt_llm_tpu_torch.autotuner import AutoTuner
        tactic = AutoTuner.get().lookup("w4a16", (K, N, int(tiled))) or {}
        block_k = tactic.get("block_k")
        variant = tactic.get("variant")
        block_m = tactic.get("block_m", block_m)
        ramp_bk0 = tactic.get("ramp_bk0", ramp_bk0)
        ramp_bk_big = tactic.get("ramp_bk_big", ramp_bk_big)
    name, params = w4a16_plan(x2.shape[0], K, N, scales.shape[0], tiled,
                              block_k, block_m, variant, ramp_bk0,
                              ramp_bk_big)
    s = scales if scales.dtype == torch.bfloat16 else scales.to(torch.bfloat16)
    z = zeros
    if z is not None and z.dtype != torch.bfloat16:
        z = z.to(torch.bfloat16)
    b = bias
    if b is not None and b.dtype != torch.float32:
        b = b.to(torch.float32)
    x2 = x2.to(torch.bfloat16).contiguous()
    out = _KERNELS[name](x2, packed, s.contiguous(), z, b, activation,
                         **params)
    return out.to(out_dtype).reshape(*lead, out.shape[-1])


# --------------------------------------------------------------- W4A8 ------
def quantize_act_int8(x: torch.Tensor):
    """Dynamic per-token symmetric int8 quantization of [M, K]: returns
    (xq int8 [M, K], s_act f32 [M, 1]) with s_act = max(amax, 1e-12) / 127,
    bit-exact with the JAX package."""
    xf = x.to(torch.float32)
    s_act = div_scalar(torch.clamp(xf.abs().amax(dim=-1, keepdim=True),
                                   min=1e-12), 127.0)
    xq = torch.clamp(torch.round(xf / s_act), -127, 127).to(torch.int8)
    return xq, s_act


def w4a8_matmul_plain(xq: torch.Tensor, s_act: torch.Tensor,
                      packed: torch.Tensor, scales: torch.Tensor,
                      zeros: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      activation: Optional[str] = None,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version (the JAX XLA fallback's math): dequantize with f32
    scales and zeros, round the weight to bf16, multiply by bf16(xq) with
    f32 accumulation, then scale each row by s_act."""
    z = None if zeros is None else zeros.to(torch.float32)
    w = dequantize_w4_any(packed, scales.to(torch.float32), z).to(
        torch.bfloat16)
    out = (xq.to(torch.float32) @ w.to(torch.float32)) * s_act.to(
        torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :]
    return ACTIVATIONS[activation](out).to(out_dtype)


@functools.lru_cache(maxsize=4096)
def w4a8_plan(K: int, N: int, n_groups: int, block_n: int = 0,
              M: Optional[int] = None, n_sms: int = _SMS,
              slices: Optional[int] = None) -> dict:
    """K8's launch for a weight shape, as the packing it reads: the tiled
    ``[N/BN, K/2, BN]`` (`block_n` BN, ``pack_group`` 0) or the 2-D
    K-paired ``[K/2, N]`` (`block_n` 0, ``pack_group`` from
    `pack_group_for`), in 64-column tiles (``col_tiles``; a K-paired N
    needs only N % 16 == 0, the columns past it read as zeros).  Raises
    NotImplementedError on a shape K8 does not take.  Given the token
    count `M`, also the launch on the Hopper mainloop: the token tile and
    column tile (`sm90_tiles`: 8..128 tokens, 64 columns a block, 128 at
    128 tokens), M blocks, and K slices of whole 64-row stages, uneven by
    at most one stage, in K order (`k1_choice`'s count at `K8_K1_VARIANT`
    unless given, one of `k1_slice_choices`); a unit is (M block, column
    tile, slice) and the persistent grid is one block per unit up to the
    slots.  Pure shape logic; the tests check it
    on the CPU."""
    G = K // n_groups
    Gp = 0 if block_n else pack_group_for(K, n_groups)
    if K % 64 or G % 64:
        raise NotImplementedError(
            f"w4a8_gemm kernel needs K % 64 == 0 and G % 64 == 0 "
            f"(K={K}, G={G})")
    if block_n and (block_n % 64 or N % block_n):
        raise NotImplementedError(
            f"w4a8_gemm kernel needs BN % 64 == 0 dividing N (BN={block_n}, "
            f"N={N})")
    if not block_n and (N % 16 or Gp % 64 or K % Gp):
        raise NotImplementedError(
            f"w4a8_gemm kernel needs N % 16 == 0 and a pack group that is "
            f"a multiple of 64 for a K-paired weight (N={N}, pack "
            f"group={Gp})")
    route = {"pack_group": Gp, "col_tiles": cdiv(N, 64)}
    if M is None:
        return route
    M = max(M, 1)
    d = (k1_choice(M, K, N, n_sms, K8_K1_VARIANT)[1] if slices is None
         else slices)
    if d not in k1_slice_choices(K):
        raise ValueError(f"K8 takes 1..{K1_MAX_SLICES} slices of whole "
                         f"64-row stages (K={K}, slices={d})")
    return dict(route, **_k1_units(M, K, N, d, n_sms, K8_K1_VARIANT))


def w4a8_gemm(xq: torch.Tensor, s_act: torch.Tensor, packed: torch.Tensor,
              scales: torch.Tensor, zeros: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              activation: Optional[str] = None,
              slices: Optional[int] = None) -> torch.Tensor:
    """Launch K8 on CUDA operands: xq [M, K] int8, s_act [M, 1] f32,
    packed [N/BN, K/2, BN] (tiled) or [K/2, N] (K-paired) int8, scales
    (zeros) [K/G, N] f32, bias [N] f32.  `slices` overrides `w4a8_plan`'s
    K slice count.  Returns [M, N] bf16."""
    M, K = xq.shape
    if packed.dim() == 3:
        n_n, half, bn = packed.shape
        N = n_n * bn
    else:
        (half, N), bn = packed.shape, 0
    if half * 2 != K or scales.dim() != 2 or K % scales.shape[0]:
        raise ValueError("W4A8 operand shapes do not match")
    w4a8_plan(K, N, scales.shape[0], bn)        # K8's reach, on any device
    if xq.device.type != "cuda":
        raise ValueError("CUDA kernel called with a non-CUDA tensor")
    for name, t, dt in (("xq", xq, torch.int8), ("s_act", s_act, torch.float32),
                        ("packed", packed, torch.int8),
                        ("scales", scales, torch.float32),
                        ("zeros", zeros, torch.float32),
                        ("bias", bias, torch.float32)):
        if t is not None and (t.device != xq.device or t.dtype != dt
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dt} on {xq.device}")
    if half * 2 != K or s_act.shape != (M, 1) or scales.shape[1] != N \
            or K % scales.shape[0] \
            or (zeros is not None and zeros.shape != scales.shape) \
            or (bias is not None and bias.shape != (N,)):
        raise ValueError("W4A8 operand shapes do not match")
    G = K // scales.shape[0]
    _check_sm90_ptrs(xq, packed, scales, zeros)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=xq.device)
    if M == 0:
        return out
    plan = w4a8_plan(K, N, scales.shape[0], bn, M,
                     cuda_build.num_sms(xq.device), slices)
    n_sl = plan["slices"]
    ws = (torch.empty((n_sl, M, N), dtype=torch.float32, device=xq.device)
          if n_sl > 1 else None)
    lib = cuda_build.load_library()
    err = lib.tllm_w4a8_gemm(
        cuda_build.ptr(xq), cuda_build.ptr(s_act), cuda_build.ptr(packed),
        cuda_build.ptr(scales), cuda_build.ptr(zeros), cuda_build.ptr(bias),
        cuda_build.ptr(ws), cuda_build.ptr(out), M, N, K, G, bn,
        plan["pack_group"], _ACT_CODE[activation], plan["ntok"],
        plan["n_mb"], plan["n_ct"], _c_ints(plan["stage_start"]), n_sl,
        plan["grid"], cuda_build.stream_of(xq))
    cuda_build.check(err, "w4a8_gemm")
    cuda_build.count_launch("w4a8_gemm")
    if n_sl > 1:
        cuda_build.count_launch("w4a8_combine")
    return out


def w4a8_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                zeros: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                activation: Optional[str] = None,
                out_dtype=None) -> torch.Tensor:
    """``act(s_act * (int8(x) @ deq(packed, scales, zeros)) + bias)``: x
    ``[..., K]`` is quantized per token, then CPU tensors take the plain
    version and CUDA tensors launch K8 on the packing as stored (or
    raise)."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    xq, s_act = quantize_act_int8(x.reshape(-1, x.shape[-1]))
    if x.device.type == "cpu":
        out = w4a8_matmul_plain(xq, s_act, packed, scales, zeros, bias,
                                activation, out_dtype)
        return out.reshape(*lead, out.shape[-1])
    # any other device goes to K8's wrapper, which refuses a shape K8 does
    # not take (NotImplementedError) before a device that is not CUDA
    b = None if bias is None else bias.to(torch.float32)
    out = w4a8_gemm(xq, s_act, packed, scales.to(torch.float32),
                    None if zeros is None else zeros.to(torch.float32),
                    b, activation)
    return out.to(out_dtype).reshape(*lead, out.shape[-1])
