"""A whole W4A16 gated MLP in one launch:
``down(act(x @ gate + b_g) * (x @ up + b_u)) + b_down``.

Counterpart of `tensorrt_llm_tpu/ops/w4a16_fused.py`, whose Pallas kernel
(`_fused_mlp_kernel`) chains the three weight streams into one grid so the
TPU's weight pipeline never restarts.  Here `w4a16_fused_mlp` launches
kernel K14 (`csrc/w4a16_fused_mlp.cu`): a cooperative launch whose phases
(gate and up tiles sharing each x fragment into a bf16 ``h`` workspace,
then ``h @ down`` over `n_k2` K slices, then the slice sum) are separated by
grid barriers.  CPU tensors take `w4a16_fused_mlp_plain`.

Layouts are the JAX op's: ``gu_packed`` tiled ``[2I/BN, K/2, BN]`` with the
gate columns first (``[gate | up]``, `GatedMLP`'s fused layout),
``gu_scales`` ``[K/G, 2I]``, ``down_packed`` ``[K/BNd, I/2, BNd]``,
``down_scales`` ``[I/G, K]``; scales and zeros are rounded to bf16 (the JAX
op streams them as bf16), biases are f32.  ``block_m`` and ``mixed`` (the
TPU's M block and native s4 MXU feed) are accepted without effect: K14's M
tile is 64 rows.

As in the JAX package, no layer calls this op: `GatedMLP` runs its two
linears.  `fused_mlp_supported` returns the real eligibility of K14's
shapes (the JAX version's condition ends in ``or True``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tensorrt_llm_tpu_torch.ops import cuda_build
from tensorrt_llm_tpu_torch.ops.w4a16_gemm import ACTIVATIONS, _ACT_CODE
from tensorrt_llm_tpu_torch.quantization.quantize import dequantize_w4_any
from tensorrt_llm_tpu_torch.utils import cdiv

_TILE = 64        # K14's M and N tile
_SMS = 132


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
    The dequantized weights ``(q - z) * s`` are exact in f32."""
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


def fused_mlp_n_k2(M: int, K: int, I: int, down_group: int) -> int:
    """Default K slices of the down phase: the fewest (each whole down
    groups, at least 128 rows) that give every SM two phase-B items."""
    unit = down_group if down_group < I else 32
    n_units = I // unit
    tiles = cdiv(M, _TILE) * (K // _TILE)
    best = 1
    for d in range(1, n_units + 1):
        if n_units % d or (I // d < 128 and d > 1):
            continue
        best = d
        if tiles * d >= 2 * _SMS:
            break
    return best


def fused_mlp_launch(x, gu_packed, gu_scales, down_packed, down_scales,
                     gu_zeros=None, down_zeros=None, gu_bias=None,
                     down_bias=None, activation="silu", n_k2=None,
                     barrier_stats=False):
    """Launch K14 on CUDA operands (x [M, K] bf16 and the op's layouts,
    scales/zeros bf16, biases f32).  Returns (out [M, K] bf16, grid, stats):
    with `barrier_stats`, stats is int64 [grid, 4], each block's global
    timer (ns) on arriving at and leaving barrier 1, then barrier 2."""
    M, K = x.shape
    n_gu, half_k, BN = gu_packed.shape
    I = n_gu * BN // 2
    n_d, half_i, BNd = down_packed.shape
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
    n_k2 = n_k2 or fused_mlp_n_k2(M, K, I, Gd)
    unit = Gd if Gd < I else 32
    if n_k2 < 1 or I % n_k2 or (I // n_k2) % unit:
        raise ValueError(f"n_k2={n_k2} must cut I={I} into whole down "
                         f"groups of {unit}")
    dev = x.device
    out = torch.empty((M, K), dtype=torch.bfloat16, device=dev)
    if M == 0:
        return out, 0, None
    h = torch.empty((M, I), dtype=torch.bfloat16, device=dev)
    part = torch.empty((n_k2, M, K), dtype=torch.float32, device=dev)
    bar = torch.empty((1,), dtype=torch.int32, device=dev)
    n_sms = cuda_build.num_sms(dev)
    stats = (torch.zeros((4 * n_sms * 32,), dtype=torch.int64, device=dev)
             if barrier_stats else None)
    grid = ctypes.c_int(0)
    P = cuda_build.ptr
    lib = cuda_build.load_library()
    err = lib.tllm_w4a16_fused_mlp(
        P(x), P(gu_packed), P(gu_scales), P(gu_zeros), P(gu_bias),
        P(down_packed), P(down_scales), P(down_zeros), P(down_bias), P(h),
        P(part), P(bar), P(stats), P(out), M, K, I, Ga, Gd, BN, BNd, n_k2,
        _ACT_CODE[activation], n_sms, ctypes.byref(grid),
        cuda_build.stream_of(x))
    cuda_build.check(err, "w4a16_fused_mlp")
    cuda_build.launch_counts["w4a16_fused_mlp"] += 1
    g = grid.value
    return out, g, (stats[:4 * g].view(g, 4) if barrier_stats else None)


def w4a16_fused_mlp(x, gu_packed, gu_scales, down_packed, down_scales,
                    gu_zeros=None, down_zeros=None, gu_bias=None,
                    down_bias=None, activation="silu", out_dtype=None,
                    block_m=None, n_k2=None, mixed=True):
    """One-launch gated MLP (see the module docstring).  CPU tensors take
    the plain version; CUDA tensors launch K14 (or raise).  `n_k2` is the
    number of K slices of the down phase (default `fused_mlp_n_k2`)."""
    del block_m, mixed                # no Hopper meaning (module docstring)
    out_dtype = out_dtype or x.dtype
    lead, K = x.shape[:-1], x.shape[-1]
    if x.device.type == "cpu":
        return w4a16_fused_mlp_plain(
            x, gu_packed, gu_scales, down_packed, down_scales, gu_zeros,
            down_zeros, gu_bias, down_bias, activation, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out, _, _ = fused_mlp_launch(
        x.reshape(-1, K).to(torch.bfloat16).contiguous(), gu_packed,
        _bf16(gu_scales), down_packed, _bf16(down_scales), _bf16(gu_zeros),
        _bf16(down_zeros),
        _f32(gu_bias), _f32(down_bias), activation, n_k2)
    return out.to(out_dtype).reshape(*lead, K)
