"""W4A16 GEMM: ``act(x @ ((q - z) * s) + b)`` with int4 weights.

Counterpart of `tensorrt_llm_tpu/ops/w4a16_gemm.py`:

* `w4a16_matmul_plain` is the plain PyTorch version (the JAX package's
  `w4a16_matmul_xla`): dequantize, bf16 product with f32 accumulation.
* `w4a16_gemm` wraps kernel K1 (`csrc/w4a16_gemm.cu`, general M) and
  `w4a16_gemv` wraps kernel K2 (`csrc/w4a16_gemv.cu`, M <= 16).
* `w4a16_matmul` dispatches: the plain version for CPU tensors, a kernel for
  CUDA tensors.  K2 takes M <= `GEMV_MAX_M` = 16 rows: at decode batch sizes
  the product is bound by the int4 weight bytes, and K1's 64-row
  tensor-core tile would run at most a quarter full; above 16 rows the FMA
  work of the CUDA-core GEMV outgrows the weight stream and K1 wins.

Scales and zeros are rounded to bf16 on every path, as in the JAX package
(its `w4a16_matmul_xla` and the Pallas kernels store half-precision scales).
Both packings are accepted: the 3-D tiled one the kernels read, and the 2-D
K-paired one, which the CUDA path repacks to tiles on the fly (layers repack
once at load time instead).

W4A8 (the JAX package's `w4a8_matmul`, same module): activations are
quantized per token to int8 (`quantize_act_int8`, plain torch ops on every
device, as the JAX package leaves it to XLA), then
``act(s_act * (xq @ deq(q, s, z)) + b)``.  `w4a8_matmul_plain` is the JAX
XLA fallback's math; `w4a8_gemm` wraps kernel K8 (`csrc/w4a8_gemm.cu`,
exact int8 x int4 products per scale group on the s8 tensor cores).  W4A8
scales and zeros stay f32 on every path: the JAX package never rounds them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tensorrt_llm_tpu_torch.ops import cuda_build
from tensorrt_llm_tpu_torch.quantization.quantize import (
    dequantize_w4_any, to_tiled)

GEMV_MAX_M = 16
_SMS = 132          # H100 SXM streaming multiprocessors
_GEMV_COLS = 64     # output columns per K2 block
_GEMV_MAX_KS = 2048  # K2 stages its x slice in shared memory as f32

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


def _check_operands(x, packed3, scales, zeros, bias):
    M, K = x.shape
    n_n, half, bn = packed3.shape
    N = n_n * bn
    if x.device.type != "cuda":
        raise ValueError("CUDA kernel called with a non-CUDA tensor")
    for name, t in (("packed", packed3), ("scales", scales), ("zeros", zeros),
                    ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("x must be contiguous bf16")
    if packed3.dtype != torch.int8 or half * 2 != K:
        raise ValueError(f"packed {tuple(packed3.shape)} does not match K={K}")
    if scales.dtype != torch.bfloat16 or scales.shape[1] != N \
            or K % scales.shape[0]:
        raise ValueError(f"scales must be bf16 [K/G, {N}]")
    if zeros is not None and (zeros.dtype != torch.bfloat16
                              or zeros.shape != scales.shape):
        raise ValueError("zeros must be bf16 shaped like scales")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (N,)):
        raise ValueError(f"bias must be f32 [{N}]")
    G = K // scales.shape[0]
    if bn % 64 or K % 32 or G % 32:
        raise NotImplementedError(
            f"W4A16 kernels need BN % 64 == 0, K % 32 == 0 and G % 32 == 0 "
            f"(BN={bn}, K={K}, G={G})")
    return M, N, K, G, bn


def w4a16_gemm(x: torch.Tensor, packed3: torch.Tensor, scales: torch.Tensor,
               zeros: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None) -> torch.Tensor:
    """Launch K1 on CUDA operands: x [M, K] bf16, packed3 [N/BN, K/2, BN]
    int8, scales (zeros) [K/G, N] bf16, bias [N] f32.  Returns [M, N] bf16."""
    M, N, K, G, bn = _check_operands(x, packed3, scales, zeros, bias)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    lib = cuda_build.load_library()
    err = lib.tllm_w4a16_gemm(
        cuda_build.ptr(x), cuda_build.ptr(packed3), cuda_build.ptr(scales),
        cuda_build.ptr(zeros), cuda_build.ptr(bias), cuda_build.ptr(out),
        M, N, K, G, bn, _ACT_CODE[activation], cuda_build.stream_of(x))
    cuda_build.check(err, "w4a16_gemm")
    cuda_build.launch_counts["w4a16_gemm"] += 1
    return out


def gemv_split(K: int, N: int, G: int) -> int:
    """K2's split-K factor: enough (N/64 columns x splits) blocks to cover
    the SMs twice, with every K slice a whole number of scale groups (and of
    128 rows) and at most `_GEMV_MAX_KS` long."""
    unit = max(G, 128) if K % max(G, 128) == 0 else G
    n_units = K // unit
    want = max(-(-2 * _SMS // (N // _GEMV_COLS)), -(-K // _GEMV_MAX_KS))
    divisors = [d for d in range(1, n_units + 1) if n_units % d == 0]
    for d in divisors:
        if d >= want and K // d <= _GEMV_MAX_KS:
            return d
    return divisors[-1]


def w4a16_gemv(x: torch.Tensor, packed3: torch.Tensor, scales: torch.Tensor,
               zeros: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None) -> torch.Tensor:
    """Launch K2 (M <= 16) on CUDA operands; same contract as `w4a16_gemm`."""
    M, N, K, G, bn = _check_operands(x, packed3, scales, zeros, bias)
    if M > GEMV_MAX_M:
        raise ValueError(f"w4a16_gemv takes M <= {GEMV_MAX_M}, got {M}")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    split = gemv_split(K, N, G)
    ws = torch.empty((split, M, N), dtype=torch.float32, device=x.device)
    lib = cuda_build.load_library()
    err = lib.tllm_w4a16_gemv(
        cuda_build.ptr(x), cuda_build.ptr(packed3), cuda_build.ptr(scales),
        cuda_build.ptr(zeros), cuda_build.ptr(bias), cuda_build.ptr(ws),
        cuda_build.ptr(out), M, N, K, G, bn, _ACT_CODE[activation], split,
        cuda_build.stream_of(x))
    cuda_build.check(err, "w4a16_gemv")
    cuda_build.launch_counts["w4a16_gemv"] += 1
    return out


def w4a16_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                 zeros: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None,
                 out_dtype=None) -> torch.Tensor:
    """Fused dequant-GEMM ``act(x @ deq(packed, scales, zeros) + bias)``.

    x ``[..., K]``; packed ``[N//BN, K//2, BN]`` (tiled) or ``[K//2, N]``
    (K-paired); scales/zeros ``[K//G, N]``; bias ``[N]``.  CPU tensors take
    the plain version; CUDA tensors launch K1 or K2 (or raise)."""
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
    packed3 = to_tiled(packed, scales)
    s = scales if scales.dtype == torch.bfloat16 else scales.to(torch.bfloat16)
    z = zeros
    if z is not None and z.dtype != torch.bfloat16:
        z = z.to(torch.bfloat16)
    b = bias
    if b is not None and b.dtype != torch.float32:
        b = b.to(torch.float32)
    x2 = x2.to(torch.bfloat16).contiguous()
    fn = w4a16_gemv if x2.shape[0] <= GEMV_MAX_M else w4a16_gemm
    out = fn(x2, packed3, s.contiguous(), z, b, activation)
    return out.to(out_dtype).reshape(*lead, out.shape[-1])


# --------------------------------------------------------------- W4A8 ------
def quantize_act_int8(x: torch.Tensor):
    """Dynamic per-token symmetric int8 quantization of [M, K]: returns
    (xq int8 [M, K], s_act f32 [M, 1]) with s_act = max(amax, 1e-12) / 127,
    bit-exact with the JAX package."""
    xf = x.to(torch.float32)
    s_act = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-12) / 127.0
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


def w4a8_gemm(xq: torch.Tensor, s_act: torch.Tensor, packed3: torch.Tensor,
              scales: torch.Tensor, zeros: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              activation: Optional[str] = None) -> torch.Tensor:
    """Launch K8 on CUDA operands: xq [M, K] int8, s_act [M, 1] f32,
    packed3 [N/BN, K/2, BN] int8, scales (zeros) [K/G, N] f32, bias [N]
    f32.  Returns [M, N] bf16."""
    M, K = xq.shape
    n_n, half, bn = packed3.shape
    N = n_n * bn
    if xq.device.type != "cuda":
        raise ValueError("CUDA kernel called with a non-CUDA tensor")
    for name, t, dt in (("xq", xq, torch.int8), ("s_act", s_act, torch.float32),
                        ("packed", packed3, torch.int8),
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
    if bn % 64 or K % 64 or G % 64:
        raise NotImplementedError(
            f"w4a8_gemm kernel needs BN % 64 == 0, K % 64 == 0 and "
            f"G % 64 == 0 (BN={bn}, K={K}, G={G})")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=xq.device)
    if M == 0:
        return out
    lib = cuda_build.load_library()
    err = lib.tllm_w4a8_gemm(
        cuda_build.ptr(xq), cuda_build.ptr(s_act), cuda_build.ptr(packed3),
        cuda_build.ptr(scales), cuda_build.ptr(zeros), cuda_build.ptr(bias),
        cuda_build.ptr(out), M, N, K, G, bn, _ACT_CODE[activation],
        cuda_build.stream_of(xq))
    cuda_build.check(err, "w4a8_gemm")
    cuda_build.launch_counts["w4a8_gemm"] += 1
    return out


def w4a8_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                zeros: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                activation: Optional[str] = None,
                out_dtype=None) -> torch.Tensor:
    """``act(s_act * (int8(x) @ deq(packed, scales, zeros)) + bias)``: x
    ``[..., K]`` is quantized per token, then CPU tensors take the plain
    version and CUDA tensors launch K8 (or raise)."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    xq, s_act = quantize_act_int8(x.reshape(-1, x.shape[-1]))
    if x.device.type == "cpu":
        out = w4a8_matmul_plain(xq, s_act, packed, scales, zeros, bias,
                                activation, out_dtype)
        return out.reshape(*lead, out.shape[-1])
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b = None if bias is None else bias.to(torch.float32)
    out = w4a8_gemm(xq, s_act, to_tiled(packed, scales),
                    scales.to(torch.float32),
                    None if zeros is None else zeros.to(torch.float32),
                    b, activation)
    return out.to(out_dtype).reshape(*lead, out.shape[-1])
