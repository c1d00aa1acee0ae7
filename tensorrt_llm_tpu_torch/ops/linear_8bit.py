"""The 8-bit linears' products: W8A16, FP8 (static or per-token e4m3
activations) and W8A8 (per-token int8 activations).

Counterpart of the `apply` of `W8A16LinearMethod`, `FP8LinearMethod` and
`W8A8LinearMethod` in `tensorrt_llm_tpu/layers/linear.py`.  The JAX package
computes them in XLA, outside Pallas, so the port computes them in plain
PyTorch on every device, with the JAX package's rounding order:

* W8A16 / FP8: the product in f32 with exact terms (bf16 activations and
  int8 or e4m3 weights, every one of them an f32 -- and a TF32 -- value, so
  no product rounds whatever the TF32 setting), then the per-channel scale
  (and, per token, the activation scale), the bias and the activation in
  f32, one rounding to the output dtype.
* W8A8: ``int8 x int8`` summed exactly in int32 (`int8_product`:
  `torch._int_mm`, cuBLASLt's s8 x s8 -> s32 on the card), never in f32,
  which stops being exact once 127^2 * K passes 2^24.

Weights are ``qweight [K, N]`` (int8, or float8_e4m3fn for FP8) with f32
``scales [N]``; activations ``[..., K]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tensorrt_llm_tpu_torch.ops.w4a16_gemm import (
    ACTIVATIONS, quantize_act_int8)
from tensorrt_llm_tpu_torch.quantization.quantize import E4M3_MAX, to_e4m3
from tensorrt_llm_tpu_torch.utils import cdiv, div_scalar

# torch._int_mm on the card takes more than 16 rows, K and N multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def quantize_act_fp8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token e4m3 quantization of [M, K]: (x8 float8_e4m3fn
    [M, K], s_act f32 [M, 1]) with s_act = max(amax, 1e-12) / 448, the JAX
    package's `FP8LinearMethod(dynamic_act=True)`."""
    xf = x.to(torch.float32)
    s_act = div_scalar(torch.clamp(xf.abs().amax(dim=-1, keepdim=True),
                                   min=1e-12), E4M3_MAX)
    return to_e4m3(xf / s_act), s_act


def _f32_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ w [K, N] with exact terms and f32 sums."""
    return a.to(torch.float32) @ w.to(torch.float32)


def pad_int_mm_weight(w: torch.Tensor) -> torch.Tensor:
    """w int8 [K, N] as the card's `torch._int_mm` takes it: K and N
    zero-padded to multiples of 8 (zeros add nothing to an integer sum),
    column-major.  A W8A8 layer makes it once, when its weight is loaded."""
    K, N = w.shape
    Kp = cdiv(K, _INT_MM_ALIGN) * _INT_MM_ALIGN
    Np = cdiv(N, _INT_MM_ALIGN) * _INT_MM_ALIGN
    wp = w.new_zeros((Np, Kp))
    wp[:N, :K] = w.t()
    return wp.t()


def int_mm_operands(xq: torch.Tensor, w: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xq, w) as `torch._int_mm` on the card takes them: w padded by
    `pad_int_mm_weight` (here, per call, only where its K or N is not a
    multiple of 8), xq zero-padded to more than 16 rows and to w's K."""
    if w.shape[0] % _INT_MM_ALIGN or w.shape[1] % _INT_MM_ALIGN:
        w = pad_int_mm_weight(w)
    M, K = xq.shape
    Mp = cdiv(max(_INT_MM_MIN_ROWS, M), _INT_MM_ALIGN) * _INT_MM_ALIGN
    return _pad_rows_cols(xq, Mp, w.shape[0]), w


def _pad_rows_cols(xq: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    M, K = xq.shape
    if (rows, cols) == (M, K):
        return xq.contiguous()
    xp = xq.new_zeros((rows, cols))
    xp[:M, :K] = xq
    return xp


def int8_product(xq: torch.Tensor, w: torch.Tensor,
                 n: Optional[int] = None) -> torch.Tensor:
    """xq int8 [M, K] @ w int8 [Kw, Nw] summed exactly in int32: [M, n]
    (n defaults to Nw).  w may be `pad_int_mm_weight`'s (Kw >= K, its rows
    past K zero), which spares the card's product a per-call copy of the
    weight; it is best column-major, the layout cuBLASLt's int8 product
    reads."""
    M = xq.shape[0]
    n = w.shape[1] if n is None else n
    if M == 0:
        return torch.zeros((0, n), dtype=torch.int32, device=xq.device)
    if xq.device.type == "cpu":
        return torch._int_mm(_pad_rows_cols(xq, M, w.shape[0]), w)[:, :n]
    return torch._int_mm(*int_mm_operands(xq, w))[:M, :n]


def _finish(out, scales, bias, activation, out_dtype):
    out = out * scales[None, :]
    if bias is not None:
        out = out + bias
    return ACTIVATIONS[activation](out).to(out_dtype)


def w8a16_matmul(x: torch.Tensor, qweight: torch.Tensor,
                 scales: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 activation: Optional[str] = None) -> torch.Tensor:
    """``act((x @ q) * scales + bias)``: int8 weights, bf16 activations."""
    x2 = x.reshape(-1, x.shape[-1])
    out = _finish(_f32_product(x2, qweight), scales, bias, activation,
                  x.dtype)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def fp8_matmul(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None,
               dynamic_act: bool = False) -> torch.Tensor:
    """e4m3 weights; with `dynamic_act` the activations are quantized to
    e4m3 per token first and their scale multiplies the product before the
    weight's (FP8_PER_CHANNEL_PER_TOKEN)."""
    x2 = x.reshape(-1, x.shape[-1])
    if dynamic_act:
        x8, s_act = quantize_act_fp8(x2)
        out = _f32_product(x8, qweight) * s_act
    else:
        out = _f32_product(x2, qweight)
    out = _finish(out, scales, bias, activation, x.dtype)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def w8a8_matmul(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                activation: Optional[str] = None) -> torch.Tensor:
    """SmoothQuant-style W8A8: per-token int8 activations (`quantize_act_
    int8`), the int32 product, then ``acc * s_act * scales``.  `qweight`
    may be padded (`pad_int_mm_weight`): N is that of `scales`."""
    x2 = x.reshape(-1, x.shape[-1])
    xq, s_act = quantize_act_int8(x2)
    out = int8_product(xq, qweight, scales.shape[0]).to(torch.float32) \
        * s_act
    out = _finish(out, scales, bias, activation, x.dtype)
    return out.reshape(*x.shape[:-1], out.shape[-1])
