"""Linear layer: unquantized, W4A16, W4A8_AWQ, W8A16, W8A8 or FP8.

Counterpart of `tensorrt_llm_tpu/layers/linear.py` (`UnquantizedLinearMethod`,
`W4A16LinearMethod`, `W4A8LinearMethod`, `W8A16LinearMethod`,
`FP8LinearMethod`, `W8A8LinearMethod` and `make_linear_method`'s choice
among them).  Weights keep the JAX package's ``[in, out]`` orientation.  An
int4 layer (W4A16 family, W4A8_AWQ) holds:

* ``qweight`` int8: W4A16 keeps the packing it arrives in, the tiled
  ``[N//BN, K//2, BN]`` or the K-paired ``[K//2, N]`` (which
  `W4A16LinearMethod._pack` picks where no 128-multiple column tile
  divides N), and so does W4A8 (K8 reads both packings; the JAX package
  sends a 2-D W4A8 weight to XLA),
* ``scales`` ``[K//G, N]``: bf16 for W4A16 (rounded once at load; the JAX
  package rounds the same f32 scales to bf16 on every call), f32 for W4A8
  (the JAX package never rounds them),
* optional ``zeros`` (same dtype as the scales; W4A8 always has them, as
  the JAX package forces) and ``bias`` f32.

W4A16 layers run `w4a16_matmul` (K1/K2/K13 on a tiled weight, K12 on a
K-paired one, by the tuned tactic), W4A8 layers `w4a8_matmul`
(per-token int8 activations, K8 on CUDA).  Under `QuantConfig.clip_search`
the int4 weights come from the clip-ratio search
(`quantization/calibrate.py`), as the JAX package's W4A16 and W4A8
methods quantize them.

An 8-bit layer holds ``qweight [K, N]`` -- int8 per output channel
(`quantize_w8`) for W8A16 and W8A8_SQ_PER_CHANNEL, e4m3 (`quantize_fp8`)
for FP8 and FP8_PER_CHANNEL_PER_TOKEN -- with f32 ``scales [N]`` and
``bias``, and runs the plain products of `ops/linear_8bit.py`, as the JAX
package runs them in XLA.  A W8A8 weight is kept column-major (its bytes
``[N, K]``), the layout of the card's int8 product, with K and N
zero-padded to multiples of 8 (``qweight_mm``; ``qweight`` is its
``[K, N]`` view).  An AWQ/GPTQ
`QTensor` given to an 8-bit or unquantized layer is dequantized exactly
and then quantized by that layer's method, as in the JAX package.

An unquantized layer (lm_head) holds ``weight`` bf16 ``[in, out]`` and runs
a plain matrix product: on CUDA that is `torch.matmul`, as the JAX package
leaves its bf16 lm_head to `jnp.dot` outside any kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tensorrt_llm_tpu_torch.ops.linear_8bit import (
    fp8_matmul, pad_int_mm_weight, w8a8_matmul, w8a16_matmul)
from tensorrt_llm_tpu_torch.ops.w4a16_gemm import (
    ACTIVATIONS, w4a8_matmul, w4a16_matmul)
from tensorrt_llm_tpu_torch.quantization import (
    QuantAlgo, QuantConfig, choose_block_n, pack_group_for, pack_w4,
    pack_w4_tiled, quantize_fp8, quantize_w4, quantize_w8)
from tensorrt_llm_tpu_torch.quantization.calibrate import (
    quantize_w4_calibrated)
from tensorrt_llm_tpu_torch.quantization.hf_ingest import QTensor


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 quant: Optional[QuantConfig] = None, name: str = ""):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        active = (quant is not None and quant.quant_algo != QuantAlgo.NO_QUANT
                  and not quant.excludes(name))
        self.algo = quant.quant_algo if active else QuantAlgo.NO_QUANT
        self.quantized = active
        # int4 weights (W4A16 family or W4A8_AWQ) in the kernels' packings
        self.w4 = active and quant.is_w4
        self.w4a8 = active and quant.quant_algo == QuantAlgo.W4A8_AWQ
        self.clip_search = self.w4 and quant.clip_search
        self.group_size = quant.group_size if self.w4 else 0
        self.has_zeros = bool(self.w4 and (
            quant.has_zero_point or quant.quant_algo in (
                QuantAlgo.W4A16_AWQ, QuantAlgo.W4A16_GPTQ,
                QuantAlgo.W4A8_AWQ)))
        for b in ("weight", "qweight", "scales", "zeros", "bias"):
            self.register_buffer(b, None)
        self.qweight_mm = None   # W8A8: the padded storage of qweight

    @property
    def w4a16(self) -> bool:
        """int4 weights with bf16 activations: the tuned W4A16 kernels."""
        return self.w4 and not self.w4a8

    @property
    def w8(self) -> bool:
        """Per-channel 8-bit weights (int8 or e4m3) and f32 scales [N]."""
        return self.quantized and not self.w4

    @property
    def fp8(self) -> bool:
        """e4m3 weights: FP8 or FP8_PER_CHANNEL_PER_TOKEN."""
        return self.algo in (QuantAlgo.FP8,
                             QuantAlgo.FP8_PER_CHANNEL_PER_TOKEN)

    # ---- parameters -----------------------------------------------------
    def from_float(self, w, bias: Optional[torch.Tensor] = None) -> None:
        """Quantize (int4 with or without the clip search, or 8-bit) or cast
        (bf16) full float weights [in, out].  `w` may instead be a
        `QTensor` from an AWQ/GPTQ checkpoint: an int4 layer packs its ints
        as they are, at its group size (never re-quantized); any other
        layer takes its exact dequantization."""
        assert tuple(w.shape) == (self.in_features, self.out_features), \
            (tuple(w.shape), (self.in_features, self.out_features))
        if isinstance(w, QTensor):
            if not self.w4:
                w = w.dequant()
            else:
                self.group_size = w.group_size
                self.load({"qweight": self._pack(w.q, w.scales.shape[0]),
                           "scales": w.scales, "zeros": w.zeros,
                           "bias": bias})
                return
        if self.w4:
            quantize = (quantize_w4_calibrated if self.clip_search
                        else quantize_w4)
            q, s, z = quantize(w, self.group_size,
                               symmetric=not self.has_zeros)
            self.load({"qweight": self._pack(q, s.shape[0]), "scales": s,
                       "zeros": z, "bias": bias})
        elif self.w8:
            q, s = quantize_fp8(w) if self.fp8 else quantize_w8(w)
            self.load({"qweight": q, "scales": s, "bias": bias})
        else:
            self.load({"weight": w, "bias": bias})

    @staticmethod
    def _pack(q: torch.Tensor, n_scale_groups: int) -> torch.Tensor:
        """The JAX package's `W4A16LinearMethod._pack`: tiled where a
        128-multiple column tile divides N, else K-paired."""
        K, N = q.shape
        bn = choose_block_n(N)
        if bn and K % 2 == 0:
            return pack_w4_tiled(q, bn)
        return pack_w4(q, pack_group_for(K, n_scale_groups))

    def load(self, p: Dict[str, Optional[torch.Tensor]]) -> None:
        """Install parameters in the JAX package's naming (``qweight``,
        ``scales``, ``zeros``, ``bias`` or ``weight``, ``bias``)."""
        if self.w4:
            s = p["scales"]
            sdt = torch.float32 if self.w4a8 else torch.bfloat16
            self.qweight = p["qweight"].to(torch.int8).contiguous()
            self.scales = s.to(sdt).contiguous()
            z = p.get("zeros")
            self.zeros = None if z is None else z.to(sdt).contiguous()
        elif self.w8:
            q = p["qweight"]
            want = torch.float8_e4m3fn if self.fp8 else torch.int8
            if q.dtype != want:
                raise ValueError(f"{self.algo} qweight must be {want}, got "
                                 f"{q.dtype}")
            if self.algo == QuantAlgo.W8A8_SQ_PER_CHANNEL:
                # the card's int8 product operand, padded once here;
                # qweight is its [K, N] view
                self.qweight_mm = pad_int_mm_weight(q)
                q = self.qweight_mm[:q.shape[0], :q.shape[1]]
            else:
                q = q.contiguous()
            self.qweight = q
            self.scales = p["scales"].to(torch.float32).contiguous()
        else:
            self.weight = p["weight"].to(torch.bfloat16).contiguous()
        b = p.get("bias")
        self.bias = None if b is None else b.to(torch.float32).contiguous()

    # ---- forward ----------------------------------------------------------
    def forward(self, x: torch.Tensor,
                activation: Optional[str] = None) -> torch.Tensor:
        if self.w4:
            fn = w4a8_matmul if self.w4a8 else w4a16_matmul
            return fn(x, self.qweight, self.scales, self.zeros, self.bias,
                      activation, out_dtype=x.dtype)
        if self.w8:
            args = (x, self.qweight, self.scales, self.bias, activation)
            if self.algo == QuantAlgo.W8A16:
                return w8a16_matmul(*args)
            if self.algo == QuantAlgo.W8A8_SQ_PER_CHANNEL:
                return w8a8_matmul(x, self.qweight_mm, *args[2:])
            return fp8_matmul(*args, dynamic_act=(
                self.algo == QuantAlgo.FP8_PER_CHANNEL_PER_TOKEN))
        if x.device.type == "cuda":
            out = torch.matmul(x, self.weight.to(x.dtype))
            if self.bias is None and activation is None:
                return out
            out = out.to(torch.float32)
        else:
            out = x.to(torch.float32) @ self.weight.to(torch.float32)
        if self.bias is not None:
            out = out + self.bias
        return ACTIVATIONS[activation](out).to(x.dtype)
