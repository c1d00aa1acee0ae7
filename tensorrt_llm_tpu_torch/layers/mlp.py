"""Gated MLP (SwiGLU / GeGLU).  Counterpart of `GatedMLP` in
`tensorrt_llm_tpu/layers/mlp.py`: one fused gate+up projection (one pass
over the weights), the gate activation times up in f32, then down."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tensorrt_llm_tpu_torch.layers.linear import Linear
from tensorrt_llm_tpu_torch.ops.w4a16_gemm import ACTIVATIONS
from tensorrt_llm_tpu_torch.quantization import QuantConfig
from tensorrt_llm_tpu_torch.quantization.hf_ingest import wcat


class GatedMLP(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int,
                 activation: str = "silu",
                 quant: Optional[QuantConfig] = None):
        super().__init__()
        self.intermediate_size = intermediate_size
        self.activation = activation
        self.gate_up = Linear(hidden_size, 2 * intermediate_size, quant, "mlp")
        self.down = Linear(intermediate_size, hidden_size, quant, "mlp")

    def from_float(self, gate_w, up_w, down_w) -> None:
        """Full float weights in [in, out] layout (or AWQ/GPTQ
        `QTensor`s); gate and up are fused column-wise ([gate | up]) as in
        the JAX package at tp = 1."""
        self.gate_up.from_float(wcat([gate_w, up_w]))
        self.down.from_float(down_w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gu = self.gate_up(x)
        i = self.intermediate_size
        gate, up = gu[..., :i], gu[..., i:]
        h = (ACTIVATIONS[self.activation](gate.to(torch.float32))
             * up.to(torch.float32)).to(x.dtype)
        return self.down(h)
