"""Gated MLP (SwiGLU / GeGLU).  Counterpart of `GatedMLP` in
`tensorrt_llm_tpu/layers/mlp.py`: one fused gate+up projection (one pass
over the weights), the gate activation times up in f32, then down.  With
multi-LoRA stacks (``lora_gate_up_*``, ``lora_down_*``) and `lora_ids`,
each row's adapter product follows gate_up and down (JAX
`layers/mlp.py:95-106`)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tensorrt_llm_tpu_torch.layers.linear import Linear
from tensorrt_llm_tpu_torch.lora.multi_lora import apply_lora
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
        for b in ("lora_gate_up_a", "lora_gate_up_b", "lora_down_a",
                  "lora_down_b"):
            self.register_buffer(b, None)

    def from_float(self, gate_w, up_w, down_w) -> None:
        """Full float weights in [in, out] layout (or AWQ/GPTQ
        `QTensor`s); gate and up are fused column-wise ([gate | up]) as in
        the JAX package at tp = 1."""
        self.gate_up.from_float(wcat([gate_w, up_w]))
        self.down.from_float(down_w)

    def forward(self, x: torch.Tensor,
                lora_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        gu = self.gate_up(x)
        if lora_ids is not None and self.lora_gate_up_a is not None:
            gu = apply_lora(x, gu, (self.lora_gate_up_a, self.lora_gate_up_b),
                            lora_ids)
        i = self.intermediate_size
        gate, up = gu[..., :i], gu[..., i:]
        h = (ACTIVATIONS[self.activation](gate.to(torch.float32))
             * up.to(torch.float32)).to(x.dtype)
        y = self.down(h)
        if lora_ids is not None and self.lora_down_a is not None:
            y = apply_lora(h, y, (self.lora_down_a, self.lora_down_b),
                           lora_ids)
        return y
