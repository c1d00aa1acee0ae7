"""Gated MLP (SwiGLU / GeGLU) and the non-gated MLP.

Counterparts of `GatedMLP` and `MLP` in `tensorrt_llm_tpu/layers/mlp.py`.
`GatedMLP`: one fused gate+up projection (one pass over the weights), the
gate activation times up in f32, then down.  With multi-LoRA stacks
(``lora_gate_up_*``, ``lora_down_*``) and `lora_ids`, each row's adapter
product follows gate_up and down (JAX `layers/mlp.py:95-106`).  `MLP`:
up -> activation -> down, both optionally biased (Starcoder2's c_fc /
c_proj, Nemotron's squared ReLU, Apertus's learned xIELU); the activation
runs in f32 on the bf16 output of up, outside the kernel, as the JAX
package applies it outside its Pallas call."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
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


class MLP(nn.Module):
    """Non-gated MLP: up -> activation -> down (JAX `layers/mlp.py:111`).
    Under ``activation="xielu"`` it holds the learned ``alpha_p`` /
    ``alpha_n`` ([1] f32 each, HF's ``mlp.act_fn.*``)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 activation: str = "gelu", has_bias: bool = False,
                 quant: Optional[QuantConfig] = None):
        super().__init__()
        self.activation = activation
        self.has_bias = has_bias
        self.up = Linear(hidden_size, intermediate_size, quant, "mlp")
        self.down = Linear(intermediate_size, hidden_size, quant, "mlp")
        self.register_buffer("alpha_p", None)
        self.register_buffer("alpha_n", None)

    def from_float(self, up_w, down_w, up_b=None, down_b=None,
                   act=None) -> None:
        """Float weights [in, out] (or `QTensor`s) and biases; under xIELU
        `act` holds the learned ``{"alpha_p", "alpha_n"}``."""
        self.up.from_float(up_w, up_b if self.has_bias else None)
        self.down.from_float(down_w, down_b if self.has_bias else None)
        if self.activation == "xielu":
            self.alpha_p = act["alpha_p"].to(torch.float32).reshape(1)
            self.alpha_n = act["alpha_n"].to(torch.float32).reshape(1)

    def forward(self, x: torch.Tensor,
                lora_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.up(x).to(torch.float32)
        if self.activation == "xielu":
            h = xielu(h, self.alpha_p, self.alpha_n)
        else:
            h = ACTIVATIONS[self.activation](h)
        return self.down(h.to(x.dtype))


def xielu(x: torch.Tensor, alpha_p: torch.Tensor, alpha_n: torch.Tensor,
          beta: float = 0.5, eps: float = -1e-6) -> torch.Tensor:
    """xIELU (arXiv:2411.13010; JAX `_xielu`, HF
    `XIELUActivation._xielu_python`) in f32: alpha_p x^2 + beta x for
    x > 0, (expm1(min(x, eps)) - x) alpha_n + beta x otherwise, with
    alpha_p = softplus(a_p) and alpha_n = beta + softplus(a_n)."""
    ap = F.softplus(alpha_p.to(torch.float32))
    an = beta + F.softplus(alpha_n.to(torch.float32))
    return torch.where(x > 0, ap * x * x + beta * x,
                       (torch.expm1(torch.clamp(x, max=eps)) - x) * an
                       + beta * x)
