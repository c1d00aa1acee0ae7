"""RMSNorm, the fused residual-add + RMSNorm, and LayerNorm.

Counterpart of `tensorrt_llm_tpu/ops/norms.py`.  The JAX package leaves these
to XLA, so the port leaves them to plain PyTorch: compute in f32, round once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)


def add_rms_norm(x: torch.Tensor, residual: Optional[torch.Tensor],
                 weight: torch.Tensor, eps: float = 1e-6
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual add then RMSNorm.  Returns (normed, new_residual)."""
    if residual is not None:
        x = (x.to(torch.float32) + residual.to(torch.float32)).to(x.dtype)
    return rms_norm(x, weight, eps), x


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], eps: float = 1e-5
               ) -> torch.Tensor:
    """LayerNorm over the last axis with weight and optional bias (the DSA
    indexer's key norm)."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)
