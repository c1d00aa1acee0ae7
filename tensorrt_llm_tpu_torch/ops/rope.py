"""Rotary position embeddings (NeoX rotate-half), plain PyTorch.

Counterpart of `tensorrt_llm_tpu/ops/rope.py` for the Llama family with base
frequencies.  Frequency scaling (linear, llama3, YaRN), mrope, partial
rotary and the interleaved layout belong to later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class RopeConfig:
    head_dim: int = 128
    theta: float = 10000.0
    max_position: int = 8192


def make_rope_tables(cfg: RopeConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [max_position, head_dim // 2], f32."""
    dim = cfg.head_dim
    inv = 1.0 / (cfg.theta ** (torch.arange(0, dim, 2, dtype=torch.float32)
                               / dim))
    freqs = torch.outer(torch.arange(cfg.max_position, dtype=torch.float32),
                        inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               cos_table: torch.Tensor, sin_table: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q [T, H, D] and k [T, Hkv, D] at `positions` [T], in f32."""
    half = cos_table.shape[-1]
    cos = cos_table[positions][:, None, :]
    sin = sin_table[positions][:, None, :]

    def rotate(x):
        x1 = x[..., :half].to(torch.float32)
        x2 = x[..., half:2 * half].to(torch.float32)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.to(x.dtype)

    return rotate(q), rotate(k)
