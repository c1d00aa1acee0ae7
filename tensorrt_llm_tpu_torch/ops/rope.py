"""Rotary position embeddings (NeoX rotate-half), plain PyTorch.

Counterpart of `tensorrt_llm_tpu/ops/rope.py`: base frequencies with
llama3 and YaRN scaling, and HunYuan's dynamic NTK by alpha (HF
`HunYuanDenseV1RotaryEmbedding`: the base times alpha^(D / (D - 2)) over
the head dim D, no attention factor; the JAX package's tables ignore that
type and keep the plain base).  YaRN (NTK-by-parts ramp, with HF's `truncate`
flag, DeepSeek's `mscale` / `mscale_all_dim` ratio) folds its attention
factor into the cos and sin tables, as the JAX package and HF do.  The
interleaved input layout (adjacent pairs, DeepSeek's MLA q_pe / k_pe) is
de-interleaved before the rotation and stays de-interleaved, as HF's
`apply_rotary_pos_emb_interleave` leaves it; GLM's GQA heads rotate
adjacent pairs too (`gqa_rope_interleave`), where the permutation is the
same on q and k and leaves the scores as they are.  Partial rotary
(`rotary_dim`, GLM and Nemotron) rotates the leading `rotary_dim` channels
of a head and passes the tail through.  mrope belongs to a later slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class RopeConfig:
    head_dim: int = 128
    theta: float = 10000.0
    max_position: int = 8192
    scaling_type: Optional[str] = None  # None | 'llama3' | 'yarn' | 'dynamic'
    scaling_factor: float = 1.0
    # llama3
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192
    # yarn
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: Optional[float] = None
    mscale_all_dim: Optional[float] = None
    attention_factor: Optional[float] = None
    truncate: bool = True
    # dynamic NTK by alpha (HunYuan); plain dynamic NTK (no alpha) raises
    alpha: Optional[float] = None
    # DeepSeek checkpoints store rope pairs interleaved (x0, y0, x1, y1, ...)
    interleaved: bool = False
    # partial rotary: only the leading rotary_dim channels rotate
    rotary_dim: Optional[int] = None


def _base_inv_freq(cfg: RopeConfig) -> torch.Tensor:
    dim = cfg.rotary_dim or cfg.head_dim
    base = cfg.theta
    if cfg.scaling_type == "dynamic":
        if not cfg.alpha:
            raise NotImplementedError(
                "dynamic NTK rope scaling without `alpha` is not in this "
                "slice")
        D = cfg.head_dim
        base = cfg.theta * cfg.alpha ** (D / (D - 2))
    return 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32)
                           / dim))


def _llama3_scale(cfg: RopeConfig, inv_freq: torch.Tensor) -> torch.Tensor:
    low_wl = cfg.original_max_position / cfg.low_freq_factor
    high_wl = cfg.original_max_position / cfg.high_freq_factor
    wavelen = 2 * math.pi / inv_freq
    scaled = inv_freq / cfg.scaling_factor
    smooth = (cfg.original_max_position / wavelen - cfg.low_freq_factor) / (
        cfg.high_freq_factor - cfg.low_freq_factor)
    smooth = torch.clamp(smooth, 0.0, 1.0)
    mid = (1 - smooth) * scaled + smooth * inv_freq
    return torch.where(wavelen > low_wl, scaled,
                       torch.where(wavelen < high_wl, inv_freq, mid))


def _yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _yarn_inv_freq(cfg: RopeConfig) -> Tuple[torch.Tensor, float]:
    """NTK-by-parts inverse frequencies and the attention factor (YaRN,
    arXiv:2309.00071), as HF `_compute_yarn_parameters`."""
    dim = cfg.rotary_dim or cfg.head_dim
    base, factor = cfg.theta, cfg.scaling_factor
    orig_max = cfg.original_max_position
    att = cfg.attention_factor
    if att is None:
        if cfg.mscale and cfg.mscale_all_dim:
            att = float(_yarn_mscale(factor, cfg.mscale)
                        / _yarn_mscale(factor, cfg.mscale_all_dim))
        else:
            att = _yarn_mscale(factor)

    def corr_dim(num_rot):
        return (dim * math.log(orig_max / (num_rot * 2 * math.pi))) / (
            2 * math.log(base))

    low, high = corr_dim(cfg.beta_fast), corr_dim(cfg.beta_slow)
    if cfg.truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp(
        (torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low),
        0, 1)
    extrap_factor = 1.0 - ramp
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    inv_extrap = 1.0 / pos_freqs
    inv_interp = 1.0 / (factor * pos_freqs)
    return inv_interp * (1 - extrap_factor) + inv_extrap * extrap_factor, att


def make_rope_tables(cfg: RopeConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [max_position, rotary_dim // 2] (rotary_dim
    defaults to head_dim), f32, with YaRN's attention factor folded in."""
    att = 1.0
    if cfg.scaling_type == "yarn":
        inv, att = _yarn_inv_freq(cfg)
    else:
        inv = _base_inv_freq(cfg)
        if cfg.scaling_type == "llama3":
            inv = _llama3_scale(cfg, inv)
        elif cfg.scaling_type not in (None, "dynamic"):
            raise NotImplementedError(
                f"rope scaling {cfg.scaling_type!r} is not in this slice")
    freqs = torch.outer(torch.arange(cfg.max_position, dtype=torch.float32),
                        inv)
    return torch.cos(freqs) * att, torch.sin(freqs) * att


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               cos_table: torch.Tensor, sin_table: torch.Tensor,
               interleaved: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q [T, H, D] and k [T, Hkv, D] at `positions` [T], in f32.
    The tables' width sets the rotated channels (2 x width); channels past
    them pass through.  `interleaved`: the rotated pairs are adjacent (x0,
    y0, x1, y1, ...); they are de-interleaved first and the output keeps
    the de-interleaved order."""
    half = cos_table.shape[-1]
    rot = 2 * half
    cos = cos_table[positions][:, None, :]
    sin = sin_table[positions][:, None, :]

    def rotate(x):
        xr, tail = x[..., :rot], x[..., rot:]
        if interleaved:
            s = xr.shape
            xr = xr.reshape(*s[:-1], half, 2).transpose(-1, -2).reshape(s)
        x1 = xr[..., :half].to(torch.float32)
        x2 = xr[..., half:].to(torch.float32)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                        dim=-1).to(x.dtype)
        return torch.cat([out, tail], dim=-1) if tail.shape[-1] else out

    return rotate(q), rotate(k)
