"""Quantization calibration: the clip-ratio search for int4 groups.

Counterpart of `tensorrt_llm_tpu/quantization/calibrate.py`.  Plain
absmax rounding spends the int4 grid on outliers; for every group the scale
``absmax * r`` is tried over `CLIP_GRID` and the ratio with the least
(optionally activation-weighted) reconstruction error wins.  All groups of
a layer are searched at once, in f32, with the JAX package's arithmetic:
the same scales and ints wherever the errors of two ratios are not within
the summation order's rounding of each other (the sums over a group run in
another order than XLA's, so such a near-tie may go the other way; both
choices then reconstruct equally well).  Divisions by a Python number go
through `div_scalar`, so the card picks what the CPU picks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tensorrt_llm_tpu_torch.utils import div_scalar

# candidate clip ratios (1.0 == plain absmax rounding)
CLIP_GRID = (1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7)


def quantize_w4_calibrated(
    w: torch.Tensor,
    group_size: int = 128,
    symmetric: bool = True,
    act_scales: Optional[torch.Tensor] = None,
    clip_grid: Tuple[float, ...] = CLIP_GRID,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Per-group int4 quantization of ``[K, N]`` with the clip-ratio search:
    the ratio r minimising ``sum_k a_k (w_k - deq(q_k))^2`` over each group,
    a_k an optional per-input-channel activation weight (normalised to mean
    1).  Returns ``(q int8, scales f32, zeros f32 or None)`` as
    `quantize_w4` does."""
    K, N = w.shape
    G = K if group_size in (-1, 0) else group_size
    assert K % G == 0
    wg = w.to(torch.float32).reshape(K // G, G, N)
    aw = None
    if act_scales is not None:
        aw = torch.as_tensor(act_scales, dtype=torch.float32,
                             device=w.device).reshape(K // G, G, 1)
        aw = aw / torch.clamp(aw.mean(), min=1e-8)

    def err_for(scales, zeros):
        q = torch.round(wg / scales[:, None, :])
        if zeros is not None:
            q = torch.clamp(q + zeros[:, None, :], 0, 15)
            deq = (q - zeros[:, None, :]) * scales[:, None, :]
        else:
            q = torch.clamp(q, -8, 7)
            deq = q * scales[:, None, :]
        e = torch.square(wg - deq)
        if aw is not None:
            e = e * aw
        return e.sum(dim=1)                             # [K//G, N]

    if symmetric:
        absmax = wg.abs().amax(dim=1)                   # [K//G, N]
        best_err, best_r = None, None
        for r in clip_grid:
            e = err_for(torch.clamp(div_scalar(absmax * r, 7.0), min=1e-8),
                        None)
            if best_err is None:
                best_err, best_r = e, torch.full_like(absmax, r)
            else:
                take = e < best_err
                best_err = torch.where(take, e, best_err)
                best_r = torch.where(take, r, best_r)
        scales = torch.clamp(div_scalar(absmax * best_r, 7.0), min=1e-8)
        q = torch.clamp(torch.round(wg / scales[:, None, :]), -8, 7)
        return q.reshape(K, N).to(torch.int8), scales, None

    wmax = wg.amax(dim=1)
    wmin = wg.amin(dim=1)
    best = None
    for r in clip_grid:
        span = torch.clamp(div_scalar((wmax - wmin) * r, 15.0), min=1e-8)
        zu = torch.clamp(torch.round(-wmin * r / span), 0, 15)
        e = err_for(span, zu)
        if best is None:
            best = (e, span, zu)
        else:
            take = e < best[0]
            best = (torch.where(take, e, best[0]),
                    torch.where(take, span, best[1]),
                    torch.where(take, zu, best[2]))
    _, scales, zu = best
    q = torch.clamp(torch.round(wg / scales[:, None, :]) + zu[:, None, :],
                    0, 15) - 8
    return q.reshape(K, N).to(torch.int8), scales, zu - 8


def weight_mse(w: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
               zeros: Optional[torch.Tensor], group_size: int) -> float:
    """Reconstruction mean squared error of a quantization (diagnostic)."""
    K, N = w.shape
    G = K if group_size in (-1, 0) else group_size
    qg = q.to(torch.float32).reshape(K // G, G, N)
    if zeros is not None:
        qg = qg - zeros.to(torch.float32)[:, None, :]
    deq = (qg * scales.to(torch.float32)[:, None, :]).reshape(K, N)
    return float(torch.mean(torch.square(w.to(torch.float32) - deq)))
