"""Batched token sampler: greedy, temperature, top-k, top-p, min-p.

Counterpart of `tensorrt_llm_tpu/runtime/sampler.py`, on the device with no
host sync: the per-row parameters of the sampled rows are uploaded once per
decode chunk (`SamplingState`, through pinned memory on a CUDA device) and
every step of the chunk reuses them.  Greedy rows take the first maximal logit, exactly as the JAX
package does.  Other rows sample with the Gumbel-max trick; the noise comes
from a `torch.Generator` seeded per row from the request seed (or a default
derived from the row) and the step, so a run is reproducible.  It cannot
replay the JAX package's `jax.random` draws, so non-greedy sampling is held
to the reference only statistically.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from tensorrt_llm_tpu_torch.llmapi.sampling_params import SamplingParams
from tensorrt_llm_tpu_torch.utils import upload

NEG_INF = float(torch.finfo(torch.float32).min)
_GOLDEN = 2654435761


def row_seeds(params: List[SamplingParams], step: int) -> List[int]:
    return [(((p.seed if p.seed is not None else 0x9E3779B9 + i)
              & 0xFFFFFFFF) ^ ((step * _GOLDEN) & 0xFFFFFFFF))
            for i, p in enumerate(params)]


@dataclass
class SamplingState:
    """The sampled (non-greedy) rows of a batch and their parameters as
    device tensors: rows [S], temperature/top-p/min-p [S, 1], the k-th
    index of top-k and its use [S, 1].  None of it exists for an all-greedy
    batch."""

    rows: torch.Tensor
    temp: torch.Tensor
    topk: List[int]
    kidx: Optional[torch.Tensor]
    use_k: Optional[torch.Tensor]
    topp: torch.Tensor
    minp: torch.Tensor

    @staticmethod
    def build(params: List[SamplingParams], device
              ) -> Optional["SamplingState"]:
        sampled = [i for i, p in enumerate(params) if not p.greedy]
        if not sampled:
            return None
        dev = torch.device(device)
        ps = [params[i] for i in sampled]
        f32 = np.float32

        def col(values, dtype):
            return upload(np.asarray(values, dtype)[:, None], dev)

        topk = [p.top_k for p in ps]
        any_k = any(k > 0 for k in topk)
        return SamplingState(
            rows=upload(np.asarray(sampled, np.int64), dev),
            temp=col([max(p.temperature, 1e-5) for p in ps], f32),
            topk=topk,
            kidx=(col([max(k, 1) - 1 for k in topk], np.int64)
                  if any_k else None),
            use_k=col([k > 0 for k in topk], np.bool_) if any_k else None,
            topp=col([p.top_p for p in ps], f32),
            minp=col([p.min_p for p in ps], f32))


def sample_tokens(logits: torch.Tensor, params: List[SamplingParams],
                  step: int = 0, step_offset: int = 0,
                  state: Optional[SamplingState] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B, V] f32 (rows past len(params) are padding and sampled
    greedily).  `state` is `SamplingState.build(params, device)`, made once
    for the steps of a chunk (built here when not given).  Returns
    (tokens [B] int32, logprob of each token [B])."""
    B, V = logits.shape
    tokens = torch.argmax(logits, dim=-1)
    if state is None:
        state = SamplingState.build(params, logits.device)
    if state is not None:
        dev = logits.device
        scaled = logits[state.rows] / state.temp
        if state.kidx is not None:
            topv = torch.topk(scaled, max(state.topk), dim=-1).values
            kth = topv.gather(1, state.kidx)
            scaled = torch.where(state.use_k & (scaled < kth), NEG_INF,
                                 scaled)
        probs = torch.softmax(scaled, dim=-1)
        sp, si = torch.sort(probs, dim=-1, descending=True)
        keep_sorted = (torch.cumsum(sp, dim=-1) - sp) < state.topp
        keep = torch.zeros_like(keep_sorted).scatter(1, si, keep_sorted)
        scaled = torch.where(keep, scaled, NEG_INF)
        pmax = probs.amax(dim=-1, keepdim=True)
        scaled = torch.where(probs < state.minp * pmax, NEG_INF, scaled)
        seeds = row_seeds(params, step)
        noise = []
        for i in (i for i, p in enumerate(params) if not p.greedy):
            g = torch.Generator(device=dev)
            g.manual_seed((seeds[i] + step_offset * _GOLDEN) & 0xFFFFFFFF)
            u = torch.rand(V, generator=g, device=dev).clamp_(1e-20, 1.0)
            noise.append(-torch.log(-torch.log(u)))
        drawn = torch.argmax(scaled + torch.stack(noise), dim=-1)
        tokens = tokens.index_copy(0, state.rows, drawn)
    tokens = tokens.to(torch.int32)
    logp = torch.log_softmax(logits, dim=-1).gather(
        1, tokens.to(torch.int64)[:, None])[:, 0]
    return tokens, logp
