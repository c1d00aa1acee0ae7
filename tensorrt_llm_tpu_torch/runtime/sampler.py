"""Batched token sampler: greedy, temperature, top-k, top-p, min-p.

Counterpart of `tensorrt_llm_tpu/runtime/sampler.py`, on the device with no
host sync.  Greedy rows take the first maximal logit, exactly as the JAX
package does.  Other rows sample with the Gumbel-max trick; the noise comes
from a `torch.Generator` seeded per row from the request seed (or a default
derived from the row) and the step, so a run is reproducible.  It cannot
replay the JAX package's `jax.random` draws, so non-greedy sampling is held
to the reference only statistically.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from tensorrt_llm_tpu_torch.llmapi.sampling_params import SamplingParams

NEG_INF = float(torch.finfo(torch.float32).min)
_GOLDEN = 2654435761


def row_seeds(params: List[SamplingParams], step: int) -> List[int]:
    return [(((p.seed if p.seed is not None else 0x9E3779B9 + i)
              & 0xFFFFFFFF) ^ ((step * _GOLDEN) & 0xFFFFFFFF))
            for i, p in enumerate(params)]


def sample_tokens(logits: torch.Tensor, params: List[SamplingParams],
                  step: int = 0, step_offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B, V] f32 (rows past len(params) are padding and sampled
    greedily).  Returns (tokens [B] int32, logprob of each token [B])."""
    B, V = logits.shape
    tokens = torch.argmax(logits, dim=-1)
    sampled_rows = [i for i, p in enumerate(params) if not p.greedy]
    if sampled_rows:
        dev = logits.device
        rows = torch.tensor(sampled_rows, device=dev)
        ps = [params[i] for i in sampled_rows]
        temp = torch.tensor([max(p.temperature, 1e-5) for p in ps],
                            device=dev)[:, None]
        scaled = logits[rows] / temp
        topk = [p.top_k for p in ps]
        if any(k > 0 for k in topk):
            kmax = max(topk)
            topv = torch.topk(scaled, kmax, dim=-1).values
            kidx = torch.tensor([max(k, 1) - 1 for k in topk], device=dev)
            kth = topv.gather(1, kidx[:, None])
            use = torch.tensor([k > 0 for k in topk], device=dev)[:, None]
            scaled = torch.where(use & (scaled < kth), NEG_INF, scaled)
        probs = torch.softmax(scaled, dim=-1)
        sp, si = torch.sort(probs, dim=-1, descending=True)
        topp = torch.tensor([p.top_p for p in ps], device=dev)[:, None]
        keep_sorted = (torch.cumsum(sp, dim=-1) - sp) < topp
        keep = torch.zeros_like(keep_sorted).scatter(1, si, keep_sorted)
        scaled = torch.where(keep, scaled, NEG_INF)
        minp = torch.tensor([p.min_p for p in ps], device=dev)[:, None]
        pmax = probs.amax(dim=-1, keepdim=True)
        scaled = torch.where(probs < minp * pmax, NEG_INF, scaled)
        seeds = row_seeds(params, step)
        noise = []
        for i in sampled_rows:
            g = torch.Generator(device=dev)
            g.manual_seed((seeds[i] + step_offset * _GOLDEN) & 0xFFFFFFFF)
            u = torch.rand(V, generator=g, device=dev).clamp_(1e-20, 1.0)
            noise.append(-torch.log(-torch.log(u)))
        drawn = torch.argmax(scaled + torch.stack(noise), dim=-1)
        tokens = tokens.index_copy(0, rows, drawn)
    tokens = tokens.to(torch.int32)
    logp = torch.log_softmax(logits, dim=-1).gather(
        1, tokens.to(torch.int64)[:, None])[:, 0]
    return tokens, logp
