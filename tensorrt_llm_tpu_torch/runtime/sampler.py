"""Batched token sampler: greedy, temperature, top-k, top-p, min-p.

Counterpart of `tensorrt_llm_tpu/runtime/sampler.py`, on the device with no
host sync: the per-row parameters of the sampled rows are uploaded once per
decode chunk (`SamplingState`, through pinned memory on a CUDA device) and
every step of the chunk reuses them.  Greedy rows take the first maximal
logit, exactly as the JAX package does.  Other rows sample with the
Gumbel-max trick; the noise comes from a `torch.Generator` seeded per row
from the request seed (or, without one, a default derived from the request
id) and the output position of the token drawn, so a seeded request draws
the same tokens in any batch, path and iteration (the JAX package folds the
executor's iteration and the row instead, so its seeded runs repeat only
under the same schedule).  It cannot replay the JAX package's `jax.random`
draws, so non-greedy sampling is held to the reference only statistically.

The host logits path (one decode step at a time, see the executor) edits a
step's logits before sampling, on their device: `apply_penalties`
(repetition, presence and frequency, the JAX math) on counts that
`TokenCounts` keeps on the device, a row per request, and
`apply_logit_controls` (logit bias, min-tokens, bad words, no repeated
n-gram, the request's `logits_processor`), the JAX executor's
`_apply_logit_controls`.  `top_n_logprobs` gives the top-N logprobs of the
edited distribution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorrt_llm_tpu_torch.llmapi.sampling_params import SamplingParams
from tensorrt_llm_tpu_torch.utils import upload

NEG_INF = float(torch.finfo(torch.float32).min)
BANNED = -1e30          # a token a logit control rules out
_GOLDEN = 2654435761


def row_seeds(params: List[SamplingParams], request_ids: Sequence[int],
              positions: Sequence[int]) -> List[int]:
    """Each row's noise seed: its request seed (or a default derived from
    its request id) folded with the output position of the token it
    draws."""
    return [(((p.seed if p.seed is not None else 0x9E3779B9 + rid)
              & 0xFFFFFFFF) ^ ((pos * _GOLDEN) & 0xFFFFFFFF))
            for p, rid, pos in zip(params, request_ids, positions)]


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
                  request_ids: Sequence[int], positions: Sequence[int],
                  step_offset: int = 0,
                  state: Optional[SamplingState] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B, V] f32 (rows past len(params) are padding and sampled
    greedily).  `positions` gives each request's output position at step
    offset 0 (the tokens it has, applied or dispatched); a step of a chunk
    draws at ``position + step_offset``.  `state` is
    `SamplingState.build(params, device)`, made once for the steps of a
    chunk (built here when not given).  Returns (tokens [B] int32, logprob
    of each token [B])."""
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
        seeds = row_seeds(params, request_ids,
                          [p + step_offset for p in positions])
        noise = []
        for i in (i for i, p in enumerate(params) if not p.greedy):
            g = torch.Generator(device=dev)
            g.manual_seed(seeds[i])
            u = torch.rand(V, generator=g, device=dev).clamp_(1e-20, 1.0)
            noise.append(-torch.log(-torch.log(u)))
        drawn = torch.argmax(scaled + torch.stack(noise), dim=-1)
        tokens = tokens.index_copy(0, state.rows, drawn)
    tokens = tokens.to(torch.int32)
    logp = torch.log_softmax(logits, dim=-1).gather(
        1, tokens.to(torch.int64)[:, None])[:, 0]
    return tokens, logp


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    repetition: torch.Tensor, presence: torch.Tensor,
                    frequency: torch.Tensor) -> torch.Tensor:
    """JAX `sampler.apply_penalties`: logits [B, V] f32, counts [B, V] of
    each token in each sequence (prompt and output), the three penalties
    [B].  A seen token's positive logit is divided by the repetition
    penalty and a negative one multiplied; then the presence penalty comes
    off every seen token and the frequency penalty times its count."""
    seen = counts > 0
    rep = repetition[:, None]
    logits = torch.where(seen & (logits > 0), logits / rep,
                         torch.where(seen, logits * rep, logits))
    logits = logits - presence[:, None] * seen.to(torch.float32)
    return logits - frequency[:, None] * counts.to(torch.float32)


def top_n_logprobs(logits: torch.Tensor, n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-n (logprob, token) of each row of logits [B, V]."""
    vals, idx = torch.topk(torch.log_softmax(logits, dim=-1), n, dim=-1)
    return vals, idx


class TokenCounts:
    """Token counts of the penalised requests on the device: one int32
    row of [V] per request (ids taken modulo V, as the JAX executor's host
    counts), in one pool that doubles when full.  `rows` adds the tokens
    each request appended since its last call with one upload, and returns
    the requests' rows; `drop` frees a finished request's row."""

    def __init__(self, vocab_size: int, device):
        self.vocab_size = vocab_size
        self.device = torch.device(device)
        self.pool: Optional[torch.Tensor] = None
        self.slot = {}          # request id -> pool row
        self.seen = {}          # request id -> tokens counted
        self.free: List[int] = []

    def _take(self) -> int:
        if not self.free:
            old = 0 if self.pool is None else self.pool.shape[0]
            pool = torch.zeros((max(8, 2 * old), self.vocab_size),
                               dtype=torch.int32, device=self.device)
            if old:
                pool[:old] = self.pool
            self.pool = pool
            self.free = list(range(pool.shape[0] - 1, old - 1, -1))
        return self.free.pop()

    def rows(self, reqs) -> torch.Tensor:
        V = self.vocab_size
        slots, pairs = [], []
        for r in reqs:
            rid = r.request_id
            toks = r.all_token_ids
            if rid not in self.slot:
                self.slot[rid] = self._take()
                self.pool[self.slot[rid]].zero_()
                self.seen[rid] = 0
            s = self.slot[rid]
            pairs += [(s, int(t) % V) for t in toks[self.seen[rid]:]]
            self.seen[rid] = len(toks)
            slots.append(s)
        if pairs:
            idx = upload(np.asarray(pairs, np.int64).T.copy(), self.device)
            self.pool.index_put_(
                (idx[0], idx[1]),
                torch.ones(len(pairs), dtype=torch.int32, device=self.device),
                accumulate=True)
        return self.pool.index_select(
            0, upload(np.asarray(slots, np.int64), self.device))

    def drop(self, request_id: int) -> None:
        s = self.slot.pop(request_id, None)
        if s is not None:
            self.seen.pop(request_id)
            self.free.append(s)


def has_penalties(sp: SamplingParams) -> bool:
    return (sp.repetition_penalty != 1.0 or sp.presence_penalty != 0.0
            or sp.frequency_penalty != 0.0)


def has_logit_controls(sp: SamplingParams) -> bool:
    return bool(sp.min_tokens or sp.bad_words or sp.logit_bias
                or sp.no_repeat_ngram_size
                or sp.logits_processor is not None)


def apply_logit_controls(logits: torch.Tensor, reqs,
                         eos_token_id: Optional[int],
                         failed: Optional[dict] = None) -> torch.Tensor:
    """The JAX executor's `_apply_logit_controls` on the logits' device:
    row i of logits [B, V] belongs to ``reqs[i]`` (``sampling_params``,
    ``all_token_ids``, ``num_output_tokens``).  In each row with a
    control: `logit_bias` is added; the end id (the request's `end_id`, or
    `eos_token_id`) and the stop ids are banned (`BANNED`) before
    `min_tokens` outputs; the last token of every bad word whose other
    tokens end the sequence is banned, as is every token that would repeat
    an n-gram of `no_repeat_ngram_size`; then `logits_processor(token_ids,
    row)` gets the row (a tensor on the logits' device, which it may edit
    in place) and returns the new row as a tensor or an array.  All biases
    and bans go up in one upload.  A processor that raises fails its row
    into `failed` (row -> error) when given, else the exception propagates.
    Returns a new tensor when a row has a control, else `logits` itself."""
    bias, ban, procs = [], [], []
    for i, r in enumerate(reqs):
        sp = r.sampling_params
        if not has_logit_controls(sp):
            continue
        toks = r.all_token_ids
        if sp.logit_bias:
            bias += [(i, int(t), float(b)) for t, b in sp.logit_bias.items()]
        if sp.min_tokens and r.num_output_tokens < sp.min_tokens:
            eos = sp.end_id if sp.end_id is not None else eos_token_id
            ban += [(i, int(t)) for t in ([eos] if eos is not None else [])
                    + list(sp.stop_token_ids or [])]
        for w in sp.bad_words or ():
            if len(w) == 1 or (len(toks) >= len(w) - 1
                               and toks[-(len(w) - 1):] == list(w[:-1])):
                ban.append((i, int(w[-1])))
        n = sp.no_repeat_ngram_size
        if n and len(toks) >= n - 1:
            tail = tuple(toks[-(n - 1):]) if n > 1 else ()
            ban += [(i, int(toks[j + n - 1]))
                    for j in range(len(toks) - n + 1)
                    if tuple(toks[j:j + n - 1]) == tail]
        if sp.logits_processor is not None:
            procs.append((i, r))
    if not (bias or ban or procs):
        return logits
    out = logits.to(torch.float32, copy=True)
    dev = out.device
    if bias:
        b = np.asarray(bias, np.float64)
        idx = upload(b[:, :2].T.astype(np.int64), dev)
        out.index_put_((idx[0], idx[1]),
                       upload(b[:, 2].astype(np.float32), dev),
                       accumulate=True)
    if ban:
        idx = upload(np.asarray(ban, np.int64).T.copy(), dev)
        out.index_put_((idx[0], idx[1]),
                       torch.full((len(ban),), BANNED, dtype=torch.float32,
                                  device=dev))
    for i, r in procs:
        try:
            row = r.sampling_params.logits_processor(list(r.all_token_ids),
                                                     out[i])
            out[i] = torch.as_tensor(row, dtype=torch.float32).to(dev)
        except Exception as exc:  # noqa: BLE001 -- ends its request
            if failed is None:
                raise
            failed[i] = f"logits processor: {exc!r}"
    return out
