"""Beam search over the paged KV cache.

Counterpart of `tensorrt_llm_tpu/runtime/beam_search.py`: a request's beams
are separate paged KV sequences that share their immutable prefix blocks by
ref count (`KVCacheManager.fork_sequence`), each with a private tail block
that the engine copies on the device (`ModelEngine.copy_kv_blocks`), so a
fork costs one page copy.  The prefill logits seed `width` beams (every
fork made before any beam is admitted, so a beam that ends at once cannot
free the sequence the others fork from); each executor iteration then
advances all live beams of a request as one batched decode step
(`run_decode` on the beams' rows) and reorders them on the host in numpy:
``2 x width`` candidates (enough for `width` EOS hits and `width`
continuations), the first child of a parent inheriting its sequence and
further children forking it, childless parents freed.  Finished beams are
scored ``cum / len ** length_penalty`` (raw cumulative logprob at 0); with
no length penalty the search stops as soon as no live beam can beat the
`width`-th finished one.  `beam_width_array` widens (extra children of the
best parents) or narrows (dropped beams freed) the width step by step, its
last entry holding after its end.  Every beam keeps per-token logprobs of
its chosen tokens; `apply_to_request` leaves the best `n` beams in
`req.beam_outputs` and the best one as the request's output.

One change from the JAX package, which decodes every beam step of a
`lora_request` on the base model (its beam sequences carry no adapter
slot): a beam sequence carries its request's `lora_slot`, so every step
runs with the adapter its prefill ran with.

A fork or a growth that finds no free block raises `OutOfBlocksError`; the
executor then ends this request alone with an error (`abort` frees every
sequence the search holds).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from tensorrt_llm_tpu_torch.runtime.request import FinishReason, LlmRequest


class _BeamSeq:
    """A beam: a duck-typed request for `ModelEngine.prepare_decode_inputs`
    (id, tokens, adapter slot) with its chosen tokens' logprobs."""

    __slots__ = ("request_id", "tokens", "lps", "lora_slot")

    def __init__(self, request_id: int, tokens: List[int],
                 lps: Optional[List[float]] = None, lora_slot: int = 0):
        self.request_id = request_id
        self.tokens = tokens
        self.lps = lps if lps is not None else []
        self.lora_slot = lora_slot

    @property
    def all_token_ids(self) -> List[int]:
        return self.tokens

    @property
    def num_tokens(self) -> int:
        return len(self.tokens)


def _log_softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


def _new_seq_id() -> int:
    """A beam sequence id from the request id counter (never a request's)."""
    LlmRequest._id_counter += 1
    return LlmRequest._id_counter


class BeamSearch:
    """The beam state machine of one request."""

    def __init__(self, req: LlmRequest, kv, engine,
                 eos_token_id: Optional[int], max_seq_len: int):
        sp = req.sampling_params
        self.req = req
        self.kv = kv
        self.engine = engine
        self.width = sp.best_of or sp.n
        self.width_array = list(sp.beam_width_array or [])
        self._step_idx = 0
        if self.width_array:
            self.width = self.width_array[0]
        self.eos = sp.end_id if sp.end_id is not None else eos_token_id
        self.max_seq_len = max_seq_len
        self.length_penalty = sp.length_penalty
        self.live: List[Tuple[_BeamSeq, float]] = []     # (beam, cum logp)
        # finished beams: (output tokens, score, per-token logprobs)
        self.finished: List[Tuple[List[int], float, List[float]]] = []
        self.done = False
        self._held = {req.request_id}    # KV sequences this search holds

    # ---- KV ---------------------------------------------------------------
    def _fork(self, src: int) -> int:
        sid = _new_seq_id()
        pairs = self.kv.fork_sequence(src, sid)
        self._held.add(sid)
        # VSWA: the fork takes a ring slot of its own, a copy of the
        # source's ring (raises, like the pool, when none is free)
        ring = self.kv.ring_fork_pairs(src, sid)
        self.engine.copy_kv_blocks(pairs, ring)
        return sid

    def _free(self, sid: int) -> None:
        self.kv.free_sequence(sid)
        self._held.discard(sid)

    def abort(self) -> None:
        """Free every sequence the search holds (the request ended)."""
        for sid in list(self._held):
            self._free(sid)
        self.live = []
        self.done = True

    # ---- lifecycle --------------------------------------------------------
    def init_from_logits(self, logits_row: np.ndarray) -> None:
        """Seed `width` beams from the prefill logits (the top-`width` first
        tokens): beam 0 takes the request's sequence, the others fork it,
        all before any is admitted."""
        logp = _log_softmax(np.asarray(logits_row, np.float32))
        top = np.argsort(logp)[::-1][:self.width]
        prompt = list(self.req.prompt_token_ids)
        rid = self.req.request_id
        seeded = [(rid if j == 0 else self._fork(rid), int(tok))
                  for j, tok in enumerate(top)]
        slot = self.req.lora_slot
        for sid, tok in seeded:
            self._admit(_BeamSeq(sid, prompt + [tok], [float(logp[tok])],
                                 slot), float(logp[tok]))
        self._check_done()

    def _score(self, tokens_out_len: int, cum: float) -> float:
        if self.length_penalty > 0:
            return cum / (tokens_out_len ** self.length_penalty)
        return cum

    def _ends(self, tok: int, out_len: int, num_tokens: int) -> bool:
        """Whether a beam ending in `tok` with `out_len` outputs and
        `num_tokens` tokens in all is finished."""
        sp = self.req.sampling_params
        hit_eos = (self.eos is not None and not sp.ignore_eos
                   and tok == self.eos) or tok in (sp.stop_token_ids or ())
        return hit_eos or out_len >= sp.max_tokens \
            or num_tokens >= self.max_seq_len

    def _admit(self, seq: _BeamSeq, cum: float) -> None:
        """Place a freshly extended beam into live or finished."""
        out_len = seq.num_tokens - self.req.prompt_len
        if self._ends(seq.tokens[-1], out_len, seq.num_tokens):
            self.finished.append((seq.tokens[self.req.prompt_len:],
                                  self._score(out_len, cum), list(seq.lps)))
            self._free(seq.request_id)
        else:
            self.live.append((seq, cum))

    # ---- one decode step --------------------------------------------------
    def step(self) -> int:
        """One batched decode step over the live beams and their
        reordering; returns the rows decoded."""
        if self.done:
            return 0
        self._step_idx += 1
        if self.width_array:
            self.width = self.width_array[
                min(self._step_idx, len(self.width_array) - 1)]
        k = len(self.live)
        seqs = [s for s, _ in self.live]
        cums = np.array([c for _, c in self.live], np.float32)
        for s in seqs:
            self.kv.grow_sequence(s.request_id, s.num_tokens)
        inputs = self.engine.prepare_decode_inputs(seqs)
        logits = self.engine.run_decode(inputs).cpu().numpy()[:k]
        logp = _log_softmax(logits.astype(np.float32))         # [k, V]
        V = logp.shape[1]
        cand = (cums[:, None] + logp).reshape(-1)                # [k*V]
        n_cand = min(2 * self.width, cand.size)
        idx = np.argpartition(cand, -n_cand)[-n_cand:]
        idx = idx[np.argsort(cand[idx])[::-1]]

        # successors best first: (parent, token, cum)
        new_live: List[Tuple[int, int, float]] = []
        P = self.req.prompt_len
        for flat in idx:
            parent, tok = divmod(int(flat), V)
            ps = seqs[parent]
            out_len = ps.num_tokens + 1 - P
            if self._ends(tok, out_len, ps.num_tokens + 1):
                if len(self.finished) < 2 * self.width:
                    self.finished.append(
                        (ps.tokens[P:] + [tok],
                         self._score(out_len, float(cand[flat])),
                         ps.lps + [float(logp[parent, tok])]))
            elif len(new_live) < self.width:
                new_live.append((parent, tok, float(cand[flat])))
            if len(new_live) >= self.width:
                break

        # re-sequence the KV: a parent's first child inherits its
        # sequence, further children fork it; childless parents are freed
        children_of = {}
        for j, (parent, _, _) in enumerate(new_live):
            children_of.setdefault(parent, []).append(j)
        next_live: List[Optional[Tuple[_BeamSeq, float]]] = \
            [None] * len(new_live)
        for parent, childs in children_of.items():
            ps = seqs[parent]
            for ci, j in enumerate(childs):
                _, tok, cum = new_live[j]
                sid = ps.request_id if ci == 0 else self._fork(ps.request_id)
                next_live[j] = (_BeamSeq(
                    sid, ps.tokens + [tok],
                    ps.lps + [float(logp[parent, tok])], ps.lora_slot), cum)
        for i, s in enumerate(seqs):
            if i not in children_of:
                self._free(s.request_id)
        self.live = [b for b in next_live if b is not None]
        self._check_done()
        return k

    def _check_done(self) -> None:
        if self.live and len(self.finished) >= self.width:
            best_live = max(c for _, c in self.live)
            worst_kept = sorted((t[1] for t in self.finished),
                                reverse=True)[self.width - 1]
            # logprob sums only fall (no length penalty): no live beam can
            # beat the kept set any more
            if self.length_penalty == 0 and best_live <= worst_kept:
                self._finalize()
                return
        if not self.live:
            self._finalize()

    def _finalize(self) -> None:
        for s, c in self.live:
            out_len = s.num_tokens - self.req.prompt_len
            self.finished.append((s.tokens[self.req.prompt_len:],
                                  self._score(max(out_len, 1), c),
                                  list(s.lps)))
            self._free(s.request_id)
        self.live = []
        self.finished.sort(key=lambda t: t[1], reverse=True)
        self.finished = self.finished[:self.width]
        self.done = True

    # ---- results -----------------------------------------------------------
    def apply_to_request(self) -> None:
        """Leave the best `n` beams in `req.beam_outputs` and the best beam
        as the request's output, and finish the request (the executor
        delivers it)."""
        req = self.req
        sp = req.sampling_params
        n = min(sp.n, len(self.finished))
        req.beam_outputs = [
            {"token_ids": toks, "cumulative_logprob": score,
             "logprobs": ([{t: lp} for t, lp in zip(toks, lps)]
                          if sp.logprobs else None)}
            for toks, score, lps in self.finished[:n]]
        best = self.finished[0][0] if self.finished else []
        req.output_token_ids = list(best)
        reason = (FinishReason.EOS if best and self.eos is not None
                  and best[-1] == self.eos else FinishReason.LENGTH)
        req.finish(reason)
