"""NGram draft proposer.

Counterpart of `tensorrt_llm_tpu/speculative/ngram.py` (the reference's
NGramPoolManager), line for line: propose the continuation that followed
the most recent occurrence of the sequence's tail n-gram, longest n first.
Host only; no device work.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from tensorrt_llm_tpu_torch.speculative.interface import (
    Drafter, SpeculativeConfig)


class NGramDrafter(Drafter):
    def __init__(self, cfg: SpeculativeConfig):
        self.cfg = cfg
        # per request: ngram tuple -> continuation (most recent wins)
        self._pools: Dict[int, Dict[Tuple[int, ...], List[int]]] = {}
        self._indexed_upto: Dict[int, int] = {}

    def _index(self, request):
        """Index every (ngram -> next tokens) of the sequence, from where
        the last call stopped."""
        toks = request.all_token_ids
        pool = self._pools.setdefault(request.request_id, {})
        start = self._indexed_upto.get(request.request_id, 0)
        k = self.cfg.max_draft_len
        # re-index the last k positions too: their continuations were cut
        # at the then-end of the sequence
        start = max(0, start - k)
        for n in range(1, self.cfg.max_matching_ngram_size + 1):
            for i in range(max(n, start), len(toks)):
                pool[tuple(toks[i - n:i])] = toks[i:i + k]
        self._indexed_upto[request.request_id] = len(toks)

    def propose(self, request) -> List[int]:
        self._index(request)
        toks = request.all_token_ids
        pool = self._pools[request.request_id]
        for n in range(self.cfg.max_matching_ngram_size, 0, -1):
            if len(toks) < n:
                continue
            cont = pool.get(tuple(toks[-n:]))
            if cont:
                return list(cont[:self.cfg.max_draft_len])
        return []

    def on_request_finished(self, request):
        self._pools.pop(request.request_id, None)
        self._indexed_upto.pop(request.request_id, None)
