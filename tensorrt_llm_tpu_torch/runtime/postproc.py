"""Asynchronous detokenization + stop-string scanning off the hot loop.

The port's own copy of `tensorrt_llm_tpu/runtime/postproc.py`, and the
port's one stop-string scan (it has no synchronous scan on the executor
thread).  The reference moves detokenization into dedicated postprocess
workers so the executor loop never runs Python text processing between
dispatches (`tensorrt_llm/executor/postproc_worker.py:52`).  In-process
single-controller design here: one daemon thread owns per-request
incremental detokenizer state and scans for textual stop strings; the
executor feeds raw token ids (cheap list slicing, no tokenizer calls on its
thread) and polls for hits each iteration.  Consequence, shared with the
reference: a stop string takes effect a few fused chunks late (the
pipeline's depth times k tokens at most) -- the executor truncates the
request's token list back to the token that completed the match, so results
are identical to a synchronous scan.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Tuple

from tensorrt_llm_tpu_torch.utils import logger


class _ReqScan:
    __slots__ = ("detok", "text", "n_tokens", "lens", "stops", "maxw",
                 "skip")

    def __init__(self, detok, stops: List[str], skip: bool):
        self.detok = detok
        self.text = ""          # bounded scan tail
        self.n_tokens = 0       # tokens consumed so far
        self.lens: List[int] = []  # text length after each consumed token
        self.stops = stops
        self.maxw = max(len(s) for s in stops)
        self.skip = skip        # request's skip_special_tokens


class StopScanWorker:
    """Daemon thread scanning streamed tokens for stop strings.

    Protocol: `feed(req_id, stops, tokens)` hands the request's FULL output
    token list (the worker tracks its own consumed prefix, so redundant
    feeds are cheap and idempotent); `poll()` returns `{req_id:
    (n_output_tokens_at_match, stop_string)}` for newly matched requests;
    `drop(req_id)` releases state when a request finishes for any reason.
    """

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self._q: "queue.Queue" = queue.Queue()
        self._state: Dict[int, _ReqScan] = {}
        self._hits: Dict[int, Tuple[int, str]] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tllm-stop-scan")
        self._thread.start()

    # ------------------------------------------------------------ executor side --
    def feed(self, req_id: int, stops: List[str], tokens: List[int],
             skip_special_tokens: bool = True):
        """Called from the executor thread: no tokenizer work here.
        `skip_special_tokens` must match the request's detokenization mode
        so the scanned text is the text the user receives."""
        self._q.put((req_id, stops, list(tokens), skip_special_tokens))

    def poll(self) -> Dict[int, Tuple[int, str]]:
        with self._lock:
            hits, self._hits = self._hits, {}
        return hits

    def take(self, req_id: int) -> Optional[Tuple[int, str]]:
        """Pop only this request's hit (used by the executor's finish path
        to reconcile a stop match with an EOS/length finish in the same
        fused chunk, without draining other requests' hits)."""
        with self._lock:
            return self._hits.pop(req_id, None)

    def drop(self, req_id: int):
        self._q.put((req_id, None, None))

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until everything queued so far has been scanned (tests /
        final-result path)."""
        done = threading.Event()
        self._q.put((None, None, done))
        return done.wait(timeout)

    def close(self):
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=2.0)

    # ------------------------------------------------------------- worker side --
    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            req_id, stops, tokens = item[0], item[1], item[2]
            if req_id is None:
                tokens.set()  # flush marker
                continue
            if stops is None:
                self._state.pop(req_id, None)
                with self._lock:
                    self._hits.pop(req_id, None)
                continue
            try:
                self._scan(req_id, stops, tokens, item[3])
            except Exception:  # noqa: BLE001 — scanning must never die
                logger.exception("stop-scan failed for request %d", req_id)
                self._state.pop(req_id, None)

    def _scan(self, req_id: int, stops: List[str], tokens: List[int],
              skip: bool):
        st = self._state.get(req_id)
        if st is None:
            from tensorrt_llm_tpu_torch.llmapi.detokenizer import (
                IncrementalDetokenizer)
            st = self._state[req_id] = _ReqScan(
                IncrementalDetokenizer(self.tokenizer, skip), stops, skip)
        if req_id in self._hits:
            return
        new = tokens[st.n_tokens:]
        for tok in new:
            st.text += st.detok.push([tok])
            st.n_tokens += 1
            st.lens.append(len(st.text))
            # bounded scan: a match must end within the newly added text
            start = max(0, (st.lens[-2] if len(st.lens) > 1 else 0)
                        - (st.maxw - 1))
            window = st.text[start:]
            for s in st.stops:
                if s in window:
                    with self._lock:
                        self._hits[req_id] = (st.n_tokens, s)
                    return
            # keep the scan tail bounded
            if len(st.text) > 4 * st.maxw + 64:
                cut = len(st.text) - (st.maxw + 16)
                st.text = st.text[cut:]
                st.lens = [max(0, v - cut) for v in st.lens[-8:]]
