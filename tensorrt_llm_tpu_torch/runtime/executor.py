"""Continuous-batching executor loop.

Counterpart of `tensorrt_llm_tpu/runtime/executor.py` (`PyExecutor`): a
background thread that, each iteration, ingests new requests and
cancellations, schedules (`Scheduler`: capacity policy, token budget,
chunked prefill, priorities, batch waiting), allocates paged-KV blocks with
prefix and partial tail-block reuse (copying the reused pages before the
first prefill chunk), runs the prefill chunks and one batched decode chunk
(up to `max_decode_steps` tokens per sequence), samples, applies stop
criteria and streams results.  A finished request's last piece goes out at
the end of its iteration, after its KV blocks are freed and the
iteration's stats are kept, so a caller woken by it reads settled KV and
iteration stats.

The overlap decode pipeline (on by default, `overlap_depth` 4; JAX
`_overlap_decode`) dispatches each decode chunk from the previous chunk's
sampled tokens while they are still on the device, so the host does not
wait for the device between chunks: a chunk's results are applied (tokens
appended, stops checked, pieces emitted) once they have reached the host,
and the host waits only when `overlap_depth` chunks are in flight.
`_virtual` counts each request's tokens dispatched but not yet applied.
Whenever the batch's composition changes, the pipeline is drained first,
since the next chunk's inputs are the previous chunk's rows.  Once a
request's whole budget is dispatched, the next iteration drains the
pipeline and frees the request before it schedules, instead of letting the
request ride further chunks: with `ignore_eos` the batches and admissions,
and hence the tokens, do not depend on when results land.
Every launch is on the device's current stream, so a block freed while a
chunk that writes it is in flight is reused only by work that runs after
that chunk: a finished or cancelled request frees its KV at once, and its
rows in chunks still in flight are dropped.  Tests keep the pipeline full
by setting `_force_lag`.

Not in this slice: disaggregated serving and its receive path, speculative
and beam decoding, guided decoding, stop strings, penalties and logit
controls, multi-host lockstep.  The JAX package's faults listed in ROADMAP
Queue C are not copied: a request's failure ends only that request, and
shutdown resolves every request still held.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine
from tensorrt_llm_tpu_torch.runtime.request import (
    FinishReason, LlmRequest, RequestState)
from tensorrt_llm_tpu_torch.runtime.sampler import sample_tokens
from tensorrt_llm_tpu_torch.runtime.scheduler import Scheduler, SchedulerConfig
from tensorrt_llm_tpu_torch.utils import logger

STATS_KEPT = 1000   # iterations of stats the executor keeps
CANCEL_GRACE = 3    # iterations an unmatched cancel waits for its request


@dataclass
class IterationStats:
    iteration: int = 0
    num_active: int = 0
    num_waiting: int = 0
    num_prefill_tokens: int = 0
    num_prefill_chunks: int = 0
    num_decode_tokens: int = 0
    decode_steps: int = 0
    inflight_chunks: int = 0
    kv_stats: dict = field(default_factory=dict)
    step_time_ms: float = 0.0


class PyExecutor:
    def __init__(self, engine: ModelEngine,
                 scheduler_cfg: Optional[SchedulerConfig] = None,
                 eos_token_id: Optional[int] = None, max_seq_len: int = 2048,
                 max_decode_steps: int = 8, overlap: bool = True,
                 overlap_depth: int = 4):
        self.engine = engine
        self.kv = engine.kv_manager
        self.scheduler = Scheduler(scheduler_cfg or SchedulerConfig(), self.kv)
        self.eos_token_id = eos_token_id
        self.max_seq_len = max_seq_len
        self.max_decode_steps = max(1, max_decode_steps)

        # overlap decode pipeline (module docstring)
        self._overlap_enabled = bool(overlap)
        self._overlap_depth = max(1, int(overlap_depth))
        self._force_lag = False        # tests: results never land early
        self._inflight: "collections.deque" = collections.deque()
        self._inflight_comp = None
        self._virtual: dict = {}       # request id -> unapplied tokens
        engine.host_ring = self._overlap_depth + 1
        self._cancelled: set = set()
        self._cancel_misses: dict = {}
        self._done: List[LlmRequest] = []   # finished and freed this step

        self.request_queue: "queue.Queue[LlmRequest]" = queue.Queue()
        self.active: List[LlmRequest] = []
        self.waiting: List[LlmRequest] = []
        self._submit_lock = threading.Lock()
        self.iteration = 0
        self.stats_history: List[IterationStats] = []

        self._shutdown = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._jobs: List = []          # callables run between two steps

    # ------------------------------------------------------------ lifecycle --
    def start(self):
        assert self._thread is None
        self._thread = threading.Thread(target=self._loop_main, daemon=True,
                                        name="tllm-torch-executor")
        self._thread.start()

    def shutdown(self):
        self._shutdown.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=60)
            self._thread = None
        # resolve anything still held so no caller waits forever
        self._fail_all("executor shut down", FinishReason.CANCELLED)

    def call_between_steps(self, fn):
        """Run `fn` on the executor thread between two iterations and
        return its result (a weight swap: no step sees part old, part new
        weights).  Runs it here when the loop is not running."""
        if self._thread is None:
            return fn()
        done, box = threading.Event(), {}

        def job():
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001
                box["error"] = e
            done.set()

        with self._submit_lock:
            self._jobs.append(job)
        self._wake.set()
        while not done.wait(timeout=0.1):
            if self._thread is None or self._error is not None:
                raise RuntimeError("executor stopped before the call ran")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def submit(self, request: LlmRequest) -> LlmRequest:
        return self.submit_many([request])[0]

    def cancel(self, request_id: int) -> None:
        """End a request at the next iteration with finish reason
        CANCELLED; its KV is freed then."""
        with self._submit_lock:
            self._cancelled.add(request_id)
        self._wake.set()

    def submit_many(self, requests: List[LlmRequest]) -> List[LlmRequest]:
        """Validate every request, then queue them all at once: the loop
        admits a batch in one iteration, never a part of it."""
        for r in requests:
            self._validate(r)
        with self._submit_lock:
            for r in requests:
                self.request_queue.put(r)
        self._wake.set()
        return requests

    def _validate(self, request: LlmRequest) -> None:
        if self._shutdown.is_set():
            raise RuntimeError("executor is shut down")
        if self._error is not None:
            raise RuntimeError(f"executor loop died: {self._error}")
        if request.prompt_len == 0:
            raise ValueError("prompt must contain at least one token")
        if request.prompt_len >= self.max_seq_len:
            raise ValueError(
                f"prompt length {request.prompt_len} exceeds max_seq_len "
                f"{self.max_seq_len} (need room for at least one new token)")
        bad = request.sampling_params.unsupported()
        if bad:
            raise NotImplementedError(
                "sampling options not in this slice of the port: "
                + ", ".join(bad))
        if request.prompt_len + request.sampling_params.max_tokens \
                > self.max_seq_len:
            request.sampling_params = dataclasses.replace(
                request.sampling_params,
                max_tokens=max(1, self.max_seq_len - request.prompt_len))

    # ------------------------------------------------------------------ loop --
    def _loop_main(self):
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        try:
            while not self._shutdown.is_set():
                if not self._step():
                    self._wake.wait(timeout=0.005)
                    self._wake.clear()
        except BaseException as e:  # noqa: BLE001
            self._error = e
            logger.error("executor loop died: %s\n%s", e,
                         traceback.format_exc())
            self._fail_all(str(e), FinishReason.ERROR)

    def _fail_all(self, msg: str, reason: FinishReason):
        while True:
            try:
                self.waiting.append(self.request_queue.get_nowait())
            except queue.Empty:
                break
        self._inflight.clear()
        self._virtual.clear()
        done, self._done = self._done, []
        for req in done:
            req.emit(finished=True)
        for req in self.active + self.waiting:
            if req.is_finished:     # finished this step, not yet delivered
                req.emit(finished=True)
                continue
            req.finish(reason)
            req.emit(finished=True,
                     error=msg if reason == FinishReason.ERROR else None)
        for req in self.active:
            self.kv.free_sequence(req.request_id)
        self.active, self.waiting = [], []

    def _fetch_new_requests(self):
        with self._submit_lock:
            while True:
                try:
                    self.waiting.append(self.request_queue.get_nowait())
                except queue.Empty:
                    break

    def _handle_cancellations(self):
        """End every cancelled request still held: free its KV, drop its
        rows of the chunks in flight and deliver it.  An id that matches
        no request waits `CANCEL_GRACE` iterations (a submission racing
        its cancel), then is forgotten."""
        with self._submit_lock:
            pending = set(self._cancelled)
        if not pending:
            return
        hit = set()
        for req in self.active + self.waiting:
            if req.request_id not in pending:
                continue
            hit.add(req.request_id)
            if req.is_finished:          # its own finish stands
                continue
            if req in self.active:
                self.active.remove(req)
                self.kv.free_sequence(req.request_id)
                self._virtual.pop(req.request_id, None)
            else:
                self.waiting.remove(req)
            req.finish(FinishReason.CANCELLED)
            req.emit(finished=True)
        for rid in pending - hit:
            self._cancel_misses[rid] = self._cancel_misses.get(rid, 0) + 1
            if self._cancel_misses[rid] < CANCEL_GRACE:
                hit.discard(rid)
            else:
                hit.add(rid)
        for rid in hit:
            self._cancel_misses.pop(rid, None)
        with self._submit_lock:
            self._cancelled -= hit

    def _step(self) -> bool:
        t0 = time.perf_counter()
        with self._submit_lock:
            jobs, self._jobs = self._jobs, []
        if jobs and self._inflight:
            self._drain_inflight()       # no chunk spans a job
            self._cleanup_finished()
        for job in jobs:
            job()
        self._fetch_new_requests()
        self._handle_cancellations()
        if self._inflight and not all(
                self._wants_tokens(r) for r in self._inflight[-1].reqs
                if r.is_generating):
            # a request's budget is all dispatched: apply and free it now,
            # so that what is scheduled next does not depend on timing
            self._drain_inflight()
            self._cleanup_finished()
        if not self.active and not self.waiting:
            self._inflight.clear()       # only rows of ended requests
            self._virtual.clear()
            self._deliver()
            return False
        batch = self.scheduler.schedule(self.active, self.waiting)
        if batch.empty:
            if self._inflight:
                # every request left is waiting on chunks in flight
                self._drain_inflight()
                self._cleanup_finished()
                self._deliver()
                return True
            self._deliver()
            return False
        self.iteration += 1
        stats = IterationStats(iteration=self.iteration,
                               num_active=len(self.active),
                               num_waiting=len(self.waiting))

        for req, chunk in batch.prefill:
            if req.state == RequestState.QUEUED:
                cached = self.kv.add_sequence(req.request_id,
                                              req.prompt_token_ids,
                                              req.cache_salt)
                if req.kv_retention_priority is not None:
                    self.kv.set_seq_priority(req.request_id,
                                             req.kv_retention_priority)
                # copy-on-partial-reuse: the reused page lands in the
                # fresh block before this chunk's writes (stream order)
                self.engine.copy_kv_blocks(
                    self.kv.drain_partial_copies(req.request_id))
                req.num_cached_tokens = cached
                req.context_position = cached
                req.start_context()
                self.waiting.remove(req)
                self.active.append(req)
                # reuse may cover part of the scheduled chunk
                chunk = min(chunk, req.remaining_context)
            start = req.context_position
            self.kv.grow_sequence(req.request_id, start + chunk)
            logits = self.engine.run_prefill(
                self.engine.prepare_prefill_inputs(req, chunk))
            req.context_position += chunk
            self.kv.seal_full_blocks(
                req.request_id, req.prompt_token_ids[:req.context_position])
            stats.num_prefill_tokens += chunk
            stats.num_prefill_chunks += 1
            if req.remaining_context == 0:
                req.finish_context()
                self._sample_and_update([req], logits)

        decode_reqs = [r for r in batch.decode if r.is_generating]
        if self._inflight and not decode_reqs:
            self._drain_inflight()
        if decode_reqs:
            k = self._decode_steps_for(decode_reqs)
            if self._overlap_enabled:
                n, steps = self._overlap_decode(decode_reqs, k)
            else:
                n, steps = self._decode_multi(decode_reqs, k)
            stats.num_decode_tokens += n * steps
            stats.decode_steps = steps
        stats.inflight_chunks = len(self._inflight)

        self._cleanup_finished()
        stats.kv_stats = self.kv.stats()
        stats.step_time_ms = (time.perf_counter() - t0) * 1e3
        self.stats_history.append(stats)
        if len(self.stats_history) > STATS_KEPT:
            self.stats_history = self.stats_history[-STATS_KEPT:]
        # deliver finished requests last: a caller woken by its result sees
        # the sequence's KV freed and this iteration's stats kept
        self._deliver()
        return True

    def _deliver(self):
        done, self._done = self._done, []
        for req in done:
            req.emit(finished=True)

    # ---------------------------------------------------------------- decode --
    def _wants_tokens(self, req: LlmRequest) -> bool:
        """Whether a generating request needs tokens past those already
        dispatched (its budget and the position ceiling)."""
        v = self._virtual.get(req.request_id, 0)
        return (req.num_output_tokens + v < req.sampling_params.max_tokens
                and req.num_tokens + v < self.max_seq_len)

    def _decode_steps_for(self, reqs: List[LlmRequest]) -> int:
        """Decode steps to fuse into one dispatch without passing any
        request's position ceiling; requests that may stop on EOS cap the
        overshoot at 4 steps (extra tokens are dropped host-side).  The
        block guard counts positions already dispatched (`_virtual`)."""
        k = self.max_decode_steps
        for r in reqs:
            v = self._virtual.get(r.request_id, 0)
            k = min(k, max(self.max_seq_len - r.num_tokens - v + 1, 1))
            sp = r.sampling_params
            if not sp.ignore_eos or sp.stop_token_ids:
                k = min(k, 4)
        k = max(k, 1)
        while k > 1:
            extra = sum(self.kv.blocks_needed(
                r.num_tokens + self._virtual.get(r.request_id, 0) + k - 1)
                - self.kv.num_seq_blocks(r.request_id) for r in reqs)
            if extra <= self.kv.num_free_blocks:
                break
            k -= 1
        return k

    def _decode_multi(self, reqs: List[LlmRequest], k: int):
        """One k-step chunk, waited for and applied at once.  Returns
        (rows, steps) dispatched."""
        for req in reqs:
            self.kv.grow_sequence(req.request_id, req.num_tokens + k - 1)
        self._apply_chunk(self.engine.dispatch_decode(reqs, k,
                                                      step=self.iteration))
        return len(reqs), k

    # --------------------------------------------------------------- overlap --
    def _drain_inflight(self, only_ready: bool = False):
        """Apply in-flight chunks oldest first.  ``only_ready`` stops at the
        first chunk whose results have not reached the host while the
        pipeline is within its depth."""
        while self._inflight:
            ch = self._inflight[0]
            if only_ready and len(self._inflight) <= self._overlap_depth \
                    and (self._force_lag or not self.engine.chunk_ready(ch)):
                break
            self._inflight.popleft()
            for r in ch.reqs:
                v = self._virtual.get(r.request_id, 0) - ch.k
                if v > 0:
                    self._virtual[r.request_id] = v
                else:
                    self._virtual.pop(r.request_id, None)
            self._apply_chunk(ch)
        if not self._inflight:
            self._inflight_comp = None

    def _overlap_decode(self, reqs: List[LlmRequest], k: int):
        """Dispatch one chunk fed from the previous chunk's tokens on the
        device, then apply what has landed; wait only past the depth.
        Returns (rows, steps) dispatched."""
        comp = (tuple(r.request_id for r in reqs), k)
        if self._inflight and self._inflight_comp != comp:
            self._drain_inflight()
            reqs = [r for r in reqs if r.is_generating]
            comp = (tuple(r.request_id for r in reqs), k)
        virt = [self._virtual.get(r.request_id, 0) for r in reqs]
        try:
            for r, v in zip(reqs, virt):
                self.kv.grow_sequence(r.request_id, r.num_tokens + v + k - 1)
        except RuntimeError:
            # the pool ran out mid-pipeline: apply what is in flight, free
            # what finished, and grow again from applied positions
            self._drain_inflight()
            self._cleanup_finished()
            reqs = [r for r in reqs if r.is_generating]
            virt = [0] * len(reqs)
            comp = (tuple(r.request_id for r in reqs), k)
            for r in reqs:
                self.kv.grow_sequence(r.request_id, r.num_tokens + k - 1)
        if not reqs:
            return 0, 0
        prev = self._inflight[-1].toks[-1] if self._inflight else None
        ch = self.engine.dispatch_decode(reqs, k, step=self.iteration,
                                         virtual_extra=virt,
                                         prev_tokens=prev)
        self._inflight.append(ch)
        self._inflight_comp = comp
        for r in reqs:
            self._virtual[r.request_id] = \
                self._virtual.get(r.request_id, 0) + k
        self._drain_inflight(only_ready=True)
        return len(reqs), k

    def _apply_chunk(self, ch):
        """Append a chunk's tokens to its requests that still generate,
        check stops and emit; rows of ended requests are dropped."""
        toks, logps = self.engine.chunk_result(ch)
        for i, req in enumerate(ch.reqs):
            for j in range(ch.k):
                if not req.is_generating:
                    break
                self._append(req, int(toks[j, i]), float(logps[j, i]))
            if req.is_generating:
                req.emit(finished=False)

    def _sample_and_update(self, reqs: List[LlmRequest], logits):
        params = [r.sampling_params for r in reqs]
        tokens, logp = sample_tokens(logits, params, step=self.iteration)
        tokens = tokens.cpu().numpy()
        logp = logp.cpu().numpy()
        for i, req in enumerate(reqs):
            if not req.is_generating:
                continue
            self._append(req, int(tokens[i]), float(logp[i]))
            if req.is_generating:
                req.emit(finished=False)

    def _append(self, req: LlmRequest, tok: int, logp: Optional[float]):
        req.append_token(tok)
        if req.sampling_params.logprobs and logp is not None:
            req.logprobs.append({tok: logp})
        reason = req.check_stop(self.eos_token_id)
        if reason is None and req.num_tokens >= self.max_seq_len:
            reason = FinishReason.LENGTH
        if reason is not None:
            req.finish(reason)      # delivered at the end of the step

    def _cleanup_finished(self):
        """Free every finished request's KV (rows of it in chunks still in
        flight are dropped when applied) and queue it for delivery."""
        for req in [r for r in self.active if r.is_finished]:
            self.kv.free_sequence(req.request_id)
            self._virtual.pop(req.request_id, None)
            self.active.remove(req)
            self._done.append(req)

    def get_stats(self) -> List[dict]:
        return [dataclasses.asdict(s) for s in self.stats_history]

