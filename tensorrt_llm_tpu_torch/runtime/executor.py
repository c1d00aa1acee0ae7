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

The host logits path (JAX `_sample_and_update`) takes one step's logits
back to the executor.  A decode batch takes it, one step after draining
the pipeline, when a request in it has penalties or logit controls
(`_needs_host_controls`), a guided-decoding matcher, generation logits or
`logprobs` > 1, or the executor has a `batched_logits_processor`; every
request's last prefill row goes through it too.  In order: the raw rows of
the requests returning generation logits are copied to the host; the
guided mask, the penalties (counts on the device, `TokenCounts`), the logit
controls and the batched processor edit the logits on their device; the
tokens are sampled; the top-N logprobs of the edited rows are recorded;
each matcher advances (a dead end ends that request with an error).
Prompt logprobs and context logits need every prompt row: such a request's
prefill chunks return all their rows (`prepare_prefill_inputs(all_rows=
True)`), copied to the host a chunk at a time (`_capture_prompt_rows`), and
its prefix is salted so that no cached block stands in for rows it needs.
Stop strings are no host control: `StopScanWorker`, a daemon thread that
owns `tokenizer.decode`, scans the appended tokens, so stop-string requests
ride fused and overlapped chunks; a match found after more tokens were
sampled truncates the request back to it (`LlmRequest.truncate_output`),
and a request ending on EOS or length asks the worker first
(`_reconcile_stop_on_finish`: a match that completed earlier wins).
An exception of a request's processor or matcher ends that request with an
error and nothing else.

Each request freed at the end of its run leaves a trace record
(`llmapi/tracing.py`: queue time, TTFT, end to end, token counts) in
`tracer`.  `weights_released` (set by `LLM.release_memory`) closes the
submit door until the weights are back.

Not in this slice: disaggregated serving and its receive path, speculative
and beam decoding, multi-host lockstep.  The JAX package's faults listed
in ROADMAP Queue C are not copied: a request's failure ends only that
request, and shutdown resolves every request still held.
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

import numpy as np
import torch

from tensorrt_llm_tpu_torch.llmapi.tracing import RequestTracer
from tensorrt_llm_tpu_torch.runtime.guided_decoder import (
    GuidedDecoder, create_matcher)
from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine
from tensorrt_llm_tpu_torch.runtime.postproc import StopScanWorker
from tensorrt_llm_tpu_torch.runtime.request import (
    FinishReason, LlmRequest, RequestState)
from tensorrt_llm_tpu_torch.runtime.sampler import (
    TokenCounts, apply_logit_controls, apply_penalties, has_logit_controls,
    has_penalties, sample_tokens, top_n_logprobs)
from tensorrt_llm_tpu_torch.runtime.scheduler import Scheduler, SchedulerConfig
from tensorrt_llm_tpu_torch.utils import logger, upload

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
                 overlap_depth: int = 4, tokenizer=None,
                 batched_logits_processor=None):
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

        # host logits path (module docstring)
        self.tokenizer = tokenizer
        self.batched_logits_processor = batched_logits_processor
        V = engine.model.cfg.vocab_size
        self.guided = GuidedDecoder(V)
        self._counts = TokenCounts(V, engine.device)
        self._stop_scan = (None if tokenizer is None
                           else StopScanWorker(tokenizer))
        self._stop_fed: dict = {}      # request id -> tokens fed to the scan

        self.request_queue: "queue.Queue[LlmRequest]" = queue.Queue()
        self.active: List[LlmRequest] = []
        self.waiting: List[LlmRequest] = []
        self._submit_lock = threading.Lock()
        self.iteration = 0
        self.stats_history: List[IterationStats] = []
        self.total_tokens_generated = 0
        self.tracer = RequestTracer()
        self.weights_released = False  # LLM.release_memory: submit refused

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
        if self._stop_scan is not None:
            self._stop_scan.close()

    def call_between_steps(self, fn, drain: bool = True):
        """Run `fn` on the executor thread between two iterations and
        return its result: a weight swap (no step sees part old, part new
        weights), or a read of the host KV bookkeeping, which only this
        thread mutates.  `drain` first applies the chunks in flight (a
        read leaves the overlap pipeline running).  Runs `fn` here when
        the loop is not running, or when this is the loop's thread."""
        if self._thread is None or not self._thread.is_alive() \
                or threading.current_thread() is self._thread:
            return fn()
        done, box = threading.Event(), {}

        def job():
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001
                box["error"] = e
            done.set()

        with self._submit_lock:
            self._jobs.append((job, drain))
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
            # checked under the lock that `close_for_release` takes
            if self.weights_released:
                raise RuntimeError("model weights are released from device "
                                   "memory; call resume_memory() first")
            for r in requests:
                self.request_queue.put(r)
        self._wake.set()
        return requests

    def close_for_release(self) -> None:
        """Close the submit door (`weights_released`) if nothing is in
        flight, else raise and leave it open.  A request that finished but
        is still held for delivery is waited for (up to 5 s); one that is
        queued, waiting or generating refuses the release."""
        deadline = time.time() + 5.0
        with self._submit_lock:
            self.weights_released = True
        try:
            while True:
                if any(not r.is_finished for r in self.active) \
                        or self.waiting or not self.request_queue.empty():
                    raise RuntimeError("cannot release weight memory with "
                                       "requests in flight")
                if not self.active and not self._inflight:
                    return
                if time.time() > deadline:
                    raise RuntimeError("executor did not drain finished "
                                       "requests in time")
                self._wake.set()
                time.sleep(0.01)
        except Exception:
            self.weights_released = False
            raise

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
                "beam search is not in the port yet: " + ", ".join(bad))
        V = self.guided.vocab_size
        ids = request.prompt_token_ids
        if min(ids) < 0 or max(ids) >= V:
            # an index past the embedding table would end the loop (and,
            # on the card, the device context): refused here
            raise ValueError(f"prompt token ids must lie in [0, {V})")
        sp = request.sampling_params
        if sp.stop and self.tokenizer is None:
            raise ValueError("stop strings need a tokenizer (pass "
                             "tokenizer=, or use stop_token_ids)")
        ids = ([sp.end_id] if sp.end_id is not None else []) + list(
            sp.stop_token_ids or []) + list(sp.logit_bias or ()) + [
            t for w in sp.bad_words or () for t in w]
        if any(not 0 <= int(t) < V for t in ids):
            # an index past the logits would end the loop (and, on the
            # card, the device context): refused here
            raise ValueError(f"token ids of end_id, stop_token_ids, "
                             f"logit_bias and bad_words must lie in [0, {V})")
        if any(not w for w in sp.bad_words or ()):
            raise ValueError("bad_words holds an empty phrase")
        if request.prompt_len + sp.max_tokens > self.max_seq_len:
            request.sampling_params = dataclasses.replace(
                sp, max_tokens=max(1, self.max_seq_len - request.prompt_len))

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
        self._deliver()
        for req in self.active + self.waiting:
            if req.is_finished:     # finished this step, not yet delivered
                req.emit(finished=True, error=req.error)
                continue
            req.finish(reason)
            req.emit(finished=True,
                     error=msg if reason == FinishReason.ERROR else None)
        for req in self.active:
            self.kv.free_sequence(req.request_id)
            self._forget(req)
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
                self._forget(req)
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
        if self._inflight and any(drain for _, drain in jobs):
            self._drain_inflight()       # no chunk spans a swap
            self._cleanup_finished()
        for job, _ in jobs:
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
                self._pump_stop_scan()
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
            sp = req.sampling_params
            want_rows = bool(sp.prompt_logprobs or sp.return_context_logits)
            if req.state == RequestState.QUEUED:
                if not self._admit_guided(req):
                    continue
                if want_rows:
                    # every prompt row's logits are needed and a reused
                    # block has none: a salt of its own defeats the match
                    # (its blocks still seal under it, harmlessly)
                    req.cache_salt = ("__ctx_logits__", req.request_id,
                                      req.cache_salt)
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
                self.engine.prepare_prefill_inputs(req, chunk, want_rows))
            if want_rows:
                # the chunk's rows go to the host; only the last stays
                rows = logits.cpu().numpy()
                logits = logits[chunk - 1:].clone()
                self._capture_prompt_rows(req, start, chunk, rows)
                del rows
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
        if decode_reqs and self._host_logits(decode_reqs):
            if self._inflight:
                # the host path reads request state: apply the pipeline
                self._drain_inflight()
                decode_reqs = [r for r in decode_reqs if r.is_generating]
            if decode_reqs:
                self._decode_host(decode_reqs)
                stats.num_decode_tokens += len(decode_reqs)
                stats.decode_steps = 1
        elif decode_reqs:
            k = self._decode_steps_for(decode_reqs)
            if self._overlap_enabled:
                n, steps = self._overlap_decode(decode_reqs, k)
            else:
                n, steps = self._decode_multi(decode_reqs, k)
            stats.num_decode_tokens += n * steps
            stats.decode_steps = steps
        stats.inflight_chunks = len(self._inflight)

        self._pump_stop_scan()
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
            req.emit(finished=True, error=req.error)

    def _end_with_error(self, req: LlmRequest, error: str):
        """End one request with an error (delivered with its last piece);
        nothing else is touched."""
        req.error = error
        req.finish(FinishReason.ERROR)

    def _admit_guided(self, req: LlmRequest) -> bool:
        """Register a guided request's matcher before its KV is allocated.
        A spec that fails to compile ends only that request."""
        g = req.sampling_params.guided_decoding
        if g is None:
            return True
        try:
            self.guided.register(req.request_id, create_matcher(
                g, self.tokenizer, self.eos_token_id,
                vocab_size=self.guided.vocab_size))
        except Exception as exc:  # noqa: BLE001 -- a per-request input error
            self.waiting.remove(req)
            self._end_with_error(req, f"guided decoding: {exc}")
            self._done.append(req)
            return False
        return True

    def _forget(self, req: LlmRequest):
        """Drop a request's matcher, penalty counts and stop-scan state."""
        rid = req.request_id
        self.guided.drop(rid)
        self._counts.drop(rid)
        if self._stop_fed.pop(rid, None) is not None:
            self._stop_scan.drop(rid)

    # ---------------------------------------------------------------- decode --
    def _wants_tokens(self, req: LlmRequest) -> bool:
        """Whether a generating request needs tokens past those already
        dispatched (its budget and the position ceiling)."""
        v = self._virtual.get(req.request_id, 0)
        return (req.num_output_tokens + v < req.sampling_params.max_tokens
                and req.num_tokens + v < self.max_seq_len)

    @staticmethod
    def _needs_host_controls(sp) -> bool:
        """Penalties and logit controls: applied on the host logits path
        only.  Stop strings are not among them (the scan worker)."""
        return has_penalties(sp) or has_logit_controls(sp)

    def _host_logits(self, reqs: List[LlmRequest]) -> bool:
        """Whether a decode batch takes the host logits path, one step at
        a time (the JAX `_decode_steps_for`'s k = 1 cases)."""
        if self.batched_logits_processor is not None \
                or self.guided.any_active(reqs):
            return True
        return any(self._needs_host_controls(r.sampling_params)
                   or r.sampling_params.return_generation_logits
                   or (r.sampling_params.logprobs or 0) > 1 for r in reqs)

    def _decode_host(self, reqs: List[LlmRequest]):
        """One decode step whose logits come back to `_sample_and_update`."""
        for req in reqs:
            self.kv.grow_sequence(req.request_id, req.num_tokens)
        self._sample_and_update(reqs, self.engine.run_decode(
            self.engine.prepare_decode_inputs(reqs)))

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
        self._apply_chunk(self.engine.dispatch_decode(reqs, k))
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
        ch = self.engine.dispatch_decode(reqs, k, virtual_extra=virt,
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

    @staticmethod
    def _capture_prompt_rows(req: LlmRequest, start: int, chunk: int,
                             rows: np.ndarray):
        """Record a full-rows prefill chunk's context logits and prompt
        logprobs (JAX `_capture_prompt_rows`): row i, f32 on the host,
        predicts the token at position start + i + 1."""
        sp = req.sampling_params
        rows = np.asarray(rows[:chunk], np.float32)
        if sp.return_context_logits:
            req.context_logits = (rows if req.context_logits is None
                                  else np.concatenate(
                                      [req.context_logits, rows]))
        if sp.prompt_logprobs:
            if req.prompt_logprobs is None:
                # position 0 has no preceding context to predict it from
                req.prompt_logprobs = [None]
            n = int(sp.prompt_logprobs)
            mx = rows.max(axis=-1, keepdims=True)
            lp = rows - (np.log(np.sum(np.exp(rows - mx), axis=-1,
                                       keepdims=True)) + mx)
            for i in range(chunk):
                pos = start + i + 1
                if pos >= req.prompt_len:
                    break  # the last row predicts the first output token
                row = lp[i]
                top = np.argpartition(-row, min(n, row.size - 1))[:n]
                ids = set(top.tolist()) | {int(req.prompt_token_ids[pos])}
                req.prompt_logprobs.append(
                    {int(t): float(row[t]) for t in ids})

    def _sample_and_update(self, reqs: List[LlmRequest], logits):
        """Sample one token per request from logits [len(reqs), V] on the
        host logits path (module docstring) and apply stops."""
        params = [r.sampling_params for r in reqs]
        dev = logits.device
        gen = [i for i, p in enumerate(params) if p.return_generation_logits]
        raw = (logits.index_select(0, upload(np.asarray(gen, np.int64), dev))
               .cpu().numpy() if gen else None)
        gen_pos = {i: j for j, i in enumerate(gen)}   # row -> row of raw
        failed = {}                        # row -> error
        logits = self.guided.mask_logits(reqs, logits, failed)
        logits = self._apply_penalties(reqs, logits)
        logits = apply_logit_controls(logits, reqs, self.eos_token_id,
                                      failed)
        if self.batched_logits_processor is not None:
            try:
                out = self.batched_logits_processor(
                    [r.request_id for r in reqs],
                    [r.all_token_ids for r in reqs], logits)
                logits = torch.as_tensor(out, dtype=torch.float32).to(dev)
            except Exception as exc:  # noqa: BLE001 -- ends its requests
                logger.exception("batched logits processor failed")
                failed.update({i: f"batched logits processor: {exc!r}"
                               for i in range(len(reqs))})
        tokens, logp = sample_tokens(
            logits, params, [r.request_id for r in reqs],
            [r.num_output_tokens for r in reqs])
        top_rows = [i for i, p in enumerate(params) if (p.logprobs or 0) > 1]
        top = None
        if top_rows:
            vals, idx = top_n_logprobs(
                logits.index_select(0, upload(np.asarray(top_rows, np.int64),
                                              dev)),
                max(params[i].logprobs for i in top_rows))
            top = dict(zip(top_rows, zip(vals.cpu().numpy(),
                                         idx.cpu().numpy())))
        tokens = tokens.cpu().numpy()
        logp = logp.cpu().numpy()
        for i, req in enumerate(reqs):
            if not req.is_generating:
                continue
            if i in failed:
                self._end_with_error(req, failed[i])
                continue
            tok = int(tokens[i])
            lp = float(logp[i])
            if top is not None and i in top:
                n = params[i].logprobs
                lp = {int(t): float(v)
                      for v, t in zip(top[i][0][:n], top[i][1][:n])}
                lp[tok] = float(logp[i])
            if i in gen_pos:
                req.generation_logits.append(raw[gen_pos[i]])
            self._append(req, tok, lp)
            if req.is_generating:
                req.emit(finished=False)

    def _apply_penalties(self, reqs: List[LlmRequest], logits):
        """Repetition, presence and frequency penalties of the rows that
        set one, on counts kept on the device (`TokenCounts`)."""
        rows = [i for i, r in enumerate(reqs)
                if has_penalties(r.sampling_params)]
        if not rows:
            return logits
        dev = logits.device
        idx = upload(np.asarray(rows, np.int64), dev)
        pen = upload(np.asarray(
            [(reqs[i].sampling_params.repetition_penalty,
              reqs[i].sampling_params.presence_penalty,
              reqs[i].sampling_params.frequency_penalty) for i in rows],
            np.float32), dev)
        sel = apply_penalties(logits.index_select(0, idx),
                              self._counts.rows([reqs[i] for i in rows]),
                              pen[:, 0], pen[:, 1], pen[:, 2])
        return logits.index_copy(0, idx, sel)

    def _append(self, req: LlmRequest, tok: int, logp):
        """Append one token (`logp` its logprob, or a dict of top-N ones),
        advance the request's matcher and check its stops."""
        req.append_token(tok)
        self.total_tokens_generated += 1
        if req.sampling_params.logprobs and logp is not None:
            req.logprobs.append(logp if isinstance(logp, dict)
                                else {tok: logp})
        try:
            ok = self.guided.advance(req, tok)
        except Exception as exc:  # noqa: BLE001 -- ends only this request
            logger.exception("guided matcher failed")
            self._end_with_error(req, f"guided decoding: {exc!r}")
            return
        if not ok:
            self._end_with_error(req, "guided decoding: dead end")
            return
        reason = req.check_stop(self.eos_token_id)
        if reason is None and req.num_tokens >= self.max_seq_len:
            reason = FinishReason.LENGTH
        if reason is not None:
            # delivered at the end of the step
            req.finish(self._reconcile_stop_on_finish(req, reason))

    # ------------------------------------------------------------ stop scan --
    def _feed_stop_scan(self, req: LlmRequest):
        n = len(req.output_token_ids)
        if n > self._stop_fed.get(req.request_id, 0):
            sp = req.sampling_params
            self._stop_scan.feed(req.request_id, sp.stop,
                                 req.output_token_ids, sp.skip_special_tokens)
            self._stop_fed[req.request_id] = n

    def _pump_stop_scan(self):
        """Hand the new tokens of stop-string requests to the scan worker
        and finish every request whose match it found, truncated back to
        the token that completed the match."""
        if self._stop_scan is None:
            return
        for req in self.active:
            if req.sampling_params.stop and req.is_generating:
                self._feed_stop_scan(req)
        hits = self._stop_scan.poll()
        for req in self.active:
            hit = hits.get(req.request_id)
            if hit is None or not req.is_generating:
                continue
            req.truncate_output(hit[0])
            req.stop_string = hit[1]
            req.finish(FinishReason.STOP_STRING)

    def _reconcile_stop_on_finish(self, req: LlmRequest, reason):
        """A request ending on EOS or length may hold a stop string that
        completed earlier in the same fused chunk: feed the worker, wait
        for it, and let the match win if it landed before the finishing
        token (at the same token, `check_stop` runs first)."""
        sp = req.sampling_params
        if (self._stop_scan is None or not sp.stop
                or reason not in (FinishReason.EOS, FinishReason.LENGTH)):
            return reason
        self._feed_stop_scan(req)
        if not self._stop_scan.flush():
            logger.warning("stop-string scan still busy after its timeout: "
                           "request %d ends on %s without the last tokens "
                           "scanned", req.request_id, reason.value)
        hit = self._stop_scan.take(req.request_id)
        if hit is None or hit[0] >= len(req.output_token_ids):
            return reason
        req.truncate_output(hit[0])
        req.stop_string = hit[1]
        return FinishReason.STOP_STRING

    def _cleanup_finished(self):
        """Free every finished request's KV (rows of it in chunks still in
        flight are dropped when applied) and queue it for delivery."""
        for req in [r for r in self.active if r.is_finished]:
            self.kv.free_sequence(req.request_id)
            self._virtual.pop(req.request_id, None)
            self._forget(req)
            self.active.remove(req)
            self._done.append(req)
            self.tracer.record_request(req)

    def get_stats(self) -> List[dict]:
        return [dataclasses.asdict(s) for s in self.stats_history]

