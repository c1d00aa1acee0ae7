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

Disaggregated serving (JAX `_admit_generation_only`, `_pump_kv_receive`,
`_pump_kv_stream`): a ``context_only`` request's KV pages are captured when
its first token is sampled, before the request reads as finished
(`_send_context`): a whole payload on `req.kv_payload`, or with a frame
queue (`req.kv_stream`) the blocks not yet sent and an end frame carrying
the first token; frames of the full blocks of each prefill chunk leave as
the chunk ends, so the transfer overlaps the remaining prefill.  A
context-only request is not freed while a chunk in flight still writes it
(`_virtual`).  A ``generation_only`` request bypasses the scheduler: it is
admitted when the pool holds its prompt (`_gen_queue`), into blocks of a
private salt (``__disagg_<id>``, so transferred pages never alias another
sequence's cached blocks), then its pages are injected, whole or frame by
frame as they arrive (`_receiving`), and it enters generation with its
first token appended as if sampled here: penalty counts, seeded noise
positions and the stop-string scan then see the prompt plus that token, as
on a single instance.  Unlike the JAX executor: shutdown resolves every
request still receiving with an error; a receiving request keeps the loop
and `close_for_release` from counting the executor idle; a receive that
has no end frame within `RECEIVE_DEADLINE_S` (the JAX server's 600 s) ends
with an error; and a context-only request that fails puts an error frame
on its stream.

Speculative decoding (JAX `_spec_decode`, `_verify_tree`, with a
`drafter`, `speculative/`): each iteration, unless the gate is off (more
decoding requests than `max_concurrency`, a `draft_len_schedule` entry of
0, the adaptive disable after a window of short acceptances, or a
`batched_logits_processor`), the pipeline is drained and every greedy
request without logprobs, generation logits, a matcher or host logit
controls takes a round: the drafter proposes a tree (`_verify_tree`: one
forward under an ancestor mask; the accepted path's KV rides the next
round's chunk, `_spec_pending`, or `_flush_pending` writes it) or a chain
(one prefill-like forward over the last token and the draft), the longest
matching prefix plus one bonus token is appended (relaxed acceptance
inside thinking spans), and `spec_stats` counts proposed and accepted
tokens and rounds.  A request the drafter has nothing for decodes
normally, at most 2 steps a chunk while speculation is on; a one-model
drafter's (`needs_hidden`) greedy requests decode one step at a time on
the host logits path, their prefill chunks returning every row, so the
drafter gets the hidden tap of every position (`on_hidden`).  Drafters
hear of every finished request (`on_request_finished`) and are flushed at
shutdown.

Beam search (JAX `executor.py:656-676`, `runtime/beam_search.py`): a beam
request's last prefill chunk seeds its `BeamSearch` instead of sampling,
and each iteration, before speculation and the plain decode, every beam
request in the batch takes one batched step over its live beams.  Beam
steps read request state and fork and free blocks, so the overlap pipeline
is drained first (the JAX executor steps beams before it drains).  A fork
or a growth that finds the pool exhausted ends that request alone with an
error; every sequence its beams hold is freed with it.  A disaggregated
request with beam search is refused at submit (the JAX package gives it no
defined result).  Every request's `on_finished` hook (a paged LoRA slot's
release) runs once, when the request ends, before its last piece is sent.

Under VSWA rings (`ModelEngine.vswa`) every payload and frame carries the
sliding layers' ring pages (JAX `executor.py:357, 401-404, 833-843`): a
streamed context-only request sends one frame at its end, marked
``"ring"``, as rings rewrite early pages while the prefill runs, and a
generation-only request needs a free ring slot to be admitted.

Not in this slice: multi-host lockstep.  The JAX
package's faults listed in ROADMAP Queue C are not copied: a request's
failure ends only that request, and shutdown resolves every request still
held.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from tensorrt_llm_tpu_torch.llmapi.disagg_params import leaves
from tensorrt_llm_tpu_torch.llmapi.tracing import RequestTracer
from tensorrt_llm_tpu_torch.ops.cuda_build import launch_scope
from tensorrt_llm_tpu_torch.runtime.beam_search import BeamSearch
from tensorrt_llm_tpu_torch.runtime.guided_decoder import (
    GuidedDecoder, create_matcher)
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import OutOfBlocksError
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
RECEIVE_DEADLINE_S = 600.0   # a streamed KV receive's end frame, at most
_EXECUTOR_IDS = itertools.count()   # for each executor's launch scope


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
    # speculative rounds, and the target forwards they ran: linear verify
    # chunks and tree verify steps (with the pending-KV flushes)
    spec_rounds: int = 0
    spec_verify_forwards: int = 0
    spec_tree_forwards: int = 0
    spec_ms: float = 0.0          # host wall ms of the speculative section
    # beam search: batched decode forwards (one per beam request stepped)
    # and the host wall ms of the beam section
    beam_steps: int = 0
    beam_ms: float = 0.0
    kv_stats: dict = field(default_factory=dict)
    step_time_ms: float = 0.0


class PyExecutor:
    def __init__(self, engine: ModelEngine,
                 scheduler_cfg: Optional[SchedulerConfig] = None,
                 eos_token_id: Optional[int] = None, max_seq_len: int = 2048,
                 max_decode_steps: int = 8, overlap: bool = True,
                 overlap_depth: int = 4, tokenizer=None,
                 batched_logits_processor=None, drafter=None):
        self.engine = engine
        self.kv = engine.kv_manager
        # the host KV tier moves blocks with the disaggregated page copies
        self.kv.attach_block_io(engine.extract_kv_blocks,
                                engine.inject_kv_blocks)
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

        # speculative decoding (module docstring)
        self.drafter = drafter
        if drafter is not None:
            drafter.bind(engine, self.kv)
        self._needs_hidden = bool(getattr(drafter, "needs_hidden", False))
        self._hidden_capture = getattr(drafter, "hidden_capture", "final")
        self.spec_stats = {"proposed": 0, "accepted": 0, "rounds": 0}
        self._spec_adaptive_off = False
        self._spec_len_cap = None
        self._spec_pending: dict = {}  # request id -> tree KV not written
        self._think: dict = {}         # request id -> (scanned, thinking)
        aw = getattr(getattr(drafter, "cfg", None), "acceptance_window",
                     None)
        self._accept_hist = collections.deque(maxlen=aw) if aw else None

        self.request_queue: "queue.Queue[LlmRequest]" = queue.Queue()
        self.active: List[LlmRequest] = []
        self.waiting: List[LlmRequest] = []
        # generation_only requests not yet admitted, and those admitted
        # whose streamed KV frames are still arriving
        self._gen_queue: List[LlmRequest] = []
        self._receiving: List[LlmRequest] = []
        self._submit_lock = threading.Lock()
        self.iteration = 0
        self.stats_history: List[IterationStats] = []
        self.total_tokens_generated = 0
        self.tracer = RequestTracer()
        self.weights_released = False  # LLM.release_memory: submit refused

        self._shutdown = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the loop's kernel launches are counted under this name too
        # (`cuda_build.launch_counts_by_scope`)
        self.launch_scope = f"executor-{next(_EXECUTOR_IDS)}"
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
        if self.drafter is not None and hasattr(self.drafter, "flush"):
            self.drafter.flush()      # capture drafters write their shard

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
                        or self.waiting or self._gen_queue \
                        or self._receiving or not self.request_queue.empty():
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
        if request.sampling_params.use_beam_search \
                and request.request_type != "full":
            raise ValueError("beam search on a disaggregated "
                             f"{request.request_type} request is not "
                             "supported")
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
            with launch_scope(self.launch_scope):
                while not self._shutdown.is_set():
                    if not self._step():
                        # frames of a receive arrive on a queue the loop
                        # polls
                        self._wake.wait(
                            timeout=0.0005 if self._receiving else 0.005)
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
        for req in (self._receiving + self._gen_queue + self.active
                    + self.waiting):
            self._finish_hook(req)
        for req in self._receiving + self._gen_queue:
            # a receive that cannot complete ends with an error
            self.kv.free_sequence(req.request_id)
            self._forget(req)
            req.finish(FinishReason.ERROR)
            req.emit(finished=True, error=f"kv receive: {msg}")
        self._receiving, self._gen_queue = [], []
        for req in self.active + self.waiting:
            if req.is_finished:     # finished this step, not yet delivered
                req.emit(finished=True, error=req.error)
                continue
            req.finish(reason)
            err = msg if reason == FinishReason.ERROR else None
            self._stream_error(req, msg)
            req.emit(finished=True, error=err)
        for req in self.active:
            self.kv.free_sequence(req.request_id)
            self._forget(req)
        self.active, self.waiting = [], []

    def _fetch_new_requests(self):
        with self._submit_lock:
            while True:
                try:
                    req = self.request_queue.get_nowait()
                except queue.Empty:
                    break
                (self._gen_queue if req.request_type == "generation_only"
                 else self.waiting).append(req)

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
        for req in (self.active + self.waiting + self._receiving
                    + self._gen_queue):
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
            elif req in self._receiving:
                self._receiving.remove(req)
                self.kv.free_sequence(req.request_id)
                self._forget(req)
            elif req in self._gen_queue:
                self._gen_queue.remove(req)
            else:
                self.waiting.remove(req)
            req.finish(FinishReason.CANCELLED)
            self._stream_error(req, "cancelled")
            self._finish_hook(req)
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
        if self._gen_queue:
            self._admit_generation_only()
        if self._receiving:
            self._pump_kv_receive()
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
                    self.waiting.remove(req)
                    self._done.append(req)
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
            # a one-model drafter reads the hidden of every prompt row
            tap = self._needs_hidden and sp.greedy
            inputs = self.engine.prepare_prefill_inputs(
                req, chunk, want_rows or tap)
            if tap:
                logits, hidden = self.engine.run_with_hidden(
                    "prefill", inputs, self._hidden_capture)
                self.drafter.on_hidden(req, start, hidden)
                if not want_rows:
                    logits = logits[chunk - 1:]
            else:
                logits = self.engine.run_prefill(inputs)
            if want_rows:
                # the chunk's rows go to the host; only the last stays
                rows = logits.cpu().numpy()
                logits = logits[chunk - 1:].clone()
                self._capture_prompt_rows(req, start, chunk, rows)
                del rows
            req.context_position += chunk
            self.kv.seal_full_blocks(
                req.request_id, req.prompt_token_ids[:req.context_position])
            if req.kv_stream is not None:
                self._pump_kv_stream(req)
            stats.num_prefill_tokens += chunk
            stats.num_prefill_chunks += 1
            if req.remaining_context == 0:
                req.finish_context()
                if sp.use_beam_search:
                    self._start_beams(req, logits)
                else:
                    self._sample_and_update([req], logits)

        decode_reqs = [r for r in batch.decode if r.is_generating]
        if any(r.beam is not None for r in decode_reqs):
            t_beam = time.perf_counter()
            decode_reqs = self._step_beams(decode_reqs, stats)
            stats.beam_ms = (time.perf_counter() - t_beam) * 1e3
        if self.drafter is not None and decode_reqs:
            t_spec = time.perf_counter()
            decode_reqs = self._speculate(decode_reqs, stats)
            stats.spec_ms = (time.perf_counter() - t_spec) * 1e3
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
            self._finish_hook(req)
            req.emit(finished=True, error=req.error)

    @staticmethod
    def _finish_hook(req: LlmRequest):
        """Run the request's one-shot `on_finished` hook (a paged LoRA
        slot's release); its exception is logged, never raised."""
        cb, req.on_finished = req.on_finished, None
        if cb is not None:
            try:
                cb(req)
            except Exception:  # noqa: BLE001 -- a hook never ends the loop
                logger.exception("request finish hook failed")

    # ----------------------------------------------------------- beams ---
    def _start_beams(self, req: LlmRequest, logits):
        """Seed a beam request's `BeamSearch` from its last prefill row."""
        req.beam = BeamSearch(req, self.kv, self.engine, self.eos_token_id,
                              self.max_seq_len)
        try:
            req.beam.init_from_logits(logits[-1].cpu().numpy())
        except OutOfBlocksError as exc:
            req.beam.abort()
            self._end_with_error(req, f"beam search: {exc}")
            return
        if req.beam.done:
            req.beam.apply_to_request()

    def _step_beams(self, reqs: List[LlmRequest], stats) -> List[LlmRequest]:
        """One batched step of every beam request among `reqs` (the
        pipeline drained first); returns the others."""
        if self._inflight:
            self._drain_inflight()
            reqs = [r for r in reqs if r.is_generating]
        for req in [r for r in reqs if r.beam is not None]:
            try:
                rows = req.beam.step()
            except OutOfBlocksError as exc:
                req.beam.abort()
                self._end_with_error(req, f"beam search: {exc}")
                continue
            stats.beam_steps += 1
            stats.num_decode_tokens += rows
            if req.beam.done:
                req.beam.apply_to_request()
        return [r for r in reqs if r.beam is None]

    def _end_with_error(self, req: LlmRequest, error: str):
        """End one request with an error (delivered with its last piece);
        nothing else is touched."""
        req.error = error
        req.finish(FinishReason.ERROR)
        self._stream_error(req, error)

    def _admit_guided(self, req: LlmRequest) -> bool:
        """Register a guided request's matcher before its KV is allocated.
        A spec that fails to compile ends only that request (the caller
        delivers it)."""
        g = req.sampling_params.guided_decoding
        if g is None:
            return True
        try:
            self.guided.register(req.request_id, create_matcher(
                g, self.tokenizer, self.eos_token_id,
                vocab_size=self.guided.vocab_size))
        except Exception as exc:  # noqa: BLE001 -- a per-request input error
            self._end_with_error(req, f"guided decoding: {exc}")
            return False
        return True

    # ---------------------------------------------------------- disagg ---
    def _send_context(self, req: LlmRequest):
        """A context-only request's KV leaves, before the request reads as
        finished: the whole prompt's pages on `kv_payload`, or the blocks
        not yet streamed and the end frame on `kv_stream`."""
        P = req.prompt_len
        bs = self.kv.block_size
        if req.kv_stream is not None:
            self._pump_kv_stream(req, tail=True)
            req.kv_stream.put({"end": True, "num_tokens": P,
                               "block_size": bs,
                               "first_gen_tokens": list(req.output_token_ids)})
            req.kv_payload = {"streamed": True, "num_tokens": P,
                              "block_size": bs}
            return
        table = self.kv.block_table(req.request_id, self.kv.blocks_needed(P))
        req.kv_payload = {"layers": self.engine.extract_kv_blocks(
            table, self._ring_table(req.request_id)),
            "num_tokens": P, "block_size": bs}

    def _ring_table(self, rid):
        """The request's VSWA ring table, or None without rings."""
        return self.kv.local_block_table(rid) if self.engine.vswa else None

    def _pump_kv_stream(self, req: LlmRequest, tail: bool = False):
        """A frame of the full blocks a streamed context-only request's
        prefill completed since its last frame; ``tail`` adds the last,
        partial block."""
        P = req.prompt_len
        if self.engine.vswa:
            # rings rewrite early pages while the prefill runs: one frame
            # of every page at the end
            if tail:
                table = self.kv.block_table(req.request_id,
                                            self.kv.blocks_needed(P))
                req.kv_stream.put({"start_block": 0, "ring": True,
                                   "layers": self.engine.extract_kv_blocks(
                                       table,
                                       self._ring_table(req.request_id))})
                req.kv_streamed_blocks = len(table)
            return
        done = (self.kv.blocks_needed(P) if tail
                else min(req.context_position, P) // self.kv.block_size)
        sent = req.kv_streamed_blocks
        if done > sent:
            table = self.kv.block_table(req.request_id, done)
            req.kv_stream.put({"start_block": sent, "layers":
                               self.engine.extract_kv_blocks(table[sent:])})
            req.kv_streamed_blocks = done

    @staticmethod
    def _stream_error(req: LlmRequest, msg: str):
        """A failed streamed context-only request tells its receiver."""
        if req.kv_stream is not None and req.kv_payload is None:
            req.kv_payload = {"streamed": True, "error": msg}
            req.kv_stream.put({"end": True, "error": msg})

    def _admit_generation_only(self):
        """Admit queued generation-only requests, in order, while the pool
        holds their prompts: private blocks, then the pages (whole now, or
        streamed as frames arrive)."""
        while self._gen_queue:
            req = self._gen_queue[0]
            P = req.prompt_len
            if self.kv.blocks_needed(P) > self.kv.num_free_blocks \
                    or not self.kv.can_admit_new():
                return
            self._gen_queue.pop(0)
            if not self._admit_guided(req):
                self._done.append(req)
                continue
            rid = req.request_id
            self.kv.add_sequence(rid, req.prompt_token_ids,
                                 cache_salt=f"__disagg_{rid}")
            self.kv.grow_sequence(rid, P)
            dp = req.disagg_params
            if dp.kv_frames is not None:
                req.receive_deadline = time.time() + RECEIVE_DEADLINE_S
                self._receiving.append(req)
                continue
            try:
                self.engine.inject_kv_blocks(
                    self.kv.block_table(rid, self.kv.blocks_needed(P)),
                    dp.kv_payload["layers"], self._ring_table(rid))
            except ValueError as e:
                self._end_receive(req, f"kv payload: {e}")
                continue
            self._activate_generation_only(req, dp.first_gen_tokens)

    def _activate_generation_only(self, req: LlmRequest, first_tokens):
        """Enter generation with the transferred first token(s) appended
        as if sampled here (stops, matcher, penalty counts, stop scan)."""
        req.start_context()
        req.context_position = req.prompt_len
        req.finish_context()
        self.active.append(req)
        for tok in first_tokens:
            if req.is_generating:
                self._append(req, int(tok), None)
        if req.is_generating:
            req.emit(finished=False)

    def _end_receive(self, req: LlmRequest, error: str):
        """End an admitted generation-only request with an error."""
        if req in self._receiving:
            self._receiving.remove(req)
        self.kv.free_sequence(req.request_id)
        self._forget(req)
        self._end_with_error(req, error)
        self._done.append(req)

    def _pump_kv_receive(self):
        """Inject the frames that have arrived (without waiting) into the
        receiving requests' blocks; activate a request at its end frame;
        end one at an error frame, a bad frame or its deadline."""
        now = time.time()
        for req in list(self._receiving):
            q = req.disagg_params.kv_frames
            table = None
            while True:
                try:
                    frame = q.get_nowait()
                except queue.Empty:
                    if now > req.receive_deadline:
                        self._end_receive(req, "kv stream: no end frame "
                                          f"within {RECEIVE_DEADLINE_S} s")
                    break
                err = frame.get("error")
                if err is None and not frame.get("end") \
                        and bool(frame.get("ring")) != self.engine.vswa:
                    err = ("a ring frame for an engine without VSWA rings"
                           if frame.get("ring") else
                           "a frame without rings for an engine with VSWA "
                           "rings")
                if err is not None:
                    self._end_receive(req, f"kv stream: {err}")
                    break
                if frame.get("end"):
                    self._receiving.remove(req)
                    first = (req.disagg_params.first_gen_tokens
                             or frame.get("first_gen_tokens", []))
                    self._activate_generation_only(req, first)
                    break
                if table is None:
                    table = self.kv.block_table(
                        req.request_id, self.kv.blocks_needed(req.prompt_len))
                s = int(frame["start_block"])
                # a ring frame carries every page of the prompt
                n = (len(table) if frame.get("ring")
                     else len(next(iter(leaves(frame["layers"][0])))))
                try:
                    if s + n > len(table):
                        raise ValueError(f"frame blocks [{s}, {s + n}) past "
                                         f"the prompt's {len(table)}")
                    self.engine.inject_kv_blocks(
                        table[s:s + n], frame["layers"],
                        self._ring_table(req.request_id))
                except ValueError as e:
                    self._end_receive(req, f"kv stream: {e}")
                    break

    def _forget(self, req: LlmRequest):
        """Drop a request's matcher, penalty counts, stop-scan and
        speculation state, and tell the drafter it ended."""
        rid = req.request_id
        if req.beam is not None:
            req.beam.abort()          # every beam's sequence
        self.guided.drop(rid)
        self._counts.drop(rid)
        self._spec_pending.pop(rid, None)
        self._think.pop(rid, None)
        if self.drafter is not None:
            self.drafter.on_request_finished(req)
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
        a time (the JAX `_decode_steps_for`'s k = 1 cases); a one-model
        drafter's greedy requests take it for their hidden tap."""
        if self.batched_logits_processor is not None \
                or self.guided.any_active(reqs):
            return True
        if self._needs_hidden and any(r.sampling_params.greedy
                                      for r in reqs):
            return True
        return any(self._needs_host_controls(r.sampling_params)
                   or r.sampling_params.return_generation_logits
                   or (r.sampling_params.logprobs or 0) > 1 for r in reqs)

    def _decode_host(self, reqs: List[LlmRequest]):
        """One decode step whose logits come back to `_sample_and_update`."""
        for req in reqs:
            self.kv.grow_sequence(req.request_id, req.num_tokens)
        inputs = self.engine.prepare_decode_inputs(reqs)
        if not self._needs_hidden:
            self._sample_and_update(reqs, self.engine.run_decode(inputs))
            return
        logits, hidden = self.engine.run_with_hidden(
            "decode", inputs, self._hidden_capture)
        for i, req in enumerate(reqs):
            if req.sampling_params.greedy:
                self.drafter.on_hidden(req, req.num_tokens - 1,
                                       hidden[i:i + 1])
        self._sample_and_update(reqs, logits)

    def _decode_steps_for(self, reqs: List[LlmRequest]) -> int:
        """Decode steps to fuse into one dispatch without passing any
        request's position ceiling; requests that may stop on EOS cap the
        overshoot at 4 steps (extra tokens are dropped host-side).  The
        block guard counts positions already dispatched (`_virtual`)."""
        k = self.max_decode_steps
        if self.drafter is not None and not self._spec_adaptive_off:
            # speculation owns the decode loop: a long fused chunk would
            # spend a request's budget before the drafter proposes again
            k = min(k, 2)
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
            reason = self._reconcile_stop_on_finish(req, reason)
            if req.request_type == "context_only":
                # the pages leave before the request reads as finished
                self._send_context(req)
            # delivered at the end of the step
            req.finish(reason)

    # ----------------------------------------------------------- speculation --
    def _speculate(self, reqs: List[LlmRequest], stats) -> List[LlmRequest]:
        """One speculative round for every eligible request when the gate
        is on; returns the requests left for plain decode (their tree KV
        not yet written is flushed first)."""
        dcfg = getattr(self.drafter, "cfg", None)
        cap = getattr(dcfg, "max_concurrency", None)
        spec_on = (not self._spec_adaptive_off
                   and self.batched_logits_processor is None
                   and (cap is None or len(reqs) <= cap))
        self._spec_len_cap = None
        sched = getattr(dcfg, "draft_len_schedule", None)
        if sched:
            fits = [bs for bs in sched if bs <= len(reqs)]
            self._spec_len_cap = sched[max(fits)] if fits else None
            if self._spec_len_cap == 0:
                spec_on = False
        if spec_on:
            if self._inflight:
                # a round reads request state: apply the pipeline first
                self._drain_inflight()
                reqs = [r for r in reqs if r.is_generating]
            left = []
            for req in reqs:
                n0 = req.num_output_tokens
                try:
                    done = self._spec_eligible(req) and self._spec_decode(
                        req, stats)
                except NotImplementedError as exc:
                    # a drafter's refusal (a tree on an MLA model) ends
                    # only its request
                    self._end_with_error(req, f"speculative decoding: {exc}")
                    continue
                if done:
                    stats.num_decode_tokens += req.num_output_tokens - n0
                    continue
                left.append(req)
            reqs = left
        for req in reqs:
            self._flush_pending(req, stats)
        return reqs

    def _spec_eligible(self, req: LlmRequest) -> bool:
        """Rounds bypass the host logits path: requests that need it
        (logprobs, generation logits, a matcher, host logit controls) and
        sampled ones decode normally."""
        sp = req.sampling_params
        return bool(sp.greedy and not self.guided.has(req.request_id)
                    and not sp.logprobs and not sp.return_generation_logits
                    and not self._needs_host_controls(sp))

    def _flush_pending(self, req: LlmRequest, stats):
        """Write the KV of tokens a tree round accepted but did not write
        (every appended token but the last, which the next step feeds)."""
        P = self._spec_pending.pop(req.request_id, 0)
        if not P:
            return
        n = req.num_tokens
        self.kv.grow_sequence(req.request_id, n - 1)
        inputs = self.engine.prepare_tree_verify_inputs(
            req, req.all_token_ids[n - 1 - P:n - 1],
            np.arange(n - 1 - P, n - 1), [True] * P)
        self.engine.run_verify_tree(inputs, np.tril(np.ones((P, P), bool)))
        stats.spec_tree_forwards += 1

    def _relaxed_params(self, req: LlmRequest):
        """(topk, delta, thinking now) when relaxed acceptance inside
        thinking spans is configured, else None (strict).  The thinking
        state follows the begin/end tokens of every token appended since
        the last look."""
        cfg = getattr(self.drafter, "cfg", None)
        if cfg is None or not cfg.use_relaxed_acceptance_for_thinking:
            return None
        scanned, state = self._think.get(req.request_id, (0, False))
        toks = req.all_token_ids
        for t in toks[scanned:]:
            if t == cfg.begin_thinking_phase_token:
                state = True
            elif t == cfg.end_thinking_phase_token:
                state = False
        self._think[req.request_id] = (len(toks), state)
        return int(cfg.relaxed_topk), float(cfg.relaxed_delta), state

    @staticmethod
    def _relaxed_accept(row, tok: int, topk: int, delta: float) -> bool:
        """`tok` is in the target's top-`topk` and its probability within
        `delta` of the top-1's."""
        row = np.asarray(row, np.float64)
        p = np.exp(row - row.max())
        p = p / p.sum()
        top = np.argpartition(-p, min(topk, p.size - 1))[:topk]
        return int(tok) in {int(t) for t in top} \
            and float(p.max() - p[int(tok)]) <= delta

    def _record_acceptance(self, accepted_len: int):
        """A full window of rounds whose mean accepted length is below the
        threshold turns speculation off for the rest of the run."""
        if self._accept_hist is None or self._spec_adaptive_off:
            return
        self._accept_hist.append(accepted_len)
        thr = self.drafter.cfg.acceptance_length_threshold
        mean = sum(self._accept_hist) / len(self._accept_hist)
        if thr is not None and len(self._accept_hist) == \
                self._accept_hist.maxlen and mean < thr:
            self._spec_adaptive_off = True
            logger.info("speculation disabled: rolling acceptance length "
                        "%.2f < threshold %.2f", mean, thr)

    def _commit(self, req: LlmRequest, accepted: List[int], proposed: int,
                stats) -> int:
        """Count a round and append its accepted tokens (stops apply);
        returns how many were appended."""
        self.spec_stats["proposed"] += proposed
        self.spec_stats["accepted"] += len(accepted) - 1
        self.spec_stats["rounds"] += 1
        stats.spec_rounds += 1
        self._record_acceptance(len(accepted))
        appended = 0
        for tok in accepted:
            if not req.is_generating:
                break
            self._append(req, tok, None)
            appended += 1
        self.drafter.on_accepted(req, accepted[:appended])
        if req.is_generating:
            req.emit(finished=False)
        return appended

    def _spec_decode(self, req: LlmRequest, stats) -> bool:
        """Draft, verify in one forward, accept the longest matching prefix
        and one bonus token.  False: the request decodes normally."""
        budget = min(req.sampling_params.max_tokens - req.num_output_tokens,
                     self.max_seq_len - req.num_tokens) - 1
        if budget < 1:
            self._flush_pending(req, stats)
            return False
        relaxed = self._relaxed_params(req)
        thinking = relaxed is not None and relaxed[2]
        # tree verification is strict; inside a thinking span the relaxed
        # chain accepts more
        tree = None if thinking else self.drafter.propose_tree(req)
        if tree is not None and tree[0] and self._verify_tree(
                req, tree[0], tree[1], stats):
            return True
        self._flush_pending(req, stats)
        if self._spec_len_cap is not None:
            budget = min(budget, self._spec_len_cap)
        draft = self.drafter.propose(req)[:budget]
        if not draft:
            return False
        k = len(draft)
        rid = req.request_id
        if self.kv.blocks_needed(req.num_tokens + k) \
                - self.kv.num_seq_blocks(rid) > self.kv.num_free_blocks:
            return False
        self.kv.grow_sequence(rid, req.num_tokens + k)
        inputs = self.engine.prepare_verify_inputs(req, draft)
        hidden = None
        if self._needs_hidden:
            logits, hidden = self.engine.run_with_hidden(
                "prefill", inputs, self._hidden_capture)
        else:
            logits = self.engine.run_prefill(inputs)
        stats.spec_verify_forwards += 1
        greedy = torch.argmax(logits, dim=-1).tolist()
        rows = None if relaxed is None else logits.cpu().numpy()
        cfg = self.drafter.cfg
        accepted: List[int] = []
        for j in range(k):
            if draft[j] == greedy[j] or (thinking and self._relaxed_accept(
                    rows[j], draft[j], relaxed[0], relaxed[1])):
                accepted.append(draft[j])
            else:
                break
            if relaxed is not None:
                # phase changes apply mid-chunk
                if draft[j] == cfg.begin_thinking_phase_token:
                    thinking = True
                elif draft[j] == cfg.end_thinking_phase_token:
                    thinking = False
        accepted.append(greedy[len(accepted)])     # bonus or correction
        if hidden is not None:
            # rows 0..a hold real tokens: their hiddens are valid
            self.drafter.on_hidden(req, req.num_tokens - 1,
                                   hidden[:len(accepted)])
        self._commit(req, accepted, k, stats)
        return True

    def _verify_tree(self, req: LlmRequest, tree_tokens, parents,
                     stats) -> bool:
        """Verify a draft tree in one forward: rows are the pending commits
        and the last token (causal) and the tree's nodes (pad slots, each
        seeing the committed rows and its ancestors).  The accepted path's
        KV rides the next round's chunk (`_spec_pending`)."""
        rid = req.request_id
        n = req.num_tokens
        P = self._spec_pending.get(rid, 0)
        k = len(tree_tokens)
        budget = min(req.sampling_params.max_tokens - req.num_output_tokens,
                     self.max_seq_len - n) - 1
        if budget < 1 or n - 1 - P < 0:
            return False
        if self.kv.blocks_needed(n) - self.kv.num_seq_blocks(rid) \
                > self.kv.num_free_blocks:
            return False
        self.kv.grow_sequence(rid, n)
        depth = [0] * k
        for i, p in enumerate(parents):
            depth[i] = 1 if p < 0 else depth[p] + 1
        C = P + 1
        T = C + k
        positions = np.array(list(range(n - 1 - P, n))
                             + [n - 1 + d for d in depth], np.int64)
        inputs = self.engine.prepare_tree_verify_inputs(
            req, list(req.all_token_ids[n - 1 - P:n]) + list(tree_tokens),
            positions, [True] * C + [False] * k)
        mask = np.tril(np.ones((T, T), bool))
        mask[C:, C:] = False
        for i in range(k):
            j = i
            while j >= 0:
                mask[C + i, C + j] = True
                j = parents[j]
        hidden = None
        if self._needs_hidden:
            logits, hidden = self.engine.run_verify_tree(
                inputs, mask, with_hidden=True, capture=self._hidden_capture)
        else:
            logits = self.engine.run_verify_tree(inputs, mask)
        stats.spec_tree_forwards += 1
        greedy = torch.argmax(logits, dim=-1).tolist()
        children = {}
        for i, p in enumerate(parents):
            children.setdefault(p, []).append(i)
        accepted: List[int] = []
        accepted_rows = []
        node, row = -1, C - 1
        while True:
            want = greedy[row]
            nxt = next((i for i in children.get(node, ())
                        if tree_tokens[i] == want), None)
            if nxt is None or len(accepted) >= budget:
                break
            accepted.append(want)
            node, row = nxt, C + nxt
            accepted_rows.append(row)
        accepted.append(greedy[row])               # bonus or correction
        if hidden is not None:
            self.drafter.on_hidden(req, n - 1 - P, hidden[:C])
            for r in accepted_rows:
                self.drafter.on_hidden(req, int(positions[r]),
                                       hidden[r:r + 1])
        appended = self._commit(req, accepted, k, stats)
        if appended > 1:
            self._spec_pending[rid] = appended - 1
        else:
            self._spec_pending.pop(rid, None)
        return True

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
            if req.request_type == "context_only" \
                    and self._virtual.get(req.request_id):
                # a chunk in flight still writes its blocks
                self._drain_inflight()
            self.kv.free_sequence(req.request_id)
            self._virtual.pop(req.request_id, None)
            self._forget(req)
            self.active.remove(req)
            self._done.append(req)
            self.tracer.record_request(req)

    def get_stats(self) -> List[dict]:
        return [dataclasses.asdict(s) for s in self.stats_history]

