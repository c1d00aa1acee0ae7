"""Continuous-batching executor loop.

Counterpart of `tensorrt_llm_tpu/runtime/executor.py` (`PyExecutor`): a
background thread that, each iteration, ingests new requests, schedules
(capacity + token budget, chunked prefill), allocates paged-KV blocks with
prefix reuse, runs the prefill chunks and one batched decode dispatch (up to
`max_decode_steps` tokens per sequence), samples, applies stop criteria and
streams results.  A finished request's last piece goes out at the end of
its iteration, after its KV blocks are freed and the iteration's stats are
kept, so a caller woken by it reads settled KV and iteration stats.

Not in this slice: the overlap pipeline, disaggregated serving and its
receive path, speculative and beam decoding, guided decoding, stop strings,
penalties and logit controls, multi-host lockstep.  The JAX package's faults
listed in ROADMAP Queue C are not copied: a request's failure ends only that
request, and shutdown resolves every request still held.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine
from tensorrt_llm_tpu_torch.runtime.request import (
    FinishReason, LlmRequest, RequestState)
from tensorrt_llm_tpu_torch.runtime.sampler import sample_tokens
from tensorrt_llm_tpu_torch.runtime.scheduler import Scheduler, SchedulerConfig
from tensorrt_llm_tpu_torch.utils import logger


STATS_KEPT = 1000   # iterations of stats the executor keeps


@dataclass
class IterationStats:
    iteration: int = 0
    num_active: int = 0
    num_waiting: int = 0
    num_prefill_tokens: int = 0
    num_prefill_chunks: int = 0
    num_decode_tokens: int = 0
    decode_steps: int = 0
    kv_stats: dict = field(default_factory=dict)
    step_time_ms: float = 0.0


class PyExecutor:
    def __init__(self, engine: ModelEngine,
                 scheduler_cfg: Optional[SchedulerConfig] = None,
                 eos_token_id: Optional[int] = None, max_seq_len: int = 2048,
                 max_decode_steps: int = 8):
        self.engine = engine
        self.kv = engine.kv_manager
        self.scheduler = Scheduler(scheduler_cfg or SchedulerConfig(), self.kv)
        self.eos_token_id = eos_token_id
        self.max_seq_len = max_seq_len
        self.max_decode_steps = max(1, max_decode_steps)

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
            import dataclasses
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

    def _step(self) -> bool:
        t0 = time.perf_counter()
        with self._submit_lock:
            jobs, self._jobs = self._jobs, []
        for job in jobs:
            job()
        self._fetch_new_requests()
        if not self.active and not self.waiting:
            return False
        batch = self.scheduler.schedule(self.active, self.waiting)
        if batch.empty:
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
        if decode_reqs:
            k = self._decode_steps_for(decode_reqs)
            if k > 1:
                self._decode_multi(decode_reqs, k)
            else:
                for req in decode_reqs:
                    self.kv.grow_sequence(req.request_id, req.num_tokens)
                logits = self.engine.run_decode(
                    self.engine.prepare_decode_inputs(decode_reqs))
                self._sample_and_update(decode_reqs, logits)
            stats.num_decode_tokens += len(decode_reqs) * k
            stats.decode_steps = k

        done = self._cleanup_finished()
        stats.kv_stats = self.kv.stats()
        stats.step_time_ms = (time.perf_counter() - t0) * 1e3
        self.stats_history.append(stats)
        if len(self.stats_history) > STATS_KEPT:
            self.stats_history = self.stats_history[-STATS_KEPT:]
        # deliver finished requests last: a caller woken by its result sees
        # the sequence's KV freed and this iteration's stats kept
        for req in done:
            req.emit(finished=True)
        return True

    # ---------------------------------------------------------------- decode --
    def _decode_steps_for(self, reqs: List[LlmRequest]) -> int:
        """Decode steps to fuse into one dispatch without passing any
        request's position ceiling; requests that may stop on EOS cap the
        overshoot at 4 steps (extra tokens are dropped host-side)."""
        k = self.max_decode_steps
        for r in reqs:
            k = min(k, max(self.max_seq_len - r.num_tokens + 1, 1))
            sp = r.sampling_params
            if not sp.ignore_eos or sp.stop_token_ids:
                k = min(k, 4)
        k = max(k, 1)
        while k > 1:
            extra = sum(self.kv.blocks_needed(r.num_tokens + k - 1)
                        - self.kv.num_seq_blocks(r.request_id) for r in reqs)
            if extra <= self.kv.num_free_blocks:
                break
            k -= 1
        return k

    def _decode_multi(self, reqs: List[LlmRequest], k: int):
        for req in reqs:
            self.kv.grow_sequence(req.request_id, req.num_tokens + k - 1)
        inputs = self.engine.prepare_decode_inputs(reqs, extra_tokens=k - 1)
        slot_table = np.stack([
            np.asarray(self.kv.slot_mapping(r.request_id, r.num_tokens - 1, k),
                       np.int64) for r in reqs], axis=1)
        toks, logps = self.engine.run_decode_multi(
            inputs, k, [r.sampling_params for r in reqs], slot_table,
            step=self.iteration)
        toks = toks.cpu().numpy()
        logps = (logps.cpu().numpy()
                 if any(r.sampling_params.logprobs for r in reqs) else None)
        for i, req in enumerate(reqs):
            for j in range(k):
                if not req.is_generating:
                    break
                self._append(req, int(toks[j, i]),
                             None if logps is None else float(logps[j, i]))
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

    def _cleanup_finished(self) -> List[LlmRequest]:
        done = [req for req in self.active if req.is_finished]
        for req in done:
            self.kv.free_sequence(req.request_id)
            self.active.remove(req)
        return done

    def get_stats(self) -> List[dict]:
        import dataclasses
        return [dataclasses.asdict(s) for s in self.stats_history]

