"""Capacity + micro-batch scheduler (token budget, chunked prefill).

Counterpart of `tensorrt_llm_tpu/runtime/scheduler.py`, with its three
capacity policies (the reference's `CapacityScheduler`,
`batch_manager/capacityScheduler.cpp`):

* GUARANTEED_NO_EVICT (default): a request is scheduled only when the blocks
  for its whole sequence (prompt + max_tokens) are free;
* MAX_UTILIZATION: only the blocks of this step's tokens must be free
  (`_fits_next_step`); a decode row that does not fit is paused;
* STATIC_BATCH: no new request is admitted while any is active.

Decode requests go first, then chunked-prefill continuations, then new
requests by `priority` (higher first, arrival order within a level).  Chunk
boundaries stay block-aligned except for a prompt's last chunk
(`enable_chunked_prefill`, at most `max_chunk_size` tokens); with chunking
off a prompt is scheduled whole or not at all.  Batch waiting
(`batch_wait_timeout_iters` / `batch_wait_max_tokens_ratio`) holds new
prefills back while decode work runs and the batch is sparse.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from tensorrt_llm_tpu_torch.runtime.request import LlmRequest


class CapacitySchedulerPolicy(str, enum.Enum):
    MAX_UTILIZATION = "max_utilization"
    GUARANTEED_NO_EVICT = "guaranteed_no_evict"
    STATIC_BATCH = "static_batch"


@dataclass
class SchedulerConfig:
    policy: CapacitySchedulerPolicy = \
        CapacitySchedulerPolicy.GUARANTEED_NO_EVICT
    max_batch_size: int = 64
    max_num_tokens: int = 2048          # per-step token budget
    enable_chunked_prefill: bool = True
    max_chunk_size: Optional[int] = None
    # while decode work exists, hold NEW prefills for up to
    # `batch_wait_timeout_iters` iterations until the scheduled tokens
    # reach `batch_wait_max_tokens_ratio * max_num_tokens`; 0 and 0.0: off
    batch_wait_timeout_iters: int = 0
    batch_wait_max_tokens_ratio: float = 0.0

    def __post_init__(self):
        self.policy = CapacitySchedulerPolicy(self.policy)


@dataclass
class ScheduledBatch:
    # (request, chunk length): each prefill chunk runs as one model call
    prefill: List[Tuple[LlmRequest, int]] = field(default_factory=list)
    decode: List[LlmRequest] = field(default_factory=list)
    paused: List[LlmRequest] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.prefill and not self.decode

    @property
    def total_tokens(self) -> int:
        return sum(c for _, c in self.prefill) + len(self.decode)


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, kv):
        self.cfg = cfg
        self.kv = kv
        self._batch_wait_iters = 0

    def _apply_batch_waiting(self, batch: ScheduledBatch,
                             active_ctx: set) -> None:
        """Drop this iteration's NEW prefills while decode work exists and
        the batch is under the token-density threshold.  Prefills already
        mid-chunking are never held.  Setting one knob alone works: a ratio
        alone waits at most 8 iterations; a timeout alone holds new
        prefills until it expires."""
        cfg = self.cfg
        enabled = (cfg.batch_wait_timeout_iters > 0
                   or cfg.batch_wait_max_tokens_ratio > 0)
        new_prefill = [(r, c) for r, c in batch.prefill
                       if id(r) not in active_ctx]
        if not (enabled and new_prefill and batch.decode):
            self._batch_wait_iters = 0
            return
        timeout = cfg.batch_wait_timeout_iters or 8
        ratio = (cfg.batch_wait_max_tokens_ratio
                 if cfg.batch_wait_max_tokens_ratio > 0 else 1.0)
        if (self._batch_wait_iters < timeout
                and batch.total_tokens < ratio * cfg.max_num_tokens):
            self._batch_wait_iters += 1
            held = {id(r) for r, _ in new_prefill}
            batch.prefill = [(r, c) for r, c in batch.prefill
                             if id(r) not in held]
        else:
            self._batch_wait_iters = 0

    def _fits_no_evict(self, req: LlmRequest, reserved: int):
        """Worst case: blocks to hold the full sequence at max_total_len."""
        have = self.kv.num_seq_blocks(req.request_id)
        need = self.kv.blocks_needed(req.max_total_len) - have
        return need + reserved <= self.kv.num_free_blocks, max(need, 0)

    def _fits_next_step(self, req: LlmRequest, reserved: int,
                        step_tokens: int):
        """MAX_UTILIZATION: only the blocks this step's tokens need (a
        request not yet generating is sized by its scheduled chunk)."""
        have = self.kv.num_seq_blocks(req.request_id)
        target = (req.num_tokens + 1 if req.is_generating
                  else req.context_position + step_tokens)
        need = self.kv.blocks_needed(target) - have
        return need + reserved <= self.kv.num_free_blocks, max(need, 0)

    def _fits(self, req: LlmRequest, reserved: int, step_tokens: int):
        if self.cfg.policy == CapacitySchedulerPolicy.GUARANTEED_NO_EVICT:
            return self._fits_no_evict(req, reserved)
        return self._fits_next_step(req, reserved, step_tokens)

    def schedule(self, active: List[LlmRequest],
                 waiting: List[LlmRequest]) -> ScheduledBatch:
        cfg = self.cfg
        batch = ScheduledBatch()
        budget = cfg.max_num_tokens
        reserved = 0
        n = 0
        gen = [r for r in active if r.is_generating]
        ctx = [r for r in active if r.is_context_init]
        if cfg.policy == CapacitySchedulerPolicy.STATIC_BATCH and active:
            waiting = []
        for req in gen:
            if n >= cfg.max_batch_size or budget <= 0:
                batch.paused.append(req)
                continue
            fits, need = self._fits(req, reserved, 1)
            if not fits:
                batch.paused.append(req)
                continue
            reserved += need
            batch.decode.append(req)
            budget -= 1
            n += 1
        # higher priority first, arrival order within a level (stable sort)
        waiting = sorted(waiting, key=lambda r: -r.priority)
        # VSWA: a brand-new sequence needs a free ring slot (JAX
        # `scheduler.py:166-169`), counted down as this round admits
        new_slots = getattr(self.kv, "free_ring_slots", lambda: 1 << 30)()
        n_ctx = len(ctx)
        for i, req in enumerate(ctx + waiting):
            if n >= cfg.max_batch_size or budget <= 0:
                break
            if i >= n_ctx and new_slots <= 0:
                continue
            remaining = (req.remaining_context if req.is_context_init
                         else req.prompt_len)
            if cfg.enable_chunked_prefill:
                chunk = min(remaining, budget)
                if cfg.max_chunk_size:
                    chunk = min(chunk, cfg.max_chunk_size)
                if chunk < remaining:
                    chunk = (chunk // self.kv.block_size) * self.kv.block_size
                if chunk <= 0:
                    continue
            else:
                chunk = remaining
                if chunk > budget:
                    continue
            fits, need = self._fits(req, reserved, chunk)
            if not fits:
                continue
            reserved += need
            new_slots -= i >= n_ctx
            batch.prefill.append((req, chunk))
            budget -= chunk
            n += 1
        self._apply_batch_waiting(batch, {id(r) for r in ctx})
        return batch

