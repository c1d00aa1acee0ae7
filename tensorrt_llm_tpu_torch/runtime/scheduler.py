"""Capacity + micro-batch scheduler (token budget, chunked prefill).

Counterpart of `tensorrt_llm_tpu/runtime/scheduler.py` with its default
GUARANTEED_NO_EVICT capacity policy: a request is admitted only when the
blocks for its whole sequence (prompt + max_tokens) are free.  Decode
requests go first, then chunked-prefill continuations, then new requests in
arrival order; chunk boundaries stay block-aligned except for a prompt's
last chunk.  The other policies and batch waiting belong to later slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import KVCacheManager
from tensorrt_llm_tpu_torch.runtime.request import LlmRequest


@dataclass
class SchedulerConfig:
    max_batch_size: int = 64
    max_num_tokens: int = 2048          # per-step token budget


@dataclass
class ScheduledBatch:
    prefill: List[Tuple[LlmRequest, int]] = field(default_factory=list)
    decode: List[LlmRequest] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.prefill and not self.decode


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, kv: KVCacheManager):
        self.cfg = cfg
        self.kv = kv

    def _fits(self, req: LlmRequest, reserved: int):
        """Worst case: blocks to hold the full sequence at max_total_len."""
        have = self.kv.num_seq_blocks(req.request_id)
        need = self.kv.blocks_needed(req.max_total_len) - have
        return need + reserved <= self.kv.num_free_blocks, max(need, 0)

    def schedule(self, active: List[LlmRequest],
                 waiting: List[LlmRequest]) -> ScheduledBatch:
        cfg = self.cfg
        batch = ScheduledBatch()
        budget = cfg.max_num_tokens
        reserved = 0
        n = 0
        for req in (r for r in active if r.is_generating):
            if n >= cfg.max_batch_size or budget <= 0:
                continue
            fits, need = self._fits(req, reserved)
            if not fits:
                continue
            reserved += need
            batch.decode.append(req)
            budget -= 1
            n += 1
        ctx = [r for r in active if r.is_context_init]
        for req in ctx + waiting:
            if n >= cfg.max_batch_size or budget <= 0:
                break
            remaining = (req.remaining_context if req.is_context_init
                         else req.prompt_len)
            chunk = min(remaining, budget)
            if chunk < remaining:
                chunk = (chunk // self.kv.block_size) * self.kv.block_size
            if chunk <= 0:
                continue
            fits, need = self._fits(req, reserved)
            if not fits:
                continue
            reserved += need
            batch.prefill.append((req, chunk))
            budget -= chunk
            n += 1
        return batch
