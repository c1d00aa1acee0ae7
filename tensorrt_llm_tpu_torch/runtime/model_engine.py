"""Model engine: assembles step inputs and runs prefill and decode steps.

Counterpart of `tensorrt_llm_tpu/runtime/model_engine.py`.  PyTorch runs
eagerly, so there are no compiled buckets: a prefill step takes exactly the
chunk's tokens and a decode step exactly the batch, with block tables as
wide as the longest sequence needs.  `run_decode_multi` runs k decode steps
as a Python loop of single steps with sampling on the device between them
(the next step's input ids are the previous step's sampled tokens, still on
the device); its tokens equal the JAX package's fused `scan` mode.

Not in this slice: the chain/scan/unroll variants, warmup, CUDA graphs,
pipeline/context/data parallelism and the KV page copy/extract machinery.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from tensorrt_llm_tpu_torch.attention_backend.interface import (
    AttentionMetadata)
from tensorrt_llm_tpu_torch.llmapi.sampling_params import SamplingParams
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import KVCacheManager
from tensorrt_llm_tpu_torch.runtime.sampler import sample_tokens
from tensorrt_llm_tpu_torch.utils import resolve_device


@dataclass
class StepInputs:
    """Host-assembled step inputs (numpy)."""

    input_ids: np.ndarray
    positions: np.ndarray
    slot_mapping: np.ndarray
    block_tables: np.ndarray
    kv_lens: np.ndarray
    logit_indices: np.ndarray
    q_offset: int = 0


class ModelEngine:
    def __init__(self, model, kv_manager: KVCacheManager, device="cuda"):
        self.model = model
        self.kv_manager = kv_manager
        self.device = resolve_device(device)
        self.kv_caches = kv_manager.allocate_pools()
        self.lock = threading.Lock()

    # ------------------------------------------------------------ inputs ---
    def prepare_prefill_inputs(self, req, chunk: int) -> StepInputs:
        """One context chunk of one request."""
        kv = self.kv_manager
        start = req.context_position
        end = start + chunk
        return StepInputs(
            input_ids=np.asarray(req.prompt_token_ids[start:end], np.int64),
            positions=np.arange(start, end, dtype=np.int64),
            slot_mapping=np.asarray(
                kv.slot_mapping(req.request_id, start, chunk), np.int64),
            block_tables=np.asarray(
                [kv.block_table(req.request_id, kv.blocks_needed(end))],
                np.int32),
            kv_lens=np.asarray([end], np.int32),
            logit_indices=np.asarray([chunk - 1], np.int64),
            q_offset=start)

    def prepare_decode_inputs(self, reqs, extra_tokens: int = 0
                              ) -> StepInputs:
        """One new token per request; `extra_tokens` widens the tables for
        k-step decode (positions up to num_tokens + extra - 1)."""
        kv = self.kv_manager
        MB = max(kv.blocks_needed(r.num_tokens + extra_tokens) for r in reqs)
        pos = np.asarray([r.num_tokens - 1 for r in reqs], np.int64)
        return StepInputs(
            input_ids=np.asarray([r.all_token_ids[-1] for r in reqs],
                                 np.int64),
            positions=pos,
            slot_mapping=np.asarray(
                [kv.slot_mapping(r.request_id, int(p), 1)[0]
                 for r, p in zip(reqs, pos)], np.int64),
            block_tables=np.asarray(
                [kv.block_table(r.request_id, MB) for r in reqs], np.int32),
            kv_lens=(pos + 1).astype(np.int32),
            logit_indices=np.arange(len(reqs), dtype=np.int64))

    def _tensors(self, inputs: StepInputs, mode: str):
        dev = self.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                dev, non_blocking=True)

        meta = AttentionMetadata(
            positions=t(inputs.positions), slot_mapping=t(inputs.slot_mapping),
            block_tables=t(inputs.block_tables), kv_lens=t(inputs.kv_lens),
            q_offset=int(inputs.q_offset), mode=mode)
        return t(inputs.input_ids), meta, t(inputs.logit_indices)

    # -------------------------------------------------------------- steps ---
    @torch.no_grad()
    def run_prefill(self, inputs: StepInputs) -> torch.Tensor:
        """One prefill chunk; returns the last row's logits [1, V] (f32)."""
        ids, meta, rows = self._tensors(inputs, "prefill")
        with self.lock:
            return self.model(ids, self.kv_caches, meta, rows)

    @torch.no_grad()
    def run_decode(self, inputs: StepInputs) -> torch.Tensor:
        """One decode step; returns logits [B, V] (f32)."""
        ids, meta, rows = self._tensors(inputs, "decode")
        with self.lock:
            return self.model(ids, self.kv_caches, meta, rows)

    @torch.no_grad()
    def run_decode_multi(self, inputs: StepInputs, num_steps: int,
                         params: List[SamplingParams], slot_table: np.ndarray,
                         step: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """`num_steps` decode steps, sampling on the device between them.
        slot_table [k, B] holds each step's KV slots (blocks pre-grown).
        Returns (tokens [k, B], logprobs [k, B]) as device tensors."""
        ids, meta, rows = self._tensors(inputs, "decode")
        slots = torch.from_numpy(np.ascontiguousarray(slot_table)).to(
            self.device)
        toks, logps = [], []
        with self.lock:
            for j in range(num_steps):
                meta.slot_mapping = slots[j]
                logits = self.model(ids, self.kv_caches, meta, rows)
                tok, lp = sample_tokens(logits, params, step, step_offset=j)
                toks.append(tok)
                logps.append(lp)
                ids = tok.to(torch.int64)
                meta.positions = meta.positions + 1
                meta.kv_lens = meta.kv_lens + 1
        return torch.stack(toks), torch.stack(logps)
