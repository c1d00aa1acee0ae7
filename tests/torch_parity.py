"""Helpers shared by the port's parity tests (`tests/test_torch_*.py`)."""

import queue
import threading

import numpy as np
import torch

from tensorrt_llm_tpu_torch.attention_backend import AttentionMetadata
from tensorrt_llm_tpu_torch.models import get_model_class
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import model_pools


def jax_generate(jl, prompts, sampling_params):
    """Greedy token ids from the JAX `LLM` with the whole batch admitted
    before its executor's first step.  Its `generate` submits requests one
    by one while the executor thread runs, so under load the first steps
    could see part of the batch and the chunk schedule would depend on
    thread timing; the port's `generate` admits a batch at once."""
    ex = jl.executor
    real = ex.request_queue
    gate = threading.Event()

    class _Gated:
        def get_nowait(self):
            if not gate.is_set():
                raise queue.Empty
            return real.get_nowait()

        def __getattr__(self, name):
            return getattr(real, name)

    ex.request_queue = _Gated()
    try:
        futs = [jl.generate_async(p, sampling_params) for p in prompts]
        gate.set()
        return [f.result().outputs[0].token_ids for f in futs]
    finally:
        ex.request_queue = real


def port_logits(cfg, params, tokens, block_size=8, kv_quant="NONE"):
    """The port's last-row logits after `tokens`, one prefill of a fresh
    CPU model with `params` on fresh pools (bf16, or INT8 for
    ``kv_quant="INT8"``)."""
    m = get_model_class(cfg.architecture)(cfg, "cpu").load_state(params)
    n = len(tokens)
    blocks = list(range(1, -(-n // block_size) + 1))
    caches = model_pools(cfg, len(blocks) + 1, block_size, kv_quant, "cpu")
    meta = AttentionMetadata(
        positions=torch.arange(n), mode="prefill", q_offset=0,
        slot_mapping=torch.tensor([blocks[p // block_size] * block_size
                                   + p % block_size for p in range(n)]),
        block_tables=torch.tensor([blocks], dtype=torch.int32),
        kv_lens=torch.tensor([n], dtype=torch.int32))
    with torch.no_grad():
        return m(torch.tensor(tokens), caches, meta,
                 torch.tensor([n - 1]))[0].numpy()
