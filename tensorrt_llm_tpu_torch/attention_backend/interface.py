"""Attention backend interface.

Counterpart of `tensorrt_llm_tpu/attention_backend/interface.py`.  Two modes
per step, as in the JAX package:

* "prefill": one sequence's chunk of T tokens against its paged KV;
  `block_tables` is ``[1, MB]`` and the chunk starts at `q_offset`, so the
  sequence's KV length after the step is ``q_offset + T``.
* "decode": B sequences, one token each; `block_tables` ``[B, MB]`` and
  `kv_lens` ``[B]`` (including the new token).

Tensors live on the step's device.  `q_offset` is a host int: the prefill
kernel takes it as a launch argument, so no device value is read back.
The backend follows the device: CUDA kernels on a CUDA device, the plain
PyTorch versions on the CPU.  `AttentionBackend.plain_attention` is the
JAX `XlaAttention` (`attention_backend/xla_backend.py`): the CPU's path,
and on the card the route of what the JAX package sends to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class AttentionMetadata:
    positions: torch.Tensor = None       # [T] position of each input token
    slot_mapping: torch.Tensor = None    # [T] flat KV slot; OOB -> page 0
    block_tables: torch.Tensor = None    # [B, MB] int32
    kv_lens: torch.Tensor = None         # [B] int32
    q_offset: int = 0                    # prefill: position of the first token
    mode: str = "decode"
    # prefill: [T, T] bool in-chunk visibility of a draft-tree verify step,
    # whose `q_offset` is the committed prefix length (rows carry their own
    # `positions`; tree rows have pad slots)
    pair_mask: Optional[torch.Tensor] = None
    # [T] int64 multi-LoRA adapter slot of each row (0: the base model);
    # None when no row of the step has an adapter
    lora_ids: Optional[torch.Tensor] = None
    # VSWA: the sliding layers' ring slots [T] and ring tables [B, R]
    # (None: sliding layers share the full pools and mask their window)
    local_slot_mapping: Optional[torch.Tensor] = None
    local_block_tables: Optional[torch.Tensor] = None
    # set on the view a sliding layer attends with when its KV lives in a
    # ring: slot s holds position s + floor((kv_len - 1 - s) / P) * P,
    # P = block_tables.shape[-1] * block_size
    cyclic: bool = False

    def __post_init__(self):
        assert self.mode in ("prefill", "decode")

    def for_sliding_layer(self) -> "AttentionMetadata":
        """The view a sliding layer attends with: the ring tables and slots
        when rings are on, else this one."""
        if self.local_block_tables is None:
            return self
        return dataclasses.replace(
            self, slot_mapping=self.local_slot_mapping,
            block_tables=self.local_block_tables, cyclic=True)


class AttentionBackend:
    """Base: write the new K/V into the paged cache, then attend.  A
    sliding-window layer's backend masks keys more than `sliding_window`
    positions behind each query; `logit_cap` caps the scores (c * tanh(s /
    c), Gemma-2); `attention_chunk` keeps the keys of the query's own chunk
    of that many positions (Llama4)."""

    def __init__(self, num_heads: int, num_kv_heads: int, head_dim: int,
                 scale: float, sliding_window: Optional[int] = None,
                 logit_cap: Optional[float] = None,
                 attention_chunk: Optional[int] = None):
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.scale = scale
        self.sliding_window = sliding_window
        self.logit_cap = logit_cap
        self.attention_chunk = attention_chunk

    def __call__(self, q, k, v, k_cache, v_cache, meta: AttentionMetadata,
                 sinks=None) -> torch.Tensor:
        raise NotImplementedError

    def plain_attention(self, q, k, v, k_cache, v_cache,
                        meta: AttentionMetadata, sinks=None) -> torch.Tensor:
        """The JAX `XlaAttention.__call__` in plain ops: a draft-tree
        verify step (pair mask) and a ring prefill read the pool before
        this chunk's K/V are written and take the chunk's from the inputs
        (rows with a pad slot land in reserved page 0); every other step
        writes, then attends."""
        from tensorrt_llm_tpu_torch.ops.attention_plain import (
            cyclic_prefill_plain, paged_decode_plain, paged_prefill_plain,
            tree_verify_attention, write_kv_cache)
        opts = dict(sliding_window=self.sliding_window,
                    logit_cap=self.logit_cap, sinks=sinks,
                    attention_chunk=self.attention_chunk)
        prefill = meta.mode == "prefill"
        if prefill and meta.pair_mask is not None:
            out = tree_verify_attention(
                q, k_cache, v_cache, k, v, meta.block_tables[0],
                meta.q_offset, meta.positions, meta.pair_mask, self.scale,
                cyclic=meta.cyclic, **opts)
        elif prefill and meta.cyclic:
            out = cyclic_prefill_plain(
                q, k_cache, v_cache, k, v, meta.block_tables[0],
                meta.q_offset + q.shape[0], meta.q_offset, self.scale, **opts)
        else:
            write_kv_cache(k_cache, v_cache, k, v, meta.slot_mapping)
            if prefill:
                return paged_prefill_plain(
                    q, k_cache, v_cache, meta.block_tables[0],
                    kv_len=meta.q_offset + q.shape[0],
                    q_offset=meta.q_offset, scale=self.scale, **opts)
            return paged_decode_plain(q, k_cache, v_cache, meta.block_tables,
                                      meta.kv_lens, scale=self.scale,
                                      cyclic=meta.cyclic, **opts)
        write_kv_cache(k_cache, v_cache, k, v, meta.slot_mapping)
        return out


def get_attention_backend(device) -> type:
    from tensorrt_llm_tpu_torch.attention_backend.cuda_backend import (
        CudaAttention)
    from tensorrt_llm_tpu_torch.attention_backend.plain_backend import (
        PlainAttention)
    return CudaAttention if torch.device(device).type == "cuda" \
        else PlainAttention
