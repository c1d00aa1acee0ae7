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
PyTorch versions on the CPU.
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
    # a feature of the JAX interface that the port does not run
    cyclic: bool = False

    def __post_init__(self):
        assert self.mode in ("prefill", "decode")


class AttentionBackend:
    """Base: write the new K/V into the paged cache, then attend.  A
    sliding-window layer's backend masks keys more than `sliding_window`
    positions behind each query."""

    def __init__(self, num_heads: int, num_kv_heads: int, head_dim: int,
                 scale: float, sliding_window: Optional[int] = None):
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.scale = scale
        self.sliding_window = sliding_window

    def __call__(self, q, k, v, k_cache, v_cache, meta: AttentionMetadata,
                 sinks=None) -> torch.Tensor:
        raise NotImplementedError

    def tree_attention(self, q, k, v, k_cache, v_cache,
                       meta: AttentionMetadata, sinks=None) -> torch.Tensor:
        """Draft-tree verification (JAX `XlaAttention` under a pair mask),
        plain ops on every device: the prefix is read before this chunk's
        K/V are written (rows with a pad slot, the tree's, land in reserved
        page 0)."""
        from tensorrt_llm_tpu_torch.ops.attention_plain import (
            tree_verify_attention, write_kv_cache)
        out = tree_verify_attention(
            q, k_cache, v_cache, k, v, meta.block_tables[0], meta.q_offset,
            meta.positions, meta.pair_mask, self.scale,
            sliding_window=self.sliding_window, sinks=sinks)
        write_kv_cache(k_cache, v_cache, k, v, meta.slot_mapping)
        return out


def get_attention_backend(device) -> type:
    from tensorrt_llm_tpu_torch.attention_backend.cuda_backend import (
        CudaAttention)
    from tensorrt_llm_tpu_torch.attention_backend.plain_backend import (
        PlainAttention)
    return CudaAttention if torch.device(device).type == "cuda" \
        else PlainAttention
