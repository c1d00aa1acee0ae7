"""Plain PyTorch attention backend: gather-based paged attention over bf16,
FP8 (upcast after the gather) or INT8 pools (dequantized after the
gather), VSWA cyclic rings, logit caps, chunked attention and draft-tree
verification under a pair mask (`AttentionBackend.plain_attention`).
Counterpart of `tensorrt_llm_tpu/attention_backend/xla_backend.py`."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.attention_backend.interface import (
    AttentionBackend, AttentionMetadata)


class PlainAttention(AttentionBackend):
    def __call__(self, q, k, v, k_cache, v_cache, meta: AttentionMetadata,
                 sinks=None):
        return self.plain_attention(q, k, v, k_cache, v_cache, meta, sinks)
