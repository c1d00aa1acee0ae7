"""Plain PyTorch attention backend: gather-based paged attention over bf16,
FP8 (upcast after the gather) or INT8 pools (dequantized after the
gather), and draft-tree verification
under a pair mask.  Counterpart of
`tensorrt_llm_tpu/attention_backend/xla_backend.py`."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.attention_backend.interface import (
    AttentionBackend, AttentionMetadata)
from tensorrt_llm_tpu_torch.ops.attention_plain import (
    paged_decode_plain, paged_prefill_plain, write_kv_cache)


class PlainAttention(AttentionBackend):
    def __call__(self, q, k, v, k_cache, v_cache, meta: AttentionMetadata,
                 sinks=None):
        if meta.cyclic:
            raise NotImplementedError(
                "cyclic (VSWA ring) attention is not in this slice of the "
                "port")
        if meta.pair_mask is not None and meta.mode == "prefill":
            return self.tree_attention(q, k, v, k_cache, v_cache, meta,
                                       sinks)
        write_kv_cache(k_cache, v_cache, k, v, meta.slot_mapping)
        if meta.mode == "prefill":
            return paged_prefill_plain(
                q, k_cache, v_cache, meta.block_tables[0],
                kv_len=meta.q_offset + q.shape[0], q_offset=meta.q_offset,
                scale=self.scale, sliding_window=self.sliding_window,
                sinks=sinks)
        return paged_decode_plain(q, k_cache, v_cache, meta.block_tables,
                                  meta.kv_lens, scale=self.scale,
                                  sliding_window=self.sliding_window,
                                  sinks=sinks)
