"""CUDA attention backend: prefill on kernel K3, decode on kernel K4, over
bf16 pools or, in their e4m3 instances, FP8 pools; over INT8 pools prefill
on K7 and decode on K6.

Counterpart of `tensorrt_llm_tpu/attention_backend/pallas_backend.py:51-108`,
which sends FP8 pools (plain e4m3 arrays, not INT8's pairs) to its Pallas
prefill and decode kernels as well.  The KV append stays plain torch
(`write_kv_cache`: an `index_copy_` scatter, after `quantize_kv_token` for
INT8 pools and the e4m3 cast for FP8 pools), as XLA does it in the JAX
package.  A prefill step with a pair mask (draft-tree verification) goes
to the plain `tree_verify_attention`, as the JAX Pallas backend sends it
to XLA (`pallas_backend.py:70` -> `xla_backend.py:34`).  A shape the
kernels refuse raises NotImplementedError in their wrappers, and cyclic
VSWA rings raise here: nothing is rerouted to another path.
"""

from __future__ import annotations

from tensorrt_llm_tpu_torch.attention_backend.interface import (
    AttentionBackend, AttentionMetadata)
from tensorrt_llm_tpu_torch.ops.attention_plain import write_kv_cache
from tensorrt_llm_tpu_torch.ops.flash_prefill import flash_prefill_attention
from tensorrt_llm_tpu_torch.ops.paged_attention import paged_decode_attention


class CudaAttention(AttentionBackend):
    def __call__(self, q, k, v, k_cache, v_cache, meta: AttentionMetadata,
                 sinks=None):
        if meta.cyclic:
            raise NotImplementedError("cyclic VSWA rings are not in this slice")
        if meta.pair_mask is not None and meta.mode == "prefill":
            return self.tree_attention(q, k, v, k_cache, v_cache, meta,
                                       sinks)
        write_kv_cache(k_cache, v_cache, k, v, meta.slot_mapping)
        if meta.mode == "prefill":
            return flash_prefill_attention(
                q, k_cache, v_cache, meta.block_tables[0],
                kv_len=meta.q_offset + q.shape[0], q_offset=meta.q_offset,
                scale=self.scale, sliding_window=self.sliding_window,
                sinks=sinks)
        return paged_decode_attention(q, k_cache, v_cache, meta.block_tables,
                                      meta.kv_lens, scale=self.scale,
                                      sliding_window=self.sliding_window,
                                      sinks=sinks)

