"""CUDA attention backend: prefill on kernel K3, decode on kernel K4, over
bf16 pools or, in their e4m3 instances, FP8 pools; over INT8 pools prefill
on K7 and decode on K6.

Counterpart of `tensorrt_llm_tpu/attention_backend/pallas_backend.py:51-108`,
with its dispatch condition (`plain_route`): a step that JAX sends to XLA
takes the plain ops here too (`AttentionBackend.plain_attention`) -- a
VSWA ring (``meta.cyclic``), chunked attention (`attention_chunk`), a pair
mask (draft-tree verification), pages that are not lane-aligned (a head
dim that neither is a multiple of 128 nor divides 128, such as 80 or 96,
or a page whose ``BS * D`` is no multiple of 128), and INT8 pools at a
head dim the kernels do not take.  One exception: INT8 pools at D 64 run
K6/K7, where JAX goes to XLA, as the port has kernels for them.  Every
other step runs a kernel, and a shape the kernels do not take (D 32, D
384, bf16 pages under 8 tokens) raises NotImplementedError in their
wrappers: nothing gives way to the plain ops after a refusal, a failed
build or a failed launch.  The KV append stays plain torch
(`write_kv_cache`: an `index_copy_` scatter, after `quantize_kv_token`
for INT8 pools and the e4m3 cast for FP8 pools), as XLA does it in the
JAX package.
"""

from __future__ import annotations

from tensorrt_llm_tpu_torch.attention_backend.interface import (
    AttentionBackend, AttentionMetadata)
from tensorrt_llm_tpu_torch.ops.attention_plain import (
    pool_dims, write_kv_cache)
from tensorrt_llm_tpu_torch.ops.flash_prefill import (
    PREFILL_HEAD_DIMS, flash_prefill_attention)
from tensorrt_llm_tpu_torch.ops.paged_attention import (
    DECODE_HEAD_DIMS, paged_decode_attention, pool_kind)


def plain_route(head_dim: int, page_size: int, kind: str, cyclic: bool,
                attention_chunk, pair_mask: bool) -> bool:
    """Whether a step takes the plain ops: the JAX Pallas backend's XLA
    condition (`pallas_backend.py:57-76`), except that INT8 pools at a head
    dim the port's kernels take (64) keep their kernels."""
    D = head_dim
    lane_ok = D % 128 == 0 or (128 % D == 0 and (page_size * D) % 128 == 0)
    int8_kernel = D % 128 == 0 or D in set(DECODE_HEAD_DIMS) & set(
        PREFILL_HEAD_DIMS)
    return (cyclic or attention_chunk is not None or pair_mask
            or not lane_ok or (kind == "int8" and not int8_kernel))


class CudaAttention(AttentionBackend):
    def __call__(self, q, k, v, k_cache, v_cache, meta: AttentionMetadata,
                 sinks=None):
        if plain_route(self.head_dim, pool_dims(k_cache)[2],
                       pool_kind(k_cache), meta.cyclic, self.attention_chunk,
                       meta.pair_mask is not None):
            return self.plain_attention(q, k, v, k_cache, v_cache, meta,
                                        sinks)
        write_kv_cache(k_cache, v_cache, k, v, meta.slot_mapping)
        if meta.mode == "prefill":
            return flash_prefill_attention(
                q, k_cache, v_cache, meta.block_tables[0],
                kv_len=meta.q_offset + q.shape[0], q_offset=meta.q_offset,
                scale=self.scale, sliding_window=self.sliding_window,
                logit_cap=self.logit_cap, sinks=sinks)
        return paged_decode_attention(q, k_cache, v_cache, meta.block_tables,
                                      meta.kv_lens, scale=self.scale,
                                      sliding_window=self.sliding_window,
                                      logit_cap=self.logit_cap, sinks=sinks)
