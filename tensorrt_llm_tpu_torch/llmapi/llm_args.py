"""LLM construction arguments: the subset of
`tensorrt_llm_tpu/llmapi/llm_args.py` that the port runs, plus `device`
(CUDA unless the caller asks for the CPU) and `params` (a ready model state,
e.g. from `params_from_jax`, instead of checkpoint or random weights).
`model` is a `ModelConfig` or an HF checkpoint directory; `tokenizer` a
path (loaded with `transformers`) or a tokenizer object; `quant_algo` /
`quant_group_size` quantize a float checkpoint at load (unset: an AWQ/GPTQ
checkpoint's own `quantization_config` is adopted); `load_format="dummy"`
draws random weights at the checkpoint's shapes.  `enable_warmup` None means
on for a CUDA device and off for the CPU, as the JAX package warms up on
the TPU only.  The scheduler's fields (`scheduler_policy`,
`enable_chunked_prefill`, `batch_wait_*`), the overlap
pipeline's (`disable_overlap_scheduler`, `overlap_depth`: JAX's defaults,
overlap on at depth 4) and the KV cache's (`enable_partial_reuse`,
`copy_on_partial_reuse`, `kv_bookkeeping`: "native" or "python", and the
host tier's `kv_host_cache_blocks`, `kv_secondary_offload_min_priority` and
`kv_connector`) carry the JAX package's names.  `quant_clip_search` and `lora_path` are fields of the JAX
package that the port refuses when set."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from tensorrt_llm_tpu_torch.quantization.mode import (
    KvCacheQuantAlgo, QuantAlgo, QuantConfig)
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import KVCacheConfig
from tensorrt_llm_tpu_torch.runtime.scheduler import (
    CapacitySchedulerPolicy, SchedulerConfig)


@dataclass
class LlmArgs:
    model: Any = None                  # ModelConfig | HF checkpoint dir
    tokenizer: Any = None              # path | tokenizer object
    dtype: Any = "bfloat16"            # activations: bf16 only
    device: Any = "cuda"
    params: Optional[Dict[str, Any]] = None

    # quantization
    quant_algo: Optional[str] = None   # e.g. "W4A16", "W4A8_AWQ"
    quant_group_size: int = 128
    quant_clip_search: bool = False    # calibrate.py's clip search: not yet

    max_batch_size: int = 64
    max_num_tokens: int = 2048         # per-step token budget
    max_seq_len: int = 2048

    kv_block_size: int = 16
    kv_num_blocks: Optional[int] = None  # None => from free device memory
    free_mem_fraction: float = 0.85
    enable_block_reuse: bool = True
    enable_partial_reuse: bool = True
    copy_on_partial_reuse: bool = True
    kv_bookkeeping: str = "native"     # "native" (C++) | "python"
    kv_cache_quant: str = "NONE"       # "INT8": int8 pages + f32 scales
    # host-memory tier for evicted reuse blocks (0: off), the least
    # retention priority it takes, and an external store with
    # save/load/contains (`runtime.kv_cache_manager.KvCacheConnector`)
    kv_host_cache_blocks: int = 0
    kv_secondary_offload_min_priority: Optional[int] = None
    kv_connector: Optional[Any] = None

    # scheduler
    scheduler_policy: str = "guaranteed_no_evict"
    enable_chunked_prefill: bool = True
    batch_wait_timeout_iters: int = 0
    batch_wait_max_tokens_ratio: float = 0.0

    lora_path: Optional[str] = None    # LoRA merged at load: not yet

    max_decode_steps: int = 8          # decode steps per executor iteration
    batched_logits_processor: Any = None
    disable_overlap_scheduler: bool = False
    overlap_depth: int = 4             # decode chunks in flight at most
    enable_warmup: Optional[bool] = None  # autotune + warm steps at build

    seed: int = 0
    skip_tokenizer_init: bool = False
    # "auto": read *.safetensors when the model directory has them;
    # "dummy": random weights at the checkpoint's shapes
    load_format: str = "auto"
    return_perf_metrics: bool = False

    def __post_init__(self):
        if self.load_format not in ("auto", "dummy"):
            raise ValueError(f"load_format={self.load_format!r}: 'auto' or "
                             "'dummy'")
        if self.dtype not in ("bfloat16", "auto", torch.bfloat16):
            raise NotImplementedError(
                f"dtype={self.dtype!r}: the port computes in bfloat16")

    def quant_config(self) -> Optional[QuantConfig]:
        if self.quant_clip_search:
            raise NotImplementedError(
                "quant_clip_search (the JAX package's calibrate.py clip "
                "search) is not in the port yet")
        if not self.quant_algo:
            return None
        return QuantConfig(
            quant_algo=QuantAlgo(self.quant_algo),
            kv_cache_quant_algo=KvCacheQuantAlgo(self.kv_cache_quant),
            group_size=self.quant_group_size)

    def make_kv_cache_config(self, layout: str = "kv",
                             dsa_index_dim: int = 0) -> KVCacheConfig:
        """The user's KV settings, with the pool layout the model needs."""
        return KVCacheConfig(block_size=self.kv_block_size,
                             num_blocks=self.kv_num_blocks,
                             free_mem_fraction=self.free_mem_fraction,
                             enable_block_reuse=self.enable_block_reuse,
                             enable_partial_reuse=self.enable_partial_reuse,
                             copy_on_partial_reuse=self.copy_on_partial_reuse,
                             bookkeeping=self.kv_bookkeeping,
                             kv_quant=KvCacheQuantAlgo(self.kv_cache_quant),
                             layout=layout, dsa_index_dim=dsa_index_dim,
                             host_cache_blocks=self.kv_host_cache_blocks,
                             secondary_offload_min_priority=(
                                 self.kv_secondary_offload_min_priority),
                             kv_connector=self.kv_connector)

    def make_scheduler_config(self) -> SchedulerConfig:
        return SchedulerConfig(
            policy=CapacitySchedulerPolicy(self.scheduler_policy),
            max_batch_size=self.max_batch_size,
            max_num_tokens=self.max_num_tokens,
            enable_chunked_prefill=self.enable_chunked_prefill,
            batch_wait_timeout_iters=self.batch_wait_timeout_iters,
            batch_wait_max_tokens_ratio=self.batch_wait_max_tokens_ratio)
