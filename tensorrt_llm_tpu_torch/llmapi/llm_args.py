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
`kv_connector`) carry the JAX package's names.  `quant_algo` takes every
`QuantAlgo` name (the W4A16 family, W4A8_AWQ, W8A16,
W8A8_SQ_PER_CHANNEL, FP8, FP8_PER_CHANNEL_PER_TOKEN), `kv_cache_quant`
"NONE", "INT8" or "FP8", and `quant_clip_search` quantizes int4 weights
with the clip-ratio search (`quantization/calibrate.py`).  LoRA: `lora_path`
(a PEFT adapter directory merged into the checkpoint's weights at load),
`lora_adapters` ({name: directory}, served per request through
``generate(..., lora_request=name)``) and `lora_max_device_adapters` (at
most this many adapters in device slots, the rest paged in on demand; None:
all resident).  `speculative_config` (a
`speculative.SpeculativeConfig` or a mode name such as "AUTO") turns on
speculative decoding.  The parallel sizes carry the JAX package's names;
the port has no parallel mapping yet, so any size above 1 is refused
(`check_parallel`), after the refusals the JAX package makes of
speculation under star context parallelism and of hidden-tap drafters
under pipeline parallelism."""

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
    quant_algo: Optional[str] = None   # e.g. "W4A16", "W4A8_AWQ", "FP8"
    quant_group_size: int = 128
    quant_clip_search: bool = False    # int4: calibrate.py's clip search

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
    # "INT8": int8 pages + f32 scales; "FP8": e4m3 pages, no scales
    kv_cache_quant: str = "NONE"
    # host-memory tier for evicted reuse blocks (0: off), the least
    # retention priority it takes, and an external store with
    # save/load/contains (`runtime.kv_cache_manager.KvCacheConnector`)
    kv_host_cache_blocks: int = 0
    kv_secondary_offload_min_priority: Optional[int] = None
    kv_connector: Optional[Any] = None
    # VSWA: sliding-window layers in ring pools of their own (the JAX
    # package's `KVCacheConfig.separate_window_pools`, default True; the
    # port's flat LlmArgs carries it as the other kv_* fields).  False
    # keeps full pools: more KV memory, but the sliding layers stay on the
    # attention kernels and keep prefix reuse (GPT-OSS's 128-token window
    # serves faster that way: `chip_smoke.py gptoss_rings_ab`)
    kv_separate_window_pools: bool = True

    # scheduler
    scheduler_policy: str = "guaranteed_no_evict"
    enable_chunked_prefill: bool = True
    batch_wait_timeout_iters: int = 0
    batch_wait_max_tokens_ratio: float = 0.0

    # LoRA: merged at load, or served per request from device slots
    lora_path: Optional[str] = None
    lora_adapters: Optional[Dict[str, str]] = None
    lora_max_device_adapters: Optional[int] = None

    # parallelism (JAX names): refused above 1 until the port has a mapping
    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    data_parallel_size: int = 1
    context_parallel_size: int = 1
    context_parallel_type: str = "ulysses"

    speculative_config: Optional[Any] = None   # SpeculativeConfig | name

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

    def check_parallel(self, drafter=None) -> None:
        """Refuse what the port cannot run: speculation under star context
        parallelism and a hidden-tap drafter under pipeline parallelism
        (AssertionError, as the JAX package's asserts), then any parallel
        size above 1 (NotImplementedError)."""
        if self.context_parallel_size > 1 \
                and self.context_parallel_type == "star" \
                and self.speculative_config is not None:
            raise AssertionError(
                "speculative decoding under star CP lands later")
        if self.pipeline_parallel_size > 1 \
                and getattr(drafter, "needs_hidden", False):
            raise AssertionError("hidden-tapping drafters (EAGLE/MTP) stay "
                                 "single-step under PP")
        sizes = {"tensor_parallel_size": self.tensor_parallel_size,
                 "pipeline_parallel_size": self.pipeline_parallel_size,
                 "data_parallel_size": self.data_parallel_size,
                 "context_parallel_size": self.context_parallel_size}
        big = [f"{k}={v}" for k, v in sizes.items() if v > 1]
        if big:
            raise NotImplementedError(
                f"{', '.join(big)} needs the parallel mapping "
                "(tensorrt_llm_tpu_torch.parallel), not in the port yet")

    def quant_config(self) -> Optional[QuantConfig]:
        if not self.quant_algo:
            return None
        return QuantConfig(
            quant_algo=QuantAlgo(self.quant_algo),
            kv_cache_quant_algo=KvCacheQuantAlgo(self.kv_cache_quant),
            group_size=self.quant_group_size,
            clip_search=self.quant_clip_search)

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
                             kv_connector=self.kv_connector,
                             separate_window_pools=(
                                 self.kv_separate_window_pools))

    def make_scheduler_config(self) -> SchedulerConfig:
        return SchedulerConfig(
            policy=CapacitySchedulerPolicy(self.scheduler_policy),
            max_batch_size=self.max_batch_size,
            max_num_tokens=self.max_num_tokens,
            enable_chunked_prefill=self.enable_chunked_prefill,
            batch_wait_timeout_iters=self.batch_wait_timeout_iters,
            batch_wait_max_tokens_ratio=self.batch_wait_max_tokens_ratio)
