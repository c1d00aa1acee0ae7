"""LLM construction arguments: the subset of
`tensorrt_llm_tpu/llmapi/llm_args.py` that this slice runs, plus `device`
(CUDA unless the caller asks for the CPU) and `params` (a ready model state,
e.g. from `params_from_jax`, instead of random weights).  `enable_warmup`
None means on for a CUDA device and off for the CPU, as the JAX package
warms up on the TPU only."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from tensorrt_llm_tpu_torch.quantization.mode import KvCacheQuantAlgo
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import KVCacheConfig
from tensorrt_llm_tpu_torch.runtime.scheduler import SchedulerConfig


@dataclass
class LlmArgs:
    model: Any = None                  # ModelConfig (HF loading: later)
    tokenizer: Any = None
    device: Any = "cuda"
    params: Optional[Dict[str, Any]] = None

    max_batch_size: int = 64
    max_num_tokens: int = 2048         # per-step token budget
    max_seq_len: int = 2048

    kv_block_size: int = 16
    kv_num_blocks: Optional[int] = None  # None => from free device memory
    free_mem_fraction: float = 0.85
    enable_block_reuse: bool = True
    kv_cache_quant: str = "NONE"       # "INT8": int8 pages + f32 scales

    max_decode_steps: int = 8          # decode steps per executor iteration
    enable_warmup: Optional[bool] = None  # autotune + warm steps at build

    seed: int = 0
    skip_tokenizer_init: bool = False
    return_perf_metrics: bool = False

    def make_kv_cache_config(self, layout: str = "kv",
                             dsa_index_dim: int = 0) -> KVCacheConfig:
        """The user's KV settings, with the pool layout the model needs."""
        return KVCacheConfig(block_size=self.kv_block_size,
                             num_blocks=self.kv_num_blocks,
                             free_mem_fraction=self.free_mem_fraction,
                             enable_block_reuse=self.enable_block_reuse,
                             kv_quant=KvCacheQuantAlgo(self.kv_cache_quant),
                             layout=layout, dsa_index_dim=dsa_index_dim)

    def make_scheduler_config(self) -> SchedulerConfig:
        return SchedulerConfig(max_batch_size=self.max_batch_size,
                               max_num_tokens=self.max_num_tokens)
