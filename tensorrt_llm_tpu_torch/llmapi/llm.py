"""The LLM user API.

Counterpart of `tensorrt_llm_tpu/llmapi/llm.py`: builds the model, the paged
KV cache, the engine and the executor thread, and serves `generate` /
`generate_async` on token-id prompts.  The model runs on CUDA unless the
caller passes ``device="cpu"``; without a GPU the default raises.

In this slice the model is a `ModelConfig` (or one of the presets of
`models/`: `gpt_oss_20b_config`, `moonlight_16b_a3b_config`,
`deepseek_v3_config`, `deepseek_v32_config`) with random (seeded) weights,
or with a ready state passed as ``params`` (see `params_from_jax`).  An MLA
model gets one latent pool per layer, plus the indexer pool under DSA.
Before the executor starts, the engine warms up (`ModelEngine.warmup`:
the W4A16 autotuner, then one prefill chunk and one decode step), by
default on a CUDA device only (`enable_warmup`).
Tokenizers, checkpoints, streaming iteration and the server belong to
later slices.
"""

from __future__ import annotations

import dataclasses
import weakref
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Union

import torch

from tensorrt_llm_tpu_torch.llmapi.llm_args import LlmArgs
from tensorrt_llm_tpu_torch.llmapi.sampling_params import SamplingParams
from tensorrt_llm_tpu_torch.models.modeling_utils import (
    ModelConfig, get_model_class)
from tensorrt_llm_tpu_torch.quantization.mode import KvCacheQuantAlgo
from tensorrt_llm_tpu_torch.runtime.executor import PyExecutor
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
    KVCacheManager, pool_layout)
from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine
from tensorrt_llm_tpu_torch.runtime.request import LlmRequest
from tensorrt_llm_tpu_torch.utils import cdiv, resolve_device


@dataclass
class CompletionOutput:
    index: int
    text: str
    token_ids: List[int]
    finish_reason: Optional[str] = None
    logprobs: Optional[list] = None


@dataclass
class RequestOutput:
    request_id: int
    prompt: Optional[str]
    prompt_token_ids: List[int]
    outputs: List[CompletionOutput] = field(default_factory=list)
    finished: bool = False
    metrics: Optional[dict] = None


class LLM:
    def __init__(self, model: Any = None, tokenizer: Any = None,
                 args: Optional[LlmArgs] = None, **kwargs):
        if args is None:
            args = LlmArgs(model=model, tokenizer=tokenizer, **kwargs)
        self.args = args
        self.executor = None
        self.device = resolve_device(args.device)
        self._build()

    def _build(self):
        a = self.args
        if a.tokenizer is not None or not a.skip_tokenizer_init:
            raise NotImplementedError(
                "tokenizers are not in this slice of the port: pass "
                "skip_tokenizer_init=True and token-id prompts")
        if not isinstance(a.model, ModelConfig):
            raise NotImplementedError(
                "this slice takes a ModelConfig; checkpoint loading comes "
                f"later (got {type(a.model).__name__})")
        cfg = dataclasses.replace(a.model)
        cfg.max_position = max(cfg.max_position, a.max_seq_len)
        self.model_config = cfg
        self.model = get_model_class(cfg.architecture)(cfg, self.device)
        if a.params is not None:
            self.model.load_state(a.params)
        else:
            self.model.init_random(a.seed)
        geo = pool_layout(cfg)
        kvcfg = a.make_kv_cache_config(geo["layout"], geo["dsa_index_dim"])
        num_blocks = kvcfg.num_blocks or self._derive_num_blocks(cfg, kvcfg)
        self.kv_manager = KVCacheManager(kvcfg, cfg.num_layers,
                                         geo["num_kv_heads"],
                                         geo["head_dim"], num_blocks,
                                         self.device)
        self.engine = ModelEngine(self.model, self.kv_manager, self.device)
        warm = a.enable_warmup
        if warm is None:
            warm = self.device.type == "cuda"
        if warm:
            # tune the W4A16 tactics and warm the steps before serving
            self.engine.warmup(min(a.max_num_tokens, a.max_seq_len - 1),
                               a.max_batch_size)
        self.executor = PyExecutor(
            self.engine, a.make_scheduler_config(), eos_token_id=None,
            max_seq_len=a.max_seq_len, max_decode_steps=a.max_decode_steps)
        self.executor.start()
        # join the executor thread at interpreter exit even without shutdown()
        self._exit_finalizer = weakref.finalize(
            self, PyExecutor.shutdown, self.executor)

    def _derive_num_blocks(self, cfg: ModelConfig, kvcfg) -> int:
        """Pool size from free device memory (reference
        calculate_max_num_blocks), bounded by what max_batch_size sequences
        of max_seq_len could use."""
        a = self.args
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            budget = int(free * kvcfg.free_mem_fraction)
        else:
            budget = 4 << 30
        int8 = kvcfg.kv_quant == KvCacheQuantAlgo.INT8
        n = KVCacheManager.blocks_from_memory(
            budget, cfg.num_layers, cfg.kv_pool_heads, cfg.kv_pool_dim,
            kvcfg.block_size, dtype_bytes=1 if int8 else 2,
            num_pools=1 if kvcfg.layout == "latent" else 2,
            extra_dims=kvcfg.dsa_index_dim,
            scale_pools=int8)
        need = a.max_batch_size * cdiv(a.max_seq_len, kvcfg.block_size)
        return min(max(n, 64), max(need * 2, 64) * 8)

    # ------------------------------------------------------------ generate --
    def generate(self, prompts: Union[Sequence[List[int]], List[int]],
                 sampling_params: Union[SamplingParams,
                                        Sequence[SamplingParams], None] = None,
                 cache_salt: Optional[str] = None) -> List[RequestOutput]:
        """Serve a batch of token-id prompts.  The batch reaches the
        executor in one piece, so the schedule does not depend on how fast
        the caller submits."""
        import numbers
        if prompts and isinstance(prompts[0], numbers.Integral):
            prompts = [prompts]
        sampling_params = sampling_params or SamplingParams()
        sps = ([sampling_params] * len(prompts)
               if isinstance(sampling_params, SamplingParams)
               else list(sampling_params))
        reqs = [self._request(p, sp, cache_salt)
                for p, sp in zip(prompts, sps)]
        self.executor.submit_many(reqs)
        return [GenerationFuture(self, r).result() for r in reqs]

    def generate_async(self, prompt: List[int],
                       sampling_params: Optional[SamplingParams] = None,
                       cache_salt: Optional[str] = None
                       ) -> "GenerationFuture":
        req = self._request(prompt, sampling_params, cache_salt)
        self.executor.submit(req)
        return GenerationFuture(self, req)

    @staticmethod
    def _request(prompt, sampling_params, cache_salt):
        if isinstance(prompt, str):
            raise NotImplementedError("text prompts need a tokenizer, which "
                                      "is not in this slice")
        return LlmRequest([int(t) for t in prompt],
                          sampling_params or SamplingParams(),
                          cache_salt=(None if cache_salt is None
                                      else f"user:{cache_salt}"))

    def get_kv_cache_stats(self) -> dict:
        return self.kv_manager.stats()

    def get_stats(self) -> List[dict]:
        return self.executor.get_stats()

    def shutdown(self):
        if self.executor is not None:
            self.executor.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


class GenerationFuture:
    """Handle of one in-flight request."""

    def __init__(self, llm: LLM, req: LlmRequest):
        self.llm = llm
        self.req = req

    @property
    def request_id(self) -> int:
        return self.req.request_id

    def result(self, timeout: Optional[float] = None) -> RequestOutput:
        toks: List[int] = []
        while True:
            piece = self.req.out_queue.get(timeout=timeout)
            if piece.error:
                raise RuntimeError(f"generation failed: {piece.error}")
            toks.extend(piece.new_token_ids)
            if piece.finished:
                reason = piece.finish_reason
                break
        r = self.req
        metrics = None
        if self.llm.args.return_perf_metrics:
            metrics = {
                "arrival_time": r.arrival_time,
                "first_scheduled_time": r.first_sched_time,
                "first_token_time": r.first_token_time,
                "last_token_time": r.end_time,
                "ttft_s": (r.first_token_time - r.arrival_time
                           if r.first_token_time else None),
                "e2e_s": (r.end_time - r.arrival_time
                          if r.end_time else None),
                "kv_cache_hit_tokens": r.num_cached_tokens,
                "num_output_tokens": r.num_output_tokens,
            }
        return RequestOutput(
            request_id=r.request_id, prompt=None,
            prompt_token_ids=r.prompt_token_ids,
            outputs=[CompletionOutput(
                index=0, text="", token_ids=toks,
                finish_reason=reason.value if reason else None,
                logprobs=r.logprobs or None)],
            finished=True, metrics=metrics)
