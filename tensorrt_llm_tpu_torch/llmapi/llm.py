"""The LLM user API.

Counterpart of `tensorrt_llm_tpu/llmapi/llm.py`: builds the model, the paged
KV cache, the engine and the executor thread, and serves `generate` /
`generate_async` on text or token-id prompts, with text returned whole or
streamed.  The model runs on CUDA unless the caller passes ``device="cpu"``;
without a GPU the default raises.

`model` is an HF checkpoint directory (`config.json`, read with `json`, and
`*.safetensors`, read by the port's own `SafetensorsReader`; no
`transformers` or `safetensors` needed), loaded by `load_hf_weights`:
quantized at load under `quant_algo`, or, when that is unset and the
checkpoint is AWQ/GPTQ, taken as stored under its own
`quantization_config`.  `load_format="dummy"`, or a directory without
weights (with a warning), draws random weights at the checkpoint's shapes.
`model` may instead be a `ModelConfig` (or one of the presets of `models/`)
with random (seeded) weights, or with a ready state passed as ``params``
(see `params_from_jax`).  `update_weights` swaps in the weights of another
checkpoint of the same shapes.  An MLA model gets one latent pool per
layer, plus the indexer pool under DSA.

The tokenizer is an object with ``encode``/``decode``/``eos_token_id``
given as `tokenizer`, or a path (the model directory by default) loaded
with `transformers.AutoTokenizer`, imported only then;
``skip_tokenizer_init=True`` serves token ids only.  Its eos id stops
generation.  `GenerationFuture.result` detokenizes the output whole;
iterating the future (``generate_async(..., streaming=True)``) yields one
`RequestOutput` per executor piece, with cumulative token ids and text from
`IncrementalDetokenizer`; `GenerationFuture.cancel` ends the request at the
executor's next iteration (finish reason "cancelled").  `generate_async`
takes the JAX signature's scheduling `priority` and
`kv_retention_priority`.  A stop string (it needs a tokenizer) is cut from
the text unless `include_stop_str_in_output`; tokens sampled past it are
dropped from `result()` and from the stream (a piece's `truncate_to`).
``n > 1`` (without beam search) submits n sibling requests, seeds
``seed + j``, which share the prompt's KV through prefix reuse, and
returns one `RequestOutput` with n outputs (`_FanoutFuture`; not
streamed).  Outputs carry the top-N `logprobs`, `generation_logits`,
`prompt_logprobs` and `context_logits` when the sampling parameters ask
for them.

Before the executor starts, the engine warms up (`ModelEngine.warmup`: the
W4A16 autotuner, then one prefill chunk and one decode step), by default on
a CUDA device only (`enable_warmup`).

For the server (JAX `llmapi/llm.py:399-436, 811-820`): `get_kv_cache_events`
and `match_kv_prefix` read the KV manager's event ring and reuse index,
on the executor thread between two steps (`read_kv`);
`release_memory` closes the executor's submit door (refusing while a
request is in flight), then moves every weight to pinned host memory
between two steps and frees the device copies; `resume_memory` puts them
back on the device, at new addresses, which every layer reads at its next
call (nothing in the port keeps a weight's pointer).  The futures' pieces
can be read without a blocked thread: `GenerationFuture.fold` /
`stream_fold` turn the pieces of `req.out_queue` into `RequestOutput`s, and
`LlmRequest.listener` is called after each piece is queued.

Disaggregated serving (JAX `llmapi/llm.py:575-580, 705-732`):
`generate_async(..., disaggregated_params=)` submits a ``context_only``
request (its sampling parameters copied with ``max_tokens=1``) or a
``generation_only`` one, whose whole payload is checked against the pools
at submit (ValueError: `ModelEngine.check_kv_layers`).
`generate_context_only` returns the first token and the
`DisaggregatedParams` a decode worker takes; `generate_context_only_streamed`
returns the future and the queue its KV frames appear on while the prefill
still runs.  The host KV tier and the connector are the `LlmArgs` fields
`kv_host_cache_blocks`, `kv_secondary_offload_min_priority` and
`kv_connector`.

Beam search (``SamplingParams(use_beam_search=True, n=..., best_of=...)``)
is one request whatever its `n`; its result holds one `CompletionOutput`
per returned beam, best first, with `cumulative_logprob` and, under
`logprobs`, each token's logprob (JAX `llmapi/llm.py:877-886`).

LoRA (JAX `llmapi/llm.py:182-220, 583-610`): `lora_path` merges a PEFT
adapter into the checkpoint's weights as they are read, before
quantization (`lora.merge_lora_into_state`; a model that is not read from
a checkpoint refuses it).  `lora_adapters` installs the adapters' stacks
on the model (`lora.multi_lora`), paged through
`lora_max_device_adapters` device slots when fewer than the adapters;
``generate(..., lora_request=name)`` and ``generate_async(...,
lora_request=name)`` then serve a request with that adapter: its slot is
pinned until it ends (a paged slot may wait for one to free; `generate`
first submits the requests it has already pinned), and ``lora:{name}`` is
folded into its prefix-reuse salt.  An unknown adapter raises KeyError.

`speculative_config` (JAX `llmapi/llm.py:240-300`) builds the drafter
(`speculative.get_drafter`) that the executor binds; an MTP drafter
without its own weights takes the checkpoint's extra layer, which
`load_hf_weights` hands over.  Parallel sizes above 1 are refused
(`LlmArgs.check_parallel`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import numbers
import os
import warnings
import weakref
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from tensorrt_llm_tpu_torch.llmapi.detokenizer import IncrementalDetokenizer
from tensorrt_llm_tpu_torch.llmapi.disagg_params import DisaggregatedParams
from tensorrt_llm_tpu_torch.llmapi.hf_checkpoint import (
    SafetensorsReader, has_weights, read_hf_config)
from tensorrt_llm_tpu_torch.llmapi.llm_args import LlmArgs
from tensorrt_llm_tpu_torch.llmapi.sampling_params import SamplingParams
from tensorrt_llm_tpu_torch.lora.lora_manager import (
    load_lora_adapter, merge_lora_into_state)
from tensorrt_llm_tpu_torch.lora.multi_lora import (
    MultiLoraManager, PagedMultiLoraManager)
from tensorrt_llm_tpu_torch.models.modeling_utils import (
    ModelConfig, get_model_class)
from tensorrt_llm_tpu_torch.quantization.hf_ingest import quant_config_from_hf
from tensorrt_llm_tpu_torch.quantization.mode import (
    KvCacheQuantAlgo, QuantAlgo, QuantConfig)
from tensorrt_llm_tpu_torch.runtime.executor import PyExecutor
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
    KVCacheManager, pool_layout)
from tensorrt_llm_tpu_torch.runtime.model_engine import (
    ModelEngine, default_ring_slots, ring_plan)
from tensorrt_llm_tpu_torch.runtime.request import LlmRequest
from tensorrt_llm_tpu_torch.utils import cdiv, resolve_device


@dataclass
class CompletionOutput:
    index: int
    text: str
    token_ids: List[int]
    finish_reason: Optional[str] = None
    logprobs: Optional[list] = None
    cumulative_logprob: Optional[float] = None   # beam search
    # np [num_output_tokens, V], when return_generation_logits was set
    generation_logits: Optional[Any] = None


@dataclass
class RequestOutput:
    request_id: int
    prompt: Optional[str]
    prompt_token_ids: List[int]
    outputs: List[CompletionOutput] = field(default_factory=list)
    finished: bool = False
    # top-N logprobs per prompt position (entry 0 is None), when
    # SamplingParams.prompt_logprobs was set
    prompt_logprobs: Optional[list] = None
    # np [prompt_len, V], when return_context_logits was set
    context_logits: Optional[Any] = None
    metrics: Optional[dict] = None


def resolve_model_config(a: LlmArgs) -> tuple:
    """(ModelConfig, checkpoint directory or None) of the arguments: the
    `ModelConfig` given (with `quant_algo`'s config when set), or the one
    of a checkpoint's `config.json`, quantized under `quant_algo` or, when
    that is unset, under an AWQ/GPTQ checkpoint's own
    `quantization_config`."""
    quant = a.quant_config()
    if isinstance(a.model, ModelConfig):
        cfg = dataclasses.replace(a.model)
        if quant is not None:
            cfg.quant = quant
        return cfg, None
    if not isinstance(a.model, (str, os.PathLike)):
        raise TypeError("model must be a checkpoint directory or a "
                        f"ModelConfig, got {type(a.model).__name__}")
    path = str(a.model)
    hf = read_hf_config(path)
    if quant is None:
        hq = quant_config_from_hf(hf.get("quantization_config"))
        if hq is not None:
            kw = dict(quant_algo=QuantAlgo(hq["algo"]),
                      group_size=hq["group_size"], has_zero_point=True,
                      pre_quantized=True, ckpt_format=hq["format"],
                      ckpt_v2=hq["v2"])
            if hq["exclude_modules"]:
                kw["exclude_modules"] = tuple(hq["exclude_modules"]) + (
                    "embed",)
            quant = QuantConfig(**kw)
    return ModelConfig.from_hf_config(hf, quant=quant), path


def plan_kv_pools(cfg: ModelConfig, kvcfg, max_seq_len: int,
                  max_batch_size: int, budget: int):
    """``(num_blocks, ring_slots)``: the main pool's blocks and, where the
    sliding layers get VSWA rings (`ring_plan`), their ring slots (else
    None), out of `budget` device bytes for every pool.  The main pool
    (reference calculate_max_num_blocks) holds the global layers only, and
    is bounded by what `max_batch_size` sequences of `max_seq_len` could
    use; `kvcfg.num_blocks` fixes it.  Rings take `default_ring_slots`,
    cut to their share of the budget: what the main pool leaves of it
    when its size is fixed, else the share a ring slot has of one
    `max_seq_len` sequence's bytes (its ring beside its main blocks)."""
    bs = kvcfg.block_size
    one_byte = kvcfg.kv_quant != KvCacheQuantAlgo.NONE
    layer = KVCacheManager.block_bytes(
        1, cfg.kv_pool_heads, cfg.kv_pool_dim, bs,
        dtype_bytes=1 if one_byte else 2,
        num_pools=1 if kvcfg.layout == "latent" else 2,
        extra_dims=kvcfg.dsa_index_dim,
        scale_pools=kvcfg.kv_quant == KvCacheQuantAlgo.INT8)
    need = max_batch_size * cdiv(max_seq_len, bs)
    cap = max(need * 2, 64) * 8
    plan = ring_plan(cfg, bs, max_seq_len, kvcfg.separate_window_pools)
    if plan is None:
        n = kvcfg.num_blocks or min(
            max(budget // (cfg.num_layers * layer), 64), cap)
        return n, None
    _, ring_blocks, sliding = plan
    n_global = cfg.num_layers - len(sliding)
    slot = len(sliding) * ring_blocks * layer
    reserved = len(sliding) * layer          # each ring pool's block 0
    if kvcfg.num_blocks:
        ring_budget = budget - kvcfg.num_blocks * n_global * layer
    else:
        seq = n_global * cdiv(max_seq_len, bs) * layer
        ring_budget = budget * slot // (slot + seq)
    slots = max(1, min(default_ring_slots(max_batch_size),
                       (ring_budget - reserved) // slot))
    if kvcfg.num_blocks:
        return kvcfg.num_blocks, slots
    if not n_global:
        # every layer rings: main blocks are bookkeeping alone
        return max(need, 64), slots
    rest = budget - reserved - slots * slot
    return min(max(rest // (n_global * layer), 64), cap), slots


class LLM:
    def __init__(self, model: Any = None, tokenizer: Any = None,
                 args: Optional[LlmArgs] = None, **kwargs):
        if args is None:
            args = LlmArgs(model=model, tokenizer=tokenizer, **kwargs)
        self.args = args
        self.executor = None
        self._tokenizer = None
        self._released_state = None
        self.lora_manager = None
        self.device = resolve_device(args.device)
        self._build()

    # ---------------------------------------------------------------- build --
    def _load_tokenizer(self, model_path: Optional[str]):
        """The tokenizer object as given, or one loaded from a path (the
        model directory by default) with `transformers.AutoTokenizer`."""
        if self.args.skip_tokenizer_init:
            return None
        tok = self.args.tokenizer
        if tok is None:
            tok = model_path
        if isinstance(tok, (str, os.PathLike)):
            try:
                from transformers import AutoTokenizer
            except ImportError as e:
                raise ImportError(
                    f"tokenizer={str(tok)!r} is a path, which needs the "
                    "`transformers` package; pass a tokenizer object "
                    "(encode/decode/eos_token_id) or skip_tokenizer_init="
                    "True") from e
            return AutoTokenizer.from_pretrained(tok)
        return tok

    def _build(self):
        a = self.args
        drafter = None
        if a.speculative_config is not None:
            from tensorrt_llm_tpu_torch.speculative import get_drafter
            drafter = get_drafter(a.speculative_config, a)
        a.check_parallel(drafter)
        with contextlib.ExitStack() as stack:
            self._build_with(drafter, stack)

    def _build_with(self, drafter, stack: contextlib.ExitStack):
        """The build; a checkpoint reader stays open on `stack` until the
        executor has bound the drafter (an MTP drafter loads the
        checkpoint's extra layer then)."""
        a = self.args
        cfg, model_path = resolve_model_config(a)
        cfg.max_position = max(cfg.max_position, a.max_seq_len)
        self.model_config = cfg
        self._tokenizer = self._load_tokenizer(model_path)
        self.model = get_model_class(cfg.architecture)(cfg, self.device)
        from_ckpt = (a.params is None and a.load_format != "dummy"
                     and model_path is not None and has_weights(model_path))
        if a.lora_path and not from_ckpt:
            raise ValueError("lora_path merges an adapter into a "
                             "checkpoint's weights: model must be a "
                             "checkpoint directory with weights")
        if a.params is not None:
            self.model.load_state(a.params)
        elif a.load_format == "dummy":
            self.model.init_random(a.seed)
        elif from_ckpt:
            reader = stack.enter_context(SafetensorsReader(model_path))
            sink = getattr(drafter, "set_checkpoint", None)
            get_tensor = reader
            if a.lora_path:
                get_tensor = merge_lora_into_state(
                    reader, load_lora_adapter(a.lora_path))
            self.model.load_hf_weights(get_tensor, mtp_sink=sink)
        else:
            if model_path is not None:
                warnings.warn(f"no *.safetensors in {model_path}: drawing "
                              "random weights", stacklevel=4)
            self.model.init_random(a.seed)
        if a.lora_adapters:
            mgr = MultiLoraManager.from_paths(a.lora_adapters, cfg)
            if a.lora_max_device_adapters \
                    and a.lora_max_device_adapters < len(a.lora_adapters):
                mgr = PagedMultiLoraManager(mgr.adapters, cfg,
                                            a.lora_max_device_adapters)
            mgr.attach(self.model)
            self.lora_manager = mgr
        geo = pool_layout(cfg)
        kvcfg = a.make_kv_cache_config(geo["layout"], geo["dsa_index_dim"])
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            budget = int(free * kvcfg.free_mem_fraction)
        else:
            budget = 4 << 30
        num_blocks, ring_slots = plan_kv_pools(
            cfg, kvcfg, a.max_seq_len, a.max_batch_size, budget)
        self.kv_manager = KVCacheManager(kvcfg, cfg.num_layers,
                                         geo["num_kv_heads"],
                                         geo["head_dim"], num_blocks,
                                         self.device)
        self.engine = ModelEngine(self.model, self.kv_manager, self.device,
                                  max_seq_len=a.max_seq_len,
                                  max_batch_size=a.max_batch_size,
                                  ring_slots=ring_slots)
        if isinstance(self.lora_manager, PagedMultiLoraManager):
            self.lora_manager.bind_engine(self.engine)
        warm = a.enable_warmup
        if warm is None:
            warm = self.device.type == "cuda"
        if warm:
            # tune the W4A16 tactics and warm the steps before serving
            self.engine.warmup(min(a.max_num_tokens, a.max_seq_len - 1),
                               a.max_batch_size)
        eos = (None if self._tokenizer is None
               else getattr(self._tokenizer, "eos_token_id", None))
        self.executor = PyExecutor(
            self.engine, a.make_scheduler_config(), eos_token_id=eos,
            max_seq_len=a.max_seq_len, max_decode_steps=a.max_decode_steps,
            overlap=not a.disable_overlap_scheduler,
            overlap_depth=a.overlap_depth, tokenizer=self._tokenizer,
            batched_logits_processor=a.batched_logits_processor,
            drafter=drafter)
        self.executor.start()
        # join the executor thread at interpreter exit even without shutdown()
        self._exit_finalizer = weakref.finalize(
            self, PyExecutor.shutdown, self.executor)

    # ------------------------------------------------------------ weights --
    def update_weights(self, source) -> None:
        """Swap in the weights of a checkpoint directory, or of a
        `get_tensor(name)` callable, with this model's shapes: they load
        into a second model on the device (`load_hf_weights`), whose state
        the executor installs between two steps, dropping the cached
        prefix blocks (their KV came from the old weights; the JAX package
        keeps them).  Requests in flight finish on the new weights."""
        if isinstance(source, (str, os.PathLike)):
            with SafetensorsReader(str(source)) as reader:
                self.update_weights(reader)
            return
        if not callable(source):
            raise TypeError("source must be a checkpoint directory or a "
                            "get_tensor callable")
        fresh = get_model_class(self.model_config.architecture)(
            self.model_config, self.device).load_hf_weights(source)
        state = fresh.state()
        del fresh

        def swap():
            self.model.load_state(state)
            self.kv_manager.drop_cached_blocks()

        self.executor.call_between_steps(swap)

    # ------------------------------------------------------------ generate --
    @property
    def tokenizer(self):
        return self._tokenizer

    @property
    def num_devices(self) -> int:
        """Devices this instance computes on (the bench's per-device
        divisor): one, as the port has no parallel mapping yet."""
        return 1

    def generate(self, prompts, sampling_params: Union[
                     SamplingParams, Sequence[SamplingParams], None] = None,
                 cache_salt: Optional[str] = None,
                 lora_request: Union[str, Sequence[Optional[str]],
                                     None] = None) -> List[RequestOutput]:
        """Serve a prompt or a batch: each prompt is a string (needs a
        tokenizer) or a list of token ids; `lora_request` names one adapter
        for every prompt or one (or None) per prompt.  The batch reaches
        the executor in one piece, so the schedule does not depend on how
        fast the caller submits; only when a paged adapter slot must be
        waited for are the requests pinned so far submitted first."""
        if isinstance(prompts, str) or (
                prompts and isinstance(prompts[0], numbers.Integral)):
            prompts = [prompts]
        sampling_params = sampling_params or SamplingParams()
        sps = ([sampling_params] * len(prompts)
               if isinstance(sampling_params, SamplingParams)
               else list(sampling_params))
        loras = ([lora_request] * len(prompts)
                 if lora_request is None or isinstance(lora_request, str)
                 else list(lora_request))
        if len(loras) != len(prompts):
            raise ValueError(f"{len(loras)} lora_request entries for "
                             f"{len(prompts)} prompts")
        pending: List[LlmRequest] = []

        def flush():
            self._submit(pending)
            pending.clear()

        futs = []
        for p, sp, lr in zip(prompts, sps, loras):
            try:
                futs.append(self._fanout(p, sp, cache_salt, lora_request=lr,
                                         flush=flush))
            except BaseException:
                _release(pending)
                raise
            pending.extend(futs[-1].requests)
        flush()
        return [f.result() for f in futs]

    def _submit(self, reqs: List[LlmRequest]) -> None:
        """Submit `reqs` at once; a refusal releases their adapter slots."""
        if not reqs:
            return
        try:
            self.executor.submit_many(reqs)
        except BaseException:
            _release(reqs)
            raise

    def generate_async(self, prompt,
                       sampling_params: Optional[SamplingParams] = None,
                       streaming: bool = False,
                       cache_salt: Optional[str] = None,
                       kv_retention_priority: Optional[int] = None,
                       priority: float = 0.5,
                       disaggregated_params: Optional[
                           DisaggregatedParams] = None,
                       lora_request: Optional[str] = None
                       ) -> "GenerationFuture":
        """Submit one prompt (text or token ids).  The future's `result()`
        gives the whole output; iterating it streams the pieces
        (`streaming` is the JAX API's flag: the future is iterable either
        way).  `priority` in [0, 1] orders the waiting queue (higher
        first); `kv_retention_priority` is the retention priority of the
        blocks the request stores for reuse (lower evicts first).  With
        ``n > 1`` the future is a `_FanoutFuture` (no streaming).
        `disaggregated_params` makes it a context-only or generation-only
        request (module docstring); `lora_request` serves it with that
        adapter."""
        sp = sampling_params or SamplingParams()
        if sp.n > 1 and not sp.use_beam_search and streaming:
            raise ValueError("streaming with n > 1 is not supported; use n "
                             "futures or beam search")
        dp = disaggregated_params
        if dp is not None:
            if dp.request_type not in ("context_only", "generation_only"):
                raise ValueError(f"request_type {dp.request_type!r}: "
                                 "'context_only' or 'generation_only'")
            if sp.use_beam_search:
                # the JAX package gives it no defined result
                raise ValueError("beam search on a disaggregated request is "
                                 "not supported")
            if sp.n > 1:
                raise ValueError("a disaggregated request takes n = 1")
            if dp.request_type == "context_only":
                # a copy: the caller's params may serve other requests
                sp = dataclasses.replace(sp, max_tokens=1)
            elif dp.kv_frames is None:
                if dp.kv_payload is None or not dp.first_gen_tokens:
                    raise ValueError("a generation-only request needs "
                                     "kv_payload and first_gen_tokens, or "
                                     "kv_frames")
                self.engine.check_kv_layers(dp.kv_payload["layers"])
            fut = self._future(prompt, sp, cache_salt,
                               kv_retention_priority, priority, dp,
                               lora_request=lora_request)
        else:
            fut = self._fanout(prompt, sp, cache_salt, kv_retention_priority,
                               priority, lora_request=lora_request)
        self._submit(fut.requests)
        return fut

    def generate_context_only(self, prompt, sampling_params=None):
        """The context phase of a disaggregated request: (the output with
        its first token, the `DisaggregatedParams` of the generation
        phase, carrying that token and the prompt's KV pages)."""
        fut = self.generate_async(
            prompt, sampling_params, disaggregated_params=DisaggregatedParams(
                request_type="context_only"))
        out = fut.result()
        if fut.req.kv_payload is None:
            raise RuntimeError("context phase ended without its KV "
                               f"({out.outputs[0].finish_reason})")
        return out, DisaggregatedParams(
            request_type="generation_only",
            first_gen_tokens=list(out.outputs[0].token_ids),
            kv_payload=fut.req.kv_payload)

    def generate_context_only_streamed(self, prompt, sampling_params=None):
        """The streamed context phase: (future, frame queue).  KV frames
        appear on the queue while later prefill chunks still run; the
        stream ends with ``{"end": True, "first_gen_tokens": [...], ...}``
        (or ``{"end": True, "error": ...}``).  A decode worker takes the
        frames through ``DisaggregatedParams(kv_frames=...)``, or over the
        wire through `frame_to_bytes`."""
        fut = self.generate_async(
            prompt, sampling_params, disaggregated_params=DisaggregatedParams(
                request_type="context_only", stream=True))
        return fut, fut.req.kv_stream

    def _fanout(self, prompt, sp: SamplingParams, cache_salt,
                kv_retention_priority: Optional[int] = None,
                priority: float = 0.5, lora_request: Optional[str] = None,
                flush=None):
        """The future of one prompt: a `GenerationFuture`, or for parallel
        sampling (``n > 1`` without beam search) a `_FanoutFuture` over n
        sibling requests with ``n=1`` and seeds ``seed + j``."""
        if sp.n <= 1 or sp.use_beam_search:
            return self._future(prompt, sp, cache_salt,
                                kv_retention_priority, priority,
                                lora_request=lora_request, flush=flush)
        subs: List[GenerationFuture] = []
        try:
            for j in range(sp.n):
                subs.append(self._future(
                    prompt, dataclasses.replace(
                        sp, n=1,
                        seed=None if sp.seed is None else sp.seed + j),
                    cache_salt, kv_retention_priority, priority,
                    lora_request=lora_request, flush=flush))
        except BaseException:
            _release([f.req for f in subs])
            raise
        return _FanoutFuture(subs)

    def _future(self, prompt, sampling_params, cache_salt,
                kv_retention_priority: Optional[int] = None,
                priority: float = 0.5,
                disagg: Optional[DisaggregatedParams] = None,
                lora_request: Optional[str] = None, flush=None
                ) -> "GenerationFuture":
        text = None
        if isinstance(prompt, str):
            if self._tokenizer is None:
                raise ValueError("a text prompt needs a tokenizer (pass "
                                 "tokenizer=, or token ids)")
            text = prompt
            prompt = self._tokenizer.encode(prompt)
        # what changes the KV of the same token ids is part of the
        # prefix-reuse identity: the user's salt and the adapter
        salt = ([] if cache_salt is None else [f"user:{cache_salt}"]) + (
            [] if lora_request is None else [f"lora:{lora_request}"])
        req = LlmRequest([int(t) for t in prompt],
                         sampling_params or SamplingParams(),
                         cache_salt="|".join(salt) or None,
                         kv_retention_priority=kv_retention_priority,
                         priority=priority,
                         request_type=("full" if disagg is None
                                       else disagg.request_type),
                         disagg_params=disagg, lora_request=lora_request)
        if lora_request is not None:
            self._pin_adapter(req, lora_request, flush)
        return GenerationFuture(self, req, text)

    def _pin_adapter(self, req: LlmRequest, name: str, flush=None) -> None:
        """Give `req` the device slot of adapter `name`: under paging the
        slot is pinned (swapped in when absent) and released by the
        request's `on_finished` hook; `flush()` runs before a wait for a
        slot.  KeyError for an unknown adapter."""
        mgr = self.lora_manager
        if mgr is None:
            raise ValueError("lora_request needs lora_adapters={name: path} "
                             "on the LLM")
        if not isinstance(mgr, PagedMultiLoraManager):
            req.lora_slot = mgr.slot_of(name)
            return
        slot = mgr.acquire(name, wait=False)
        if slot is None:
            if flush is not None:
                flush()
            slot = mgr.acquire(name)
        req.lora_slot = slot
        req.on_finished = lambda r, n=name: mgr.release(n)

    def read_kv(self, fn):
        """`fn(kv_manager)` on the executor thread between two steps: the
        KV bookkeeping (the C++ one included) is mutated on that thread
        only, so a read from another thread must not overlap a step."""
        return self.executor.call_between_steps(
            lambda: fn(self.kv_manager), drain=False)

    def get_kv_cache_stats(self) -> dict:
        return self.read_kv(lambda kv: kv.stats())

    def get_kv_cache_events(self, since_id: int = 0) -> list:
        """The KV manager's stored/removed block events with id >=
        `since_id` (feeds KV-aware routers)."""
        return self.read_kv(lambda kv: kv.get_events(since_id))

    def match_kv_prefix(self, token_ids) -> int:
        """Tokens of this prompt whose KV is cached here right now."""
        ids = [int(t) for t in token_ids]
        return self.read_kv(lambda kv: kv.match_prefix(ids))

    # ------------------------------------------------------------- memory --
    def release_memory(self) -> None:
        """Move the weights off the device (between RL rollouts): refused
        with a request in flight; `generate` then refuses until
        `resume_memory`.  The host copies are pinned on CUDA."""
        ex = self.executor
        ex.close_for_release()
        try:
            ex.call_between_steps(self._offload_weights)
        except BaseException:
            ex.weights_released = False
            raise

    def _offload_weights(self):
        if self._released_state is not None:
            return
        host = {}
        for name, t in self.model.state().items():
            if self.device.type == "cuda":
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t)
            else:
                h = t      # the CPU copy is the host copy
            host[name] = h
        for name in host:
            mod, _, leaf = name.rpartition(".")
            setattr(self.model.get_submodule(mod) if mod else self.model,
                    leaf, None)
        self._released_state = host
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def resume_memory(self) -> None:
        """Put weights released by `release_memory` back on the device and
        reopen the submit door."""
        def onload():
            if self._released_state is not None:
                self.model.load_state(self._released_state)
                self._released_state = None
        self.executor.call_between_steps(onload)
        self.executor.weights_released = False

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
    """Handle of one in-flight request: `result()` waits for the whole
    output; iterating yields one `RequestOutput` per executor piece
    (cumulative token ids and text; the last has ``finished=True``).  Read
    a request one way: both consume the same pieces."""

    def __init__(self, llm: LLM, req: LlmRequest,
                 prompt_text: Optional[str] = None):
        self.llm = llm
        self.req = req
        self.prompt_text = prompt_text

    @property
    def request_id(self) -> int:
        return self.req.request_id

    @property
    def requests(self) -> List[LlmRequest]:
        return [self.req]

    def cancel(self) -> None:
        """End the request at the executor's next iteration: its result
        finishes with reason "cancelled" and its KV is freed."""
        self.llm.executor.cancel(self.req.request_id)

    def _decode(self, token_ids: List[int]) -> str:
        tok = self.llm.tokenizer
        sp = self.req.sampling_params
        if tok is None or not sp.detokenize:
            return ""
        return self._cut_stop(tok.decode(
            token_ids, skip_special_tokens=sp.skip_special_tokens))

    def _cut_stop(self, text: str) -> str:
        """`text` up to the first occurrence of the matched stop string,
        unless the request keeps it."""
        stop = self.req.stop_string
        if stop and not self.req.sampling_params.include_stop_str_in_output:
            idx = text.find(stop)
            if idx >= 0:
                return text[:idx]
        return text

    def _output(self, toks: List[int], text: str, piece,
                finished: bool) -> RequestOutput:
        """A `RequestOutput` of the tokens so far; the logprobs, logits and
        prompt logprobs ride the last one."""
        r = self.req
        reason = piece.finish_reason
        metrics = None
        if finished and self.llm.args.return_perf_metrics:
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
        gl = (np.stack(r.generation_logits)
              if finished and r.generation_logits else None)
        outputs = [CompletionOutput(
            index=0, text=text, token_ids=list(toks),
            finish_reason=reason.value if reason else None,
            logprobs=(r.logprobs or None) if finished else None,
            generation_logits=gl)]
        if finished and r.beam_outputs:
            # beam search: one output per returned beam, best first
            outputs = [CompletionOutput(
                index=i, text=self._decode(b["token_ids"]),
                token_ids=list(b["token_ids"]),
                finish_reason=reason.value if reason else None,
                logprobs=b["logprobs"],
                cumulative_logprob=b["cumulative_logprob"])
                for i, b in enumerate(r.beam_outputs)]
        return RequestOutput(
            request_id=r.request_id, prompt=self.prompt_text,
            prompt_token_ids=r.prompt_token_ids,
            outputs=outputs,
            finished=finished,
            prompt_logprobs=r.prompt_logprobs if finished else None,
            context_logits=r.context_logits if finished else None,
            metrics=metrics)

    def fold(self):
        """A generator that takes the request's pieces (``send``) and
        yields None until the last, then the whole `RequestOutput`, text
        decoded at once (what `result` returns)."""
        toks: List[int] = []
        out = None
        while True:
            piece = yield out
            _check(piece)
            if piece.truncate_to is not None:
                del toks[piece.truncate_to:]   # sampled past a stop string
            toks.extend(piece.new_token_ids)
            if piece.finished:
                out = self._output(toks, self._decode(toks), piece, True)

    def stream_fold(self):
        """A generator that takes the request's pieces (``send``) and
        yields one `RequestOutput` per piece (what iterating yields):
        cumulative token ids and text, detokenized incrementally."""
        sp = self.req.sampling_params
        tok = self.llm.tokenizer
        detok = (IncrementalDetokenizer(tok, sp.skip_special_tokens)
                 if tok is not None and sp.detokenize else None)
        toks: List[int] = []
        out = None
        while True:
            piece = yield out
            _check(piece)
            if piece.truncate_to is not None:
                del toks[piece.truncate_to:]   # sampled past a stop string
                if detok is not None:
                    # the text past the match was pushed: start again from
                    # the kept tokens
                    detok = IncrementalDetokenizer(tok,
                                                   sp.skip_special_tokens)
                    detok.push(toks)
            toks.extend(piece.new_token_ids)
            if detok is None:
                text = self._decode(toks)
            else:
                detok.push(piece.new_token_ids)
                if piece.finished:
                    detok.flush()
                # the stop string is known once the request has ended
                text = self._cut_stop(detok.text)
            out = self._output(toks, text, piece, piece.finished)

    def result(self, timeout: Optional[float] = None) -> RequestOutput:
        f = self.fold()
        next(f)
        while True:
            out = f.send(self.req.out_queue.get(timeout=timeout))
            if out is not None:
                return out

    def __iter__(self) -> Iterator[RequestOutput]:
        f = self.stream_fold()
        next(f)
        while True:
            out = f.send(self.req.out_queue.get())
            yield out
            if out.finished:
                return


def _release(reqs: List[LlmRequest]) -> None:
    """Run the finish hooks (adapter slot releases) of requests that will
    never reach the executor."""
    for r in reqs:
        PyExecutor._finish_hook(r)


def _check(piece):
    if piece.error:
        raise RuntimeError(f"generation failed: {piece.error}")


class _FanoutFuture:
    """The n sibling requests of a parallel-sampling call
    (``SamplingParams.n > 1``) as one `RequestOutput` with n outputs."""

    def __init__(self, subs: List[GenerationFuture]):
        self.subs = subs

    @property
    def request_id(self) -> int:
        return self.subs[0].request_id

    @property
    def requests(self) -> List[LlmRequest]:
        return [s.req for s in self.subs]

    def result(self, timeout: Optional[float] = None) -> RequestOutput:
        return self.combine([s.result(timeout=timeout) for s in self.subs])

    @staticmethod
    def combine(results: List[RequestOutput]) -> RequestOutput:
        """The siblings' outputs as one `RequestOutput` with n outputs."""
        first = results[0]
        outputs = [dataclasses.replace(r.outputs[0], index=j)
                   for j, r in enumerate(results)]
        return dataclasses.replace(first, outputs=outputs)

    def cancel(self) -> None:
        for s in self.subs:
            s.cancel()
