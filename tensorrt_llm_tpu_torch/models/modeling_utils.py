"""Decoder-only causal LM for the Llama (Llama, Mistral, Qwen2, Qwen3,
SmolLM3, Granite, Seed-OSS), Mixtral, GPT-OSS, Gemma (1-3 text), OLMo2,
Starcoder2, Nemotron, GLM/GLM4, Phi3/Phi4, EXAONE-4, Apertus, HunYuan
dense and DeepSeek V3 families, and the MoE families (Qwen3-MoE, Qwen2-MoE,
GLM-4.5, dots.llm1, HunYuan-MoE, MiniMax-M2, EXAONE-MoE, Llama4 text,
Mistral Large 3).

Counterpart of `tensorrt_llm_tpu/models/modeling_utils.py`: `ModelConfig`
(the fields those families use, with `from_hf_config`), `DecoderLayer` (GQA
attention -- per-head, flat or post-RoPE q/k norms, partial or
adjacent-pair RoPE, none on NoPE layers -- or, when `kv_lora_rank` is set,
Multi-head Latent Attention with an optional DSA indexer; a gated MLP, a
non-gated one (`mlp_gated` False) or a W4A16 MoE, dense on
`mlp_only_layers` and off the `decoder_sparse_step` stride; sliding-window
layers by `layer_types`, by Gemma's `sliding_window_pattern` or by the
window, chunked ones on the RoPE layers
under `attention_chunk_size`, with their own RoPE base under
`rope_local_theta`; RMSNorm or LayerNorm with a bias (`norm_type`);
pre-norm blocks, Gemma's and GLM-4's sandwich norms under `post_norms`, or
OLMo2's and EXAONE-4's norms on the block outputs under
`post_block_norms`; Granite's `residual_multiplier` on both block
outputs), and `DecoderModelForCausalLM.forward` (embedding, times
`embedding_multiplier` when set, the decoder layers over a paged KV cache
-- bf16, INT8 or FP8 K/V pools, or one latent pool per layer under MLA --
final norm, bf16 lm_head, or the embedding matrix under
`tie_word_embeddings`, divided by `logits_scaling`, then
`final_logit_softcap`); linears are W4A16,
W4A8_AWQ, W8A16, W8A8, FP8 or unquantized (MoE experts are int4 under the
W4A16 family and bf16 otherwise, as in the JAX package).
Weights come from `init_random` (drawn on the model's device from a seeded
`torch.Generator`, one layer at a time, quantized as they are drawn), from
an HF checkpoint through `load_hf_weights` (a `get_tensor(name)` callable,
such as `llmapi.hf_checkpoint.SafetensorsReader`: each tensor goes to the
model's device as it is read and is quantized there, or taken as stored
from an AWQ/GPTQ checkpoint), or from `params_from_jax`, which converts the
JAX package's parameter pytree so the tests can run the same weights on
both sides.  Two models hold the same weights through `state()` /
`load_state`.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tensorrt_llm_tpu_torch.attention_backend.interface import (
    AttentionMetadata)
from tensorrt_llm_tpu_torch.layers.attention import Attention
from tensorrt_llm_tpu_torch.layers.embedding import Embedding
from tensorrt_llm_tpu_torch.layers.linear import Linear
from tensorrt_llm_tpu_torch.layers.mla import MLA
from tensorrt_llm_tpu_torch.layers.mlp import MLP, GatedMLP
from tensorrt_llm_tpu_torch.layers.moe import MoE
from tensorrt_llm_tpu_torch.ops.norms import layer_norm, rms_norm
from tensorrt_llm_tpu_torch.ops.rope import RopeConfig, make_rope_tables
from tensorrt_llm_tpu_torch.quantization import QuantConfig
from tensorrt_llm_tpu_torch.quantization.hf_ingest import (
    maybe_load_quantized)
from tensorrt_llm_tpu_torch.utils import div_scalar, resolve_device


@dataclass
class ModelConfig:
    architecture: str = "LlamaForCausalLM"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    rms_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    max_position: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    o_bias: bool = False                  # o_proj bias (GPT-OSS)
    has_sinks: bool = False               # attention-sink logits (GPT-OSS)
    layer_types: Optional[tuple] = None   # "sliding_attention" / "full_attention"
    qk_norm: bool = False                 # per-head q/k RMSNorm (Gemma-3)
    activation: str = "silu"              # "gelu": tanh-GELU (Gemma)
    sliding_window: Optional[int] = None
    # "rmsnorm" or "layernorm" (Starcoder2, Nemotron: weight and bias)
    norm_type: str = "rmsnorm"
    norm_bias: bool = False
    # non-gated MLP up -> activation -> down (Starcoder2, Nemotron,
    # Apertus), optionally biased
    mlp_gated: bool = True
    mlp_bias: bool = False
    use_bias: Optional[bool] = None       # Starcoder2's HF `use_bias`
    # OLMo2 / EXAONE-4: x += norm(attn(x)); x += norm(mlp(x)), no pre-norms
    post_block_norms: bool = False
    # Granite: x += residual_multiplier * block(x), logits / logits_scaling,
    # softmax scale attention_multiplier
    residual_multiplier: Optional[float] = None
    logits_scaling: Optional[float] = None
    attention_multiplier: Optional[float] = None
    # OLMo2: one q/k RMSNorm over the flattened heads * head_dim; HunYuan:
    # the per-head q/k RMSNorm after RoPE
    qk_norm_flat: bool = False
    qk_norm_post_rope: bool = False
    # NoPE layers: HF's `no_rope_layers` list (1 = RoPE) wins; else every
    # no_rope_layer_interval-th layer (0: none)
    no_rope_layer_interval: int = 0
    no_rope_layers: Optional[tuple] = None
    # Llama4: unweighted per-head q/k RMS after RoPE on the RoPE layers, and
    # the NoPE layers' query temperature log1p(floor((pos + 1) /
    # floor_scale)) * attn_scale + 1
    qk_norm_l2: bool = False
    attn_temperature_tuning: bool = False
    floor_scale: float = 8192.0
    attn_scale: float = 0.1
    # RoPE over adjacent pairs on GQA heads (GLM), and over the leading
    # head_dim * partial_rotary_factor channels only (GLM, Nemotron)
    gqa_rope_interleave: bool = False
    partial_rotary_factor: Optional[float] = None
    # Gemma: post-attention / post-FFW norms around each block, sqrt(hidden)
    # embedding scale, tanh soft caps of the attention scores and the final
    # logits, the attention scale query_pre_attn_scalar ** -0.5, every
    # sliding_window_pattern-th layer global, and the local layers' RoPE base
    post_norms: bool = False
    embedding_multiplier: Optional[float] = None
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    sliding_window_pattern: int = 1
    rope_local_theta: Optional[float] = None
    # Llama4 chunked attention: the keys of the query's chunk only
    attention_chunk_size: Optional[int] = None
    # MoE (0 experts => dense MLP everywhere); a MoE layer every
    # decoder_sparse_step-th layer (Qwen-MoE, Llama4's
    # interleave_moe_layer_step) past mlp_only_layers
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: Optional[int] = None
    norm_topk_prob: bool = True
    decoder_sparse_step: int = 1
    # GPT-OSS MoE: biased router, topk-then-softmax, per-expert biases
    moe_router_bias: bool = False
    moe_topk_then_softmax: bool = False
    moe_expert_bias: bool = False
    # DeepSeek MoE: sigmoid scores, noaux_tc routing with a score-correction
    # bias and group-limited top-k, shared experts, leading dense layers
    moe_score_func: str = "softmax"
    moe_has_score_bias: bool = False
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    n_shared_experts: int = 0
    mlp_only_layers: tuple = ()
    # Qwen2-MoE: the shared expert's own width (the JAX package keeps it in
    # `extra`), scaled by a sigmoid gate where the family's class sets
    # `moe_shared_gate` (no HF key: None until a class sets it)
    shared_expert_intermediate_size: Optional[int] = None
    moe_shared_gate: Optional[bool] = None
    # Llama4: top-k on the raw logits, sigmoid weights, the weight applied
    # to the expert's input
    moe_topk_then_sigmoid: bool = False
    moe_apply_router_weight_on_input: bool = False
    # MLA (DeepSeek V2/V3): kv_lora_rank set => latent attention
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_interleave: bool = True
    # DSA lightning indexer (DeepSeek V3.2) on the MLA layers:
    # {"algo": "dsa", "index_n_heads", "index_head_dim", "index_topk"}
    sparse_attention: Optional[dict] = None
    quant: Optional[QuantConfig] = None
    # the HF keys of the family's `HF_EXTRA_KEYS` the config sets (the JAX
    # package's `extra`), read by the family's class
    extra: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_heads
        if self.moe_intermediate_size is None:
            self.moe_intermediate_size = self.intermediate_size

    def is_moe_layer(self, idx: int) -> bool:
        """JAX `is_moe_layer`: experts, not in `mlp_only_layers`, every
        `decoder_sparse_step`-th layer.  HF DeepSeek's `moe_layer_freq` is
        not read, as in the JAX package (1 in every published config)."""
        return (self.num_experts > 0 and idx not in self.mlp_only_layers
                and (idx + 1) % self.decoder_sparse_step == 0)

    def is_nope_layer(self, idx: int) -> bool:
        """JAX `is_nope_layer`: the layer skips RoPE.  An HF
        `no_rope_layers` list (1 = RoPE, SmolLM3; EXAONE-4's global layers)
        wins; else every `no_rope_layer_interval`-th layer."""
        if self.no_rope_layers:
            return int(self.no_rope_layers[idx]) == 0
        return (self.no_rope_layer_interval > 0
                and (idx + 1) % self.no_rope_layer_interval == 0)

    def is_sliding_layer(self, idx: int) -> bool:
        """JAX `is_sliding_layer`: an explicit `layer_types` list wins
        (GPT-OSS, Gemma-3, EXAONE-4); under `attention_chunk_size` the
        layers that keep RoPE are chunked and count as sliding (their
        lookback is bounded by the chunk) while NoPE layers attend
        globally; otherwise every `sliding_window_pattern`-th layer is
        global and the rest slide (pattern 1: every layer slides when a
        window is set, Mistral, and Qwen2's `config.json`, whose
        `sliding_window` is read as it stands)."""
        if self.layer_types is not None:
            return self.layer_types[idx] in ("sliding_attention",
                                             "chunked_attention")
        if self.attention_chunk_size:
            return not self.is_nope_layer(idx)
        if self.sliding_window is None:
            return False
        if self.sliding_window_pattern <= 1:
            return True
        return (idx + 1) % self.sliding_window_pattern != 0

    @property
    def rope_local(self) -> Optional[RopeConfig]:
        """The sliding layers' RoPE (Gemma-3's local base, unscaled)."""
        if self.rope_local_theta is None:
            return None
        return dataclasses.replace(self.rope, theta=self.rope_local_theta,
                                   scaling_type=None)

    # ---- MLA ---------------------------------------------------------------
    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank is not None

    @property
    def dsa(self) -> Optional[dict]:
        """The DSA indexer settings, when the MLA layers carry one."""
        sa = self.sparse_attention
        return sa if self.is_mla and sa and sa.get("algo") == "dsa" else None

    @property
    def kv_pool_heads(self) -> int:
        """KV heads of the paged pools: one latent "head" under MLA."""
        return 1 if self.is_mla else self.num_kv_heads

    @property
    def kv_pool_dim(self) -> int:
        """Pool row width: ``kv_lora_rank + qk_rope_head_dim`` under MLA
        (576 on DeepSeek; the JAX package rounds it up to 640 for the TPU's
        128-lane tile, a layout the port does not keep), else head_dim."""
        if self.is_mla:
            return self.kv_lora_rank + self.qk_rope_head_dim
        return self.head_dim

    @property
    def mla_scale(self) -> float:
        """MLA softmax scale: qk_head_dim^-0.5 times YaRN's mscale^2 over
        `mscale_all_dim` (HF DeepseekV3Attention)."""
        scale = (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5
        s = self.rope_scaling or {}
        if s.get("mscale_all_dim"):
            f = s.get("factor", 1.0)
            m = 0.1 * s["mscale_all_dim"] * math.log(f) + 1.0 if f > 1 \
                else 1.0
            scale *= m * m
        return scale

    @property
    def rope(self) -> RopeConfig:
        s = self.rope_scaling or {}
        stype = s.get("rope_type") or s.get("type")
        if stype == "default":
            stype = None
        return RopeConfig(
            head_dim=self.qk_rope_head_dim if self.is_mla else self.head_dim,
            theta=self.rope_theta,
            interleaved=((self.rope_interleave and self.is_mla)
                         or self.gqa_rope_interleave),
            rotary_dim=(int(self.head_dim * self.partial_rotary_factor)
                        if not self.is_mla and self.partial_rotary_factor
                        else None),
            max_position=self.max_position, scaling_type=stype,
            scaling_factor=s.get("factor", 1.0),
            low_freq_factor=s.get("low_freq_factor", 1.0),
            high_freq_factor=s.get("high_freq_factor", 4.0),
            original_max_position=s.get("original_max_position_embeddings",
                                        self.max_position),
            truncate=bool(s.get("truncate", True)),
            beta_fast=s.get("beta_fast") or 32.0,
            beta_slow=s.get("beta_slow") or 1.0,
            mscale=s.get("mscale"), mscale_all_dim=s.get("mscale_all_dim"),
            attention_factor=s.get("attention_factor"), alpha=s.get("alpha"))

    @classmethod
    def from_hf_config(cls, hf, quant: Optional[QuantConfig] = None
                       ) -> "ModelConfig":
        """Build from a transformers config (or plain dict) of an
        architecture a model class registers (DeepSeek V3: Moonlight, and
        V3.2 with its indexer), with the JAX package's field mapping; other
        architectures raise.  Llama4's multimodal config builds from its
        `text_config`.  A `scoring_func` or `topk_method` the family's
        class does not route by raises.  Keys are read as they stand:
        Qwen2's `config.json` keeps `sliding_window` 131,072 under
        `use_sliding_window` false, so every layer slides at that window,
        as in the JAX package (a `transformers.Qwen2Config` object drops
        it).  The family's activation, norms and MLP kind come from its
        model class, as the JAX constructors set them.  A DeepSeek config
        (one with `kv_lora_rank`) routes by sigmoid noaux_tc, as the JAX
        package does."""
        get = ((lambda k, d=None: hf.get(k, d)) if isinstance(hf, dict)
               else (lambda k, d=None: getattr(hf, k, d)))
        archs = get("architectures")
        if archs and archs[0] == "Llama4ForConditionalGeneration" \
                and get("text_config") is not None:
            cfg = cls.from_hf_config(get("text_config"), quant)
            cfg.architecture = archs[0]
            return cfg
        if archs:
            arch = archs[0]
        elif get("model_type"):
            # "deepseek_v3" -> "DeepseekV3ForCausalLM", as the JAX package
            arch = "".join(w.capitalize() for w in
                           get("model_type").split("_")) + "ForCausalLM"
        else:
            arch = "LlamaForCausalLM"
        known = registered_models()
        if arch not in known:
            raise NotImplementedError(
                f"from_hf_config: {arch} is not in this slice "
                f"(known: {', '.join(sorted(known))})")
        deepseek = get("kv_lora_rank") is not None
        family = known[arch]
        for key, allowed in (("scoring_func", family.HF_SCORING_FUNCS),
                             ("topk_method", family.HF_TOPK_METHODS)):
            if get(key) and get(key) not in allowed:
                raise NotImplementedError(
                    f"from_hf_config: {arch} with {key}={get(key)!r} is not "
                    "in this slice")
        gpt_oss = arch == "GptOssForCausalLM"
        mlp_only = tuple(get("mlp_only_layers") or ())
        if get("first_k_dense_replace"):
            mlp_only = tuple(range(get("first_k_dense_replace")))
        return cls(
            architecture=arch,
            vocab_size=get("vocab_size", 32000),
            hidden_size=get("hidden_size", 4096),
            intermediate_size=get("intermediate_size", 11008),
            num_layers=get("num_hidden_layers", 32),
            num_heads=get("num_attention_heads", 32),
            num_kv_heads=(get("num_key_value_heads")
                          or get("num_attention_heads", 32)),
            head_dim=get("head_dim"),
            rms_eps=(get("rms_norm_eps") or get("layer_norm_epsilon")
                     or get("norm_epsilon") or get("norm_eps") or 1e-5),
            attention_chunk_size=get("attention_chunk_size"),
            rope_theta=get("rope_theta", 10000.0),
            rope_scaling=get("rope_scaling"),
            max_position=get("max_position_embeddings", 4096),
            tie_word_embeddings=get("tie_word_embeddings", False),
            attention_bias=bool(get("attention_bias", False)
                                or get("qkv_bias", False)),
            o_bias=gpt_oss and bool(get("attention_bias", False)),
            has_sinks=gpt_oss,
            layer_types=(tuple(get("layer_types")) if get("layer_types")
                         else None),
            sliding_window=get("sliding_window"),
            activation="swiglu_oai" if gpt_oss else "silu",
            num_experts=(get("num_local_experts") or get("num_experts")
                         or get("n_routed_experts") or 0),
            num_experts_per_tok=get("num_experts_per_tok", 2),
            moe_intermediate_size=get("moe_intermediate_size"),
            norm_topk_prob=bool(get("norm_topk_prob", True)),
            decoder_sparse_step=get("decoder_sparse_step") or 1,
            shared_expert_intermediate_size=get(
                "shared_expert_intermediate_size"),
            moe_router_bias=gpt_oss,
            moe_topk_then_softmax=gpt_oss,
            moe_expert_bias=gpt_oss,
            moe_score_func="sigmoid" if deepseek else "softmax",
            moe_has_score_bias=deepseek,
            n_group=get("n_group") or 1,
            topk_group=get("topk_group") or 1,
            routed_scaling_factor=get("routed_scaling_factor") or 1.0,
            n_shared_experts=get("n_shared_experts") or 0,
            mlp_only_layers=mlp_only,
            q_lora_rank=get("q_lora_rank"),
            kv_lora_rank=get("kv_lora_rank"),
            qk_nope_head_dim=get("qk_nope_head_dim") or 128,
            qk_rope_head_dim=get("qk_rope_head_dim") or 64,
            v_head_dim=get("v_head_dim") or 128,
            rope_interleave=bool(get("rope_interleave", True)),
            sparse_attention=({"algo": "dsa",
                               "index_n_heads": get("index_n_heads", 64),
                               "index_head_dim": get("index_head_dim", 128),
                               "index_topk": get("index_topk")}
                              if get("index_topk") and deepseek else None),
            quant=quant,
            # the Gemma family's keys (the JAX package keeps them in
            # `extra` for its Gemma constructors; they set the same fields)
            query_pre_attn_scalar=get("query_pre_attn_scalar"),
            attn_logit_softcap=get("attn_logit_softcapping"),
            final_logit_softcap=get("final_logit_softcapping"),
            sliding_window_pattern=get("sliding_window_pattern") or 1,
            rope_local_theta=get("rope_local_base_freq"),
            # the dense zoo's keys (the JAX package's `extra`, read by its
            # family constructors into the same fields)
            partial_rotary_factor=get("partial_rotary_factor"),
            use_bias=get("use_bias"),
            mlp_bias=bool(get("mlp_bias", False)),
            embedding_multiplier=get("embedding_multiplier"),
            residual_multiplier=get("residual_multiplier"),
            attention_multiplier=get("attention_multiplier"),
            logits_scaling=get("logits_scaling"),
            no_rope_layers=(tuple(get("no_rope_layers"))
                            if get("no_rope_layers") else None),
            extra={k: get(k) for k in family.HF_EXTRA_KEYS
                   if get(k) is not None})


def _norm(cfg: ModelConfig, x: torch.Tensor, mod: "_Norm",
          eps: float) -> torch.Tensor:
    """JAX `_norm`: RMSNorm, or LayerNorm with its bias under
    ``norm_type="layernorm"``."""
    if cfg.norm_type == "layernorm":
        return layer_norm(x, mod.weight, mod.bias, eps)
    return rms_norm(x, mod.weight, eps)


def _add_norm(cfg: ModelConfig, x: torch.Tensor,
              residual: Optional[torch.Tensor], mod: "_Norm", eps: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX `_add_norm`: the residual added in f32 and rounded, then the
    norm; returns (normed, new residual)."""
    x = _stream(x, residual)
    return _norm(cfg, x, mod, eps), x


def _scaled(x: torch.Tensor, m: Optional[float]) -> torch.Tensor:
    """x times Granite's `residual_multiplier` in f32, rounded once."""
    return x if m is None else (x.to(torch.float32) * m).to(x.dtype)


class DecoderLayer(nn.Module):
    """A decoder block with the residual add fused into the next norm, as in
    the JAX package: pre-norm x + attn(norm(x)); x + mlp(norm(x)) (the
    block outputs times `residual_multiplier` when set), with sandwich
    norms under `post_norms`, or norms on the raw blocks' outputs under
    `post_block_norms`.  The attention is MLA when the config sets
    `kv_lora_rank`, GQA otherwise; the MLP is a W4A16 MoE on MoE layers, a
    non-gated MLP under ``mlp_gated=False``, a gated MLP elsewhere."""

    def __init__(self, cfg: ModelConfig, layer_idx: int, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.sliding = cfg.is_sliding_layer(layer_idx)
        self.is_moe = cfg.is_moe_layer(layer_idx)
        if cfg.is_mla:
            self.attn = MLA(
                cfg.hidden_size, cfg.num_heads, cfg.q_lora_rank,
                cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                cfg.v_head_dim, cfg.mla_scale, cfg.rms_eps,
                interleaved=cfg.rope.interleaved, quant=cfg.quant,
                sparse=cfg.dsa)
        else:
            nope = cfg.is_nope_layer(layer_idx)
            chunk = (cfg.attention_chunk_size
                     if cfg.attention_chunk_size and self.sliding else None)
            self.attn = Attention(
                cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim, cfg.quant, device, has_bias=cfg.attention_bias,
                has_o_bias=cfg.o_bias, has_sinks=cfg.has_sinks,
                sliding_window=(cfg.sliding_window
                                if self.sliding and chunk is None else None),
                logit_cap=cfg.attn_logit_softcap, attention_chunk=chunk,
                scale=(cfg.query_pre_attn_scalar ** -0.5
                       if cfg.query_pre_attn_scalar else None),
                has_qk_norm=cfg.qk_norm, rms_eps=cfg.rms_eps,
                qk_norm_flat=cfg.qk_norm_flat,
                qk_norm_post_rope=cfg.qk_norm_post_rope,
                nope=nope, interleaved=cfg.rope.interleaved,
                qk_norm_l2=cfg.qk_norm_l2 and not nope,
                attn_temperature_tuning=cfg.attn_temperature_tuning and nope,
                floor_scale=cfg.floor_scale, attn_scale=cfg.attn_scale)
        if self.is_moe:
            self.mlp = MoE(
                cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts,
                cfg.num_experts_per_tok, cfg.activation,
                renormalize=cfg.norm_topk_prob,
                has_router_bias=cfg.moe_router_bias,
                topk_then_softmax=cfg.moe_topk_then_softmax,
                has_expert_bias=cfg.moe_expert_bias, quant=cfg.quant,
                score_func=cfg.moe_score_func,
                has_score_bias=cfg.moe_has_score_bias, n_group=cfg.n_group,
                topk_group=cfg.topk_group,
                routed_scaling=cfg.routed_scaling_factor,
                n_shared_experts=cfg.n_shared_experts,
                topk_then_sigmoid=cfg.moe_topk_then_sigmoid,
                apply_weight_on_input=cfg.moe_apply_router_weight_on_input,
                shared_intermediate_size=(
                    cfg.shared_expert_intermediate_size or 0),
                shared_gate=bool(cfg.moe_shared_gate))
        elif not cfg.mlp_gated:
            self.mlp = MLP(cfg.hidden_size, cfg.intermediate_size,
                           cfg.activation, cfg.mlp_bias, quant=cfg.quant)
        else:
            self.mlp = GatedMLP(cfg.hidden_size, cfg.intermediate_size,
                                cfg.activation, quant=cfg.quant)
        ln = cfg.norm_type == "layernorm"
        H = cfg.hidden_size
        if not cfg.post_block_norms:
            self.input_norm = _Norm(H, ln)
        self.post_attn_norm = _Norm(H, ln)
        if cfg.post_norms:
            self.pre_ffw_norm = _Norm(H, ln)
        if cfg.post_norms or cfg.post_block_norms:
            self.post_ffw_norm = _Norm(H, ln)

    def forward(self, x, residual, rope_tables, kv_cache,
                meta: AttentionMetadata):
        """`rope_tables`: the global (cos, sin), or a pair (global, local)
        when the sliding layers have a RoPE of their own."""
        cfg = self.cfg
        eps = cfg.rms_eps
        if isinstance(rope_tables[0], tuple):
            rope_tables = rope_tables[1 if self.sliding else 0]
        if self.sliding:
            # VSWA: attend through the layer's ring, when rings are on
            meta = meta.for_sliding_layer()
        if cfg.post_block_norms:
            # OLMo2 / EXAONE-4 (JAX `modeling_utils.py:683-701`): the blocks
            # read the raw stream, x += norm(attn(x)); x += norm(mlp(x))
            x = _stream(x, residual)
            a = _norm(cfg, self.attn(x, rope_tables, kv_cache, meta),
                      self.post_attn_norm, eps)
            x = _stream(a, x)
            return _norm(cfg, self._mlp(x, meta), self.post_ffw_norm,
                         eps), x
        h, residual = _add_norm(cfg, x, residual, self.input_norm, eps)
        h = self.attn(h, rope_tables, kv_cache, meta)
        if cfg.post_norms:
            # Gemma-2/3 and GLM-4 sandwich norms (JAX
            # `modeling_utils.py:702-712`): x += post_norm(attn(pre_norm(x))),
            # the same around the MLP
            h = _norm(cfg, h, self.post_attn_norm, eps)
            h2, residual = _add_norm(cfg, h, residual, self.pre_ffw_norm,
                                     eps)
            return _norm(cfg, self._mlp(h2, meta), self.post_ffw_norm,
                         eps), residual
        rm = cfg.residual_multiplier
        h2, residual = _add_norm(cfg, _scaled(h, rm), residual,
                                 self.post_attn_norm, eps)
        return _scaled(self._mlp(h2, meta), rm), residual

    def _mlp(self, x, meta: AttentionMetadata):
        """The MLP, with the step's adapters unless it is a MoE."""
        return self.mlp(x) if self.is_moe else self.mlp(x, meta.lora_ids)


class _Norm(nn.Module):
    """A norm's f32 weight, and its bias under LayerNorm."""

    def __init__(self, n: int, bias: bool = False):
        super().__init__()
        self.register_buffer("weight", torch.ones(n, dtype=torch.float32))
        self.register_buffer("bias", torch.zeros(n, dtype=torch.float32)
                             if bias else None)


_MODEL_REGISTRY: Dict[str, type] = {}


def register_auto_model(*architectures):
    def deco(cls):
        for a in architectures:
            _MODEL_REGISTRY[a] = cls
        return cls
    return deco


def registered_models() -> Dict[str, type]:
    """Every HF architecture the port serves, with its model class."""
    # the architecture modules register themselves on import
    from tensorrt_llm_tpu_torch.models import (  # noqa: F401
        apertus, deepseek, dots1, exaone4, exaone_moe, gemma, glm, glm4_moe,
        gpt_oss, granite, hunyuan, llama, llama4, minimax_m2, mistral_large3,
        mixtral, nemotron, olmo2, phi, seed_oss, smollm3, starcoder2)
    return _MODEL_REGISTRY


def get_model_class(architecture: str) -> type:
    known = registered_models()
    if architecture not in known:
        raise KeyError(f"architecture {architecture!r} not in this slice; "
                       f"known: {sorted(known)}")
    return known[architecture]


class DecoderModelForCausalLM(nn.Module):
    # HF tensor names (the JAX package's, `models/modeling_utils.py`); the
    # MoE keys are Qwen-MoE/DeepSeek style, Mixtral overrides them
    MOE_ROUTER_KEY = "mlp.gate.weight"
    MOE_EXPERT_KEY = "mlp.experts.{j}.{proj}.weight"
    MOE_PROJ_NAMES = {"gate": "gate_proj", "up": "up_proj", "down": "down_proj"}
    MOE_SHARED_PREFIX = "mlp.shared_experts."
    MOE_BIAS_KEY = "mlp.gate.e_score_correction_bias"
    # Qwen2-MoE's sigmoid gate of the shared expert, [1, H]
    MOE_SHARED_GATE_KEY = "mlp.shared_expert_gate.weight"
    # the HF `scoring_func` / `topk_method` values the family routes by
    # (`from_hf_config` refuses others; DeepSeek and the sigmoid families
    # override)
    HF_SCORING_FUNCS: Tuple[str, ...] = ("softmax",)
    HF_TOPK_METHODS: Tuple[str, ...] = ()
    # HF keys that only this family's class reads, kept in `cfg.extra` by
    # `from_hf_config`
    HF_EXTRA_KEYS: Tuple[str, ...] = ()
    # each layer norm's HF name (GLM-4 and Apertus override): the sandwich
    # pair under `post_norms`, post_attn / post_ffw alone under
    # `post_block_norms`
    NORM_KEYS = {"input_norm": "input_layernorm",
                 "post_attn_norm": "post_attention_layernorm",
                 "pre_ffw_norm": "pre_feedforward_layernorm",
                 "post_ffw_norm": "post_feedforward_layernorm"}
    # the non-gated MLP's linears (Starcoder2: c_fc / c_proj)
    MLP_UP_KEY = "mlp.up_proj"
    MLP_DOWN_KEY = "mlp.down_proj"
    # layernorm1p (Nemotron): its (1 + w) folded into the weights at load
    NORM_WEIGHT_OFFSET = 0.0
    # the HF `model_type` of a zoo family (dense or MoE), and its HF class's
    # `tie_word_embeddings` default (`llmapi.hf_checkpoint`: a
    # `save_pretrained` config.json leaves that key out when it is true)
    HF_MODEL_TYPE: Optional[str] = None
    HF_TIE_DEFAULT = False
    # the q/k norms (HunYuan overrides)
    Q_NORM_KEY = "self_attn.q_norm.weight"
    K_NORM_KEY = "self_attn.k_norm.weight"

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.embedding = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            [DecoderLayer(cfg, i, self.device) for i in range(cfg.num_layers)])
        self.final_norm = _Norm(cfg.hidden_size,
                                cfg.norm_type == "layernorm")
        # the LM head stays bf16 (QuantConfig.exclude_modules); it holds no
        # weight under tie_word_embeddings
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, cfg.quant,
                              "lm_head")
        cos, sin = make_rope_tables(cfg.rope)
        self.register_buffer("rope_cos", cos)
        self.register_buffer("rope_sin", sin)
        local = cfg.rope_local
        cos, sin = make_rope_tables(local) if local else (None, None)
        self.register_buffer("rope_local_cos", cos)
        self.register_buffer("rope_local_sin", sin)
        self.to(self.device)

    # ---- parameters -----------------------------------------------------
    @torch.no_grad()
    def init_random(self, seed: int = 0) -> "DecoderModelForCausalLM":
        """Random weights at the real shapes, drawn on the model's device
        from a `torch.Generator` seeded with `seed`, one layer at a time and
        quantized as they are drawn (GPT-OSS-20B draws ~19 G floats; a
        DeepSeek-V3 MoE layer's 256 experts are drawn 16 at a time).  Two
        devices give different floats for one seed: carry weights across
        with `state()` / `load_state`.  Scales follow the JAX package's
        `init`; biases, q/k norms, xIELU's alphas and DeepSeek's
        score-correction bias are small random values, sinks N(0, 0.5^2);
        the layer norms keep ones (LayerNorm: zero biases)."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        H = cfg.hidden_size

        def normal(shape, std):
            return torch.randn(shape, generator=gen, device=dev).mul_(std)

        self.embedding.load(normal((cfg.vocab_size, H), 0.02))
        for layer in self.layers:
            self.init_layer(layer, normal)
        if not cfg.tie_word_embeddings:
            self.lm_head.from_float(normal((H, cfg.vocab_size),
                                           0.5 / H ** 0.5))
        return self

    @torch.no_grad()
    def init_layer(self, layer: "DecoderLayer", normal) -> None:
        """Random weights of one decoder layer (`init_random`'s draw order),
        from `normal(shape, std)`; the MTP drafter draws its block with
        it."""
        cfg = self.cfg
        H, D = cfg.hidden_size, cfg.head_dim
        Hq, Hkv = cfg.num_heads * D, cfg.num_kv_heads * D
        std = 0.5 / H ** 0.5
        b = 0.02
        if cfg.is_mla:
            self._init_mla(layer.attn, normal)
        else:
            layer.attn.from_float(
                normal((H, Hq), std), normal((H, Hkv), std),
                normal((H, Hkv), std), normal((Hq, H), std),
                q_b=normal((Hq,), b), k_b=normal((Hkv,), b),
                v_b=normal((Hkv,), b), o_b=normal((H,), b),
                sinks=normal((cfg.num_heads,), 0.5),
                **(dict(q_norm=1.0 + normal((Hq if cfg.qk_norm_flat
                                              else D,), 0.02),
                        k_norm=1.0 + normal((Hkv if cfg.qk_norm_flat
                                              else D,), 0.02))
                   if cfg.qk_norm else {}))
        if layer.is_moe:
            E, I = cfg.num_experts, cfg.moe_intermediate_size
            chunk = 16
            layer.mlp.load_experts(
                (normal((min(chunk, E - e), H, I), std),
                 normal((min(chunk, E - e), H, I), std),
                 normal((min(chunk, E - e), I, H), 0.5 / I ** 0.5))
                for e in range(0, E, chunk))
            layer.mlp.from_float(
                normal((H, E), std), None, None, None,
                router_bias=normal((E,), b), gate_b=normal((E, I), b),
                up_b=normal((E, I), b), down_b=normal((E, H), b),
                score_bias=normal((E,), 0.05),
                shared_gate=(normal((H,), std) if layer.mlp.has_shared_gate
                             else None))
            if layer.mlp.shared is not None:
                Is = layer.mlp.shared.intermediate_size
                layer.mlp.shared.from_float(
                    normal((H, Is), std), normal((H, Is), std),
                    normal((Is, H), 0.5 / Is ** 0.5))
        elif isinstance(layer.mlp, MLP):
            I = cfg.intermediate_size
            act = None
            if layer.mlp.activation == "xielu":
                act = {"alpha_p": math.log(math.expm1(0.8))
                       + normal((1,), 0.05),
                       "alpha_n": math.log(math.expm1(0.3))
                       + normal((1,), 0.05)}
            layer.mlp.from_float(normal((H, I), std),
                                 normal((I, H), 0.5 / I ** 0.5),
                                 up_b=normal((I,), b), down_b=normal((H,), b),
                                 act=act)
        else:
            I = cfg.intermediate_size
            layer.mlp.from_float(normal((H, I), std), normal((H, I), std),
                                 normal((I, H), 0.5 / I ** 0.5))

    def _init_mla(self, attn: MLA, normal) -> None:
        """Random MLA (and indexer) weights at the JAX package's `MLA.init`
        scales."""
        cfg = self.cfg
        H, Hn = cfg.hidden_size, cfg.num_heads
        L, R = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        N, V, Q = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.q_lora_rank
        std = 0.5 / H ** 0.5
        if Q is not None:
            kw = dict(q_a_w=normal((H, Q), std),
                      q_b_w=normal((Q, Hn * (N + R)), 0.5 / Q ** 0.5),
                      q_norm=1.0 + normal((Q,), 0.02))
        else:
            kw = dict(q_w=normal((H, Hn * (N + R)), std))
        ix = attn.indexer
        if ix is not None:
            kw["indexer"] = dict(
                wq_b=normal((Q, ix.n_heads * ix.head_dim), 0.5 / Q ** 0.5),
                wk=normal((H, ix.head_dim), std),
                k_norm_w=1.0 + normal((ix.head_dim,), 0.02),
                k_norm_b=normal((ix.head_dim,), 0.02),
                weights_proj=normal((H, ix.n_heads), std))
        attn.from_float(normal((H, L + R), std),
                        normal((L, Hn * (N + V)), 0.5 / L ** 0.5),
                        normal((Hn * V, H), std), 1.0 + normal((L,), 0.02),
                        **kw)

    @torch.no_grad()
    def load_state(self, state: Dict[str, torch.Tensor]
                   ) -> "DecoderModelForCausalLM":
        """Install a state (as made by `params_from_jax`, or a `state()`):
        names are module paths, values are placed on the model's device."""
        groups: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, t in state.items():
            mod, _, leaf = name.rpartition(".")
            groups.setdefault(mod, {})[leaf] = t.to(self.device)
        for mod, leaves in groups.items():
            m = self.get_submodule(mod) if mod else self
            if isinstance(m, Linear):
                m.load(leaves)
            elif isinstance(m, Embedding):
                m.load(leaves["weight"])
            elif isinstance(m, MoE):
                m.load(leaves)
            else:
                for leaf, t in leaves.items():
                    setattr(m, leaf, t)
        return self

    def state(self) -> Dict[str, torch.Tensor]:
        """Every buffer by module path (feeds `load_state` on another
        device)."""
        return {k: v for k, v in self.named_buffers() if v is not None}

    # ---- HF checkpoints ---------------------------------------------------
    @torch.no_grad()
    def load_hf_weights(self, get_tensor, mtp_sink=None
                        ) -> "DecoderModelForCausalLM":
        """Install the weights of an HF checkpoint, the JAX package's
        `load_hf_weights`: `get_tensor(name)` gives the tensor of an HF
        name (None when absent).  Each tensor goes to the model's device as
        it is read, in f32, and linears ([out, in] in HF) are transposed to
        [in, out] and quantized there by the layers' `from_float`, so the
        host holds about one tensor and the device one layer's floats at a
        time.  Under a pre-quantized (AWQ/GPTQ) config a linear that ships
        qweight/qzeros/scales is unpacked exactly instead (`QTensor`).
        The checkpoint layer `num_layers` of a DeepSeek checkpoint (its MTP
        block, ``eh_proj`` and friends) is not part of the model: when the
        checkpoint holds it, `get_tensor` is handed to `mtp_sink` (the MTP
        drafter's `set_checkpoint`), which reads it."""
        cfg, dev = self.cfg, self.device
        quant = cfg.quant
        pre_q = quant is not None and quant.pre_quantized

        def t(name):
            if pre_q:
                qt = maybe_load_quantized(get_tensor, name, quant.ckpt_format,
                                          v2=quant.ckpt_v2)
                if qt is not None:
                    return qt.to(dev)
            return hf_tensor(get_tensor, name, dev).t()

        def vec(name):
            a = get_tensor(name)
            return None if a is None else a.to(dev).to(torch.float32)

        self.embedding.load(hf_tensor(get_tensor, "model.embed_tokens.weight",
                                      dev))
        def load_norm(mod, base):
            """A norm's weight (plus `NORM_WEIGHT_OFFSET`) and, under
            LayerNorm, its bias (zeros where the checkpoint has none)."""
            mod.weight = (hf_tensor(get_tensor, base + ".weight", dev)
                          + self.NORM_WEIGHT_OFFSET)
            if cfg.norm_type == "layernorm":
                b = vec(base + ".bias") if cfg.norm_bias else None
                mod.bias = (b if b is not None
                            else torch.zeros_like(mod.weight))

        load_norm(self.final_norm, "model.norm")
        names = (("post_attn_norm", "post_ffw_norm") if cfg.post_block_norms
                 else ("input_norm", "post_attn_norm")
                 + (("pre_ffw_norm", "post_ffw_norm") if cfg.post_norms
                    else ()))
        for i, layer in enumerate(self.layers):
            pre = f"model.layers.{i}."
            for norm in names:
                load_norm(getattr(layer, norm), pre + self.NORM_KEYS[norm])
            self._load_attn(layer, pre, t, vec)
            self._load_mlp(layer, get_tensor, pre, t, vec)
        if not cfg.tie_word_embeddings:
            self.lm_head.from_float(t("lm_head.weight"))
        if mtp_sink is not None and get_tensor(
                f"model.layers.{cfg.num_layers}.eh_proj.weight") is not None:
            mtp_sink(get_tensor)
        return self

    def _load_attn(self, layer, pre: str, t, vec) -> None:
        """One layer's GQA attention from HF names (DeepSeek overrides for
        MLA)."""
        cfg = self.cfg
        a = pre + "self_attn."
        bias = cfg.attention_bias
        layer.attn.from_float(
            t(a + "q_proj.weight"), t(a + "k_proj.weight"),
            t(a + "v_proj.weight"), t(a + "o_proj.weight"),
            q_b=vec(a + "q_proj.bias") if bias else None,
            k_b=vec(a + "k_proj.bias") if bias else None,
            v_b=vec(a + "v_proj.bias") if bias else None,
            o_b=vec(a + "o_proj.bias") if cfg.o_bias else None,
            sinks=vec(a + "sinks") if cfg.has_sinks else None,
            q_norm=vec(pre + self.Q_NORM_KEY) if cfg.qk_norm else None,
            k_norm=vec(pre + self.K_NORM_KEY) if cfg.qk_norm else None)

    def _load_mlp(self, layer, get_tensor, pre: str, t, vec) -> None:
        """One layer's gated or non-gated MLP (with xIELU's alphas from
        ``mlp.act_fn.*``), or MoE (router, experts read 16 at a time and
        stacked [E, in, out], shared experts and Qwen2-MoE's gate of them,
        the score correction bias), from HF names (the family's `MOE_*`
        keys)."""
        mlp = layer.mlp
        if isinstance(mlp, MLP):
            up, down = pre + self.MLP_UP_KEY, pre + self.MLP_DOWN_KEY
            act = None
            if mlp.activation == "xielu":
                act = {a: vec(pre + "mlp.act_fn." + a)
                       for a in ("alpha_p", "alpha_n")}
            mlp.from_float(t(up + ".weight"), t(down + ".weight"),
                           up_b=vec(up + ".bias") if mlp.has_bias else None,
                           down_b=(vec(down + ".bias") if mlp.has_bias
                                   else None), act=act)
            return
        if not isinstance(mlp, MoE):
            mlp.from_float(t(pre + "mlp.gate_proj.weight"),
                           t(pre + "mlp.up_proj.weight"),
                           t(pre + "mlp.down_proj.weight"))
            return
        dev = self.device
        E = self.cfg.num_experts

        def stack(js, kind):
            proj = self.MOE_PROJ_NAMES[kind]
            return torch.stack([hf_tensor(
                get_tensor, pre + self.MOE_EXPERT_KEY.format(j=j, proj=proj),
                dev).t() for j in js])

        mlp.load_experts(
            tuple(stack(range(lo, min(lo + 16, E)), kind)
                  for kind in ("gate", "up", "down"))
            for lo in range(0, E, 16))
        self._load_moe_rest(mlp, pre, t, vec, pre + self.MOE_ROUTER_KEY)

    def _load_moe_rest(self, mlp: MoE, pre: str, t, vec,
                       router_key: str) -> None:
        """A MoE layer's shared experts, router, score bias and shared
        gate, once its experts are in."""
        if mlp.shared is not None:
            sp = pre + self.MOE_SHARED_PREFIX
            mlp.shared.from_float(t(sp + "gate_proj.weight"),
                                  t(sp + "up_proj.weight"),
                                  t(sp + "down_proj.weight"))
        mlp.from_float(
            t(router_key), None, None, None,
            score_bias=(vec(pre + self.MOE_BIAS_KEY)
                        if mlp.has_score_bias else None),
            shared_gate=(vec(pre + self.MOE_SHARED_GATE_KEY)
                         if mlp.has_shared_gate else None))

    # ---- forward ------------------------------------------------------------
    def forward(self, input_ids: torch.Tensor,
                kv_caches: List[Tuple[torch.Tensor, torch.Tensor]],
                meta: AttentionMetadata,
                logit_indices: Optional[torch.Tensor] = None,
                return_hidden: bool = False, capture: str = "final"):
        """Logits [rows, V] in f32 (bf16-rounded, as the JAX package's bf16
        lm_head returns them).  KV caches are updated in place.

        `return_hidden` also returns the hidden states at the logit rows,
        the tap one-model speculative drafters read (JAX
        `forward(return_hidden=True)`): ``capture="final"`` the residual
        stream before the final norm [rows, H] (the stream DeepSeek's MTP
        `hnorm` and EAGLE training data are trained on), ``"eagle3"`` the
        residual streams after layers 0, L//2 and L-1 concatenated
        [rows, 3H] (a duplicate capture point of a tiny model repeats the
        last).  Without it the logits are computed exactly as before."""
        cfg = self.cfg
        x = self.embedding(input_ids)
        if cfg.embedding_multiplier:
            x = (x.to(torch.float32) * cfg.embedding_multiplier).to(x.dtype)
        residual = None
        rope = (self.rope_cos, self.rope_sin)
        if self.rope_local_cos is not None:
            rope = (rope, (self.rope_local_cos, self.rope_local_sin))
        L = len(self.layers)
        cap_at = {0, L // 2, L - 1} if (return_hidden
                                        and capture == "eagle3") else ()
        captured = []
        for i, layer in enumerate(self.layers):
            x, residual = layer(x, residual, rope, kv_caches[i], meta)
            if i in cap_at:
                captured.append(_stream(x, residual))
        hidden = None
        if return_hidden:
            if capture == "eagle3":
                while len(captured) < 3:
                    captured.append(captured[-1])
                hidden = torch.cat(captured[:3], dim=-1)
            else:
                hidden = _stream(x, residual)
            if logit_indices is not None:
                hidden = hidden[logit_indices]
        x, _ = _add_norm(cfg, x, residual, self.final_norm, cfg.rms_eps)
        if logit_indices is not None:
            x = x[logit_indices]
        logits = self.logits(x)
        return (logits, hidden) if return_hidden else logits

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The LM head on final-norm rows: f32 logits [rows, V], divided by
        `logits_scaling` (Granite), soft-capped under `final_logit_softcap`
        (Gemma-2)."""
        if self.cfg.tie_word_embeddings:
            # the JAX package's jnp.dot(x, emb.T) with f32 output; cuBLAS's
            # bf16 product on the card (f32 accumulation, bf16 out, as the
            # untied head)
            logits = dot_f32(x, self.embedding.weight.t())
        else:
            logits = self.lm_head(x).to(torch.float32)
        if self.cfg.logits_scaling:
            logits = div_scalar(logits, self.cfg.logits_scaling)
        c = self.cfg.final_logit_softcap
        if c:
            logits = c * torch.tanh(logits / c)
        return logits


def _stream(x: torch.Tensor, residual: Optional[torch.Tensor]
            ) -> torch.Tensor:
    """The residual stream x + residual (added in f32, rounded once)."""
    if residual is None:
        return x
    return (x.to(torch.float32) + residual.to(torch.float32)).to(x.dtype)


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b` of bf16 operands as f32, as JAX's ``jnp.dot(...,
    preferred_element_type=f32)``: in f32 on the CPU, cuBLAS's bf16 product
    (f32 accumulation) on the card."""
    if a.device.type == "cuda":
        return torch.matmul(a, b.to(a.dtype)).to(torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


def hf_tensor(get_tensor, name: str, device) -> torch.Tensor:
    """Checkpoint tensor `name` as f32 on `device`; a missing one raises,
    naming MXFP4 when the checkpoint holds its `_blocks` form instead."""
    a = get_tensor(name)
    if a is None:
        if get_tensor(name + "_blocks") is not None:
            raise NotImplementedError(
                f"{name} is stored as MXFP4 ({name}_blocks/_scales); the "
                "port reads bf16, f16 and f32 checkpoints only")
        raise KeyError(f"checkpoint has no tensor {name!r}")
    return a.to(device).to(torch.float32)


_NORMS = ("input_norm", "post_attn_norm", "final_norm", "pre_ffw_norm",
          "post_ffw_norm")


def params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter pytree (leaves as numpy arrays; bf16
    leaves may arrive as ml_dtypes bfloat16) as a port state for
    `DecoderModelForCausalLM.load_state`.  W4A16 int4 weights keep their
    packing byte for byte (tiled or K-paired), W4A8 ones too; W4A16
    scales round to bf16 at load, W4A8 scales and zeros stay f32; 8-bit
    weights (int8, or e4m3 as ml_dtypes ``float8_e4m3fn``) keep their
    bytes and f32 scales.  A
    multi-LoRA ``lora`` subtree (``attn.lora.qkv = (A, B)``) becomes the
    holder's stack buffers (``attn.lora_qkv_a``, ``attn.lora_qkv_b``).
    LayerNorm ``{"weight", "bias"}`` pairs keep their names; the xIELU
    ``mlp.act`` pair becomes the MLP's ``alpha_p`` / ``alpha_n``."""
    out: Dict[str, torch.Tensor] = {}

    def tensor(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        if a.dtype.name == "float8_e4m3fn":
            return torch.from_numpy(np.array(a).view(np.uint8)).view(
                torch.float8_e4m3fn)
        return torch.from_numpy(np.array(a))

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            if path in (["rope"], ["rope_local"]):
                out[path[0] + "_cos"] = tensor(node[0])
                out[path[0] + "_sin"] = tensor(node[1])
                return
            if len(path) > 1 and path[-2] == "lora":
                pre = ".".join(path[:-2] + [f"lora_{path[-1]}"])
                out[pre + "_a"] = tensor(node[0])
                out[pre + "_b"] = tensor(node[1])
                return
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        elif node is not None:
            if len(path) > 1 and path[-2] == "act":
                path = path[:-2] + path[-1:]
            name = ".".join(path)
            if path[-1] in _NORMS:
                name += ".weight"
            out[name] = tensor(node)

    walk(tree, [])
    return out

