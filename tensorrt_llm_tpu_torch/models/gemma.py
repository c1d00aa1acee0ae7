"""Gemma family (Gemma, Gemma-2, Gemma-3 text).

Counterpart of `tensorrt_llm_tpu/models/gemma.py`: the shared decoder with
tanh-GELU gated MLPs, tied embeddings scaled by sqrt(hidden), the (1 + w)
RMSNorm convention folded into the weights at load (+1 on every norm
weight, so the norms stay plain RMSNorms), and per family:

* Gemma-2: post-attention and post-FFW norms, the attention scale
  `query_pre_attn_scalar ** -0.5`, soft caps of the attention scores
  (`attn_logit_softcapping`) and of the final logits
  (`final_logit_softcapping`), local and global layers alternating
  (`sliding_window_pattern` 2);
* Gemma-3: the same norms and scale, per-head q/k RMSNorm, every
  `sliding_window_pattern`-th layer global (default 6), and the local
  layers' own RoPE base (`rope_local_base_freq`).

Their sliding layers keep VSWA rings where the engine makes them
(`runtime/model_engine.py`).  The family's HF keys reach the config's
fields through `ModelConfig.from_hf_config` (the JAX package routes them
through its `extra` dict to the same fields).  The vision model
(`Gemma3ForConditionalGeneration`) is not in this slice.
"""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

# Gemma-2-9B's published widths (HF google/gemma-2-9b config.json)
GEMMA2_9B = {"hf_config": {
    "architectures": ["Gemma2ForCausalLM"], "vocab_size": 256000,
    "hidden_size": 3584, "intermediate_size": 14336,
    "num_hidden_layers": 42, "num_attention_heads": 16,
    "num_key_value_heads": 8, "head_dim": 256, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "max_position_embeddings": 8192,
    "sliding_window": 4096, "query_pre_attn_scalar": 256,
    "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "hidden_activation": "gelu_pytorch_tanh", "tie_word_embeddings": True}}


class _GemmaBase(DecoderModelForCausalLM):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.tie_word_embeddings = True
        cfg.embedding_multiplier = cfg.hidden_size ** 0.5
        cfg.activation = "gelu"
        super().__init__(cfg, device)

    def load_hf_weights(self, get_tensor, mtp_sink=None):
        """HF weights with the (1 + w) norm convention folded in: +1 on
        every norm weight (layer norms, q/k norms, the final norm)."""
        def plus_one(name):
            a = get_tensor(name)
            if a is not None and name.endswith("norm.weight"):
                a = a.float() + 1.0
            return a
        return super().load_hf_weights(plus_one, mtp_sink)


@register_auto_model("GemmaForCausalLM")
class GemmaForCausalLM(_GemmaBase):
    pass


@register_auto_model("Gemma2ForCausalLM")
class Gemma2ForCausalLM(_GemmaBase):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.post_norms = True
        cfg.sliding_window_pattern = 2   # alternating local / global
        super().__init__(cfg, device)


@register_auto_model("Gemma3ForCausalLM", "Gemma3TextModel")
class Gemma3ForCausalLM(_GemmaBase):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.post_norms = True
        cfg.qk_norm = True
        if cfg.sliding_window_pattern <= 1:
            cfg.sliding_window_pattern = 6
        if cfg.rope_local_theta is None:
            cfg.rope_local_theta = 10000.0
        super().__init__(cfg, device)
