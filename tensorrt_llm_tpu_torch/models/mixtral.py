"""Mixtral and Qwen-MoE causal LMs.  Counterpart of
`tensorrt_llm_tpu/models/mixtral.py`: the shared decoder with its FFNs a
MoE -- Mixtral under softmax -> top-k -> renormalize routing with the HF
names of its `block_sparse_moe` weights; Qwen3-MoE with per-head q/k
RMSNorm, no QKV bias and `norm_topk_prob` as read, a MoE every
`decoder_sparse_step`-th layer past `mlp_only_layers`; Qwen2-MoE with QKV
bias, `norm_topk_prob` false unless the config sets it, and its shared
expert of `shared_expert_intermediate_size` scaled by the sigmoid gate
``mlp.shared_expert_gate`` (HF `Qwen2MoeSparseMoeBlock`; the JAX package
drops both, so its Qwen2-MoE agrees with HF only when that width is 0).

The presets are the published `config.json` fields (model-structure keys
only) of huggingface.co/Qwen/Qwen3-30B-A3B and
huggingface.co/Qwen/Qwen1.5-MoE-A2.7B, kept as the port's own copies."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

# Qwen3-30B-A3B's published widths (HF Qwen/Qwen3-30B-A3B config.json):
# 128 experts of 768, top 8 renormalized, every layer a MoE
QWEN3_30B_A3B = {"hf_config": {
    "architectures": ["Qwen3MoeForCausalLM"], "vocab_size": 151936,
    "hidden_size": 2048, "intermediate_size": 6144,
    "moe_intermediate_size": 768, "num_hidden_layers": 48,
    "num_attention_heads": 32, "num_key_value_heads": 4, "head_dim": 128,
    "num_experts": 128, "num_experts_per_tok": 8, "norm_topk_prob": True,
    "decoder_sparse_step": 1, "mlp_only_layers": [],
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 40960, "attention_bias": False,
    "tie_word_embeddings": False}}

# Qwen1.5-MoE-A2.7B's published widths (HF Qwen/Qwen1.5-MoE-A2.7B
# config.json): 60 experts of 1,408, top 4 not renormalized, a gated shared
# expert of 5,632; `sliding_window` stays in the file under
# `use_sliding_window` false, read as it stands (every layer slides at
# 32,768: no ring below it), as Qwen2.5's
QWEN1_5_MOE_A2_7B = {"hf_config": {
    "architectures": ["Qwen2MoeForCausalLM"], "vocab_size": 151936,
    "hidden_size": 2048, "intermediate_size": 5632,
    "moe_intermediate_size": 1408, "shared_expert_intermediate_size": 5632,
    "num_hidden_layers": 24, "num_attention_heads": 16,
    "num_key_value_heads": 16, "num_experts": 60, "num_experts_per_tok": 4,
    "norm_topk_prob": False, "decoder_sparse_step": 1,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 8192, "sliding_window": 32768,
    "use_sliding_window": False, "max_window_layers": 21,
    "tie_word_embeddings": False}}


@register_auto_model("MixtralForCausalLM")
class MixtralForCausalLM(DecoderModelForCausalLM):
    MOE_ROUTER_KEY = "block_sparse_moe.gate.weight"
    MOE_EXPERT_KEY = "block_sparse_moe.experts.{j}.{proj}.weight"
    MOE_PROJ_NAMES = {"gate": "w1", "up": "w3", "down": "w2"}

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.norm_topk_prob = True          # Mixtral renormalizes the top-k
        cfg.moe_intermediate_size = cfg.intermediate_size
        super().__init__(cfg, device)


@register_auto_model("Qwen3MoeForCausalLM")
class Qwen3MoeForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "qwen3_moe"

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.qk_norm = True
        cfg.attention_bias = False
        super().__init__(cfg, device)


@register_auto_model("Qwen2MoeForCausalLM")
class Qwen2MoeForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "qwen2_moe"
    HF_EXTRA_KEYS = ("norm_topk_prob",)     # its default differs
    MOE_SHARED_PREFIX = "mlp.shared_expert."

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.attention_bias = True
        cfg.norm_topk_prob = bool(cfg.extra.get("norm_topk_prob", False))
        cfg.n_shared_experts = 1 if cfg.shared_expert_intermediate_size else 0
        cfg.moe_shared_gate = bool(cfg.n_shared_experts)
        super().__init__(cfg, device)
