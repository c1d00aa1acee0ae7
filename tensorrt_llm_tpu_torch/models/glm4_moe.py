"""GLM-4.5 MoE (HF `Glm4MoeForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/glm4_moe.py`: DeepSeek V3's noaux_tc routing
(sigmoid scores, the score-correction bias, group-limited top-k, routed
scaling) and shared experts over GQA attention with a biased QKV, RoPE on
the leading half of each head (rotate-half pairs), per-head q/k RMSNorm
under `use_qk_norm`, and `first_k_dense_replace` leading dense layers.

The preset is the published `config.json` (model-structure keys only) of
huggingface.co/zai-org/GLM-4.5-Air, kept as the port's own copy."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

# GLM-4.5-Air's published widths: 96/8 heads of 128 (a decode group of
# 12), 128 experts of 1,408 and one shared, top 8, layer 0 dense
GLM_4_5_AIR = {"hf_config": {
    "architectures": ["Glm4MoeForCausalLM"], "vocab_size": 151552,
    "hidden_size": 4096, "intermediate_size": 10944,
    "moe_intermediate_size": 1408, "num_hidden_layers": 46,
    "num_attention_heads": 96, "num_key_value_heads": 8, "head_dim": 128,
    "n_routed_experts": 128, "num_experts_per_tok": 8, "n_shared_experts": 1,
    "n_group": 1, "topk_group": 1, "routed_scaling_factor": 1.0,
    "norm_topk_prob": True, "first_k_dense_replace": 1,
    "partial_rotary_factor": 0.5, "use_qk_norm": False,
    "attention_bias": True, "rope_theta": 1000000.0, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 131072, "tie_word_embeddings": False}}


@register_auto_model("Glm4MoeForCausalLM")
class Glm4MoeForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "glm4_moe"
    HF_SCORING_FUNCS = ("sigmoid", "noaux_tc")
    HF_TOPK_METHODS = ("noaux_tc",)
    HF_EXTRA_KEYS = ("use_qk_norm",)

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.moe_score_func = "sigmoid"
        cfg.moe_has_score_bias = True
        cfg.qk_norm = bool(cfg.extra.get("use_qk_norm", False))
        if cfg.partial_rotary_factor is None:
            cfg.partial_rotary_factor = 0.5
        super().__init__(cfg, device)
