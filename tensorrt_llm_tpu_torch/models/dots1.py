"""rednote dots.llm1 (HF `Dots1ForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/dots1.py`: DeepSeek V3's noaux_tc routing and
shared experts over GQA attention with per-head q/k RMSNorm and full
rotary, its first layer dense (`first_k_dense_replace`).

The preset is the published `config.json` (model-structure keys only) of
huggingface.co/rednote-hilab/dots.llm1.inst, kept as the port's own
copy."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

# dots.llm1's published widths: 32/32 heads of 128, 128 experts of 1,408
# and two shared, top 6, layer 0 dense
DOTS_LLM1 = {"hf_config": {
    "architectures": ["Dots1ForCausalLM"], "vocab_size": 152064,
    "hidden_size": 4096, "intermediate_size": 10944,
    "moe_intermediate_size": 1408, "num_hidden_layers": 62,
    "num_attention_heads": 32, "num_key_value_heads": 32, "head_dim": 128,
    "n_routed_experts": 128, "num_experts_per_tok": 6, "n_shared_experts": 2,
    "n_group": 1, "topk_group": 1, "routed_scaling_factor": 2.5,
    "norm_topk_prob": True, "first_k_dense_replace": 1,
    "rope_theta": 10000000.0, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 32768, "attention_bias": False,
    "tie_word_embeddings": False}}


@register_auto_model("Dots1ForCausalLM")
class Dots1ForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "dots1"
    HF_SCORING_FUNCS = ("sigmoid", "noaux_tc")
    HF_TOPK_METHODS = ("noaux_tc",)

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.moe_score_func = "sigmoid"
        cfg.moe_has_score_bias = True
        cfg.qk_norm = True
        super().__init__(cfg, device)
