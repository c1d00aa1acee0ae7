"""Nemotron dense (HF `NemotronForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/nemotron.py`: LayerNorm1P (its (1 + w) folded
into the weights at load, `NORM_WEIGHT_OFFSET`), a squared-ReLU non-gated
MLP, and RoPE over the leading half of each head by default."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

# Minitron-8B-Base's published widths (HF nvidia/Minitron-8B-Base
# config.json): 48 query heads of 128, a q width of 6,144 past the hidden
# 4,096
MINITRON_8B = {"hf_config": {
    "architectures": ["NemotronForCausalLM"], "vocab_size": 256000,
    "hidden_size": 4096, "intermediate_size": 16384,
    "num_hidden_layers": 32, "num_attention_heads": 48,
    "num_key_value_heads": 8, "head_dim": 128, "rope_theta": 10000.0,
    "norm_eps": 1e-5, "max_position_embeddings": 4096,
    "partial_rotary_factor": 0.5, "hidden_act": "relu2",
    "tie_word_embeddings": False}}


@register_auto_model("NemotronForCausalLM")
class NemotronForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "nemotron"
    NORM_WEIGHT_OFFSET = 1.0    # layernorm1p: ln(x) * (1 + w) + b

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.norm_type = "layernorm"
        cfg.norm_bias = True
        cfg.mlp_gated = False
        cfg.activation = "relu2"
        if cfg.partial_rotary_factor is None:
            cfg.partial_rotary_factor = 0.5
        super().__init__(cfg, device)
