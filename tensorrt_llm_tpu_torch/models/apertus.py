"""Apertus (HF `ApertusForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/apertus.py`: the Llama decoder with a non-gated
MLP under the learned xIELU activation (per-layer `alpha_p` / `alpha_n`,
arXiv:2411.13010), per-head q/k RMSNorm before RoPE, and its own norm
names (`attention_layernorm`, `feedforward_layernorm`)."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

# Apertus-8B's published widths (HF swiss-ai/Apertus-8B-2509 config.json)
APERTUS_8B = {"hf_config": {
    "architectures": ["ApertusForCausalLM"], "vocab_size": 131072,
    "hidden_size": 4096, "intermediate_size": 21504,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "rope_theta": 12000000.0,
    "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192},
    "rms_norm_eps": 1e-5, "max_position_embeddings": 65536,
    "hidden_act": "xielu", "tie_word_embeddings": False}}


@register_auto_model("ApertusForCausalLM")
class ApertusForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "apertus"
    NORM_KEYS = dict(DecoderModelForCausalLM.NORM_KEYS,
                     input_norm="attention_layernorm",
                     post_attn_norm="feedforward_layernorm")

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.qk_norm = True
        cfg.mlp_gated = False
        cfg.activation = "xielu"
        super().__init__(cfg, device)
