"""ByteDance Seed-OSS (HF `SeedOssForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/seed_oss.py`: the Llama decoder with a biased QKV
and an explicit head_dim."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

# Seed-OSS-36B-Instruct's published widths (HF
# ByteDance-Seed/Seed-OSS-36B-Instruct config.json)
SEED_OSS_36B = {"hf_config": {
    "architectures": ["SeedOssForCausalLM"], "vocab_size": 155136,
    "hidden_size": 5120, "intermediate_size": 27648,
    "num_hidden_layers": 64, "num_attention_heads": 80,
    "num_key_value_heads": 8, "head_dim": 128, "rope_theta": 10000000.0,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 524288,
    "attention_bias": True, "tie_word_embeddings": False}}


@register_auto_model("SeedOssForCausalLM")
class SeedOssForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "seed_oss"

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.attention_bias = True
        super().__init__(cfg, device)
