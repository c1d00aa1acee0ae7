"""IBM Granite (HF `GraniteForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/granite.py`: the Llama decoder with four scalar
multipliers -- the embedding (`embedding_multiplier`), each block's output
(`residual_multiplier`), the softmax scale (`attention_multiplier`, carried
as `query_pre_attn_scalar = am ** -2`, so that the attention's
`query_pre_attn_scalar ** -0.5` is exactly `am`) and the logits' divisor
(`logits_scaling`)."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

# granite-3.1-8b-instruct's published widths (HF
# ibm-granite/granite-3.1-8b-instruct config.json)
GRANITE_3_1_8B = {"hf_config": {
    "architectures": ["GraniteForCausalLM"], "vocab_size": 49155,
    "hidden_size": 4096, "intermediate_size": 12800,
    "num_hidden_layers": 40, "num_attention_heads": 32,
    "num_key_value_heads": 8, "rope_theta": 10000000.0,
    "rms_norm_eps": 1e-5, "max_position_embeddings": 131072,
    "embedding_multiplier": 12.0, "residual_multiplier": 0.22,
    "attention_multiplier": 0.0078125, "logits_scaling": 16.0,
    "tie_word_embeddings": True}}


@register_auto_model("GraniteForCausalLM")
class GraniteForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "granite"

    def __init__(self, cfg: ModelConfig, device="cuda"):
        am = cfg.attention_multiplier
        if am:
            cfg.query_pre_attn_scalar = am ** -2
        super().__init__(cfg, device)
