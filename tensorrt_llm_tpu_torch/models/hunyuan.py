"""Tencent HunYuan v1 dense (HF `HunYuanDenseV1ForCausalLM`).  Counterpart
of the dense class in `tensorrt_llm_tpu/models/hunyuan.py`: the Llama
decoder whose per-head q/k RMSNorm (HF `query_layernorm` /
`key_layernorm`) comes after RoPE.  The MoE class comes with the MoE
families."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

# Hunyuan-7B-Instruct's published widths (HF tencent/Hunyuan-7B-Instruct
# config.json).  Its dynamic-NTK `rope_scaling` (alpha 1000) is left out:
# the JAX package's tables ignore that type, and the weights are random
HUNYUAN_7B = {"hf_config": {
    "architectures": ["HunYuanDenseV1ForCausalLM"], "vocab_size": 128167,
    "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-5, "max_position_embeddings": 32768,
    "tie_word_embeddings": False}}


@register_auto_model("HunYuanDenseV1ForCausalLM")
class HunYuanDenseV1ForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "hunyuan_v1_dense"
    Q_NORM_KEY = "self_attn.query_layernorm.weight"
    K_NORM_KEY = "self_attn.key_layernorm.weight"

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.qk_norm = True
        cfg.qk_norm_post_rope = True
        super().__init__(cfg, device)
