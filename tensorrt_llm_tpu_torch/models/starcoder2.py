"""StarCoder2 (HF `Starcoder2ForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/starcoder2.py`: LayerNorm with a bias everywhere,
biased QKV and o projections, and a non-gated tanh-GELU MLP (`c_fc` /
`c_proj`, biased), all under HF's `use_bias` (default true)."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

# starcoder2-7b's published widths (HF bigcode/starcoder2-7b config.json):
# a 4,096-token window on every layer
STARCODER2_7B = {"hf_config": {
    "architectures": ["Starcoder2ForCausalLM"], "vocab_size": 49152,
    "hidden_size": 4608, "intermediate_size": 18432,
    "num_hidden_layers": 32, "num_attention_heads": 36,
    "num_key_value_heads": 4, "rope_theta": 1000000.0,
    "norm_epsilon": 1e-5, "max_position_embeddings": 16384,
    "sliding_window": 4096, "use_bias": True,
    "hidden_act": "gelu_pytorch_tanh", "tie_word_embeddings": False}}


@register_auto_model("Starcoder2ForCausalLM")
class Starcoder2ForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "starcoder2"
    HF_TIE_DEFAULT = True
    MLP_UP_KEY = "mlp.c_fc"
    MLP_DOWN_KEY = "mlp.c_proj"

    def __init__(self, cfg: ModelConfig, device="cuda"):
        bias = True if cfg.use_bias is None else bool(cfg.use_bias)
        cfg.norm_type = "layernorm"
        cfg.norm_bias = True
        cfg.mlp_gated = False
        cfg.mlp_bias = bias
        cfg.attention_bias = bias
        cfg.o_bias = bias
        cfg.activation = "gelu"      # gelu_pytorch_tanh
        super().__init__(cfg, device)
