"""OLMo-2 (HF `Olmo2ForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/olmo2.py`: norms on the block outputs
(x += norm(attn(x)); x += norm(mlp(x))) and one q/k RMSNorm over the
flattened heads x head_dim projection."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

# OLMo-2-1124-7B's published widths (HF allenai/OLMo-2-1124-7B config.json)
OLMO2_7B = {"hf_config": {
    "architectures": ["Olmo2ForCausalLM"], "vocab_size": 100352,
    "hidden_size": 4096, "intermediate_size": 11008,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 32, "rope_theta": 500000.0,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 4096,
    "tie_word_embeddings": False}}


@register_auto_model("Olmo2ForCausalLM")
class Olmo2ForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "olmo2"

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.post_block_norms = True
        cfg.qk_norm = True
        cfg.qk_norm_flat = True
        super().__init__(cfg, device)
