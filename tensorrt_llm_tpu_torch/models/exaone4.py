"""LG EXAONE-4 (HF `Exaone4ForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/exaone4.py`: norms on the block outputs, per-head
q/k RMSNorm, and hybrid attention -- the sliding layers keep RoPE, the
global layers of a hybrid `layer_types` skip it (HF `Exaone4Attention`
applies RoPE only when `sliding_window` is None or the layer slides)."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

# EXAONE-4.0-32B's published widths (HF LGAI-EXAONE/EXAONE-4.0-32B
# config.json): three sliding layers of 4,096 tokens, then a global one
EXAONE4_32B = {"hf_config": {
    "architectures": ["Exaone4ForCausalLM"], "vocab_size": 102400,
    "hidden_size": 5120, "intermediate_size": 27392,
    "num_hidden_layers": 64, "num_attention_heads": 40,
    "num_key_value_heads": 8, "head_dim": 128, "rope_theta": 1000000.0,
    "rope_scaling": {"rope_type": "llama3", "factor": 16.0,
                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192},
    "rms_norm_eps": 1e-5, "max_position_embeddings": 131072,
    "sliding_window": 4096,
    "layer_types": ["full_attention" if (i + 1) % 4 == 0
                    else "sliding_attention" for i in range(64)],
    "tie_word_embeddings": False}}


@register_auto_model("Exaone4ForCausalLM")
class Exaone4ForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "exaone4"

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.post_block_norms = True
        cfg.qk_norm = True
        if cfg.layer_types is not None and cfg.sliding_window is not None \
                and "full_attention" in cfg.layer_types:
            cfg.no_rope_layers = tuple(
                0 if t == "full_attention" else 1 for t in cfg.layer_types)
        super().__init__(cfg, device)
