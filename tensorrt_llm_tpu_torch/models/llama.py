"""Llama-family architectures.  Counterpart of
`tensorrt_llm_tpu/models/llama.py`: config specialisations of the shared
decoder in `modeling_utils.py` -- Llama and Mistral as they are, Qwen2
(QKV bias) and Qwen3 (per-head q/k RMSNorm, no bias)."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

# Qwen2.5-7B's published widths (HF Qwen/Qwen2.5-7B-Instruct config.json):
# `sliding_window` stays in the file under `use_sliding_window` false, so
# `from_hf_config` marks every layer sliding at 131,072 tokens, as the JAX
# package does; no pool is a ring while that is past `max_seq_len`
QWEN2_5_7B = {"hf_config": {
    "architectures": ["Qwen2ForCausalLM"], "vocab_size": 152064,
    "hidden_size": 3584, "intermediate_size": 18944,
    "num_hidden_layers": 28, "num_attention_heads": 28,
    "num_key_value_heads": 4, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 32768,
    "sliding_window": 131072, "use_sliding_window": False,
    "max_window_layers": 28, "hidden_act": "silu",
    "tie_word_embeddings": False}}

# Qwen3-8B's published widths (HF Qwen/Qwen3-8B config.json)
QWEN3_8B = {"hf_config": {
    "architectures": ["Qwen3ForCausalLM"], "vocab_size": 151936,
    "hidden_size": 4096, "intermediate_size": 12288,
    "num_hidden_layers": 36, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 40960,
    "attention_bias": False, "tie_word_embeddings": False}}


@register_auto_model("LlamaForCausalLM", "MistralForCausalLM")
class LlamaForCausalLM(DecoderModelForCausalLM):
    pass


@register_auto_model("Qwen2ForCausalLM")
class Qwen2ForCausalLM(DecoderModelForCausalLM):
    """Qwen2 / Qwen2.5: QKV bias."""

    HF_MODEL_TYPE = "qwen2"

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.attention_bias = True
        super().__init__(cfg, device)


@register_auto_model("Qwen3ForCausalLM")
class Qwen3ForCausalLM(DecoderModelForCausalLM):
    """Qwen3 dense: per-head q/k RMSNorm before RoPE, no QKV bias."""

    HF_MODEL_TYPE = "qwen3"

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.attention_bias = False
        cfg.qk_norm = True
        super().__init__(cfg, device)
