"""SmolLM3 (HF `SmolLM3ForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/smollm3.py`: the Llama decoder whose
`no_rope_layers` list (1 = RoPE) marks NoPE layers, every 4th in the
published model."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, register_auto_model)

# SmolLM3-3B's published widths (HF HuggingFaceTB/SmolLM3-3B config.json)
SMOLLM3_3B = {"hf_config": {
    "architectures": ["SmolLM3ForCausalLM"], "vocab_size": 128256,
    "hidden_size": 2048, "intermediate_size": 11008,
    "num_hidden_layers": 36, "num_attention_heads": 16,
    "num_key_value_heads": 4, "rope_theta": 5000000.0,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 65536,
    "no_rope_layers": [int((i + 1) % 4 != 0) for i in range(36)],
    "no_rope_layer_interval": 4, "tie_word_embeddings": True}}


@register_auto_model("SmolLM3ForCausalLM")
class SmolLM3ForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "smollm3"
    HF_TIE_DEFAULT = True
