"""GLM-4 family (HF `GlmForCausalLM`, `Glm4ForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/glm.py`: RoPE over adjacent pairs of the leading
half of each head (HF Glm rotates pairs (2i, 2i+1); the port's interleaved
mode gives the same values in de-interleaved order, one permutation of q
and k that leaves the scores as they are), a biased QKV, and the fused
`gate_up_proj` checkpoint tensor split at load; Glm4 adds sandwich norms
under its own HF names."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.layers.moe import MoE
from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

_GLM_4_9B = {
    "vocab_size": 151552, "hidden_size": 4096, "intermediate_size": 13696,
    "num_hidden_layers": 40, "num_attention_heads": 32,
    "num_key_value_heads": 2, "head_dim": 128, "rope_theta": 10000.0,
    "partial_rotary_factor": 0.5, "attention_bias": True,
    "tie_word_embeddings": False}
# glm-4-9b-chat-hf's published widths (HF THUDM/glm-4-9b-chat-hf
# config.json)
GLM_4_9B_CHAT = {"hf_config": dict(
    _GLM_4_9B, architectures=["GlmForCausalLM"], rms_norm_eps=1.5625e-07,
    max_position_embeddings=131072)}
# GLM-4-9B-0414's published widths (HF THUDM/GLM-4-9B-0414 config.json)
GLM4_9B_0414 = {"hf_config": dict(
    _GLM_4_9B, architectures=["Glm4ForCausalLM"], rms_norm_eps=1e-5,
    max_position_embeddings=32768)}


@register_auto_model("GlmForCausalLM")
class GlmForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "glm"

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.attention_bias = True
        cfg.o_bias = False
        cfg.gqa_rope_interleave = True
        if cfg.partial_rotary_factor is None:
            cfg.partial_rotary_factor = 0.5
        super().__init__(cfg, device)

    def _load_mlp(self, layer, get_tensor, pre, t, vec):
        if isinstance(layer.mlp, MoE):
            return super()._load_mlp(layer, get_tensor, pre, t, vec)
        gu = t(pre + "mlp.gate_up_proj.weight")       # [H, 2I]
        I = self.cfg.intermediate_size
        layer.mlp.from_float(gu[:, :I], gu[:, I:],
                             t(pre + "mlp.down_proj.weight"))


@register_auto_model("Glm4ForCausalLM")
class Glm4ForCausalLM(GlmForCausalLM):
    """GLM + sandwich norms (post_self_attn / post_mlp layernorms): Gemma-2's
    `post_norms` under GLM-4's HF names."""

    HF_MODEL_TYPE = "glm4"

    NORM_KEYS = {"input_norm": "input_layernorm",
                 "post_attn_norm": "post_self_attn_layernorm",
                 "pre_ffw_norm": "post_attention_layernorm",
                 "post_ffw_norm": "post_mlp_layernorm"}

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.post_norms = True
        super().__init__(cfg, device)
