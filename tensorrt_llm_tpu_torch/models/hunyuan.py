"""Tencent HunYuan v1 (HF `HunYuanDenseV1ForCausalLM`,
`HunYuanMoEV1ForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/hunyuan.py`: the Llama decoder whose per-head q/k
RMSNorm (HF `query_layernorm` / `key_layernorm`) comes after RoPE; the MoE
class routes softmax -> top-k (`moe_topk`, an int or a per-layer list of
one value: a list whose layers differ raises) -> renormalize, with the
router at ``mlp.gate.wg`` and one always-on shared MLP at
``mlp.shared_mlp.``, experts and shared MLP both of
`intermediate_size` (HF `HunYuanMoEV1MLP`).  The published configs' dynamic
NTK `rope_scaling` (alpha 1000) scales the RoPE base (`ops.rope`); the JAX
package's tables ignore that type."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

_HUNYUAN_ROPE = {"type": "dynamic", "alpha": 1000.0, "factor": 1.0}

# Hunyuan-7B-Instruct's published widths (HF tencent/Hunyuan-7B-Instruct
# config.json)
HUNYUAN_7B = {"hf_config": {
    "architectures": ["HunYuanDenseV1ForCausalLM"], "vocab_size": 128167,
    "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "rope_theta": 10000.0,
    "rope_scaling": _HUNYUAN_ROPE, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 32768, "tie_word_embeddings": False}}

# Hunyuan-A13B-Instruct's published widths (HF tencent/Hunyuan-A13B-Instruct
# config.json): 64 experts of 3,072 and one shared MLP, top 8
HUNYUAN_A13B = {"hf_config": {
    "architectures": ["HunYuanMoEV1ForCausalLM"], "vocab_size": 128167,
    "hidden_size": 4096, "intermediate_size": 3072,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "num_experts": 64,
    "moe_topk": [8] * 32, "rope_theta": 10000.0,
    "rope_scaling": _HUNYUAN_ROPE, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 32768, "tie_word_embeddings": False}}


def _one_value(cfg_value, key: str):
    """A HunYuan key given as an int or as a per-layer list: the one
    value every layer takes (the port builds every MoE layer alike)."""
    if not isinstance(cfg_value, (list, tuple)):
        return cfg_value
    if len(set(cfg_value)) != 1:
        raise NotImplementedError(
            f"HunYuan: per-layer {key} {list(cfg_value)} differ across "
            "layers; not in this slice")
    return cfg_value[0]


@register_auto_model("HunYuanDenseV1ForCausalLM")
class HunYuanDenseV1ForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "hunyuan_v1_dense"
    Q_NORM_KEY = "self_attn.query_layernorm.weight"
    K_NORM_KEY = "self_attn.key_layernorm.weight"

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.qk_norm = True
        cfg.qk_norm_post_rope = True
        super().__init__(cfg, device)


@register_auto_model("HunYuanMoEV1ForCausalLM")
class HunYuanMoEV1ForCausalLM(HunYuanDenseV1ForCausalLM):
    HF_MODEL_TYPE = "hunyuan_v1_moe"
    HF_EXTRA_KEYS = ("moe_topk",)
    MOE_ROUTER_KEY = "mlp.gate.wg.weight"
    MOE_SHARED_PREFIX = "mlp.shared_mlp."

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.norm_topk_prob = True
        cfg.n_shared_experts = 1
        tk = cfg.extra.get("moe_topk")
        if tk:
            cfg.num_experts_per_tok = _one_value(tk, "moe_topk")
        cfg.moe_intermediate_size = cfg.intermediate_size
        super().__init__(cfg, device)
