"""MiniMax-M2 (HF `MiniMaxM2ForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/minimax_m2.py`: full attention with one q/k
RMSNorm over the flattened heads x head_dim (`qk_norm_flat`), RoPE on the
leading `rotary_dim` channels of each head, and a MoE under
`block_sparse_moe` routed sigmoid -> + `e_score_correction_bias` (the
selection only) -> top-k -> renormalize, with no group limit.  The JAX
package reads neither `rotary_dim` nor the bias (its MiniMax-M2 rotates
whole heads and routes by the raw sigmoid scores): the port agrees with it
where the config's `rotary_dim` is the head and the bias is zero.

The preset is the published `config.json` (model-structure keys only) of
huggingface.co/MiniMaxAI/MiniMax-M2, kept as the port's own copy."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)

# MiniMax-M2's published widths: 48/8 heads of 128, RoPE on 64 of them,
# 256 experts of 1,536, top 8 (no `moe_intermediate_size`: the experts take
# `intermediate_size`)
MINIMAX_M2 = {"hf_config": {
    "architectures": ["MiniMaxM2ForCausalLM"], "vocab_size": 200064,
    "hidden_size": 3072, "intermediate_size": 1536,
    "num_hidden_layers": 62, "num_attention_heads": 48,
    "num_key_value_heads": 8, "head_dim": 128, "rotary_dim": 64,
    "num_local_experts": 256, "num_experts_per_tok": 8,
    "scoring_func": "sigmoid", "use_routing_bias": True,
    "rope_theta": 5000000.0, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 196608, "tie_word_embeddings": False}}


@register_auto_model("MiniMaxM2ForCausalLM")
class MiniMaxM2ForCausalLM(DecoderModelForCausalLM):
    HF_MODEL_TYPE = "minimax_m2"
    MOE_ROUTER_KEY = "block_sparse_moe.gate.weight"
    MOE_EXPERT_KEY = "block_sparse_moe.experts.{j}.{proj}.weight"
    MOE_PROJ_NAMES = {"gate": "w1", "up": "w3", "down": "w2"}
    MOE_BIAS_KEY = "block_sparse_moe.e_score_correction_bias"
    HF_SCORING_FUNCS = ("sigmoid",)
    HF_EXTRA_KEYS = ("rotary_dim",)

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.qk_norm = True
        cfg.qk_norm_flat = True
        cfg.moe_score_func = "sigmoid"
        cfg.moe_has_score_bias = True
        cfg.norm_topk_prob = True
        cfg.n_group = 1
        cfg.topk_group = 1
        cfg.routed_scaling_factor = 1.0
        rd = cfg.extra.get("rotary_dim")
        if rd and rd != cfg.head_dim and cfg.partial_rotary_factor is None:
            cfg.partial_rotary_factor = rd / cfg.head_dim
        super().__init__(cfg, device)
