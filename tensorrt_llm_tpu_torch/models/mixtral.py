"""Mixtral causal LM.  Counterpart of `MixtralForCausalLM` in
`tensorrt_llm_tpu/models/mixtral.py`: the shared decoder with every FFN a
MoE under softmax -> top-k -> renormalize routing, and the HF names of its
`block_sparse_moe` weights for `load_hf_weights`.  Qwen-MoE is a later
slice."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)


@register_auto_model("MixtralForCausalLM")
class MixtralForCausalLM(DecoderModelForCausalLM):
    MOE_ROUTER_KEY = "block_sparse_moe.gate.weight"
    MOE_EXPERT_KEY = "block_sparse_moe.experts.{j}.{proj}.weight"
    MOE_PROJ_NAMES = {"gate": "w1", "up": "w3", "down": "w2"}

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.norm_topk_prob = True          # Mixtral renormalizes the top-k
        cfg.moe_intermediate_size = cfg.intermediate_size
        super().__init__(cfg, device)
