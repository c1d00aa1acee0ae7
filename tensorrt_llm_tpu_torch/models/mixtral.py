"""Mixtral causal LM.  Counterpart of `MixtralForCausalLM` in
`tensorrt_llm_tpu/models/mixtral.py`: the shared decoder with every FFN a
W4A16 MoE under softmax -> top-k -> renormalize routing.  The HF weight
loader waits for `load_hf_weights`; Qwen-MoE is a later slice."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)


@register_auto_model("MixtralForCausalLM")
class MixtralForCausalLM(DecoderModelForCausalLM):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.norm_topk_prob = True          # Mixtral renormalizes the top-k
        cfg.moe_intermediate_size = cfg.intermediate_size
        super().__init__(cfg, device)
