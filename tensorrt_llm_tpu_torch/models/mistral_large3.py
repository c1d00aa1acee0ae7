"""Mistral Large 3 (`MistralLarge3ForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/mistral_large3.py`: the DeepSeek V3 architecture
(`models/deepseek.py`: MLA, shared experts, leading dense layers) routed
softmax -> top-k -> renormalize in one group with no scaling, loaded from
the Mistral-native tensor names where the HF DeepSeek name is absent
(``tok_embeddings``, ``layers.``, ``attention``, ``attention_norm``,
``ffn_norm``, ``feed_forward``, ``norm``, ``output``)."""

from __future__ import annotations

import torch

from tensorrt_llm_tpu_torch.models.deepseek import DeepseekForCausalLM
from tensorrt_llm_tpu_torch.models.modeling_utils import (
    ModelConfig, register_auto_model)

# (HF DeepSeek name part, Mistral-native one), replaced in this order
_RENAMES = (("model.embed_tokens", "tok_embeddings"),
            ("model.layers", "layers"), ("model.norm", "norm"),
            ("lm_head", "output"), ("self_attn", "attention"),
            ("input_layernorm", "attention_norm"),
            ("post_attention_layernorm", "ffn_norm"),
            ("mlp", "feed_forward"))


def mistral_name(name: str) -> str:
    """The Mistral-native name of an HF DeepSeek tensor name."""
    for ours, theirs in _RENAMES:
        name = name.replace(ours, theirs)
    return name


@register_auto_model("MistralLarge3ForCausalLM")
class MistralLarge3ForCausalLM(DeepseekForCausalLM):
    HF_SCORING_FUNCS = ("softmax",)
    HF_TOPK_METHODS = ()

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.moe_score_func = "softmax"
        cfg.norm_topk_prob = True
        cfg.n_group = 1
        cfg.topk_group = 1
        cfg.routed_scaling_factor = 1.0
        super().__init__(cfg, device)

    @torch.no_grad()
    def load_hf_weights(self, get_tensor, mtp_sink=None):
        def get(name):
            a = get_tensor(name)
            return a if a is not None else get_tensor(mistral_name(name))
        return super().load_hf_weights(get, mtp_sink)
