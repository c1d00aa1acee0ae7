"""LG EXAONE-MoE (`ExaoneMoEForCausalLM`).  Counterpart of
`tensorrt_llm_tpu/models/exaone_moe.py`: EXAONE-4's attention and norms
(`models/exaone4.py`: norms on the block outputs, per-head q/k RMSNorm,
the global layers of a hybrid `layer_types` without RoPE) with a MoE
routed sigmoid -> + `e_score_correction_bias` -> top-k -> renormalize and
`num_shared_experts` shared experts of `moe_intermediate_size`.  The JAX
package keeps no score bias for it (it routes by the raw sigmoid scores):
the port agrees with it where the bias is zero.

No published config of this family is in the repository, so it has no
preset of its published widths.  `EXAONE_MOE_ZOO`, the shape the chip
check serves, is composed: EXAONE-4.0-32B's attention widths
(`EXAONE4_32B`) with Qwen3-30B-A3B's expert widths (`QWEN3_30B_A3B`: 128
experts of 768, top 8) and one shared expert."""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.exaone4 import (
    EXAONE4_32B, Exaone4ForCausalLM)
from tensorrt_llm_tpu_torch.models.mixtral import QWEN3_30B_A3B
from tensorrt_llm_tpu_torch.models.modeling_utils import (
    ModelConfig, register_auto_model)

_Q3 = QWEN3_30B_A3B["hf_config"]
EXAONE_MOE_ZOO = {"hf_config": dict(
    EXAONE4_32B["hf_config"], architectures=["ExaoneMoEForCausalLM"],
    num_experts=_Q3["num_experts"],
    num_experts_per_tok=_Q3["num_experts_per_tok"],
    moe_intermediate_size=_Q3["moe_intermediate_size"],
    num_shared_experts=1)}


@register_auto_model("ExaoneMoEForCausalLM")
class ExaoneMoEForCausalLM(Exaone4ForCausalLM):
    HF_MODEL_TYPE = "exaone_moe"
    HF_SCORING_FUNCS = ("sigmoid",)
    HF_TOPK_METHODS = ("noaux_tc",)
    HF_EXTRA_KEYS = ("num_shared_experts",)

    def __init__(self, cfg: ModelConfig, device="cuda"):
        cfg.moe_score_func = "sigmoid"
        cfg.moe_has_score_bias = True
        cfg.norm_topk_prob = True
        ns = cfg.extra.get("num_shared_experts")
        if ns:
            cfg.n_shared_experts = int(ns)
        super().__init__(cfg, device)
