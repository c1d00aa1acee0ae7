"""GPT-OSS (OpenAI open-weight MoE) causal LM.

Counterpart of `tensorrt_llm_tpu/models/gpt_oss.py`: alternating sliding
and full attention layers (`layer_types`), per-head attention sinks, biased
QKV and o projections, YaRN RoPE, and an all-MoE FFN stack with a biased
router (top-k on raw logits, softmax over the k), per-expert gate_up/down
biases and the clamped swiglu (alpha 1.702, limit 7).  All of it is
configuration of the shared decoder (`ModelConfig.from_hf_config` sets the
GPT-OSS fields).  Its HF checkpoint stores the experts stacked, with gate
and up interleaved channel by channel in `gate_up_proj` [E, H, 2I] (not
[out, in], and not transposed); `_load_mlp` splits them into the fused
[gate | up] layout.  MXFP4 expert weights are not read (bf16/f32 only, as
in the JAX package).

`GPT_OSS_20B` is the JAX package's `gpt-oss-20b` shape preset (its
`commands/bench.py`), kept here as the port's own copy: published widths,
W4A16 at group 64 (hidden 2880 is not a multiple of 128), weights random.
"""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, hf_tensor, register_auto_model)
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig

GPT_OSS_20B = dict(quant_group_size=64, hf_config=dict(
    architectures=["GptOssForCausalLM"], model_type="gpt_oss",
    vocab_size=201088, hidden_size=2880, intermediate_size=2880,
    num_hidden_layers=24, num_attention_heads=64,
    num_key_value_heads=8, head_dim=64,
    num_local_experts=32, num_experts_per_tok=4,
    sliding_window=128,
    layer_types=["sliding_attention", "full_attention"] * 12,
    rope_theta=150000.0, attention_bias=True, attention_dropout=0.0,
    tie_word_embeddings=False, max_position_embeddings=131072,
    rms_norm_eps=1e-5,
    rope_scaling={"rope_type": "yarn", "factor": 32.0,
                  "beta_fast": 32.0, "beta_slow": 1.0,
                  "truncate": False,
                  "original_max_position_embeddings": 4096}))


def gpt_oss_20b_config(num_layers: int = 24, **over) -> ModelConfig:
    """The `gpt-oss-20b` preset as a W4A16 `ModelConfig`; `num_layers` cuts
    depth (keep it even: layers alternate sliding and full)."""
    hf = dict(GPT_OSS_20B["hf_config"], num_hidden_layers=num_layers)
    hf["layer_types"] = hf["layer_types"][:num_layers]
    cfg = ModelConfig.from_hf_config(hf, quant=QuantConfig(
        quant_algo=QuantAlgo.W4A16,
        group_size=GPT_OSS_20B["quant_group_size"]))
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


@register_auto_model("GptOssForCausalLM")
class GptOssForCausalLM(DecoderModelForCausalLM):
    def _load_mlp(self, layer, get_tensor, pre: str, t, vec) -> None:
        def arr(name):
            return hf_tensor(get_tensor, pre + name, self.device)

        gate_up = arr("mlp.experts.gate_up_proj")     # [E, H, 2I] interleaved
        gub = arr("mlp.experts.gate_up_proj_bias")    # [E, 2I] interleaved
        layer.mlp.load_experts([(gate_up[..., ::2], gate_up[..., 1::2],
                                 arr("mlp.experts.down_proj"))])  # [E, I, H]
        del gate_up
        layer.mlp.from_float(
            arr("mlp.router.weight").t(), None, None, None,
            router_bias=arr("mlp.router.bias"), gate_b=gub[..., ::2],
            up_b=gub[..., 1::2], down_b=arr("mlp.experts.down_proj_bias"))
