"""DeepSeek V3 family (MLA + noaux_tc MoE) causal LM: DeepSeek-V3,
DeepSeek-V3.2 (with the DSA indexer) and Moonlight-16B-A3B.

Counterpart of `tensorrt_llm_tpu/models/deepseek.py`: Multi-head Latent
Attention over a paged latent cache (`layers/mla.py`), the leading
`first_k_dense_replace` dense layers, sigmoid noaux_tc routing with a
score-correction bias and group-limited top-k, shared experts, and YaRN
RoPE on interleaved pairs.  All of it is configuration of the shared
decoder (`ModelConfig.from_hf_config` sets the DeepSeek fields).  As in the
JAX package, V3.2 is `DeepseekV3ForCausalLM` plus a `sparse_attention`
indexer (the JAX registry has no `DeepseekV32ForCausalLM`).  `_load_attn`
reads the MLA weights of an HF checkpoint (q with or without the low-rank
bottleneck, V3.2's `indexer.*`); the MoE keys are the shared decoder's
defaults.  The checkpoint's MTP block (layer `num_hidden_layers`,
`num_nextn_predict_layers` 1) is not part of the model: `load_hf_weights`
hands it to the MTP drafter (`speculative/mtp.py`) when speculation runs
in MTP mode.

The presets are the published `config.json` fields (model-structure keys
only) of huggingface.co/moonshotai/Moonlight-16B-A3B,
huggingface.co/deepseek-ai/DeepSeek-V3 and
huggingface.co/deepseek-ai/DeepSeek-V3.2, kept as the port's own copies:
widths unchanged, W4A16 at group 128, weights random; a preset function's
`num_layers` cuts depth (V3 and V3.2 at their full 61 layers do not fit one
80 GB card in int4).
"""

from __future__ import annotations

from tensorrt_llm_tpu_torch.models.modeling_utils import (
    DecoderModelForCausalLM, ModelConfig, register_auto_model)
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig

MOONLIGHT_16B_A3B = dict(quant_group_size=128, hf_config=dict(
    architectures=["DeepseekV3ForCausalLM"], model_type="deepseek_v3",
    vocab_size=163840, hidden_size=2048, intermediate_size=11264,
    moe_intermediate_size=1408, num_hidden_layers=27,
    num_attention_heads=16, num_key_value_heads=16,
    n_shared_experts=2, n_routed_experts=64, num_experts_per_tok=6,
    routed_scaling_factor=2.446, scoring_func="sigmoid",
    topk_method="noaux_tc", n_group=1, topk_group=1, norm_topk_prob=True,
    first_k_dense_replace=1, moe_layer_freq=1,
    q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, hidden_act="silu",
    max_position_embeddings=8192, rope_theta=50000.0, rope_scaling=None,
    rms_norm_eps=1e-5, attention_bias=False, tie_word_embeddings=False))

_V3_YARN = {"type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1,
            "mscale": 1.0, "mscale_all_dim": 1.0,
            "original_max_position_embeddings": 4096}

DEEPSEEK_V3 = dict(quant_group_size=128, hf_config=dict(
    architectures=["DeepseekV3ForCausalLM"], model_type="deepseek_v3",
    vocab_size=129280, hidden_size=7168, intermediate_size=18432,
    moe_intermediate_size=2048, num_hidden_layers=61,
    num_attention_heads=128, num_key_value_heads=128,
    n_shared_experts=1, n_routed_experts=256, num_experts_per_tok=8,
    routed_scaling_factor=2.5, scoring_func="sigmoid",
    topk_method="noaux_tc", n_group=8, topk_group=4, norm_topk_prob=True,
    first_k_dense_replace=3, moe_layer_freq=1,
    q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, hidden_act="silu",
    max_position_embeddings=163840, rope_theta=10000, rope_scaling=_V3_YARN,
    rms_norm_eps=1e-6, attention_bias=False, tie_word_embeddings=False,
    num_nextn_predict_layers=1))

# V3.2: V3's widths plus the DSA lightning indexer
DEEPSEEK_V32 = dict(quant_group_size=128, hf_config=dict(
    DEEPSEEK_V3["hf_config"], index_n_heads=64, index_head_dim=128,
    index_topk=2048))


def _preset_config(preset: dict, num_layers: int, **over) -> ModelConfig:
    hf = dict(preset["hf_config"], num_hidden_layers=num_layers)
    cfg = ModelConfig.from_hf_config(hf, quant=QuantConfig(
        quant_algo=QuantAlgo.W4A16, group_size=preset["quant_group_size"]))
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def moonlight_16b_a3b_config(num_layers: int = 27, **over) -> ModelConfig:
    """`moonlight-16b-a3b` as a W4A16 `ModelConfig` (dense MLA, 16 heads,
    Q without a low-rank bottleneck; layer 0 dense, 64 experts top-6)."""
    return _preset_config(MOONLIGHT_16B_A3B, num_layers, **over)


def deepseek_v3_config(num_layers: int = 61, **over) -> ModelConfig:
    """`deepseek-v3` as a W4A16 `ModelConfig` (dense MLA, 128 heads;
    layers 0-2 dense, 256 experts top-8 in 8 groups)."""
    return _preset_config(DEEPSEEK_V3, num_layers, **over)


def deepseek_v32_config(num_layers: int = 61, **over) -> ModelConfig:
    """`deepseek-v3.2` as a W4A16 `ModelConfig`: V3 plus the DSA indexer
    (64 heads of 128, top 2048)."""
    return _preset_config(DEEPSEEK_V32, num_layers, **over)


@register_auto_model("DeepseekV3ForCausalLM")
class DeepseekForCausalLM(DecoderModelForCausalLM):
    # the JAX package routes a DeepSeek config by sigmoid noaux_tc whatever
    # it says: the port refuses a config that says otherwise
    HF_SCORING_FUNCS = ("sigmoid",)
    HF_TOPK_METHODS = ("noaux_tc",)

    def _load_attn(self, layer, pre: str, t, vec) -> None:
        a = pre + "self_attn."
        kw = {}
        if layer.attn.q_lora_rank is not None:
            kw["q_a_w"] = t(a + "q_a_proj.weight")
            kw["q_norm"] = vec(a + "q_a_layernorm.weight")
            kw["q_b_w"] = t(a + "q_b_proj.weight")
        else:
            kw["q_w"] = t(a + "q_proj.weight")
        if layer.attn.indexer is not None:
            i = a + "indexer."
            kw["indexer"] = {"wq_b": t(i + "wq_b.weight"),
                             "wk": t(i + "wk.weight"),
                             "k_norm_w": vec(i + "k_norm.weight"),
                             "k_norm_b": vec(i + "k_norm.bias"),
                             "weights_proj": t(i + "weights_proj.weight")}
        layer.attn.from_float(t(a + "kv_a_proj_with_mqa.weight"),
                              t(a + "kv_b_proj.weight"),
                              t(a + "o_proj.weight"),
                              vec(a + "kv_a_layernorm.weight"), **kw)
