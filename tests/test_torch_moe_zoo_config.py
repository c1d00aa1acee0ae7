"""Port parity for the MoE model zoo: configs and layer kinds.

* For each of the 9 MoE families, `from_hf_config` and the family's model
  class give the JAX package's fields and layer kinds (`is_moe_layer`,
  `is_sliding_layer`, `is_nope_layer` on every layer), from the tiny
  config of `torch_moe_zoo` (a `transformers` object where `transformers`
  has the family, and the dict a `config.json` holds) and from every
  published preset at its full depth, also under a `decoder_sparse_step`
  of 2 and an `mlp_only_layers` list (GLM-4.5's and dots.llm1's
  `first_k_dense_replace` wins over the list, on both sides).
* Where the port departs from the JAX package on purpose (the JAX
  package's faults, recorded in `ROADMAP.md`): Qwen2-MoE's shared expert
  and its gate, MiniMax-M2's `rotary_dim` and both MiniMax-M2's and
  EXAONE-MoE's score-correction bias.  Each is asserted as it stands.
* Every preset's expert products are within K5's reach (`gmm_plan`
  refuses nothing at group 128: N % 64, K % 32).
* A `scoring_func` or `topk_method` the family's class does not route by
  raises.
"""

import pytest

from tensorrt_llm_tpu.models import get_model_class as jax_model_class
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu_torch import models
from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
from tensorrt_llm_tpu_torch.ops.moe_w4a16 import gmm_plan

from torch_moe_zoo import ARCHS, HF_ARCHS, config_dict, hf_config

_FIELDS = ("architecture", "vocab_size", "hidden_size", "intermediate_size",
           "num_layers", "num_heads", "num_kv_heads", "head_dim", "rms_eps",
           "rope_theta", "max_position", "tie_word_embeddings",
           "attention_bias", "qk_norm", "qk_norm_flat", "qk_norm_post_rope",
           "qk_norm_l2", "attn_temperature_tuning", "floor_scale",
           "attn_scale", "post_block_norms", "sliding_window",
           "gqa_rope_interleave", "no_rope_layer_interval",
           "attention_chunk_size", "layer_types", "num_experts",
           "num_experts_per_tok", "moe_intermediate_size", "norm_topk_prob",
           "decoder_sparse_step", "mlp_only_layers", "moe_score_func",
           "n_group", "topk_group", "routed_scaling_factor",
           "moe_topk_then_softmax", "moe_topk_then_sigmoid",
           "moe_apply_router_weight_on_input", "kv_lora_rank",
           "q_lora_rank")
_ROPE = ("head_dim", "theta", "interleaved", "scaling_type",
         "scaling_factor")
# the fields where the port departs on purpose
_DEPARTS = {"MiniMaxM2ForCausalLM": ("moe_has_score_bias",),
            "ExaoneMoEForCausalLM": ("moe_has_score_bias",)}


def _kinds(cfg, n):
    return {fn: [getattr(cfg, fn)(i) for i in range(n)]
            for fn in ("is_moe_layer", "is_sliding_layer", "is_nope_layer")}


def _pair(hf, arch):
    jcfg = JCfg.from_hf_config(hf)
    jcfg.architecture = arch
    jax_model_class(arch)(jcfg)
    tcfg = ModelConfig.from_hf_config(hf)
    get_model_class(arch)(tcfg, "cpu")
    return jcfg, tcfg


def _assert_same(hf, arch, layers, departs=()):
    jcfg, tcfg = _pair(hf, arch)
    for f in _FIELDS:
        assert getattr(tcfg, f) == getattr(jcfg, f), (arch, f)
    for f in ("moe_has_score_bias", "n_shared_experts"):
        if f not in departs:
            assert getattr(tcfg, f) == getattr(jcfg, f), (arch, f)
    for f in _ROPE:
        assert getattr(tcfg.rope, f) == getattr(jcfg.rope, f), (arch, f)
    assert _kinds(tcfg, layers) == _kinds(jcfg, layers), arch
    return jcfg, tcfg


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_layer_kinds_match_jax(arch):
    hf = config_dict(arch)
    L = hf["num_hidden_layers"]
    jcfg, tcfg = _assert_same(hf, arch, L, _DEPARTS.get(arch, ()))
    assert tcfg.num_experts == 8 and any(tcfg.is_moe_layer(i)
                                         for i in range(L))
    if arch in HF_ARCHS:
        # the `transformers` object gives the same config as its dict
        obj = hf_config(arch)
        _, tobj = _assert_same(obj, arch, L, _DEPARTS.get(arch, ()))
        assert _kinds(tobj, L) == _kinds(tcfg, L)
    if arch in _DEPARTS:
        assert tcfg.moe_has_score_bias and not jcfg.moe_has_score_bias


def test_the_tiny_configs_cover_every_layer_kind():
    kinds = {a: _kinds(_pair(config_dict(a), a)[1],
                       config_dict(a)["num_hidden_layers"]) for a in ARCHS}
    # a dense layer beside MoE ones: Qwen3-MoE's sparse step, GLM-4.5's and
    # dots.llm1's first layer, Llama4's interleave
    assert kinds["Qwen3MoeForCausalLM"]["is_moe_layer"] == [False, True]
    assert kinds["Glm4MoeForCausalLM"]["is_moe_layer"] == [False, True]
    assert kinds["Dots1ForCausalLM"]["is_moe_layer"] == [False, True]
    ll = kinds["Llama4ForCausalLM"]
    assert ll["is_moe_layer"] == [False, True, False, True]
    assert ll["is_nope_layer"] == [False, True, False, True]
    assert ll["is_sliding_layer"] == [True, False, True, False]
    ex = kinds["ExaoneMoEForCausalLM"]
    assert ex["is_sliding_layer"] == [True, False]
    assert ex["is_nope_layer"] == [False, True]


PRESETS = ("QWEN3_30B_A3B", "QWEN1_5_MOE_A2_7B", "GLM_4_5_AIR", "DOTS_LLM1",
           "HUNYUAN_A13B", "MINIMAX_M2", "EXAONE_MOE_ZOO", "LLAMA4_SCOUT")
_VARIANTS = ({}, {"decoder_sparse_step": 2}, {"mlp_only_layers": [0, 5]})


@pytest.mark.parametrize("variant", range(len(_VARIANTS)))
@pytest.mark.parametrize("name", PRESETS)
def test_published_presets_match_jax(name, variant):
    """Every preset at its published depth (the RoPE table cut to 4,096
    positions): the same fields and layer kinds on both sides, a decode
    group within the kernels' 1-16 at head dim 128."""
    hf = dict(getattr(models, name)["hf_config"], **_VARIANTS[variant],
              max_position_embeddings=4096)
    arch = hf["architectures"][0]
    departs = _DEPARTS.get(arch, ())
    if arch == "Qwen2MoeForCausalLM":
        departs = ("n_shared_experts",)
    jcfg, tcfg = _assert_same(hf, arch, hf["num_hidden_layers"], departs)
    group = tcfg.num_heads // tcfg.num_kv_heads
    assert 1 <= group <= 16 and tcfg.head_dim == 128, name
    if variant == 0:
        n_moe = sum(tcfg.is_moe_layer(i) for i in range(tcfg.num_layers))
        dense = 1 if arch in ("Glm4MoeForCausalLM", "Dots1ForCausalLM") \
            else 0
        assert n_moe == tcfg.num_layers - dense, name


@pytest.mark.parametrize("name", PRESETS)
def test_presets_are_within_k5(name):
    """K5 takes both expert products of every preset at group 128: gate_up
    (K = hidden, N = 2 x the expert width) and down (K = the width, N =
    hidden), at a decode batch and a 256-token chunk."""
    cfg = ModelConfig.from_hf_config(dict(
        getattr(models, name)["hf_config"], num_hidden_layers=1,
        max_position_embeddings=4096))
    get_model_class(cfg.architecture)(cfg, "cpu")
    H, I, E = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    for M in (4 * cfg.num_experts_per_tok, 256 * cfg.num_experts_per_tok):
        for K, N in ((H, 2 * I), (I, H)):
            plan = gmm_plan(M, E, K, N, 128)
            assert plan["n_ct"] * plan["cols"] >= N, (name, K, N, plan)


def test_reference_departures_as_they_stand():
    """Qwen2-MoE's shared expert (the JAX package reads
    `n_shared_experts`, a key Qwen2-MoE configs lack, and has no gate) and
    MiniMax-M2's `rotary_dim` (the JAX package rotates whole heads)."""
    q = dict(models.QWEN1_5_MOE_A2_7B["hf_config"], num_hidden_layers=2)
    jcfg, tcfg = _pair(q, "Qwen2MoeForCausalLM")
    assert jcfg.n_shared_experts == 0
    assert (tcfg.n_shared_experts,
            tcfg.shared_expert_intermediate_size) == (1, 5632)
    m = get_model_class("Qwen2MoeForCausalLM")(
        ModelConfig.from_hf_config(q), "cpu")
    mlp = m.layers[0].mlp
    assert mlp.shared.intermediate_size == 5632 and mlp.has_shared_gate
    mm = dict(models.MINIMAX_M2["hf_config"], num_hidden_layers=2)
    jcfg, tcfg = _pair(mm, "MiniMaxM2ForCausalLM")
    assert tcfg.rope.rotary_dim == 64 and jcfg.rope.rotary_dim is None


@pytest.mark.parametrize("arch,key,value", [
    ("Qwen3MoeForCausalLM", "scoring_func", "sigmoid"),
    ("Llama4ForCausalLM", "topk_method", "noaux_tc"),
    ("DeepseekV3ForCausalLM", "scoring_func", "softmax"),
    ("MistralLarge3ForCausalLM", "scoring_func", "sigmoid"),
    ("MiniMaxM2ForCausalLM", "scoring_func", "softmax")])
def test_routing_a_family_does_not_take_raises(arch, key, value):
    hf = dict(config_dict("Qwen3MoeForCausalLM"), architectures=[arch],
              **{key: value})
    with pytest.raises(NotImplementedError):
        ModelConfig.from_hf_config(hf)
    # what the family routes by passes
    hf.pop(key)
    ModelConfig.from_hf_config(hf)


# every key a family class reads from `extra`, by family
_FAMILY_KEYS = {
    "Qwen2MoeForCausalLM": {"norm_topk_prob": False},
    "Glm4MoeForCausalLM": {"use_qk_norm": True},
    "HunYuanMoEV1ForCausalLM": {"moe_topk": [2, 2]},
    "MiniMaxM2ForCausalLM": {"rotary_dim": 16},
    "ExaoneMoEForCausalLM": {"num_shared_experts": 1},
    "Llama4ForCausalLM": {"use_qk_norm": True,
                          "attn_temperature_tuning": True,
                          "floor_scale": 4.0, "attn_scale": 0.1,
                          "no_rope_layer_interval": 2,
                          "interleave_moe_layer_step": 1,
                          "intermediate_size_mlp": 256}}


@pytest.mark.parametrize("arch", sorted(_FAMILY_KEYS) + [
    "Qwen3MoeForCausalLM"])
def test_extra_keeps_only_the_family_keys(arch):
    """`cfg.extra` holds the keys the family's class declares
    (`HF_EXTRA_KEYS`) and none of the other families' keys; Qwen2-MoE's
    shared-expert gate is the family's choice, not the HF key's presence."""
    every = {k: v for keys in _FAMILY_KEYS.values() for k, v in keys.items()}
    hf = dict(config_dict("Qwen3MoeForCausalLM"), architectures=[arch],
              shared_expert_intermediate_size=128, **every)
    cfg = ModelConfig.from_hf_config(hf)
    assert cfg.extra == {k: every[k] for k in _FAMILY_KEYS.get(arch, {})}
    get_model_class(arch)(cfg, "cpu")
    assert bool(cfg.moe_shared_gate) == (arch == "Qwen2MoeForCausalLM")


def test_hunyuan_per_layer_topk():
    """HunYuan's `moe_topk` list: one value on every layer is taken; a
    list whose layers differ raises rather than serving the first."""
    hf = dict(config_dict("HunYuanMoEV1ForCausalLM"), num_hidden_layers=2)
    cls = get_model_class("HunYuanMoEV1ForCausalLM")
    cfg = ModelConfig.from_hf_config(dict(hf, moe_topk=[3, 3]))
    cls(cfg, "cpu")
    assert cfg.num_experts_per_tok == 3
    with pytest.raises(NotImplementedError):
        cls(ModelConfig.from_hf_config(dict(hf, moe_topk=[2, 3])), "cpu")
