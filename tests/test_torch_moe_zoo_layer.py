"""Port parity for the MoE model zoo: the MoE layer's routing kinds and
HunYuan's dynamic NTK RoPE.

* Each routing kind of the port's `MoE` against the JAX package's `MoE`
  on the same float weights and bf16 inputs, with bf16 and W4A16 (group
  64) experts: softmax -> top-k with and without renormalization
  (Mixtral / Qwen3-MoE, Qwen2-MoE), sigmoid + score-correction bias in one
  group (MiniMax-M2, EXAONE-MoE, GLM-4.5-Air) and in 4 groups (GLM-4.5,
  dots.llm1), Llama4's top-k on the raw logits with sigmoid weights on the
  expert's input, and shared experts (DeepSeek style, HunYuan's softmax
  with one shared MLP).  The routing is the same f32 math on both sides:
  the selected ids agree as sets and the weights to 1e-6.  The layer's
  output: the same rounding points, the sums in another order, so 1e-2 of
  the largest output (as `test_torch_deepseek.py`).
* A score-bias layer whose state has no bias (the JAX package keeps none
  for MiniMax-M2 and EXAONE-MoE) gets zeros through `load_state`, and
  routes bit for bit as the same layer with a zero bias.
* Qwen2-MoE's gated shared expert, of its own width, against the JAX
  package's `Qwen3NextMoE` (the same block, HF `Qwen2MoeSparseMoeBlock`):
  1e-2 of the largest output.
* HunYuan's dynamic NTK RoPE by alpha: the port's tables against
  `transformers`' `HunYuanDenseV1RotaryEmbedding` (the same f32 formula:
  1e-5 absolute) at the published alpha 1000; the JAX package's tables
  ignore the type and keep the plain base (recorded); dynamic NTK without
  an alpha raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.layers.moe import MoE as JMoE
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.models.qwen3_next import Qwen3NextMoE
from tensorrt_llm_tpu.ops import rope as jrope
from tensorrt_llm_tpu.quantization import QuantAlgo as JQA
from tensorrt_llm_tpu.quantization import QuantConfig as JQC
from tensorrt_llm_tpu_torch.layers.moe import MoE
from tensorrt_llm_tpu_torch.ops import rope as trope
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig

H, I, E, T = 128, 64, 8, 24
GROUP = 64
W_TOL = 1e-6
OUT_TOL = 1e-2
ROPE_TOL = 1e-5

# routing kind -> (MoE keyword arguments, top-k)
KINDS = {
    "softmax_renorm": (dict(), 2),
    "softmax_plain": (dict(renormalize=False), 4),
    "sigmoid_bias": (dict(score_func="sigmoid", has_score_bias=True), 4),
    "sigmoid_bias_groups": (dict(score_func="sigmoid", has_score_bias=True,
                                 n_group=4, topk_group=2,
                                 routed_scaling=2.5), 2),
    "topk_sigmoid_on_input": (dict(topk_then_sigmoid=True,
                                   apply_weight_on_input=True,
                                   renormalize=False), 1),
    "shared_experts": (dict(score_func="sigmoid", has_score_bias=True,
                            n_shared_experts=2), 2),
    "softmax_one_shared": (dict(n_shared_experts=1), 2),
}


def _jq(quant):
    return JQC(quant_algo=JQA.W4A16, group_size=GROUP) if quant else None


def _tq(quant):
    return (QuantConfig(quant_algo=QuantAlgo.W4A16, group_size=GROUP)
            if quant else None)


def _floats(rng, shared_width=0):
    def f(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    fl = dict(router_w=f(H, E, s=0.5), gate_w=f(E, H, I, s=H ** -0.5),
              up_w=f(E, H, I, s=H ** -0.5), down_w=f(E, I, H, s=I ** -0.5),
              score_bias=f(E, s=0.1))
    sh = None
    if shared_width:
        Is = shared_width
        sh = dict(gate_w=f(H, Is, s=H ** -0.5), up_w=f(H, Is, s=H ** -0.5),
                  down_w=f(Is, H, s=Is ** -0.5))
    x = np.array(jnp.asarray(f(T, H), jnp.bfloat16).astype(jnp.float32))
    return fl, sh, x


def _pair(kind, quant, seed=0):
    kw, k = KINDS[kind]
    jm = JMoE(hidden_size=H, intermediate_size=I, num_experts=E, top_k=k,
              quant=_jq(quant), **kw)
    tm = MoE(H, I, E, k, quant=_tq(quant), **kw)
    fl, sh, x = _floats(np.random.default_rng(seed),
                        kw.get("n_shared_experts", 0) * I)
    jsh = None
    if sh:
        tm.shared.from_float(**{a: torch.from_numpy(v)
                                for a, v in sh.items()})
        jsh = jm.shared.from_float(**{a: jnp.asarray(v)
                                      for a, v in sh.items()})
    jfl = dict(fl)
    if not kw.get("has_score_bias"):
        jfl.pop("score_bias")
    params = jm.from_float(**{a: jnp.asarray(v) for a, v in jfl.items()},
                           shared=jsh)
    tm.from_float(**{a: torch.from_numpy(v) for a, v in fl.items()})
    return jm, params, tm, x


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_routing_matches_jax(kind):
    jm, params, tm, x = _pair(kind, False)
    jids, jw = jm.route(params, jnp.asarray(x, jnp.bfloat16))
    tids, tw = tm.route(torch.from_numpy(x).to(torch.bfloat16))
    jids, jw = np.asarray(jids), np.asarray(jw)
    for t in range(T):
        assert set(jids[t].tolist()) == set(tids[t].tolist()), t
        jmap = dict(zip(jids[t].tolist(), jw[t].tolist()))
        for e, w in zip(tids[t].tolist(), tw[t].tolist()):
            assert abs(jmap[e] - w) <= W_TOL, (t, e)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "w4a16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_moe_matches_jax(kind, quant):
    jm, params, tm, x = _pair(kind, quant, seed=1)
    ref = np.asarray(jm(params, jnp.asarray(x, jnp.bfloat16)), np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= OUT_TOL * np.abs(ref).max(), \
        np.abs(out - ref).max()


def test_state_without_score_bias_installs_zeros():
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    from torch_moe_zoo import config_dict
    arch = "MiniMaxM2ForCausalLM"
    cls = get_model_class(arch)
    src = cls(ModelConfig.from_hf_config(config_dict(arch)), "cpu"
              ).init_random(0)
    state = {k: v for k, v in src.state().items()
             if not k.endswith(".score_bias")}
    dst = cls(ModelConfig.from_hf_config(config_dict(arch)), "cpu"
              ).load_state(state)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(T, dst.cfg.hidden_size)).astype(np.float32)).to(torch.bfloat16)
    moes = [layer.mlp for layer in dst.layers if layer.is_moe]
    assert moes
    for m, ms in zip(moes, (layer.mlp for layer in src.layers
                            if layer.is_moe)):
        assert m.has_score_bias and torch.equal(
            m.score_bias, torch.zeros(m.num_experts))
        ms.score_bias = torch.zeros(ms.num_experts)
        for a, b in zip(m.route(x), ms.route(x)):
            assert torch.equal(a, b)


def test_weight_on_input_is_not_output_scaling():
    """Llama4's weight scales the expert's input row: the output differs
    from the same routing with the weight on the output (the MLP is not
    linear), and a weight of 1 would give the same."""
    _, _, tm, x = _pair("topk_sigmoid_on_input", False)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        on_input = tm(xt).float()
        tm.apply_weight_on_input = False
        on_output = tm(xt).float()
    assert (on_input - on_output).abs().max() > 1e-2


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "w4a16"])
def test_gated_shared_expert_matches_jax_qwen3_next(quant):
    """Qwen2-MoE's block: out = experts(x) + sigmoid(x . w_g) * shared(x),
    the shared expert of its own width (here 3 x I)."""
    Is, k = 3 * I, 4
    jcfg = JCfg(hidden_size=H, intermediate_size=256, num_experts=E,
                num_experts_per_tok=k, moe_intermediate_size=I,
                norm_topk_prob=False, quant=_jq(quant),
                extra={"shared_expert_intermediate_size": Is})
    jb = Qwen3NextMoE(jcfg)
    tm = MoE(H, I, E, k, renormalize=False, quant=_tq(quant),
             n_shared_experts=1, shared_intermediate_size=Is,
             shared_gate=True)
    rng = np.random.default_rng(2)
    fl, sh, x = _floats(rng, Is)
    fl.pop("score_bias")
    # the JAX block keeps the gate in bf16: the same values on both sides
    gate = np.asarray(jnp.asarray(rng.normal(size=(H, 1)) * 0.1,
                                  jnp.bfloat16).astype(jnp.float32))
    params = {"moe": jb.moe.from_float(**{a: jnp.asarray(v)
                                          for a, v in fl.items()}),
              "shared": jb.shared.from_float(**{a: jnp.asarray(v)
                                                for a, v in sh.items()}),
              "shared_gate": jnp.asarray(gate, jnp.bfloat16)}
    tm.from_float(**{a: torch.from_numpy(v) for a, v in fl.items()},
                  shared_gate=torch.from_numpy(gate[:, 0]))
    tm.shared.from_float(**{a: torch.from_numpy(v) for a, v in sh.items()})
    ref = np.asarray(jb(params, jnp.asarray(x, jnp.bfloat16)), np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert np.abs(out - ref).max() <= OUT_TOL * np.abs(ref).max(), \
        np.abs(out - ref).max()


@pytest.mark.parametrize("head_dim", [128, 32])
def test_hunyuan_dynamic_rope_matches_transformers(head_dim):
    transformers = pytest.importorskip("transformers")
    from transformers.models.hunyuan_v1_dense import (
        modeling_hunyuan_v1_dense as hm)
    P = 4096
    scaling = {"type": "dynamic", "alpha": 1000.0, "factor": 1.0}
    hf = transformers.HunYuanDenseV1Config(
        hidden_size=4 * head_dim, num_attention_heads=4, head_dim=head_dim,
        rope_theta=10000.0, rope_scaling=scaling, max_position_embeddings=P)
    emb = hm.HunYuanDenseV1RotaryEmbedding(hf)
    pos = torch.arange(P)[None]
    cos, sin = emb(torch.zeros(1, dtype=torch.float32), pos)
    half = head_dim // 2
    cfg = trope.RopeConfig(head_dim=head_dim, theta=10000.0, max_position=P,
                           scaling_type="dynamic", alpha=1000.0)
    tc, ts = trope.make_rope_tables(cfg)
    assert torch.allclose(tc, cos[0, :, :half], atol=ROPE_TOL, rtol=0)
    assert torch.allclose(ts, sin[0, :, :half], atol=ROPE_TOL, rtol=0)
    # found in the reference: the JAX package's tables keep the plain base
    jc, _ = jrope.make_rope_tables(jrope.RopeConfig(
        head_dim=head_dim, theta=10000.0, max_position=P,
        scaling_type="dynamic"))
    plain, _ = trope.make_rope_tables(trope.RopeConfig(
        head_dim=head_dim, theta=10000.0, max_position=P))
    assert np.allclose(np.asarray(jc), plain.numpy(), atol=ROPE_TOL)
    assert (tc - plain).abs().max() > 0.1


def test_dynamic_rope_without_alpha_raises():
    with pytest.raises(NotImplementedError):
        trope.make_rope_tables(trope.RopeConfig(
            head_dim=64, max_position=64, scaling_type="dynamic",
            scaling_factor=2.0))
