"""Port parity for the dense model zoo: configs and the new layers.

* Configs: for each of the 14 architectures, `from_hf_config` and the
  family's model class give the JAX package's fields and layer kinds
  (`is_sliding_layer`, `is_nope_layer` on every layer), from a tiny
  `transformers` config and from the published presets the chip check
  serves.  Qwen2's `config.json` keeps `sliding_window` 131,072 under
  `use_sliding_window` false: read as a dict, every layer slides at that
  window (no ring below it); a `transformers.Qwen2Config` drops it.  Both
  sides agree on both.  Under `attention_chunk_size` the NoPE layers
  attend globally and the others are chunked.
* Layers, each against its JAX counterpart on the same weights and inputs:
  the non-gated `MLP` (tanh-GELU, relu2, xIELU; with and without biases;
  W4A16 and unquantized), partial and interleaved RoPE, and one- or
  two-layer models for the flat and post-RoPE q/k norms, a LayerNorm
  decoder layer, a post-block-norm layer and Granite's multipliers
  (norms, biases and alphas drawn at random, not ones and zeros).

Tolerances: RoPE runs the same f32 formulas on the same tables, so its
bf16 outputs agree to one bf16 ulp of the largest value (`ROPE_TOL`
2^-8 relative).  The MLP's two products sum in another order on each
side, so a bf16 rounding of up's output can differ by one ulp before the
activation and down: `MLP_TOL` is 2^-6 of the largest output (four bf16
ulps).  Layer models: logits are O(1) and bf16-rounded; `LOGIT_TOL` 0.03
absolute, as `tests/test_torch_model.py` states it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.attention_backend.interface import (
    AttentionMetadata as JMeta)
from tensorrt_llm_tpu.layers.mlp import MLP as JMLP
from tensorrt_llm_tpu.models import get_model_class as jax_model_class
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.ops import rope as jrope
from tensorrt_llm_tpu.quantization import QuantAlgo as JQA
from tensorrt_llm_tpu.quantization import QuantConfig as JQC
from tensorrt_llm_tpu_torch.layers.mlp import MLP
from tensorrt_llm_tpu_torch.models import (
    ModelConfig, get_model_class, params_from_jax)
from tensorrt_llm_tpu_torch.ops import rope as trope
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig
from tensorrt_llm_tpu_torch.runtime.model_engine import ring_plan

from torch_parity import port_logits
from torch_zoo import ARCHS, hf_config

ROPE_TOL = 2.0 ** -8
MLP_TOL = 2.0 ** -6
LOGIT_TOL = 0.03

# fields both configs carry, compared after the family's class has run
_FIELDS = ("architecture", "vocab_size", "hidden_size", "intermediate_size",
           "num_layers", "num_heads", "num_kv_heads", "head_dim", "rms_eps",
           "rope_theta", "max_position", "tie_word_embeddings",
           "attention_bias", "o_bias", "qk_norm", "qk_norm_flat",
           "qk_norm_post_rope", "activation", "sliding_window", "norm_type",
           "norm_bias", "mlp_gated", "mlp_bias", "post_block_norms",
           "post_norms", "residual_multiplier", "logits_scaling",
           "embedding_multiplier", "query_pre_attn_scalar",
           "gqa_rope_interleave", "no_rope_layer_interval",
           "attention_chunk_size", "layer_types")
_ROPE = ("head_dim", "theta", "rotary_dim", "interleaved", "scaling_type",
         "scaling_factor")


def _assert_same(hf, arch, layers):
    """JAX and port configs of `hf` after each family's class has run."""
    jcfg = JCfg.from_hf_config(hf)
    jcfg.architecture = arch
    jax_model_class(arch)(jcfg)
    tcfg = ModelConfig.from_hf_config(hf)
    get_model_class(arch)(tcfg, "cpu")
    for f in _FIELDS:
        assert getattr(tcfg, f) == getattr(jcfg, f), (arch, f)
    assert tcfg.partial_rotary_factor == jcfg.extra.get(
        "partial_rotary_factor"), arch
    for f in _ROPE:
        assert getattr(tcfg.rope, f) == getattr(jcfg.rope, f), (arch, f)
    for fn in ("is_sliding_layer", "is_nope_layer"):
        assert [getattr(tcfg, fn)(i) for i in range(layers)] == \
            [getattr(jcfg, fn)(i) for i in range(layers)], (arch, fn)
    return jcfg, tcfg


# layer-kind lists of 4 layers: SmolLM3's every-4th NoPE layer, EXAONE-4's
# three sliding layers and one global one
_FOUR = {"SmolLM3ForCausalLM": dict(no_rope_layers=[1, 1, 1, 0]),
         "Exaone4ForCausalLM": dict(sliding_window_pattern=4)}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_layer_kinds_match_jax(arch):
    hf = hf_config(arch, num_hidden_layers=4, **_FOUR.get(arch, {}))
    hf.architectures = [arch]
    jcfg, tcfg = _assert_same(hf, arch, 4)
    # and from the dict a config.json holds
    _assert_same(dict(hf.to_dict(), architectures=[arch]), arch, 4)
    if arch == "SmolLM3ForCausalLM":
        assert [tcfg.is_nope_layer(i) for i in range(4)] == [0, 0, 0, 1]
    if arch == "Exaone4ForCausalLM":
        assert [tcfg.is_sliding_layer(i) for i in range(4)] == [1, 1, 1, 0]
        assert [tcfg.is_nope_layer(i) for i in range(4)] == [0, 0, 0, 1]


PRESETS = ("QWEN2_5_7B", "QWEN3_8B", "SMOLLM3_3B", "OLMO2_7B",
           "GRANITE_3_1_8B", "STARCODER2_7B", "MINITRON_8B", "GLM_4_9B_CHAT",
           "GLM4_9B_0414", "PHI_4", "EXAONE4_32B", "SEED_OSS_36B",
           "APERTUS_8B", "HUNYUAN_7B")


def test_published_presets_match_jax():
    """Every preset the chip check serves, at its published widths (the
    rope table cut to 4,096 positions): the same fields and layer kinds on
    both sides, a group within the kernels' 1-16 and widths of whole
    128-column tiles."""
    from tensorrt_llm_tpu_torch import models
    for name in PRESETS:
        hf = dict(getattr(models, name)["hf_config"],
                  max_position_embeddings=4096)
        arch = hf["architectures"][0]
        _, tcfg = _assert_same(hf, arch, hf["num_hidden_layers"])
        group = tcfg.num_heads // tcfg.num_kv_heads
        assert 1 <= group <= 16 and tcfg.head_dim == 128, name
        for w in (tcfg.hidden_size, tcfg.intermediate_size):
            assert w % 128 == 0, (name, w)


def test_qwen2_sliding_window_as_read():
    """Qwen2.5's config.json: every layer slides at 131,072 on both sides,
    and no ring is made below that; the `transformers` object drops the
    window (and lists every layer as full attention)."""
    from tensorrt_llm_tpu_torch.models import QWEN2_5_7B
    transformers = pytest.importorskip("transformers")
    hf = dict(QWEN2_5_7B["hf_config"], num_hidden_layers=4)
    _, tcfg = _assert_same(hf, "Qwen2ForCausalLM", 4)
    assert tcfg.sliding_window == 131072
    assert all(tcfg.is_sliding_layer(i) for i in range(4))
    assert ring_plan(tcfg, 16, 32768) is None
    kw = {k: v for k, v in hf.items() if k != "architectures"}
    obj = transformers.Qwen2Config(**kw)
    obj.architectures = ["Qwen2ForCausalLM"]
    _, tcfg = _assert_same(obj, "Qwen2ForCausalLM", 4)
    assert tcfg.sliding_window is None
    assert not any(tcfg.is_sliding_layer(i) for i in range(4))


@pytest.mark.parametrize("interval", [0, 2])
def test_chunked_layers_skip_the_nope_layers(interval):
    """JAX `is_sliding_layer` under `attention_chunk_size`: the RoPE layers
    are chunked, the NoPE ones global (an HF list, or every
    `no_rope_layer_interval`-th layer); the chunked layers' attention gets
    the chunk, the NoPE ones none."""
    shape = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
                 num_layers=4, num_heads=2, num_kv_heads=1, head_dim=32,
                 max_position=128, attention_chunk_size=16)
    lst = None if interval else [1, 0, 1, 1]
    jcfg = JCfg(**shape, no_rope_layer_interval=interval,
                extra={"no_rope_layers": lst} if lst else {})
    tcfg = ModelConfig(**shape, no_rope_layer_interval=interval,
                       no_rope_layers=tuple(lst) if lst else None)
    want_nope = [False, True, False, True] if interval else \
        [False, True, False, False]
    assert [tcfg.is_nope_layer(i) for i in range(4)] == want_nope
    for fn in ("is_sliding_layer", "is_nope_layer"):
        assert [getattr(tcfg, fn)(i) for i in range(4)] == \
            [getattr(jcfg, fn)(i) for i in range(4)], fn
    model = get_model_class(tcfg.architecture)(tcfg, "cpu")
    for i, layer in enumerate(model.layers):
        assert layer.attn.nope == want_nope[i]
        assert layer.attn.backend.attention_chunk == (
            None if want_nope[i] else 16)


# ----------------------------------------------------------------- MLP ---
_MLP_CASES = [("gelu", True, True), ("gelu", False, False),
              ("relu2", False, True), ("relu2", True, False),
              ("xielu", False, True), ("xielu", True, False)]


@pytest.mark.parametrize("act,bias,w4", _MLP_CASES)
def test_non_gated_mlp_matches_jax(act, bias, w4):
    H, I, T = 128, 256, 9
    rng = np.random.RandomState(7)
    up = (rng.randn(H, I) / H ** 0.5).astype(np.float32)
    down = (rng.randn(I, H) / I ** 0.5).astype(np.float32)
    ub = (rng.randn(I) * 0.1).astype(np.float32) if bias else None
    db = (rng.randn(H) * 0.1).astype(np.float32) if bias else None
    alphas = {"alpha_p": np.float32([0.3]), "alpha_n": np.float32([-0.4])}
    x = rng.randn(T, H).astype(np.float32)
    jq = JQC(quant_algo=JQA.W4A16, group_size=64) if w4 else None
    tq = QuantConfig(quant_algo=QuantAlgo.W4A16, group_size=64) if w4 \
        else None
    jm = JMLP(H, I, act, has_bias=bias, quant=jq)
    jp = jm.from_float(
        jnp.asarray(up), jnp.asarray(down),
        up_b=None if ub is None else jnp.asarray(ub),
        down_b=None if db is None else jnp.asarray(db),
        act={k: jnp.asarray(v) for k, v in alphas.items()})
    ref = np.asarray(jm(jp, jnp.asarray(x, jnp.bfloat16)), np.float32)
    tm = MLP(H, I, act, bias, quant=tq)
    tm.from_float(torch.from_numpy(up), torch.from_numpy(down),
                  up_b=None if ub is None else torch.from_numpy(ub),
                  down_b=None if db is None else torch.from_numpy(db),
                  act={k: torch.from_numpy(v) for k, v in alphas.items()})
    if w4:     # the same int4 bits on both sides
        assert np.array_equal(tm.up.qweight.numpy(),
                              np.asarray(jp["up"]["qweight"]))
    out = tm(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert np.abs(out - ref).max() <= MLP_TOL * np.abs(ref).max(), (
        np.abs(out - ref).max(), np.abs(ref).max())


# ---------------------------------------------------------------- RoPE ---
@pytest.mark.parametrize("rotary_dim,interleaved",
                         [(None, False), (16, False), (16, True),
                          (None, True)])
def test_partial_and_interleaved_rope_match_jax(rotary_dim, interleaved):
    D, T = 32, 11
    jc = jrope.RopeConfig(head_dim=D, theta=10000.0, max_position=64,
                          rotary_dim=rotary_dim, interleaved=interleaved)
    tc = trope.RopeConfig(head_dim=D, theta=10000.0, max_position=64,
                          rotary_dim=rotary_dim, interleaved=interleaved)
    jcos, jsin = (np.asarray(a) for a in jrope.make_rope_tables(jc))
    tcos, tsin = trope.make_rope_tables(tc)
    assert tcos.shape == ((64, (rotary_dim or D) // 2))
    np.testing.assert_allclose(tcos.numpy(), jcos, atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), jsin, atol=1e-6)
    rng = np.random.RandomState(1)
    q = rng.randn(T, 4, D).astype(np.float32)
    k = rng.randn(T, 2, D).astype(np.float32)
    pos = np.arange(5, 5 + T, dtype=np.int32)
    jq, jk = jrope.apply_rope(jnp.asarray(q, jnp.bfloat16),
                              jnp.asarray(k, jnp.bfloat16), jnp.asarray(pos),
                              jnp.asarray(jcos), jnp.asarray(jsin),
                              interleaved=interleaved)
    tq, tk = trope.apply_rope(torch.from_numpy(q).to(torch.bfloat16),
                              torch.from_numpy(k).to(torch.bfloat16),
                              torch.from_numpy(pos).long(), tcos, tsin,
                              interleaved=interleaved)
    for a, b in ((tq, jq), (tk, jk)):
        b = np.asarray(b, np.float32)
        assert np.abs(a.float().numpy() - b).max() <= \
            ROPE_TOL * np.abs(b).max()
    if rotary_dim:     # the tail passes through untouched
        assert torch.equal(tq[..., rotary_dim:],
                           torch.from_numpy(q).to(torch.bfloat16)[
                               ..., rotary_dim:])


# ------------------------------------------------------- layer models ---
_SMALL = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
              max_position=128, rms_eps=1e-6)
# name -> (JAX-only fields, port fields; shared fields in both)
_LAYER_CASES = {
    "qk_norm_flat": dict(qk_norm=True, qk_norm_flat=True),
    "qk_norm_post_rope": dict(qk_norm=True, qk_norm_post_rope=True),
    "layernorm": dict(norm_type="layernorm", norm_bias=True,
                      mlp_gated=False, mlp_bias=True, activation="gelu",
                      attention_bias=True, o_bias=True),
    "post_block_norms": dict(post_block_norms=True, qk_norm=True,
                             qk_norm_flat=True),
    "granite_multipliers": dict(residual_multiplier=0.5,
                                logits_scaling=3.0,
                                embedding_multiplier=2.0,
                                query_pre_attn_scalar=25.0),
    "nope_partial_interleaved": dict(gqa_rope_interleave=True,
                                     attention_bias=True),
}


def _scramble(tree, rng):
    """Norm weights times U(0.5, 1.5), biases and zeros + N(0, 0.05^2), so
    that a dropped bias or misplaced norm shows."""
    def f(path, a):
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        a = np.asarray(a)
        if a.dtype.kind != "f" or "rope" in name:
            return a
        if "norm" in name and "bias" not in name:
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(a.dtype)
        if name.endswith("bias") or name.endswith("alpha_p") \
                or name.endswith("alpha_n"):
            return (a + rng.normal(0, 0.05, a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.mark.parametrize("case", sorted(_LAYER_CASES))
def test_layer_variants_match_jax(case):
    kw = dict(_SMALL, **_LAYER_CASES[case])
    tkw = dict(kw)
    jkw = dict(kw)
    if case == "nope_partial_interleaved":
        # layer 1 skips RoPE; both rotate 8 of 16 channels, adjacent pairs
        jkw["extra"] = {"no_rope_layers": [1, 0],
                        "partial_rotary_factor": 0.5}
        tkw.update(no_rope_layers=(1, 0), partial_rotary_factor=0.5)
    jcfg = JCfg(**jkw, attention_backend="xla")
    tcfg = ModelConfig(**tkw)
    jm = jax_model_class(jcfg.architecture)(jcfg)
    params = _scramble(jax.tree.map(np.asarray,
                                    jm.init(jax.random.PRNGKey(3))),
                       np.random.RandomState(4))
    state = params_from_jax(params)
    tokens = [int(t) for t in np.random.RandomState(5).randint(1, 95, 21)]
    ours = port_logits(tcfg, state, tokens)
    ref = _jax_logits(jm, params, jcfg, tokens)
    assert np.abs(ours - ref).max() <= LOGIT_TOL, np.abs(ours - ref).max()
    assert np.argmax(ours) == np.argmax(ref)


def _jax_logits(jm, params, jcfg, tokens, BS=8):
    n = len(tokens)
    blocks = list(range(1, -(-n // BS) + 1))
    shape = (len(blocks) + 1, jcfg.num_kv_heads, BS, jcfg.head_dim)
    caches = [(jnp.zeros(shape, jnp.bfloat16),) * 2
              for _ in range(jcfg.num_layers)]
    meta = JMeta(positions=jnp.arange(n, dtype=jnp.int32),
                 slot_mapping=jnp.asarray([blocks[p // BS] * BS + p % BS
                                           for p in range(n)], jnp.int32),
                 block_tables=jnp.asarray([blocks], jnp.int32),
                 kv_lens=jnp.asarray([n], jnp.int32), q_offset=jnp.int32(0),
                 mode="prefill")
    params = jax.tree.map(jnp.asarray, params)
    logits, _ = jm.forward(params, jnp.asarray(tokens, jnp.int32), caches,
                           meta, jnp.asarray([n - 1], jnp.int32))
    return np.asarray(logits, np.float32)[0]
