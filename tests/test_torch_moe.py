"""Port parity for the W4A16 MoE path: `ops/moe_w4a16.py` and
`layers/moe.py` against the JAX package on the same numpy inputs.

Tolerances, each with its reason:

* work units and quantized experts: exact (integer math; both sides round
  half-to-even).
* plain grouped product vs JAX `w4a16_grouped_matmul_xla`: both round each
  dequantized weight and the output to bf16 and accumulate in f32, in
  another order; at most one bf16 ulp of the largest output, 2^-7 of
  max|ref|.
* plain grouped product vs the Pallas kernel (interpret mode): the kernel
  keeps its output in f32 and, at these tiles, rounds ``w * bf16(s)``
  where the plain version rounds ``w * s``; 1% of max|ref| covers both
  roundings (2^-9 each) summed over K.
* MoE module vs JAX `MoE`: the same rounding points on both sides, f32
  sums in another order, which can move a bf16 intermediate by one ulp;
  1% of max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.layers.moe import MoE as JMoE
from tensorrt_llm_tpu.ops import moe_w4a16 as J
from tensorrt_llm_tpu.quantization import QuantAlgo as JQA
from tensorrt_llm_tpu.quantization import QuantConfig as JQC
from tensorrt_llm_tpu_torch.layers.moe import MoE
from tensorrt_llm_tpu_torch.ops import moe_w4a16 as T
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig


def _np(a):
    return np.array(a)      # a writable copy (torch.from_numpy shares it)


@pytest.mark.parametrize("sizes,tm", [
    ([30, 0, 50, 20], 32),
    ([0, 0, 7, 0, 0, 9], 8),
    ([64, 64], 64),
    ([0, 5, 0], 16),
    ([1, 1, 1, 1, 12], 4),
])
def test_group_metadata_matches_jax(sizes, tm):
    M = sum(sizes)
    m_tiles = -(-M // tm)
    gs = np.asarray(sizes, np.int32)
    ref = _np(J.make_group_metadata(jnp.asarray(gs), m_tiles, tm, len(sizes)))
    out = T.make_group_metadata(torch.from_numpy(gs), m_tiles, tm,
                                len(sizes)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("K,N,group,sym", [
    (192, 96, 64, True),      # K % 128 != 0, single tile (BN = N)
    (192, 256, 64, False),
    (256, 384, 128, True),
    (128, 128, -1, False),    # per-channel
])
def test_quantize_experts_bit_exact(K, N, group, sym):
    rng = np.random.default_rng(K + N)
    w = rng.normal(size=(3, K, N)).astype(np.float32) * 0.1
    jp, js, jz, jbn = J.quantize_experts_w4(jnp.asarray(w), group, sym)
    tp, ts, tz, tbn = T.quantize_experts_w4(torch.from_numpy(w), group, sym)
    assert tbn == jbn and tuple(tp.shape) == _np(jp).shape
    np.testing.assert_array_equal(tp.numpy(), _np(jp))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    if sym:
        assert tz is None and jz is None
    else:
        np.testing.assert_array_equal(tz.numpy(), _np(jz))
    np.testing.assert_array_equal(
        T.dequantize_experts_w4(tp, ts, tz).numpy(),
        _np(J.dequantize_experts_w4(jp, js, jz)))


def _grouped_inputs(seed, E, K, N, sizes, group, sym):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(E, K, N)).astype(np.float32) * 0.1
    xs = rng.normal(size=(sum(sizes), K)).astype(np.float32)
    xs = _np(jnp.asarray(xs, jnp.bfloat16).astype(jnp.float32))
    packed, scales, zeros, _ = J.quantize_experts_w4(jnp.asarray(w), group,
                                                     sym)
    gs = np.asarray(sizes, np.int32)
    tz = None if zeros is None else torch.from_numpy(_np(zeros))
    tgs = torch.from_numpy(gs)
    port = T.w4a16_grouped_matmul(
        torch.from_numpy(xs).to(torch.bfloat16),
        torch.from_numpy(_np(packed)), torch.from_numpy(_np(scales)),
        tgs, T.gmm_work_units(tgs, int(gs.sum())), tz)
    return (jnp.asarray(xs, jnp.bfloat16), packed, scales, zeros,
            jnp.asarray(gs), port)


@pytest.mark.parametrize("group,sym", [(128, True), (64, False), (-1, True)])
def test_plain_grouped_matches_pallas_interpret(group, sym):
    sizes = [30, 0, 50, 20]
    xs, packed, scales, zeros, gs, port = _grouped_inputs(
        0, 4, 256, 256, sizes, group, sym)
    ref = _np(J.w4a16_grouped_matmul(xs, packed, scales, gs, zeros,
                                     block_m=32, block_k=128,
                                     interpret=True))
    assert port.dtype == torch.float32 and port.shape == ref.shape
    err = np.abs(port.numpy() - ref).max()
    assert err <= 1e-2 * np.abs(ref).max(), err


@pytest.mark.parametrize("K,N,sizes,group", [
    (192, 96, [5, 0, 11, 3], 64),     # K % 128 != 0: JAX takes XLA here
    (320, 128, [0, 17, 0, 0, 2], 64),  # E=5 > 4: JAX's chunked scan path
])
def test_plain_grouped_matches_xla(K, N, sizes, group):
    xs, packed, scales, zeros, gs, port = _grouped_inputs(
        1, len(sizes), K, N, sizes, group, True)
    ref = _np(J.w4a16_grouped_matmul_xla(xs, packed, scales, gs, zeros))
    err = np.abs(port.numpy() - ref).max()
    assert err <= 2 ** -7 * np.abs(ref).max(), err


_VARIANTS = {
    "mixtral": dict(activation="silu"),
    "gpt_oss": dict(activation="swiglu_oai", has_router_bias=True,
                    topk_then_softmax=True, has_expert_bias=True),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
@pytest.mark.parametrize("group,zp", [(64, False), (128, True)])
def test_moe_layer_matches_jax(variant, group, zp):
    H, I, E, k, Tn = 128, 192, 4, 2, 12
    kw = _VARIANTS[variant]
    jq = JQC(quant_algo=JQA.W4A16, group_size=group, has_zero_point=zp)
    tq = QuantConfig(quant_algo=QuantAlgo.W4A16, group_size=group,
                     has_zero_point=zp)
    jm = JMoE(hidden_size=H, intermediate_size=I, num_experts=E, top_k=k,
              quant=jq, **kw)
    tm = MoE(H, I, E, k, quant=tq, **kw)
    rng = np.random.default_rng(3)

    def f(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    fl = dict(router_w=f(H, E, s=0.5), gate_w=f(E, H, I, s=H ** -0.5),
              up_w=f(E, H, I, s=H ** -0.5), down_w=f(E, I, H, s=I ** -0.5))
    if kw.get("has_expert_bias"):
        fl.update(router_bias=f(E, s=0.5), gate_b=f(E, I, s=0.1),
                  up_b=f(E, I, s=0.1), down_b=f(E, H, s=0.1))
    params = jm.from_float(**{a: jnp.asarray(v) for a, v in fl.items()})
    tm.from_float(**{a: torch.from_numpy(v) for a, v in fl.items()})
    for leaf, v in params.items():
        np.testing.assert_array_equal(getattr(tm, leaf).numpy(), _np(v),
                                      err_msg=leaf)
    x = _np(jnp.asarray(f(Tn, H), jnp.bfloat16).astype(jnp.float32))
    ref = np.asarray(jm(params, jnp.asarray(x, jnp.bfloat16)), np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    err = np.abs(out - ref).max()
    assert err <= 1e-2 * np.abs(ref).max(), err


@pytest.mark.parametrize("H,I", [(127, 192), (128, 97)])
def test_moe_odd_widths_take_bf16_experts(H, I):
    """An odd hidden or expert width cannot pack int4 pairs: under W4A16
    both sides build bf16 experts (JAX `layers/moe.py:102-104`), the same
    leaves, the same output within 1% of max|ref|."""
    E, k, Tn = 4, 2, 9
    jq = JQC(quant_algo=JQA.W4A16, group_size=64)
    tq = QuantConfig(quant_algo=QuantAlgo.W4A16, group_size=64)
    jm = JMoE(hidden_size=H, intermediate_size=I, num_experts=E, top_k=k,
              quant=jq)
    tm = MoE(H, I, E, k, quant=tq)
    assert not jm.quant_experts and not tm.quant_experts
    rng = np.random.default_rng(H + I)

    def f(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    fl = dict(router_w=f(H, E, s=0.5), gate_w=f(E, H, I, s=H ** -0.5),
              up_w=f(E, H, I, s=H ** -0.5), down_w=f(E, I, H, s=I ** -0.5))
    params = jm.from_float(**{a: jnp.asarray(v) for a, v in fl.items()})
    tm.from_float(**{a: torch.from_numpy(v) for a, v in fl.items()})
    for leaf, v in params.items():
        np.testing.assert_array_equal(
            getattr(tm, leaf).float().numpy(),
            np.asarray(jnp.asarray(v).astype(jnp.float32)), err_msg=leaf)
    x = _np(jnp.asarray(f(Tn, H), jnp.bfloat16).astype(jnp.float32))
    ref = np.asarray(jm(params, jnp.asarray(x, jnp.bfloat16)), np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()


def test_moe_rejects_cut_features():
    from tensorrt_llm_tpu_torch.models import ModelConfig
    mixtral = dict(architectures=["MixtralForCausalLM"], num_local_experts=4)
    ModelConfig.from_hf_config(dict(mixtral, n_group=1, mlp_only_layers=[]))
    # shared experts, grouped routing and dense-only layers are in the port
    # since the DeepSeek slice; a non-DeepSeek config keeps softmax routing
    cfg = ModelConfig.from_hf_config(dict(
        mixtral, n_shared_experts=1, n_group=2, topk_group=2,
        mlp_only_layers=[0]))
    assert (cfg.n_shared_experts, cfg.n_group, cfg.mlp_only_layers,
            cfg.moe_score_func) == (1, 2, (0,), "softmax")
    for cut in (dict(scoring_func="sigmoid"), dict(topk_method="noaux_tc")):
        with pytest.raises(NotImplementedError):
            ModelConfig.from_hf_config(dict(mixtral, **cut))
    # the Qwen-MoE keys are read since the MoE zoo's slice
    cfg = ModelConfig.from_hf_config(dict(
        mixtral, decoder_sparse_step=2, shared_expert_intermediate_size=512))
    assert (cfg.decoder_sparse_step, cfg.shared_expert_intermediate_size) \
        == (2, 512)
    # unquantized experts are bf16, as in the JAX package (ragged_dot)
    assert not MoE(128, 128, 4, 2, quant=None).quant_experts
    # a CPU tensor never reaches the kernel wrapper
    gs = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(ValueError):
        T.moe_gmm(torch.zeros(4, 64, dtype=torch.bfloat16),
                  torch.zeros(1, 1, 32, 64, dtype=torch.int8),
                  torch.ones(1, 1, 64), T.gmm_work_units(gs, 4))
