"""Port parity: W4A8 (int4 weights, dynamic per-token int8 activations)
against the JAX package.

The same numpy inputs go through the port's `w4a8_matmul` (CPU tensors take
its plain version) and through JAX's `w4a8_matmul`: its XLA fallback (the
default on the CPU) and its Pallas kernel in interpret mode.  Everything is
compared in f32.

Tolerances:
* `quantize_act_int8`: bit for bit (same f32 division, half-to-even round).
* vs the XLA fallback: the same math (f32 scales, bf16-rounded dequantized
  weight, f32 accumulation, per-row scale); only the f32 summation order
  differs, so 1e-5 of max|ref|.
* vs the Pallas kernel: it keeps exact integer products per scale group and
  scales the f32 partial, instead of multiplying by the bf16-rounded weight
  (q - z) * s, which differs by up to 2^-9 relative per weight; 1e-2 of
  max|ref| bounds that with margin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.layers.linear import make_linear_method
from tensorrt_llm_tpu.ops.w4a16_gemm import (
    quantize_act_int8 as jax_quantize_act, w4a8_matmul as jax_w4a8)
from tensorrt_llm_tpu.quantization import QuantAlgo as JQA
from tensorrt_llm_tpu.quantization import QuantConfig as JQC
from tensorrt_llm_tpu.quantization import quantize as jq
from tensorrt_llm_tpu_torch.layers.linear import Linear
from tensorrt_llm_tpu_torch.models import params_from_jax
from tensorrt_llm_tpu_torch.ops.w4a16_gemm import (
    quantize_act_int8, w4a8_matmul, w4a8_plan)
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_values(a):
    """f32 values that bf16 represents exactly: both sides see them alike."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _case(M, K, N, symmetric, G, with_bias, seed):
    rng = np.random.default_rng(seed)
    x = _bf16_values(rng.standard_normal((M, K), dtype=np.float32) * 0.5)
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    q, s, z = jq.quantize_w4(jnp.asarray(w), G, symmetric)
    packed = jq.pack_w4_tiled(q, jq.choose_block_n(N))
    bias = rng.standard_normal((N,), dtype=np.float32) if with_bias else None
    return x, packed, s, z, bias


def _port(x, packed, s, z, bias, act):
    out = w4a8_matmul(_t(x), _t(packed), _t(s), None if z is None else _t(z),
                      None if bias is None else _t(bias), act)
    assert out.dtype == torch.float32
    return out.numpy()


def _jax(x, packed, s, z, bias, act, interpret):
    return np.asarray(jax_w4a8(
        jnp.asarray(x), packed, s, z,
        None if bias is None else jnp.asarray(bias), act,
        interpret=interpret), np.float32)


CASES = [
    # (M, K, N, symmetric, group, bias, activation); group -1 = per channel
    (1, 256, 256, False, 128, False, None),
    (8, 512, 256, True, 128, True, "silu"),
    (40, 256, 512, False, 128, True, "gelu"),
    (16, 512, 512, False, -1, False, None),
    (8, 256, 512, True, -1, False, "relu2"),
    (3, 512, 256, False, 128, True, "relu"),
]


@pytest.mark.parametrize("M,K,seed", [(1, 256, 0), (7, 512, 1), (33, 128, 2)])
def test_quantize_act_int8_bit_exact(M, K, seed):
    rng = np.random.default_rng(seed)
    x = _bf16_values(rng.standard_normal((M, K), dtype=np.float32) * 3.0)
    x[0, :] = 0.0                       # amax clamp at 1e-12
    if M > 1:
        x[1, :7] = [0.5, -0.5, 1.5, 2.5, -2.5, 127.0, -127.0]  # .5 ties
    jq_, js = jax_quantize_act(jnp.asarray(x))
    pq, ps = quantize_act_int8(_t(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert ps.shape == (M, 1)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("M,K,N,symmetric,G,with_bias,act", CASES)
def test_plain_matches_jax_xla(M, K, N, symmetric, G, with_bias, act):
    x, packed, s, z, bias = _case(M, K, N, symmetric, G, with_bias,
                                  M + K + N)
    ref = _jax(x, packed, s, z, bias, act, interpret=None)
    out = _port(x, packed, s, z, bias, act)
    assert np.abs(out - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("M,K,N,symmetric,G,with_bias,act", CASES)
def test_plain_matches_pallas_interpret(M, K, N, symmetric, G, with_bias,
                                        act):
    x, packed, s, z, bias = _case(M, K, N, symmetric, G, with_bias,
                                  2 * M + K)
    ref = _jax(x, packed, s, z, bias, act, interpret=True)
    out = _port(x, packed, s, z, bias, act)
    assert np.abs(out - ref).max() <= 1e-2 * max(np.abs(ref).max(), 1.0)


def test_linear_keeps_f32_scales_and_matches_jax_method():
    """A W4A8 Linear keeps f32 scales and zeros (from floats and from JAX
    parameters) and computes what the JAX `W4A8LinearMethod` computes; a
    W4A16 Linear still rounds its scales to bf16."""
    K, N = 256, 384
    rng = np.random.default_rng(5)
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.05
    b = rng.standard_normal((N,), dtype=np.float32)
    x = _bf16_values(rng.standard_normal((6, K), dtype=np.float32))
    method = make_linear_method(JQC(quant_algo=JQA.W4A8_AWQ), "qkv_proj")
    jp = method.make_params(jnp.asarray(w), jnp.asarray(b), jnp.bfloat16)
    assert "zeros" in jp                      # W4A8 always has zero points
    ref = np.asarray(method.apply(jp, jnp.asarray(x)), np.float32)

    lin = Linear(K, N, QuantConfig(quant_algo=QuantAlgo.W4A8_AWQ), "qkv_proj")
    lin.load({k: _t(v) for k, v in jp.items()})
    assert lin.scales.dtype == torch.float32
    assert lin.zeros.dtype == torch.float32
    np.testing.assert_array_equal(lin.scales.numpy(), np.asarray(jp["scales"]))
    out = lin(_t(x)).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1.0)

    drawn = Linear(K, N, QuantConfig(quant_algo=QuantAlgo.W4A8_AWQ), "mlp")
    drawn.from_float(_t(w))
    assert drawn.scales.dtype == torch.float32 and drawn.zeros is not None
    w16 = Linear(K, N, QuantConfig(quant_algo=QuantAlgo.W4A16), "mlp")
    w16.from_float(_t(w))
    assert w16.scales.dtype == torch.bfloat16


def test_linear_without_tile_width_keeps_kpaired_weight_like_jax():
    """A W4A8 Linear whose N has no 64-multiple tile (N 80) loads its
    K-paired weight as it is, and computes what the JAX `Linear` computes,
    with the JAX parameters carried over by `params_from_jax`."""
    K, N = 256, 80
    rng = np.random.default_rng(11)
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.05
    b = rng.standard_normal((N,), dtype=np.float32)
    x = _bf16_values(rng.standard_normal((5, K), dtype=np.float32))
    quant = JQC(quant_algo=JQA.W4A8_AWQ, group_size=128)
    method = make_linear_method(quant, "o_proj")
    jp = method.make_params(jnp.asarray(w), jnp.asarray(b), jnp.bfloat16)
    assert jp["qweight"].ndim == 2            # K-paired in the JAX package
    ref = np.asarray(method.apply(jp, jnp.asarray(x)), np.float32)

    lin = Linear(K, N, QuantConfig(quant_algo=QuantAlgo.W4A8_AWQ,
                                   group_size=128), "o_proj")
    lin.load(params_from_jax(jp))
    assert tuple(lin.qweight.shape) == (K // 2, N)
    np.testing.assert_array_equal(lin.qweight.numpy(),
                                  np.asarray(jp["qweight"]))
    out = lin(_t(x)).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("K,N,n_groups,block_n,want", [
    # K-paired, no 64-multiple tile: K8 reads the pack groups as stored
    (256, 80, 2, 0, {"pack_group": 128, "col_tiles": 2}),
    (4096, 576, 32, 0, {"pack_group": 128, "col_tiles": 9}),
    (4096, 2880, 1, 0, {"pack_group": 256, "col_tiles": 45}),  # per channel
    (4096, 6144, 32, 1024, {"pack_group": 0, "col_tiles": 96}),  # tiled
    (256, 72, 2, 0, None),        # N % 16: not taken
    (256, 128, 8, 0, None),       # G 32: not taken
    (256, 192, 2, 96, None),      # tile not a multiple of 64
])
def test_w4a8_route_is_decided_by_shape(K, N, n_groups, block_n, want):
    """The K8 launch a W4A8 weight gets, by its shape and packing alone,
    and the shapes K8 refuses (the wrapper raises before any launch)."""
    if want is None:
        with pytest.raises(NotImplementedError):
            w4a8_plan(K, N, n_groups, block_n)
    else:
        assert w4a8_plan(K, N, n_groups, block_n) == want


def test_other_linear_algorithms_still_raise():
    """The 8-bit algorithms build since they were ported
    (tests/test_torch_w8_linears.py): neither int4 nor W4A8 layers, they
    refuse W4A8's parameters."""
    for algo in (QuantAlgo.W8A16, QuantAlgo.FP8,
                 QuantAlgo.W8A8_SQ_PER_CHANNEL):
        lin = Linear(64, 64, QuantConfig(quant_algo=algo), "mlp")
        assert lin.w8 and not (lin.w4 or lin.w4a8)
        with pytest.raises(ValueError):
            lin.load({"qweight": torch.zeros((32, 64), dtype=torch.uint8),
                      "scales": torch.ones((1, 64))})
