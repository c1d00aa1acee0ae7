"""Port parity: int4 quantization and both packings are bit-exact with JAX.

The same numpy weights go through `tensorrt_llm_tpu.quantization` and
`tensorrt_llm_tpu_torch.quantization`; every output is compared for exact
equality (both sides round half-to-even)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.quantization import quantize as jq
from tensorrt_llm_tpu_torch.quantization import quantize as tq


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(K, N, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    # exact .5 multiples of the scale exercise the half-to-even rounding
    w[0, :4] = [0.35, -0.35, 0.25, 0.0]
    return w


@pytest.mark.parametrize("K,N,group,symmetric", [
    (256, 384, 128, True),
    (256, 384, 128, False),
    (512, 256, -1, True),
    (384, 128, 64, False),
])
def test_quantize_w4_bit_exact(K, N, group, symmetric):
    w = _weights(K, N, K + N)
    jqv, js, jz = jq.quantize_w4(jnp.asarray(w), group, symmetric)
    tqv, ts, tz = tq.quantize_w4(_t(w), group, symmetric)
    np.testing.assert_array_equal(np.asarray(jqv), tqv.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    if symmetric:
        assert jz is None and tz is None
    else:
        np.testing.assert_array_equal(np.asarray(jz), tz.numpy())


@pytest.mark.parametrize("K,N,pack_group", [(256, 256, 128), (512, 128, 256),
                                            (128, 64, 32)])
def test_pack_w4_k_paired_bit_exact(K, N, pack_group):
    q = np.random.default_rng(1).integers(-8, 8, (K, N)).astype(np.int8)
    jp = np.asarray(jq.pack_w4(jnp.asarray(q), pack_group))
    tp = tq.pack_w4(_t(q), pack_group).numpy()
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(
        tq.unpack_w4(_t(jp), pack_group).numpy(), q)


@pytest.mark.parametrize("K,N,bn", [(256, 512, 128), (512, 1024, 1024),
                                    (128, 2560, 512)])
def test_pack_w4_tiled_bit_exact(K, N, bn):
    q = np.random.default_rng(2).integers(-8, 8, (K, N)).astype(np.int8)
    jp = np.asarray(jq.pack_w4_tiled(jnp.asarray(q), bn))
    tp = tq.pack_w4_tiled(_t(q), bn).numpy()
    assert tp.shape == (N // bn, K // 2, bn)
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(
        tq.unpack_w4_tiled(_t(jp)).numpy(), q)


@pytest.mark.parametrize("N", [2560, 2048, 11264, 384, 320, 64])
def test_choose_block_n_matches(N):
    assert jq.choose_block_n(N) == tq.choose_block_n(N)


@pytest.mark.parametrize("tiled,symmetric", [(True, True), (True, False),
                                             (False, True), (False, False)])
def test_dequantize_w4_any_bit_exact(tiled, symmetric):
    K, N = 256, 512
    w = _weights(K, N, 7)
    q, s, z = jq.quantize_w4(jnp.asarray(w), 128, symmetric)
    packed = (jq.pack_w4_tiled(q, 256) if tiled
              else jq.pack_w4(q, jq.pack_group_for(K, s.shape[0])))
    jd = np.asarray(jq.dequantize_w4_any(packed, s, z))
    td = tq.dequantize_w4_any(
        _t(np.asarray(packed)), _t(np.asarray(s)),
        None if z is None else _t(np.asarray(z))).numpy()
    np.testing.assert_array_equal(jd, td)


def test_to_tiled_repacks_k_paired():
    """The 2-D K-paired packing repacks into the tiled layout losslessly."""
    K, N = 256, 384
    q = np.random.default_rng(3).integers(-8, 8, (K, N)).astype(np.int8)
    s = torch.ones((K // 128, N))
    p2 = tq.pack_w4(_t(q), 128)
    p3 = tq.to_tiled(p2, s)
    assert p3.shape == (N // 128, K // 2, 128)
    np.testing.assert_array_equal(tq.unpack_w4_tiled(p3).numpy(), q)
