"""Port parity: the plain W4A16 GEMM against the JAX package.

The same numpy inputs go through the port's `w4a16_matmul` (CPU tensors
take its plain version) and through JAX: the Pallas kernel in interpret mode
(`w4a16_matmul(..., interpret=True)`, as tests/test_w4a16_gemm.py runs it)
and `w4a16_matmul_xla`.  Everything is compared in f32.

Tolerances:
* vs `w4a16_matmul_xla`: the same math (bf16-rounded dequantized weight, f32
  accumulation); only the f32 summation order differs, so 1e-5 of max|ref|.
* vs the Pallas kernel: the kernel scales the f32 partial per group instead
  of multiplying by the bf16-rounded weight (q - z) * s, which differs by up
  to 2^-9 relative per weight; 1e-2 of max|ref| bounds that with margin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.ops.w4a16_gemm import (
    w4a16_matmul as jax_w4a16, w4a16_matmul_xla as jax_w4a16_xla)
from tensorrt_llm_tpu.quantization import quantize as jq
from tensorrt_llm_tpu_torch.ops.w4a16_gemm import (
    w4a16_matmul, w4a16_matmul_plain)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(M, K, N, symmetric, with_bias, seed):
    rng = np.random.default_rng(seed)
    # bf16-representable activations: both sides see identical inputs
    x = (rng.standard_normal((M, K), dtype=np.float32) * 0.5)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    q, s, z = jq.quantize_w4(jnp.asarray(w), 128, symmetric)
    packed = jq.pack_w4_tiled(q, jq.choose_block_n(N))
    bias = rng.standard_normal((N,), dtype=np.float32) if with_bias else None
    return x, packed, s, z, bias


def _port(x, packed, s, z, bias, act):
    out = w4a16_matmul(_t(x), _t(packed), _t(s),
                       None if z is None else _t(z),
                       None if bias is None else _t(bias), act)
    assert out.dtype == torch.float32
    return out.numpy()


CASES = [
    # (M, K, N, symmetric, bias, activation)
    (1, 256, 256, True, False, None),
    (8, 512, 256, False, True, "silu"),
    (40, 256, 512, True, True, "gelu"),
    (40, 512, 512, False, False, None),
    (8, 256, 512, True, False, "relu2"),
    (1, 512, 512, False, True, "relu"),
]


@pytest.mark.parametrize("M,K,N,symmetric,with_bias,act", CASES)
def test_plain_matches_jax_xla(M, K, N, symmetric, with_bias, act):
    x, packed, s, z, bias = _case(M, K, N, symmetric, with_bias, M + K + N)
    ref = np.asarray(jax_w4a16_xla(jnp.asarray(x), packed, s, z,
                                   None if bias is None else jnp.asarray(bias),
                                   act), np.float32)
    out = _port(x, packed, s, z, bias, act)
    tol = 1e-5 * max(np.abs(ref).max(), 1.0)
    assert np.abs(out - ref).max() <= tol


@pytest.mark.parametrize("M,K,N,symmetric,with_bias,act", CASES)
def test_plain_matches_pallas_interpret(M, K, N, symmetric, with_bias, act):
    x, packed, s, z, bias = _case(M, K, N, symmetric, with_bias, 2 * M + K)
    ref = np.asarray(jax_w4a16(jnp.asarray(x), packed, s, z,
                               None if bias is None else jnp.asarray(bias),
                               act, interpret=True), np.float32)
    out = _port(x, packed, s, z, bias, act)
    tol = 1e-2 * max(np.abs(ref).max(), 1.0)
    assert np.abs(out - ref).max() <= tol


def test_k_paired_packing_accepted():
    """The 2-D K-paired packing gives the same result as the tiled one."""
    M, K, N = 8, 256, 384
    x, _, s, z, _ = _case(M, K, N, True, False, 11)
    rng = np.random.default_rng(11)
    q, s, _ = jq.quantize_w4(
        jnp.asarray(rng.standard_normal((K, N), dtype=np.float32)), 128)
    p2 = jq.pack_w4(q, 128)
    p3 = jq.pack_w4_tiled(q, 128)
    a = w4a16_matmul_plain(_t(x), _t(p2), _t(s))
    b = w4a16_matmul_plain(_t(x), _t(p3), _t(s))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
