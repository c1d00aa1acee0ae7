"""Port parity: the plain paged attention ops against the JAX package.

Same numpy inputs (bf16 pools) through the port's `flash_prefill_attention`
/ `paged_decode_attention` (CPU tensors take the plain versions) and JAX's
Pallas kernels in interpret mode, plus the XLA references.

Tolerances (compared in f32, outputs are bf16):
* vs the XLA references: the same f32 math, then one bf16 rounding of the
  output on each side; the f32 sums differ in order, so a value near a
  rounding boundary may land one bf16 ulp apart: 2^-7 (two ulps) of the
  largest output.
* vs the Pallas kernels: they also round q and the softmax probabilities to
  bf16 before the MXU products -> 2e-2 absolute and relative, as the JAX
  package's own kernel tests use, scaled by the largest output when it
  exceeds 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.ops.attention_xla import (
    paged_decode_xla, paged_prefill_xla)
from tensorrt_llm_tpu.ops.flash_prefill import (
    flash_prefill_attention as jax_prefill)
from tensorrt_llm_tpu.ops.paged_attention import (
    paged_decode_attention as jax_decode)
from tensorrt_llm_tpu_torch.ops.attention_plain import write_kv_cache
from tensorrt_llm_tpu_torch.ops.flash_prefill import flash_prefill_attention
from tensorrt_llm_tpu_torch.ops.paged_attention import paged_decode_attention


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16))


def _t(a):
    """numpy (possibly ml_dtypes bf16) -> torch, keeping bf16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.to(torch.float32).numpy()


def _close(out, ref, kernel):
    out, ref = _f32(out), _f32(ref)
    big = max(1.0, float(np.abs(ref).max()))
    if kernel:
        np.testing.assert_allclose(out, ref, atol=2e-2 * big, rtol=2e-2)
    else:
        np.testing.assert_allclose(out, ref, atol=2.0 ** -7 * big, rtol=0)


def _pools(rng, NB, Hkv, BS, D):
    k = _bf16(rng.standard_normal((NB, Hkv, BS, D)))
    v = _bf16(rng.standard_normal((NB, Hkv, BS, D)))
    return k, v


# The Pallas kernels run in interpret mode (seconds per case), so `kernel`
# marks the cases also held against them; every case is held against XLA.
PREFILL = [
    # (T, Hq, Hkv, D, BS, MB, q_offset, window, cap, sinks, kernel)
    (24, 8, 2, 64, 16, 4, 0, None, None, False, False),
    (16, 8, 2, 64, 16, 9, 64, None, None, False, True),  # awkward MB, offset
    (32, 8, 4, 128, 16, 6, 40, None, 30.0, False, False),  # D=128, logit cap
    (20, 4, 4, 128, 16, 4, 30, 24, None, True, True),    # window + sinks
    (16, 8, 1, 64, 16, 5, 48, 20, 20.0, True, False),    # all at D=64
]


@pytest.mark.parametrize("T,Hq,Hkv,D,BS,MB,q_off,window,cap,sinks,kernel",
                         PREFILL)
def test_prefill_plain_matches_jax(T, Hq, Hkv, D, BS, MB, q_off, window, cap,
                                   sinks, kernel):
    rng = np.random.default_rng(T * 7 + D)
    NB = MB + 3
    k_cache, v_cache = _pools(rng, NB, Hkv, BS, D)
    q = _bf16(rng.standard_normal((T, Hq, D)))
    table = rng.permutation(np.arange(1, NB))[:MB].astype(np.int32)
    kv_len = q_off + T
    assert kv_len <= MB * BS
    sk = (rng.standard_normal(Hq).astype(np.float32) if sinks else None)
    scale = D ** -0.5
    kw = dict(sliding_window=window, logit_cap=cap)
    out = flash_prefill_attention(
        _t(q), _t(k_cache), _t(v_cache), _t(table), kv_len, q_off, scale,
        sinks=None if sk is None else _t(sk), **kw)
    jsk = None if sk is None else jnp.asarray(sk)
    ref_xla = paged_prefill_xla(
        jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache),
        jnp.asarray(table), jnp.int32(kv_len), jnp.int32(q_off), scale,
        sinks=jsk, **kw)
    assert out.shape == (T, Hq, D) and out.dtype == torch.bfloat16
    _close(out, ref_xla, kernel=False)
    if kernel:
        ref_kernel = jax_prefill(
            jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache),
            jnp.asarray(table), jnp.int32(kv_len), jnp.int32(q_off), scale,
            interpret=True, sinks=jsk, **kw)
        _close(out, ref_kernel, kernel=True)


DECODE = [
    # (B, Hq, Hkv, D, BS, MB, window, cap, sinks, kernel)
    (3, 8, 2, 64, 16, 4, None, None, False, False),
    (2, 32, 4, 64, 16, 9, None, None, False, True),    # TinyLlama heads
    (4, 8, 8, 128, 16, 3, None, 25.0, False, False),
    (2, 32, 8, 128, 16, 5, 30, None, True, True),      # Llama-3 heads
    (3, 4, 2, 64, 8, 7, 12, 15.0, True, False),
]


@pytest.mark.parametrize("B,Hq,Hkv,D,BS,MB,window,cap,sinks,kernel", DECODE)
def test_decode_plain_matches_jax(B, Hq, Hkv, D, BS, MB, window, cap, sinks,
                                  kernel):
    rng = np.random.default_rng(B * 13 + D + MB)
    NB = B * MB + 1
    k_cache, v_cache = _pools(rng, NB, Hkv, BS, D)
    q = _bf16(rng.standard_normal((B, Hq, D)))
    tables = rng.permutation(np.arange(1, NB)).reshape(B, MB).astype(np.int32)
    kv_lens = rng.integers(1, MB * BS + 1, B).astype(np.int32)
    kv_lens[0] = MB * BS                      # one full table
    sk = (rng.standard_normal(Hq).astype(np.float32) if sinks else None)
    scale = D ** -0.5
    kw = dict(sliding_window=window, logit_cap=cap)
    out = paged_decode_attention(
        _t(q), _t(k_cache), _t(v_cache), _t(tables), _t(kv_lens), scale,
        sinks=None if sk is None else _t(sk), **kw)
    jsk = None if sk is None else jnp.asarray(sk)
    ref_xla = paged_decode_xla(
        jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache),
        jnp.asarray(tables), jnp.asarray(kv_lens), scale, sinks=jsk, **kw)
    assert out.shape == (B, Hq, D) and out.dtype == torch.bfloat16
    _close(out, ref_xla, kernel=False)
    if kernel:
        ref_kernel = jax_decode(
            jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache),
            jnp.asarray(tables), jnp.asarray(kv_lens), scale, interpret=True,
            sinks=jsk, **kw)
        _close(out, ref_kernel, kernel=True)


def test_write_kv_cache_matches_jax_and_reserves_page_zero():
    from tensorrt_llm_tpu.ops.attention_xla import write_kv_cache as jax_write
    rng = np.random.default_rng(5)
    NB, Hkv, BS, D, T = 6, 2, 4, 64, 7
    k_cache, v_cache = _pools(rng, NB, Hkv, BS, D)
    k_new = _bf16(rng.standard_normal((T, Hkv, D)))
    v_new = _bf16(rng.standard_normal((T, Hkv, D)))
    slots = np.array([5, 6, 7, 8, 21, 2**30, 13], np.int64)  # one OOB slot
    jk, jv = jax_write(jnp.asarray(k_cache), jnp.asarray(v_cache),
                       jnp.asarray(k_new), jnp.asarray(v_new),
                       jnp.asarray(slots, jnp.int32))
    tk, tv = _t(k_cache), _t(v_cache)
    write_kv_cache(tk, tv, _t(k_new), _t(v_new), torch.from_numpy(slots))
    # pages 1.. hold the same values; page 0 is reserved scratch
    np.testing.assert_array_equal(_f32(tk)[1:], _f32(jk)[1:])
    np.testing.assert_array_equal(_f32(tv)[1:], _f32(jv)[1:])
    np.testing.assert_array_equal(_f32(tk)[0, :, 0], _f32(k_new)[5])
