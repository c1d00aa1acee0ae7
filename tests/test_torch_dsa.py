"""Port parity for the DSA lightning-indexer ops against the JAX package.

Small widths (Hi = 4 indexer heads of Di = 32, latent 64 + 16, pages of 8),
inputs drawn with numpy from a seed and fed to both sides in bf16-exact
values.

* `rotate_activation`: a bf16 product with f32 accumulation on both sides:
  bit for bit.  `layer_norm`: the same f32 formula on f32 inputs: 1e-6.
* `dsa_scores_plain` vs `dsa_scores_pallas(interpret=True)`: bf16 inputs,
  so every product is exact in f32 and only the order of the f32 sums
  differs: 1e-5 of the largest score; slots past kv_len are NEG_INF on both.
* `dsa_decode_select` with `index_topk` below the context: the same
  selected sets as the JAX package's XLA selection.
* `mla_sparse_decode_plain` vs `mla_sparse_decode_xla` (same f32 math; the
  bf16 outputs may differ by one rounding step: 2^-8 of the largest output)
  and `dsa_prefill_mask` vs JAX's (the same booleans).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.ops import dsa as JD
from tensorrt_llm_tpu.ops.norms import layer_norm as jax_layer_norm
from tensorrt_llm_tpu_torch.ops import dsa as TD
from tensorrt_llm_tpu_torch.ops.attention_plain import NEG_INF
from tensorrt_llm_tpu_torch.ops.norms import layer_norm

HI, DI, BS, L, R = 4, 32, 8, 64, 16


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _jb(a):
    return jnp.asarray(a, jnp.bfloat16)


def _inputs(seed, lens, mb=None):
    rng = np.random.default_rng(seed)
    B = len(lens)
    mb = mb or max(-(-n // BS) for n in lens)
    nb = B * mb + 1
    cache = _bf16(rng.standard_normal((nb, 1, BS, DI)))
    tables = (rng.permutation(nb - 1)[:B * mb].reshape(B, mb) + 1).astype(
        np.int32)
    q = _bf16(rng.standard_normal((B, HI, DI)))
    w = (rng.random((B, HI)) * (DI ** -0.5 * HI ** -0.5)).astype(np.float32)
    return rng, cache, tables, np.asarray(lens, np.int32), q, w


@pytest.mark.parametrize("n", [32, 128])
def test_rotate_activation_matches_jax(n):
    x = _bf16(np.random.default_rng(n).standard_normal((3, 5, n)))
    ref = np.asarray(JD.rotate_activation(jnp.asarray(x)).astype(jnp.float32))
    out = TD.rotate_activation(torch.from_numpy(x.copy())).float().numpy()
    np.testing.assert_array_equal(out, ref)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, DI)).astype(np.float32) * 3 + 1
    w = 1 + rng.standard_normal(DI).astype(np.float32) * 0.1
    b = rng.standard_normal(DI).astype(np.float32) * 0.1
    ref = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), 1e-6))
    out = layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), 1e-6).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_write_indexer_cache_matches_jax():
    rng = np.random.default_rng(3)
    NB, T = 5, 9
    k = _bf16(rng.standard_normal((T, DI)))
    slots = rng.permutation(np.arange(BS, NB * BS))[:T].astype(np.int32)
    ref = JD.write_indexer_cache(jnp.zeros((NB, 1, BS, DI), jnp.bfloat16),
                                 _jb(k), jnp.asarray(slots))
    pool = torch.zeros((NB, 1, BS, DI), dtype=torch.bfloat16)
    TD.write_indexer_cache(pool, _t(k), torch.from_numpy(slots))
    np.testing.assert_array_equal(pool.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("lens,mb", [([27, 10], 4), ([0, 1, 33], 5)])
def test_dsa_scores_plain_matches_pallas(lens, mb):
    _, cache, tables, kv, q, w = _inputs(5, lens, mb)
    ref = np.asarray(JD.dsa_scores_pallas(
        _jb(q), jnp.asarray(w), _jb(cache), jnp.asarray(tables),
        jnp.asarray(kv), tile_size=2 * BS, interpret=True))
    out = TD.dsa_scores_plain(_t(q), torch.from_numpy(w), _t(cache),
                              torch.from_numpy(tables),
                              torch.from_numpy(kv)).numpy()
    valid = np.arange(mb * BS)[None, :] < kv[:, None]
    assert (out[~valid] == NEG_INF).all() and (ref[~valid] == NEG_INF).all()
    top = max(1.0, np.abs(ref[valid]).max()) if valid.any() else 1.0
    np.testing.assert_allclose(out[valid], ref[valid], rtol=0,
                               atol=1e-5 * top)
    via = TD.dsa_scores(_t(q), torch.from_numpy(w), _t(cache),
                        torch.from_numpy(tables), torch.from_numpy(kv))
    np.testing.assert_array_equal(via.numpy(), out)


def test_dsa_decode_select_and_sparse_decode_match_jax():
    """index_topk 12 is below both contexts, so top-k drops tokens."""
    lens = [40, 29]
    rng, cache, tables, kv, q, w = _inputs(7, lens)
    topk = 12
    jsel = np.asarray(JD.dsa_decode_select(
        _jb(q), jnp.asarray(w), _jb(cache), jnp.asarray(tables),
        jnp.asarray(kv), topk, backend="xla"))
    tsel = TD.dsa_decode_select(_t(q), torch.from_numpy(w), _t(cache),
                                torch.from_numpy(tables),
                                torch.from_numpy(kv), topk)
    assert tsel.shape == (2, topk)
    for b, n in enumerate(lens):
        got = set(tsel[b].tolist())
        assert got == set(jsel[b].tolist()) and max(got) < n
    # the sparse decode over JAX's selection
    B, H = len(lens), 4
    lat = _bf16(rng.standard_normal((cache.shape[0], 1, BS, L + R)))
    q_eff = _bf16(rng.standard_normal((B, H, L + R)))
    ref = np.asarray(JD.mla_sparse_decode_xla(
        _jb(q_eff), _jb(lat), jnp.asarray(tables), jnp.asarray(kv),
        jnp.asarray(jsel), 0.1, L), np.float32)
    out = TD.mla_sparse_decode_plain(
        _t(q_eff), _t(lat), torch.from_numpy(tables), torch.from_numpy(kv),
        torch.from_numpy(jsel.astype(np.int64)), 0.1, L).float().numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2 ** -8 * max(1.0, np.abs(ref).max()))


def test_dsa_select_covers_short_contexts():
    """When kv_len < index_topk every valid token is selected; the invalid
    picks are masked by the sparse decode."""
    lens = [5, 9]
    _, cache, tables, kv, q, w = _inputs(8, lens, mb=3)
    sel = TD.dsa_decode_select(_t(q), torch.from_numpy(w), _t(cache),
                               torch.from_numpy(tables), torch.from_numpy(kv),
                               16)
    for b, n in enumerate(lens):
        assert set(range(n)) <= set(sel[b].tolist())


@pytest.mark.parametrize("topk", [3, 64])
def test_dsa_prefill_mask_matches_jax(topk):
    rng = np.random.default_rng(11)
    T, off = 7, 5
    cache = _bf16(rng.standard_normal((6, 1, BS, DI)))
    table = np.array([2, 5], np.int32)
    q = _bf16(rng.standard_normal((T, HI, DI)))
    w = rng.random((T, HI)).astype(np.float32)
    ref = np.asarray(JD.dsa_prefill_mask(
        _jb(q), jnp.asarray(w), _jb(cache), jnp.asarray(table),
        jnp.int32(off + T), jnp.int32(off), topk))
    out = TD.dsa_prefill_mask(_t(q), torch.from_numpy(w), _t(cache),
                              torch.from_numpy(table), off + T, off,
                              topk).numpy()
    np.testing.assert_array_equal(out, ref)
