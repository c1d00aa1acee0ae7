"""Port parity: the attention shapes and options the JAX package runs.

* The CUDA backend's dispatch (`cuda_backend.plain_route`): the JAX
  Pallas backend's XLA condition (`pallas_backend.py:57-76`) case by case,
  with the port's one exception (INT8 pools at D 64 keep K6/K7).
* The plain ops against the JAX XLA functions on the same numpy inputs:
  cyclic (VSWA ring) prefill, decode and tree verification, chunked
  attention (`attention_chunk`) and logit caps.  Tolerance as
  `tests/test_torch_attention.py`'s kernel rule: atol 2e-2 * max|ref|,
  rtol 2e-2 (bf16 outputs of f32 math summed in another order).
* The kernels' reach: `decode_check` takes D 256 and any group of 1..16
  for bf16, e4m3 and INT8 pages and still refuses D 32 and short pages;
  the prefill wrapper takes D 256 for the three page kinds.  Meta tensors
  stop at the device check (ValueError) once the shape is taken.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.ops.attention_xla import (
    cyclic_prefill_xla, paged_decode_xla, paged_prefill_xla,
    tree_verify_attention_xla)
from tensorrt_llm_tpu_torch.attention_backend.cuda_backend import (
    CudaAttention, plain_route)
from tensorrt_llm_tpu_torch.attention_backend.interface import (
    AttentionMetadata)
from tensorrt_llm_tpu_torch.attention_backend.plain_backend import (
    PlainAttention)
from tensorrt_llm_tpu_torch.ops.attention_plain import (
    cyclic_prefill_plain, paged_decode_plain, paged_prefill_plain,
    ring_positions, tree_verify_attention)
from tensorrt_llm_tpu_torch.ops.flash_prefill import flash_prefill_attention
from tensorrt_llm_tpu_torch.ops.paged_attention import (
    decode_check, paged_decode_attention)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16))


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(out, ref):
    out = out.to(torch.float32).numpy()
    ref = np.asarray(ref, np.float32)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=2e-2,
                               atol=2e-2 * max(1.0, np.abs(ref).max()))


# ------------------------------------------------------------ dispatch ---
ROUTES = [
    # (D, BS, kind, cyclic, chunk, pair_mask, plain)
    (128, 16, "bf16", False, None, False, False),   # Llama: K3/K4
    (64, 16, "bf16", False, None, False, False),    # TinyLlama: packed view
    (256, 16, "bf16", False, None, False, False),   # Gemma: D % 128 == 0
    (256, 16, "fp8", False, None, False, False),
    (256, 16, "int8", False, None, False, False),   # int8_ok: D % 128 == 0
    (64, 16, "int8", False, None, False, False),    # the port's K6/K7
    (128, 16, "bf16", True, None, False, True),     # a VSWA ring
    (128, 16, "bf16", False, 8192, False, True),    # chunked attention
    (128, 16, "bf16", False, None, True, True),     # a draft-tree verify
    (256, 16, "int8", True, None, False, True),
    (96, 16, "bf16", False, None, False, True),     # not lane-aligned
    (80, 16, "fp8", False, None, False, True),
    (64, 3, "bf16", False, None, False, True),      # 3 x 64 % 128 != 0
    (32, 16, "int8", False, None, False, True),     # int8 at D % 128 != 0
    (32, 16, "bf16", False, None, False, False),    # JAX's packed kernel:
    (384, 16, "bf16", False, None, False, False),   # the wrapper refuses
]


@pytest.mark.parametrize("D,BS,kind,cyclic,chunk,pair,plain", ROUTES)
def test_dispatch_follows_the_jax_condition(D, BS, kind, cyclic, chunk,
                                            pair, plain):
    assert plain_route(D, BS, kind, cyclic, chunk, pair) == plain
    jax_lane_ok = D % 128 == 0 or (128 % D == 0 and (BS * D) % 128 == 0)
    jax_int8_ok = kind != "int8" or (D % 128 == 0 and not cyclic
                                     and chunk is None)
    jax_xla = (not jax_int8_ok or not jax_lane_ok or cyclic
               or chunk is not None or pair)
    # the port differs from JAX only where it has a kernel JAX lacks
    assert plain == jax_xla or (kind == "int8" and D == 64 and not plain)


def test_kernel_route_refuses_instead_of_falling_back():
    """A shape routed to the kernels that they do not take raises on a
    non-CPU tensor; the plain route never reaches a kernel."""
    T, Hkv, D = 4, 2, 32
    be = CudaAttention(4, Hkv, D, D ** -0.5)
    meta = AttentionMetadata(
        positions=torch.zeros(T, dtype=torch.int64, device="meta"),
        slot_mapping=torch.zeros(T, dtype=torch.int64, device="meta"),
        block_tables=torch.zeros((1, 2), dtype=torch.int32, device="meta"),
        kv_lens=torch.zeros(1, dtype=torch.int32, device="meta"),
        mode="prefill")
    q = torch.zeros((T, 4, D), dtype=torch.bfloat16, device="meta")
    kv = torch.zeros((T, Hkv, D), dtype=torch.bfloat16, device="meta")
    pool = torch.zeros((4, Hkv, 16, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError):
        be(q, kv, kv, pool, pool.clone(), meta)
    # the same step over CPU tensors on a ring: the plain ops, as the CPU's
    rng = np.random.default_rng(0)
    cpu = [_t(_bf16(rng.standard_normal(s))) for s in
           ((T, 4, 96), (T, Hkv, 96), (T, Hkv, 96))]
    pools = [_t(_bf16(rng.standard_normal((4, Hkv, 16, 96))))
             for _ in range(4)]
    m = AttentionMetadata(positions=torch.arange(T),
                          slot_mapping=torch.arange(16, 16 + T),
                          block_tables=torch.tensor([[1, 2]],
                                                    dtype=torch.int32),
                          kv_lens=torch.tensor([T], dtype=torch.int32),
                          mode="prefill", cyclic=True)
    a = CudaAttention(4, Hkv, 96, 0.1, sliding_window=8)(
        *cpu, pools[0], pools[1], m)
    b = PlainAttention(4, Hkv, 96, 0.1, sliding_window=8)(
        *cpu, pools[2], pools[3], m)
    assert torch.equal(a, b)


# --------------------------------------------------------- plain ops ---
def _ring_case(rng, Hq, Hkv, D, BS, R, B=1):
    NB = B * R + 1
    k = _bf16(rng.standard_normal((NB, Hkv, BS, D)))
    v = _bf16(rng.standard_normal((NB, Hkv, BS, D)))
    tables = (1 + np.arange(B * R)).reshape(B, R).astype(np.int32)
    return k, v, tables


@pytest.mark.parametrize("q_off,T,window,cap,chunk,sinks", [
    (0, 24, 16, None, None, False),       # the first chunk
    (40, 24, 16, 50.0, None, True),       # the ring has wrapped
    (70, 9, 30, None, 32, False),         # chunked attention on a ring
])
def test_cyclic_prefill_matches_jax(q_off, T, window, cap, chunk, sinks):
    rng = np.random.default_rng(q_off + T)
    Hq, Hkv, D, BS, R = 4, 2, 16, 8, 5
    k, v, tables = _ring_case(rng, Hq, Hkv, D, BS, R)
    q = _bf16(rng.standard_normal((T, Hq, D)))
    kn = _bf16(rng.standard_normal((T, Hkv, D)))
    vn = _bf16(rng.standard_normal((T, Hkv, D)))
    sk = rng.standard_normal(Hq).astype(np.float32) if sinks else None
    kw = dict(sliding_window=window, logit_cap=cap, attention_chunk=chunk)
    out = cyclic_prefill_plain(_t(q), _t(k), _t(v), _t(kn), _t(vn),
                               _t(tables[0]), q_off + T, q_off, 0.25,
                               sinks=None if sk is None else _t(sk), **kw)
    ref = cyclic_prefill_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(tables[0]), jnp.int32(q_off + T),
        jnp.int32(q_off), 0.25,
        sinks=None if sk is None else jnp.asarray(sk), **kw)
    _close(out, ref)


@pytest.mark.parametrize("cyclic,window,cap,chunk", [
    (True, 16, None, None),
    (True, 30, 50.0, None),
    (False, None, 30.0, 16),
    (False, None, None, None),
])
def test_decode_options_match_jax(cyclic, window, cap, chunk):
    rng = np.random.default_rng(int(cyclic) + (window or 0))
    Hq, Hkv, D, BS, R, B = 8, 2, 16, 8, 5, 3
    k, v, tables = _ring_case(rng, Hq, Hkv, D, BS, R, B)
    q = _bf16(rng.standard_normal((B, Hq, D)))
    kv_lens = np.asarray([3, R * BS, 97], np.int32)
    if not cyclic:
        kv_lens = np.minimum(kv_lens, R * BS)
    kw = dict(sliding_window=window, logit_cap=cap, attention_chunk=chunk)
    out = paged_decode_plain(_t(q), _t(k), _t(v), _t(tables), _t(kv_lens),
                             0.25, cyclic=cyclic, **kw)
    ref = paged_decode_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(tables), jnp.asarray(kv_lens), 0.25,
                           cyclic=cyclic, **kw)
    _close(out, ref)
    if not cyclic:
        # the CPU wrapper takes the same plain version
        _close(paged_decode_attention(_t(q), _t(k), _t(v), _t(tables),
                                      _t(kv_lens), 0.25, sliding_window=window,
                                      logit_cap=cap), paged_decode_xla(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(tables), jnp.asarray(kv_lens), 0.25,
            sliding_window=window, logit_cap=cap))


@pytest.mark.parametrize("cap,chunk", [(None, None), (50.0, 16)])
def test_prefill_chunk_and_cap_match_jax(cap, chunk):
    rng = np.random.default_rng(7)
    Hq, Hkv, D, BS, MB, T, q_off = 4, 2, 16, 8, 6, 20, 25
    NB = MB + 2
    k = _bf16(rng.standard_normal((NB, Hkv, BS, D)))
    v = _bf16(rng.standard_normal((NB, Hkv, BS, D)))
    q = _bf16(rng.standard_normal((T, Hq, D)))
    table = rng.permutation(np.arange(1, NB))[:MB].astype(np.int32)
    kw = dict(logit_cap=cap, attention_chunk=chunk)
    out = paged_prefill_plain(_t(q), _t(k), _t(v), _t(table), q_off + T,
                              q_off, 0.25, **kw)
    ref = paged_prefill_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(table), jnp.int32(q_off + T),
                            jnp.int32(q_off), 0.25, **kw)
    _close(out, ref)


@pytest.mark.parametrize("cyclic,window,cap", [(True, 16, None),
                                               (True, 24, 50.0),
                                               (False, None, 30.0)])
def test_tree_verify_options_match_jax(cyclic, window, cap):
    rng = np.random.default_rng(11)
    Hq, Hkv, D, BS, R = 4, 2, 16, 8, 5
    k, v, tables = _ring_case(rng, Hq, Hkv, D, BS, R)
    prefix = 53 if cyclic else 30
    # two pending rows, then a tree of two depths (three nodes)
    positions = np.asarray([prefix, prefix + 1, prefix + 2, prefix + 2,
                            prefix + 3], np.int32)
    mask = np.tril(np.ones((5, 5), bool))
    mask[3, 2] = False                     # siblings do not see each other
    mask[4, 3] = False
    T = len(positions)
    q = _bf16(rng.standard_normal((T, Hq, D)))
    kn = _bf16(rng.standard_normal((T, Hkv, D)))
    vn = _bf16(rng.standard_normal((T, Hkv, D)))
    out = tree_verify_attention(
        _t(q), _t(k), _t(v), _t(kn), _t(vn), _t(tables[0]), prefix,
        _t(positions), torch.from_numpy(mask), 0.25, sliding_window=window,
        cyclic=cyclic, logit_cap=cap)
    ref = tree_verify_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(tables[0]), jnp.int32(prefix),
        jnp.asarray(positions), jnp.asarray(mask), 0.25, cyclic=cyclic,
        sliding_window=window, logit_cap=cap)
    _close(out, ref)


def test_ring_positions():
    """Slot s of a ring of P holds position s + floor((L - 1 - s) / P) * P
    (negative: not written yet)."""
    P = 8
    assert ring_positions(P, 3, "cpu").tolist() == [0, 1, 2, -5, -4, -3, -2,
                                                    -1]
    assert ring_positions(P, 11, "cpu").tolist() == [8, 9, 10, 3, 4, 5, 6,
                                                     7]
    both = ring_positions(P, torch.tensor([3, 11]), "cpu")
    assert both.tolist() == [ring_positions(P, 3, "cpu").tolist(),
                             ring_positions(P, 11, "cpu").tolist()]


# ------------------------------------------------------ kernels' reach ---
@pytest.mark.parametrize("kind", ["bf16", "fp8", "int8"])
def test_decode_check_takes_d256_and_any_group(kind):
    for D in (64, 128, 256):
        for G in range(1, 17):
            decode_check(D, G, 16, kind)
    for D, G, BS in ((32, 4, 16), (16, 1, 16), (96, 4, 16), (256, 17, 16),
                     (256, 0, 16), (128, 4, 4 if kind == "bf16" else 2),
                     (128, 4, 6)):
        with pytest.raises(NotImplementedError):
            decode_check(D, G, BS, kind)


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _pool(shape, kind):
    if kind == "int8":
        return (_meta(shape, torch.int8), _meta(shape[:3], torch.float32))
    return _meta(shape, torch.float8_e4m3fn if kind == "fp8"
                 else torch.bfloat16)


@pytest.mark.parametrize("kind", ["bf16", "fp8", "int8"])
@pytest.mark.parametrize("D,Hq,Hkv,exc", [
    (256, 16, 8, ValueError),            # Gemma-2: the kernel takes it
    (128, 28, 4, ValueError),            # Qwen2.5-7B's group of 7
    (32, 8, 2, NotImplementedError),
])
def test_wrappers_take_d256_on_every_page_kind(kind, D, Hq, Hkv, exc):
    pool = _pool((8, Hkv, 16, D), kind)
    with pytest.raises(exc):
        paged_decode_attention(_meta((2, Hq, D)), pool, pool,
                               _meta((2, 4), torch.int32),
                               _meta((2,), torch.int32), 0.1)
    with pytest.raises(exc):
        flash_prefill_attention(_meta((5, Hq, D)), pool, pool,
                                _meta((4,), torch.int32), 5, 0, 0.1)
