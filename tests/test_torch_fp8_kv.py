"""Port parity: the FP8 KV cache (float8_e4m3fn pages, no scales) against
the JAX package.

The same numpy inputs go through the port's ops (CPU tensors take the plain
versions) and JAX's: the e4m3 KV append (`write_kv_cache`), the plain paged
decode, prefill and draft-tree attention over e4m3 pools against JAX's XLA
references and its Pallas kernels in interpret mode (the JAX package sends
FP8 pools to them: `attention_backend/pallas_backend.py:60-107`), the KV
manager's pools, `LLM.generate`, and the paths that copy pages: beam
forks, the host tier, NGram speculation and a disaggregated transfer whose
bytes JAX's `payload_from_bytes` reads.

Tolerances (attention compared in f32, outputs bf16):
* the append: bit for bit for values inside +-448 (past ~464 the JAX
  package's cast gives NaN and the port's saturates:
  `test_e4m3_cast_saturates_where_jax_gives_nan`).
* attention: the upcast of e4m3 to bf16 is exact on both sides, so the
  XLA references differ by f32 sums in another order and one bf16 rounding
  of the output: 2^-7 (two ulps) of the largest output; the Pallas kernels
  also round P to bf16 before P V: 2e-2 absolute and relative, as the JAX
  package's own kernel tests use, scaled by the largest output past 1.
* `LLM.generate`: greedy tokens equal, with `tests/test_torch_llm.py`'s
  near-tie rule for a token that differs.
"""

import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.llmapi import disagg_params as jdp
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.ops import attention_xla as jx
from tensorrt_llm_tpu.ops.flash_prefill import (
    flash_prefill_attention as jax_prefill)
from tensorrt_llm_tpu.ops.paged_attention import (
    paged_decode_attention as jax_decode)
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.commands import bench
from tensorrt_llm_tpu_torch.llmapi import disagg_params as tdp
from tensorrt_llm_tpu_torch.llmapi.disagg_params import DisaggregatedParams
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax
from tensorrt_llm_tpu_torch.ops.attention_plain import (
    gather_dequant, tree_verify_attention, write_kv_cache)
from tensorrt_llm_tpu_torch.ops.flash_prefill import flash_prefill_attention
from tensorrt_llm_tpu_torch.ops.paged_attention import (
    paged_decode_attention, pool_kind)
from tensorrt_llm_tpu_torch.quantization import (
    KvCacheQuantAlgo, QuantAlgo, QuantConfig, to_e4m3)
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
    KVCacheConfig, KVCacheManager)
from tensorrt_llm_tpu_torch.speculative import (
    SpeculativeConfig, SpeculativeMode)

from torch_parity import jax_generate, port_logits

E4 = jnp.float8_e4m3fn


def _t(a):
    """numpy / JAX (bf16, e4m3 or plain) -> torch, keeping the dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(np.array(a).view(np.uint8)).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _bytes(t):
    return t.view(torch.uint8).numpy()


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape, dtype=np.float32) * scale
                       ).astype(jnp.bfloat16)


def _close(out, ref, kernel):
    out = out.to(torch.float32).numpy()
    ref = np.asarray(ref, np.float32)
    big = max(1.0, float(np.abs(ref).max()))
    if kernel:
        np.testing.assert_allclose(out, ref, atol=2e-2 * big, rtol=2e-2)
    else:
        np.testing.assert_allclose(out, ref, atol=2.0 ** -7 * big, rtol=0)


def _fp8_pools(rng, seqs, Hkv, D, BS, MB, scale=4.0):
    """JAX e4m3 pools filled through the JAX append path (values inside
    +-448), one shuffled block table row per sequence length."""
    NB = len(seqs) * MB + 1
    kc = jnp.zeros((NB, Hkv, BS, D), E4)
    vc = jnp.zeros((NB, Hkv, BS, D), E4)
    ids = rng.permutation(np.arange(1, NB)).astype(np.int32)
    tables = ids[:len(seqs) * MB].reshape(len(seqs), MB)
    for b, n in enumerate(seqs):
        pos = np.arange(n)
        slots = jnp.asarray(tables[b][pos // BS] * BS + pos % BS)
        kc, vc = jx.write_kv_cache(kc, vc, _bf16(rng, (n, Hkv, D), scale),
                                   _bf16(rng, (n, Hkv, D), scale), slots)
    return kc, vc, tables


def test_write_kv_cache_fp8_bit_exact_and_reserves_page_zero():
    rng = np.random.default_rng(3)
    NB, H, BS, D = 6, 2, 8, 64
    # values over e4m3's whole range inside +-448: normals, subnormals
    k_new = jnp.asarray(np.clip(rng.standard_normal((7, H, D)) * 120,
                                -440, 440), jnp.bfloat16)
    v_new = _bf16(rng, (7, H, D), 2.0 ** -7)
    slots = np.array([16, 17, 23, 33, 34, NB * BS, NB * BS + 5], np.int64)
    zero = lambda: jnp.zeros((NB, H, BS, D), E4)  # noqa: E731
    jk, jv = jx.write_kv_cache(zero(), zero(), k_new, v_new,
                               jnp.asarray(slots, jnp.int32))
    pk = torch.zeros((NB, H, BS, D), dtype=torch.float8_e4m3fn)
    pv = torch.zeros_like(pk)
    write_kv_cache(pk, pv, _t(k_new), _t(v_new), torch.from_numpy(slots))
    for port, ref in ((pk, jk), (pv, jv)):
        np.testing.assert_array_equal(_bytes(port),
                                      np.asarray(ref).view(np.uint8))
    assert _bytes(pk)[0].any()          # the two slots past the pool
    # the gather upcasts to bf16 exactly, as JAX's e4m3 -> f32 does
    idx = np.array([[2, 4], [0, 2]], np.int32)
    np.testing.assert_array_equal(
        gather_dequant(pk, torch.from_numpy(idx)).to(torch.float32).numpy(),
        np.asarray(jx.gather_dequant(jk, jnp.asarray(idx)), np.float32))


def test_e4m3_cast_saturates_where_jax_gives_nan():
    """A reference defect the port does not copy: JAX's cast to e4m3
    gives NaN past ~464 (a NaN K or V poisons every row that reads the
    page); the port's cast (`to_e4m3`, which clamps first: PyTorch's own
    cast gives NaN there too in some versions), and so its KV append,
    saturates at +-448.  Below 464 the two agree byte for byte."""
    big = np.array([500.0, -1000.0, 465.0, -3.0e4], np.float32)
    jax_big = np.asarray(jnp.asarray(big).astype(E4), np.float32)
    assert np.isnan(jax_big).all()
    assert to_e4m3(torch.from_numpy(big)).float().tolist() == \
        [448.0, -448.0, 448.0, -448.0]
    ok = np.concatenate([np.linspace(-463.0, 463.0, 4001, dtype=np.float32),
                         2.0 ** -np.arange(6, 12, dtype=np.float32),
                         np.array([449.0, 460.0, -460.0], np.float32)])
    np.testing.assert_array_equal(
        _bytes(to_e4m3(torch.from_numpy(ok))),
        np.asarray(jnp.asarray(ok).astype(E4)).view(np.uint8))
    # through the KV append: one row past 464 is NaN in JAX's pool, 448 here
    row = jnp.full((1, 1, 64), 500.0, jnp.bfloat16)
    jk, _ = jx.write_kv_cache(jnp.zeros((2, 1, 4, 64), E4),
                              jnp.zeros((2, 1, 4, 64), E4), row, row,
                              jnp.asarray([4], jnp.int32))
    assert np.isnan(np.asarray(jk[1, 0, 0], np.float32)).all()
    pk = torch.zeros((2, 1, 4, 64), dtype=torch.float8_e4m3fn)
    write_kv_cache(pk, pk.clone(), _t(row), _t(row), torch.tensor([4]))
    assert (pk[1, 0, 0].float() == 448.0).all()


DECODE = [
    # B, Hq, Hkv, D, BS, MB, window, cap, sinks, kernel
    (2, 8, 2, 128, 16, 4, None, None, False, True),
    (3, 8, 4, 128, 8, 6, None, None, True, True),
    (2, 8, 2, 128, 16, 4, 20, 25.0, True, True),
    (2, 8, 2, 64, 16, 4, None, None, False, True),
    (3, 8, 1, 64, 16, 4, 24, None, True, True),
    (3, 8, 2, 128, 8, 6, 24, 25.0, True, False),
    (3, 8, 1, 64, 8, 6, None, None, True, False),
    (2, 4, 2, 64, 16, 4, 24, 20.0, False, False),
]


@pytest.mark.parametrize("B,Hq,Hkv,D,BS,MB,window,cap,sinks,kernel", DECODE)
def test_decode_plain_fp8_matches_jax(B, Hq, Hkv, D, BS, MB, window, cap,
                                      sinks, kernel):
    rng = np.random.default_rng(B * 100 + Hq + D + BS)
    lens = [int(rng.integers(1, MB * BS + 1)) for _ in range(B)]
    lens[0] = MB * BS                         # one full table
    kc, vc, tables = _fp8_pools(rng, lens, Hkv, D, BS, MB)
    q = _bf16(rng, (B, Hq, D))
    sk = jnp.asarray(rng.standard_normal(Hq, dtype=np.float32)) \
        if sinks else None
    kv_lens = np.array(lens, np.int32)
    kw = dict(sliding_window=window, logit_cap=cap, sinks=sk)
    if kernel:
        ref = jax_decode(q, kc, vc, jnp.asarray(tables), jnp.asarray(kv_lens),
                         D ** -0.5, tile_size=2 * BS, interpret=True, **kw)
    else:
        ref = jx.paged_decode_xla(q, kc, vc, jnp.asarray(tables),
                                  jnp.asarray(kv_lens), D ** -0.5, **kw)
    out = paged_decode_attention(
        _t(q), _t(kc), _t(vc), _t(tables), _t(kv_lens), D ** -0.5,
        sliding_window=window, logit_cap=cap,
        sinks=None if sk is None else _t(sk))
    _close(out, ref, kernel)


PREFILL = [
    # T, Hq, Hkv, D, BS, MB, q_offset, window, cap, sinks, kernel
    (32, 8, 2, 128, 16, 4, 0, None, None, False, True),
    (16, 8, 2, 128, 16, 4, 24, None, None, True, True),
    (32, 8, 4, 128, 8, 8, 20, 24, None, True, True),
    (24, 8, 2, 64, 16, 4, 16, None, 30.0, False, True),
    (24, 8, 1, 64, 16, 4, 30, 20, None, True, True),
    (24, 8, 2, 128, 8, 8, 30, 24, 30.0, True, False),
    (24, 4, 2, 64, 8, 8, 8, None, None, True, False),
]


@pytest.mark.parametrize(
    "T_,Hq,Hkv,D,BS,MB,q_off,window,cap,sinks,kernel", PREFILL)
def test_prefill_plain_fp8_matches_jax(T_, Hq, Hkv, D, BS, MB, q_off, window,
                                       cap, sinks, kernel):
    rng = np.random.default_rng(T_ + Hq + q_off + D)
    total = q_off + T_
    kc, vc, tables = _fp8_pools(rng, [total], Hkv, D, BS, MB)
    bt = tables[0]
    q = _bf16(rng, (T_, Hq, D))
    sk = jnp.asarray(rng.standard_normal(Hq, dtype=np.float32)) \
        if sinks else None
    kw = dict(sliding_window=window, logit_cap=cap, sinks=sk)
    if kernel:
        ref = jax_prefill(q, kc, vc, jnp.asarray(bt), jnp.int32(total),
                          jnp.int32(q_off), D ** -0.5, tile_size=2 * BS,
                          interpret=True, **kw)
    else:
        ref = jx.paged_prefill_xla(q, kc, vc, jnp.asarray(bt),
                                   jnp.int32(total), jnp.int32(q_off),
                                   D ** -0.5, **kw)
    out = flash_prefill_attention(
        _t(q), _t(kc), _t(vc), _t(bt), total, q_off, D ** -0.5,
        sliding_window=window, logit_cap=cap,
        sinks=None if sk is None else _t(sk))
    _close(out, ref, kernel)


@pytest.mark.parametrize("sinks,window", [(False, None), (True, 6)])
def test_tree_verify_attention_fp8_matches_jax(sinks, window):
    """Committed rows and a tree over a 13-token prefix in an e4m3 pool:
    the chunk's own rows round through e4m3 on both sides."""
    rng = np.random.default_rng(40 + sinks)
    Hq, Hkv, D, BS, MB = 8, 2, 64, 4, 6
    prefix = 13
    kc, vc, tables = _fp8_pools(rng, [prefix], Hkv, D, BS, MB)
    table = tables[0]
    positions = np.array([13, 14, 15, 15, 16, 17], np.int32)
    Tn = len(positions)
    mask = np.tril(np.ones((Tn, Tn), bool))
    mask[3, 2] = False                      # two siblings at depth 1
    mask[4, 2] = mask[5, 2] = False
    q, kn, vn = (_bf16(rng, (Tn, Hq, D)), _bf16(rng, (Tn, Hkv, D), 4.0),
                 _bf16(rng, (Tn, Hkv, D), 4.0))
    snk = jnp.asarray(rng.standard_normal(Hq, np.float32)) if sinks else None
    ref = jx.tree_verify_attention_xla(
        q, kc, vc, kn, vn, jnp.asarray(table), jnp.int32(prefix),
        jnp.asarray(positions), jnp.asarray(mask), D ** -0.5,
        sliding_window=window, sinks=snk)
    out = tree_verify_attention(
        _t(q), _t(kc), _t(vc), _t(kn), _t(vn), torch.from_numpy(table),
        prefix, torch.from_numpy(positions.astype(np.int64)),
        torch.from_numpy(mask), D ** -0.5, sliding_window=window,
        sinks=None if snk is None else _t(snk))
    _close(out, ref, kernel=False)


def test_kv_manager_fp8_pools_and_sizing():
    L, Hkv, D, BS, NB = 3, 2, 64, 8, 10
    mgr = KVCacheManager(KVCacheConfig(block_size=BS,
                                       kv_quant=KvCacheQuantAlgo.FP8),
                         L, Hkv, D, NB, device="cpu")
    pools = mgr.allocate_pools()
    assert len(pools) == L
    for k, v in pools:
        for t in (k, v):
            assert t.dtype == torch.float8_e4m3fn
            assert t.shape == (NB, Hkv, BS, D) and pool_kind(t) == "fp8"
    per_block = sum(t.numel() * t.element_size()
                    for kv in pools for t in kv) // NB
    budget = 123_456_789
    # one byte a value and no scales: half a bf16 pool's bytes
    assert KVCacheManager.blocks_from_memory(
        budget, L, Hkv, D, BS, dtype_bytes=1) == budget // per_block


def test_quantized_latent_pools_raise():
    """The JAX package allocates bf16 latent pools whatever kv_cache_quant
    says (`runtime/kv_cache_manager.py:838-845`); the port refuses a
    quantized latent cache and says why."""
    for q in ("FP8", "INT8"):
        with pytest.raises(NotImplementedError,
                           match="JAX package does not quantize latent"):
            KVCacheConfig(kv_quant=q, layout="latent")


def test_attention_kernels_refuse_fp8_shapes_before_the_device():
    """On a device that is not the CPU an FP8 pool never takes the plain
    version: a page the decode kernel refuses (not a multiple of 4 tokens)
    raises NotImplementedError, a page it takes reaches the device check."""
    q = torch.empty((2, 8, 64), dtype=torch.bfloat16, device="meta")
    tables = torch.empty((2, 4), dtype=torch.int32, device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    for bs, err in ((6, NotImplementedError), (8, ValueError)):
        pool = torch.empty((9, 2, bs, 64), dtype=torch.float8_e4m3fn,
                           device="meta")
        with pytest.raises(err):
            paged_decode_attention(q, pool, pool, tables, lens, 0.125)
    qp = torch.empty((5, 8, 96), dtype=torch.bfloat16, device="meta")
    pool = torch.empty((9, 2, 8, 96), dtype=torch.float8_e4m3fn,
                       device="meta")
    with pytest.raises(NotImplementedError):
        flash_prefill_attention(qp, pool, pool, tables[0], 5, 0, 0.1)


def test_bench_kv_dtype_fp8_is_accepted():
    args = types.SimpleNamespace(
        tp_size=1, device="cpu", quant="FP8", max_batch_size=4,
        max_seq_len=64, seed=0, dataset=None, kv_dtype="fp8",
        decode_steps=None, max_num_tokens=None, free_mem_fraction=None)
    kw = bench.llm_kwargs(args)
    assert kw["kv_cache_quant"] == "FP8" and kw["quant_algo"] == "FP8"


# ------------------------------------------------------------ serving ---
SHAPE = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
             num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
             max_position=256)
LLM_KW = dict(skip_tokenizer_init=True, max_seq_len=160, max_batch_size=3,
              max_num_tokens=48, kv_num_blocks=96, kv_block_size=8,
              max_decode_steps=4)
TIE = 0.02   # ~2 bf16 ulps of the largest logits


@pytest.fixture(autouse=True)
def _python_bookkeeping(monkeypatch):
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")


@pytest.fixture(scope="module")
def w4_fp8():
    """A JAX W4A16 `LLM` over FP8 pools, its params, and the port's."""
    import os
    os.environ["TLLM_KV_BOOKKEEPING"] = "python"
    try:
        jl = J.LLM(model=JCfg(**SHAPE), quant_algo="W4A16",
                   kv_cache_quant="FP8", **LLM_KW)
    finally:
        del os.environ["TLLM_KV_BOOKKEEPING"]
    params = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
    cfg = ModelConfig(**SHAPE, quant=QuantConfig(
        quant_algo=QuantAlgo.W4A16, kv_cache_quant_algo=KvCacheQuantAlgo.FP8))
    yield jl, params, cfg
    jl.shutdown()


def _assert_greedy_or_tie(cfg, params, prompts, want, got, kv="FP8"):
    exact = 0
    for p, a, b in zip(prompts, want, got):
        assert len(b) == len(a)
        if a == b:
            exact += 1
            continue
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        logits = port_logits(cfg, params, p + a[:i], kv_quant=kv)
        top = logits.max()
        assert logits[a[i]] >= top - TIE and logits[b[i]] >= top - TIE, (
            f"token {i} differs without a near-tie: jax {a[i]} "
            f"({logits[a[i]]}), port {b[i]} ({logits[b[i]]}), top {top}")
    return exact


def _prompts(seed=1):
    rng = np.random.RandomState(seed)
    base = [int(t) for t in rng.randint(1, 255, 40)]
    return [base + [3, 4], [int(t) for t in rng.randint(1, 255, 17)],
            base + [9], [int(t) for t in rng.randint(1, 255, 70)]]


def test_generate_fp8_kv_matches_jax_greedy(w4_fp8):
    jl, params, cfg = w4_fp8
    assert np.asarray(jl.engine.kv_caches[0][0]).dtype == ml_dtypes.float8_e4m3fn
    prompts = _prompts()
    sp = dict(max_tokens=10, temperature=0.0, ignore_eos=True)
    jout = jax_generate(jl, prompts, J.SamplingParams(**sp))
    tl = T.LLM(model=cfg, device="cpu", params=params, kv_cache_quant="FP8",
               **LLM_KW)
    try:
        assert tl.engine.kv_caches[0][0].dtype == torch.float8_e4m3fn
        tout = [o.outputs[0].token_ids for o in tl.generate(
            prompts, T.SamplingParams(**sp))]
        stats = tl.get_kv_cache_stats()
    finally:
        tl.shutdown()
    assert stats["reused_blocks"] > 0
    assert _assert_greedy_or_tie(cfg, params, prompts, jout, tout) >= 2


def test_beams_over_fp8_pools_match_jax(w4_fp8):
    """Beam forks copy e4m3 pages (as bytes) and the beams equal the JAX
    `LLM`'s over its FP8 pools."""
    jl, params, cfg = w4_fp8
    kw = dict(use_beam_search=True, temperature=0.0, ignore_eos=True,
              max_tokens=6, n=2, best_of=3)
    prompt = [7, 3, 7, 3, 11, 5, 9, 2, 4, 6]
    want = jl.generate([prompt], J.SamplingParams(**kw))[0].outputs
    tl = T.LLM(model=cfg, device="cpu", params=params, kv_cache_quant="FP8",
               **LLM_KW)
    try:
        got = tl.generate([prompt], T.SamplingParams(**kw))[0].outputs
        free = tl.get_kv_cache_stats()["free_blocks"]
    finally:
        tl.shutdown()
    assert free > 0
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        assert abs(g.cumulative_logprob - w.cumulative_logprob) <= 1e-3


def test_ngram_speculation_over_fp8_pools(w4_fp8):
    """NGram verify chunks attend FP8 pools through the prefill path; the
    committed tokens are the plain greedy run's (first differing, if at
    all, at a near-tie)."""
    _, params, cfg = w4_fp8
    base = [5, 6, 7, 8, 9, 10, 11, 12]
    prompts = [base * 3, [3, 4, 5, 3, 4, 5, 3, 4, 5, 3]]
    sp = T.SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)
    plain = T.LLM(model=cfg, device="cpu", params=params,
                  kv_cache_quant="FP8", **LLM_KW)
    spec = T.LLM(model=cfg, device="cpu", params=params, kv_cache_quant="FP8",
                 speculative_config=SpeculativeConfig(
                     mode=SpeculativeMode.NGRAM, max_draft_len=3), **LLM_KW)
    try:
        want = [o.outputs[0].token_ids for o in plain.generate(prompts, sp)]
        got = [o.outputs[0].token_ids for o in spec.generate(prompts, sp)]
        stats = dict(spec.executor.spec_stats)
    finally:
        plain.shutdown()
        spec.shutdown()
    assert stats["rounds"] > 0 and stats["proposed"] > 0, stats
    _assert_greedy_or_tie(cfg, params, prompts, want, got)


def test_host_tier_roundtrip_over_fp8_pools(w4_fp8):
    """Evicted FP8 blocks go to the host tier as bytes and come back: the
    onboarded prompt decodes the cold run's tokens."""
    _, params, cfg = w4_fp8
    llm = T.LLM(model=cfg, device="cpu", params=params, kv_cache_quant="FP8",
                **dict(LLM_KW, kv_num_blocks=24),
                kv_host_cache_blocks=64)
    sp = T.SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True)
    prompt = [(7 * i + 3) % 251 + 1 for i in range(33)]
    try:
        first = llm.generate([prompt], sp)[0].outputs[0].token_ids
        for i in range(5):
            llm.generate([[(i * 31 + j) % 251 + 1 for j in range(60)]],
                         T.SamplingParams(max_tokens=2, ignore_eos=True))
        assert llm.get_kv_cache_stats()["offloaded_blocks"] > 0
        again = llm.generate([prompt], sp)[0].outputs[0].token_ids
        st = llm.get_kv_cache_stats()
        host = next(iter(llm.kv_manager.host_cache.values()))
    finally:
        llm.shutdown()
    assert st["onboarded_blocks"] >= 2, st
    assert again == first
    assert any(t.dtype == torch.float8_e4m3fn for layer in host
               for t in tdp.leaves(layer))


def test_disagg_transfer_over_fp8_pools_reads_in_jax(w4_fp8):
    """A context-only request over FP8 pools: its payload bytes name the
    leaves "float8_e4m3fn" and JAX's `payload_from_bytes` reads the same
    pages; the generation worker injects them and decodes the tokens of a
    single `LLM`."""
    _, params, cfg = w4_fp8
    prompt = [int(t) for t in np.random.RandomState(4).randint(1, 255, 29)]
    sp = T.SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
    ctx = T.LLM(model=cfg, device="cpu", params=params, kv_cache_quant="FP8",
                **LLM_KW)
    gen = T.LLM(model=cfg, device="cpu", params=params, kv_cache_quant="FP8",
                **LLM_KW)
    try:
        want = ctx.generate([prompt], sp)[0].outputs[0].token_ids
        _, dp = ctx.generate_context_only(prompt, sp)
        blob = tdp.payload_to_bytes(dp.kv_payload)
        jp = jdp.payload_from_bytes(blob)
        port = tdp.payload_from_bytes(blob)
        assert len(jp["layers"]) == len(port["layers"]) == SHAPE["num_layers"]
        for jl_, pl_ in zip(jp["layers"], port["layers"]):
            for a, b in zip(jax.tree.leaves(jl_), tdp.leaves(pl_)):
                assert np.asarray(a).dtype == ml_dtypes.float8_e4m3fn
                assert b.dtype == torch.float8_e4m3fn
                np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                              _bytes(b))
        got = gen.generate_async(
            prompt, sp, disaggregated_params=DisaggregatedParams(
                request_type="generation_only",
                first_gen_tokens=dp.first_gen_tokens,
                kv_payload=port)).result().outputs[0].token_ids
    finally:
        ctx.shutdown()
        gen.shutdown()
    assert got == want
