"""Port parity: the INT8 KV cache (int8 pages, f32 scale per (token, head))
and the W4A8_AWQ + INT8 KV serving slice against the JAX package.

The same numpy inputs go through the port's ops (CPU tensors take the plain
versions) and JAX's: `quantize_kv_token`, `write_kv_cache` on tuple pools,
the plain paged attention over int8 pools against JAX's int8 Pallas kernels
in interpret mode (D 128, as the JAX package's own tests run them) and its
XLA references, the KV manager's pools, and a tiny `LLM.generate`.

Tolerances (attention compared in f32, outputs are bf16):
* `quantize_kv_token` and `write_kv_cache`: bit for bit.
* vs the XLA references: the same math (dequantize after the gather, round
  to bf16, f32 softmax), f32 sums in another order, then one bf16 rounding
  of the output on each side: 2^-7 (two ulps) of the largest output.
* vs the Pallas kernels: they fold the scales into the logits and the
  probabilities instead of dequantizing, and round q and the scaled
  probabilities to bf16 before the MXU products: 2e-2 absolute and
  relative, as the JAX package's own int8 kernel tests use, scaled by the
  largest output when it exceeds 1.
* `LLM.generate`: greedy tokens equal, with `tests/test_torch_llm.py`'s
  near-tie rule for a token that differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.ops import attention_xla as jx
from tensorrt_llm_tpu.ops.flash_prefill import (
    flash_prefill_attention as jax_prefill)
from tensorrt_llm_tpu.ops.paged_attention import (
    paged_decode_attention as jax_decode)
from tensorrt_llm_tpu.runtime.kv_cache_manager import (
    KVCacheManager as JKVManager)
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax
from tensorrt_llm_tpu_torch.ops.attention_plain import (
    gather_dequant, quantize_kv_token, write_kv_cache)
from tensorrt_llm_tpu_torch.ops.flash_prefill import flash_prefill_attention
from tensorrt_llm_tpu_torch.ops.paged_attention import paged_decode_attention
from tensorrt_llm_tpu_torch.quantization import (
    KvCacheQuantAlgo, QuantAlgo, QuantConfig)
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
    KVCacheConfig, KVCacheManager)

from torch_parity import jax_generate, port_logits


def _t(a):
    """numpy / JAX (possibly bf16) -> torch, keeping bf16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape, dtype=np.float32) * scale
                       ).astype(jnp.bfloat16)


def _close(out, ref, kernel):
    out = out.to(torch.float32).numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    big = max(1.0, float(np.abs(ref).max()))
    if kernel:
        np.testing.assert_allclose(out, ref, atol=2e-2 * big, rtol=2e-2)
    else:
        np.testing.assert_allclose(out, ref, atol=2.0 ** -7 * big, rtol=0)


def _int8_pools(rng, seqs, Hkv, D, BS, MB):
    """JAX int8 pools filled through the JAX append path, one shuffled
    block table row per sequence length in `seqs`."""
    NB = len(seqs) * MB + 1
    zero = lambda: (jnp.zeros((NB, Hkv, BS, D), jnp.int8),  # noqa: E731
                    jnp.zeros((NB, Hkv, BS), jnp.float32))
    kc, vc = zero(), zero()
    ids = rng.permutation(np.arange(1, NB)).astype(np.int32)
    tables = ids[:len(seqs) * MB].reshape(len(seqs), MB)
    for b, n in enumerate(seqs):
        pos = np.arange(n)
        slots = jnp.asarray(tables[b][pos // BS] * BS + pos % BS)
        kc, vc = jx.write_kv_cache(kc, vc, _bf16(rng, (n, Hkv, D), 1 + b),
                                   _bf16(rng, (n, Hkv, D)), slots)
    return kc, vc, tables


def _port_pool(c):
    return tuple(_t(a) for a in c)


@pytest.mark.parametrize("T_,H,D,seed", [(5, 2, 64, 0), (9, 4, 128, 1),
                                         (1, 8, 32, 2)])
def test_quantize_kv_token_bit_exact(T_, H, D, seed):
    rng = np.random.default_rng(seed)
    x = np.array(_bf16(rng, (T_, H, D), 2.0).astype(jnp.float32))
    x[0, 0] = 0.0                      # an all-zero row: the 1e-8 clamp
    jq, js = jx.quantize_kv_token(jnp.asarray(x).astype(jnp.bfloat16))
    pq, ps = quantize_kv_token(_t(jnp.asarray(x).astype(jnp.bfloat16)))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_write_kv_cache_int8_bit_exact_and_reserves_page_zero():
    rng = np.random.default_rng(3)
    NB, H, BS, D = 6, 2, 8, 64

    def pools():
        return ((jnp.zeros((NB, H, BS, D), jnp.int8),
                 jnp.zeros((NB, H, BS), jnp.float32)),
                (jnp.zeros((NB, H, BS, D), jnp.int8),
                 jnp.zeros((NB, H, BS), jnp.float32)))

    k_new, v_new = _bf16(rng, (7, H, D)), _bf16(rng, (7, H, D), 3.0)
    # slots in blocks 2 and 4, plus two past the pool (-> reserved page 0)
    slots = np.array([16, 17, 23, 33, 34, NB * BS, NB * BS + 5], np.int64)
    jk, jv = jx.write_kv_cache(*pools(), k_new, v_new,
                               jnp.asarray(slots, jnp.int32))
    pk, pv = (tuple(_t(a) for a in p) for p in pools())
    write_kv_cache(pk, pv, _t(k_new), _t(v_new), torch.from_numpy(slots))
    for port, ref in ((pk, jk), (pv, jv)):
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # gather + dequantize after the gather, as the JAX package does
    idx = np.array([[2, 4], [0, 2]], np.int32)
    np.testing.assert_array_equal(
        gather_dequant(pk, torch.from_numpy(idx)).to(torch.float32).numpy(),
        np.asarray(jx.gather_dequant(jk, jnp.asarray(idx)), np.float32))


DECODE = [
    # B, Hq, Hkv, D, BS, MB, window, cap, sinks, kernel
    (2, 8, 2, 128, 16, 4, None, None, False, True),
    (3, 8, 4, 128, 8, 6, None, None, True, True),
    (2, 4, 2, 128, 16, 4, 24, None, False, True),
    (2, 8, 2, 128, 16, 4, 20, 25.0, True, True),
    (3, 8, 2, 128, 8, 6, 24, 25.0, True, False),
    (3, 8, 1, 64, 8, 6, None, None, True, False),
    (2, 4, 2, 64, 16, 4, 24, 20.0, False, False),
]


@pytest.mark.parametrize("B,Hq,Hkv,D,BS,MB,window,cap,sinks,kernel", DECODE)
def test_decode_plain_int8_matches_jax(B, Hq, Hkv, D, BS, MB, window, cap,
                                       sinks, kernel):
    rng = np.random.default_rng(B * 100 + Hq + D)
    lens = [int(rng.integers(1, MB * BS + 1)) for _ in range(B)]
    lens[0] = MB * BS                         # one full table
    kc, vc, tables = _int8_pools(rng, lens, Hkv, D, BS, MB)
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
        _t(q), _port_pool(kc), _port_pool(vc), _t(tables), _t(kv_lens),
        D ** -0.5, sliding_window=window, logit_cap=cap,
        sinks=None if sk is None else _t(sk))
    _close(out, ref, kernel)


PREFILL = [
    # T, Hq, Hkv, D, BS, MB, q_offset, window, cap, sinks, kernel
    (32, 8, 2, 128, 16, 4, 0, None, None, False, True),
    (16, 8, 2, 128, 16, 4, 24, None, None, True, True),
    (32, 8, 4, 128, 8, 8, 20, 24, None, True, True),
    (24, 8, 2, 128, 16, 4, 16, None, 30.0, False, True),
    (24, 8, 2, 128, 8, 8, 30, 24, 30.0, True, False),
    (24, 4, 2, 64, 8, 8, 8, None, None, True, False),
]


@pytest.mark.parametrize(
    "T_,Hq,Hkv,D,BS,MB,q_off,window,cap,sinks,kernel", PREFILL)
def test_prefill_plain_int8_matches_jax(T_, Hq, Hkv, D, BS, MB, q_off, window,
                                        cap, sinks, kernel):
    rng = np.random.default_rng(T_ + Hq + q_off + D)
    total = q_off + T_
    kc, vc, tables = _int8_pools(rng, [total], Hkv, D, BS, MB)
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
        _t(q), _port_pool(kc), _port_pool(vc), _t(bt), total, q_off,
        D ** -0.5, sliding_window=window, logit_cap=cap,
        sinks=None if sk is None else _t(sk))
    _close(out, ref, kernel)


def test_kv_manager_int8_pools_and_scale_bytes():
    L, Hkv, D, BS, NB = 3, 2, 64, 8, 10
    mgr = KVCacheManager(KVCacheConfig(block_size=BS,
                                       kv_quant=KvCacheQuantAlgo.INT8),
                         L, Hkv, D, NB, device="cpu")
    pools = mgr.allocate_pools()
    assert len(pools) == L
    for k, v in pools:
        for data, scale in (k, v):
            assert data.dtype == torch.int8 and data.shape == (NB, Hkv, BS, D)
            assert scale.dtype == torch.float32 and scale.shape == (NB, Hkv, BS)
    per_block = sum(t.numel() * t.element_size()
                    for kv in pools for pair in kv for t in pair) // NB
    budget = 123_456_789
    n = KVCacheManager.blocks_from_memory(budget, L, Hkv, D, BS,
                                          dtype_bytes=1, scale_pools=True)
    assert n == budget // per_block
    assert n == JKVManager.blocks_from_memory(budget, L, Hkv, D, BS,
                                              dtype_bytes=1, scale_pools=True)
    bf16 = KVCacheManager(KVCacheConfig(block_size=BS), L, Hkv, D, NB,
                          device="cpu").allocate_pools()
    assert bf16[0][0].dtype == torch.bfloat16
    # FP8 pools are e4m3 pages (tests/test_torch_fp8_kv.py); a quantized
    # latent (MLA) cache is still refused
    assert KVCacheConfig(kv_quant="FP8").kv_quant == KvCacheQuantAlgo.FP8
    with pytest.raises(NotImplementedError):
        KVCacheConfig(kv_quant="FP8", layout="latent")


SHAPE = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
             num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
             max_position=256)
LLM_KW = dict(skip_tokenizer_init=True, max_seq_len=160, max_batch_size=3,
              max_num_tokens=48, kv_num_blocks=96, kv_block_size=8,
              max_decode_steps=4)
TIE = 0.02   # ~2 bf16 ulps of the largest logits


def test_generate_w4a8_int8_kv_matches_jax_greedy(monkeypatch):
    """The tiny W4A8_AWQ + INT8 KV model: the port's `LLM.generate` on the
    CPU gives the JAX `LLM`'s greedy tokens on the same weights."""
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")
    rng = np.random.RandomState(1)
    base = [int(t) for t in rng.randint(1, 255, 40)]
    prompts = [base + [3, 4], [int(t) for t in rng.randint(1, 255, 17)],
               base + [9], [int(t) for t in rng.randint(1, 255, 70)]]
    jl = J.LLM(model=JCfg(**SHAPE), quant_algo="W4A8_AWQ",
               kv_cache_quant="INT8", **LLM_KW)
    try:
        # the JAX side runs W4A8 (zero points, f32 scales) over INT8 pools
        leaf = jl.engine.params["layers"][0]["attn"]["qkv"]
        assert "zeros" in leaf
        assert np.asarray(leaf["scales"]).dtype == np.float32
        assert isinstance(jl.engine.kv_caches[0][0], tuple)
        params = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
        jout = jax_generate(jl, prompts, J.SamplingParams(
            max_tokens=10, temperature=0.0, ignore_eos=True))
    finally:
        jl.shutdown()
    cfg = ModelConfig(**SHAPE, quant=QuantConfig(
        quant_algo=QuantAlgo.W4A8_AWQ,
        kv_cache_quant_algo=KvCacheQuantAlgo.INT8))
    tl = T.LLM(model=cfg, device="cpu", params=params, kv_cache_quant="INT8",
               **LLM_KW)
    try:
        assert isinstance(tl.engine.kv_caches[0][0], tuple)
        assert tl.model.layers[0].attn.qkv.scales.dtype == torch.float32
        tout = [o.outputs[0].token_ids for o in tl.generate(
            prompts, T.SamplingParams(max_tokens=10, temperature=0.0,
                                      ignore_eos=True))]
        stats = tl.get_kv_cache_stats()
    finally:
        tl.shutdown()
    assert stats["reused_blocks"] > 0          # reused blocks keep scales
    exact = 0
    for p, a, b in zip(prompts, jout, tout):
        assert len(b) == len(a) == 10
        if a == b:
            exact += 1
            continue
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        logits = port_logits(cfg, params, p + a[:i], kv_quant="INT8")
        top = logits.max()
        assert logits[a[i]] >= top - TIE and logits[b[i]] >= top - TIE, (
            f"token {i} differs without a near-tie: jax {a[i]} "
            f"({logits[a[i]]}), port {b[i]} ({logits[b[i]]}), top {top}")
    assert exact >= 1


def test_fp8_kv_raises():
    """FP8 KV pools serve GQA models (tests/test_torch_fp8_kv.py); on an MLA
    model, whose latent pools the JAX package never quantizes, the port
    raises."""
    from tensorrt_llm_tpu_torch.models import MOONLIGHT_16B_A3B
    llm = T.LLM(model=ModelConfig(**SHAPE), device="cpu",
                kv_cache_quant="FP8", **LLM_KW)
    try:
        assert llm.engine.kv_caches[0][0].dtype == torch.float8_e4m3fn
    finally:
        llm.shutdown()
    mla = ModelConfig.from_hf_config(dict(
        MOONLIGHT_16B_A3B["hf_config"], vocab_size=256, hidden_size=128,
        intermediate_size=256, moe_intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=4,
        n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=48,
        qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
        first_k_dense_replace=1, max_position_embeddings=256))
    with pytest.raises(NotImplementedError, match="latent"):
        T.LLM(model=mla, device="cpu", kv_cache_quant="FP8", **LLM_KW)
