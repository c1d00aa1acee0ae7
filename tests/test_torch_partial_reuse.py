"""Port partial tail-block KV reuse (`KVCacheConfig.enable_partial_reuse`
/ `copy_on_partial_reuse`): after the full-block match, a cached block
sharing a token prefix with the prompt's next tokens serves those tokens,
copied into a fresh block (the source stays cached) or adopted in place
when unreferenced.  Mirrors the JAX package's `tests/test_partial_reuse.py`
without its host tier, on both port backends and the JAX package's
`_PyBookkeeping`, plus the engine's page copy over every pool kind and an
exact end-to-end greedy decode.
"""

import random
import threading
import types

import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.runtime.kv_cache_manager import (
    _PyBookkeeping as JaxPyBookkeeping)
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch import native
from tensorrt_llm_tpu_torch.models import ModelConfig
from tensorrt_llm_tpu_torch.quantization.mode import KvCacheQuantAlgo
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
    KVCacheConfig, KVCacheManager, _NativeBookkeeping, _PyBookkeeping,
    make_pools)
from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine

BS = 4


def backends(num_blocks=64):
    return [JaxPyBookkeeping(num_blocks, BS, True),
            _PyBookkeeping(num_blocks, BS, True),
            _NativeBookkeeping(native.load_native(), num_blocks, BS, True)]


def seed_chain(bk, seq_id, toks):
    bk.add_sequence(seq_id, toks)
    bk.grow_sequence(seq_id, len(toks))
    bk.seal_full_blocks(seq_id, toks)


def test_partial_match_copy():
    for bk in backends():
        base = [1, 2, 3, 4, 10, 11, 12, 13]
        seed_chain(bk, 1, base)
        src_b1 = bk.block_table(1, 2)[1]
        probe = [1, 2, 3, 4, 10, 11, 99, 98, 97]
        assert bk.add_sequence(2, probe) == BS
        k, src, dst = bk.try_partial_match(2, probe)
        assert (k, src) == (2, src_b1)
        assert dst != src and dst > 0
        assert bk.block_table(2, 2)[1] == dst
        assert bk.slot_mapping(2, 6, 1) == [dst * BS + 2]
        assert bk.stats()["partial_reused_blocks"] == 1
        # the source stays in the reuse index
        assert bk.add_sequence(3, base + [7]) == 2 * BS


def test_partial_match_picks_longest_candidate():
    for bk in backends():
        seed_chain(bk, 1, [1, 2, 3, 4, 10, 11, 12, 13])
        seed_chain(bk, 2, [1, 2, 3, 4, 10, 99, 98, 97])
        probe = [1, 2, 3, 4, 10, 11, 12, 50, 51]
        bk.add_sequence(3, probe)
        k, src, _ = bk.try_partial_match(3, probe)
        assert k == 3 and src == bk.block_table(1, 2)[1]


def test_partial_match_keeps_one_token_uncached():
    for bk in backends():
        seed_chain(bk, 1, [1, 2, 3, 4, 10, 11, 12, 13])
        probe = [1, 2, 3, 4, 10, 11, 12]
        bk.add_sequence(2, probe)
        assert bk.try_partial_match(2, probe)[0] == 2


def test_partial_adopt_in_place():
    for bk in backends():
        base = [1, 2, 3, 4, 10, 11, 12, 13]
        seed_chain(bk, 1, base)
        src_b1 = bk.block_table(1, 2)[1]
        bk.free_sequence(1)
        probe = [1, 2, 3, 4, 10, 11, 99, 98]
        bk.add_sequence(2, probe)
        assert bk.try_partial_match(2, probe, copy_on_partial=False) == (
            2, src_b1, src_b1)
        assert bk.add_sequence(3, base + [7]) == BS   # it left the index


def test_partial_adopt_refuses_referenced_source():
    for bk in backends():
        seed_chain(bk, 1, [1, 2, 3, 4, 10, 11, 12, 13])
        probe = [1, 2, 3, 4, 10, 11, 99, 98]
        bk.add_sequence(2, probe)
        assert bk.try_partial_match(2, probe, copy_on_partial=False) == (
            0, -1, -1)


def test_partial_eviction_forgets_candidate():
    for bk in backends():
        seed_chain(bk, 1, [1, 2, 3, 4, 10, 11, 12, 13])
        bk.free_sequence(1)
        for i in range(63):
            bk.add_sequence(100 + i, [1000 + i])
            bk.grow_sequence(100 + i, 1)
        probe = [1, 2, 3, 4, 10, 11, 99, 98]
        bk.add_sequence(2, probe)
        assert bk.try_partial_match(2, probe)[0] == 0


def test_match_prefix_partial_dry_run():
    for bk in backends():
        seed_chain(bk, 1, [1, 2, 3, 4, 10, 11, 12, 13])
        probe = [1, 2, 3, 4, 10, 11, 99, 98]
        assert bk.match_prefix(probe) == BS
        assert bk.match_prefix(probe, partial=True) == BS + 2
        assert bk.match_prefix(probe, partial=True) == BS + 2


@pytest.mark.parametrize("seed", [11, 12])
def test_three_way_parity_randomized(seed):
    rng = random.Random(seed)
    bks = backends(32)
    live = []
    next_id = 1
    for step in range(300):
        op = rng.random()
        if (op < 0.5 and len(live) < 6) or not live:
            toks = [rng.randrange(4) for _ in range(rng.randrange(1, 14))]
            assert len({bk.add_sequence(next_id, toks) for bk in bks}) == 1
            cop = rng.random() < 0.7
            got = {bk.try_partial_match(next_id, toks, copy_on_partial=cop)
                   for bk in bks}
            assert len(got) == 1, (step, got)
            for bk in bks:
                bk.grow_sequence(next_id, len(toks))
                bk.seal_full_blocks(next_id, toks)
            live.append((next_id, toks))
            next_id += 1
        else:
            sid, _ = live.pop(rng.randrange(len(live)))
            for bk in bks:
                bk.free_sequence(sid)
        assert all(bk.stats() == bks[0].stats() for bk in bks), step
    for sid, _ in live:
        assert all(bk.block_table(sid, 8) == bks[0].block_table(sid, 8)
                   for bk in bks)
    assert bks[0].stats()["partial_reused_blocks"] > 0


@pytest.mark.parametrize("backend", ["native", "python"])
def test_manager_records_copy_pairs(backend):
    kv = KVCacheManager(KVCacheConfig(block_size=BS, bookkeeping=backend),
                        1, 1, 8, 32, "cpu")
    base = [1, 2, 3, 4, 10, 11, 12, 13, 9]
    kv.add_sequence(1, base)
    kv.grow_sequence(1, len(base))
    kv.seal_full_blocks(1, base)
    probe = [1, 2, 3, 4, 10, 11, 99, 98]
    assert kv.add_sequence(2, probe) == BS + 2
    pairs = kv.drain_partial_copies(2)
    assert len(pairs) == 1 and pairs[0][0] != pairs[0][1]
    assert kv.drain_partial_copies(2) == []
    assert kv.stats()["partial_reused_blocks"] == 1
    off = KVCacheManager(KVCacheConfig(block_size=BS, bookkeeping=backend,
                                       enable_partial_reuse=False),
                         1, 1, 8, 32, "cpu")
    off.add_sequence(1, base)
    off.grow_sequence(1, len(base))
    off.seal_full_blocks(1, base)
    assert off.add_sequence(2, probe) == BS
    assert off.drain_partial_copies(2) == []


@pytest.mark.parametrize("kind", ["bf16", "int8", "latent", "dsa"])
def test_copy_kv_blocks_every_pool(kind):
    """The engine copies whole pages src -> dst in every pool of every
    layer: bf16 K/V, INT8 data and scales, the MLA latent pool and the DSA
    indexer pool; other blocks stay as they were."""
    kw = dict(num_layers=2, num_blocks=6, num_kv_heads=2, block_size=BS,
              head_dim=8, device="cpu")
    if kind == "int8":
        kw["kv_quant"] = KvCacheQuantAlgo.INT8
    if kind in ("latent", "dsa"):
        kw.update(num_kv_heads=1, layout="latent",
                  dsa_index_dim=16 if kind == "dsa" else 0)
    pools = make_pools(**kw)
    gen = torch.Generator().manual_seed(0)
    leaves = []

    def fill(c):
        if isinstance(c, (tuple, list)):
            for x in c:
                fill(x)
        else:
            c.copy_((torch.randn(c.shape, generator=gen) * 50).to(c.dtype))
            leaves.append(c)

    fill(pools)
    before = [t.clone() for t in leaves]
    eng = types.SimpleNamespace(kv_caches=pools, device=torch.device("cpu"),
                                lock=threading.Lock())
    ModelEngine.copy_kv_blocks(eng, [(1, 4), (2, 5)])
    for t, b in zip(leaves, before):
        assert torch.equal(t[4], b[1]) and torch.equal(t[5], b[2])
        assert torch.equal(t[:4], b[:4])


def _llm(**kw):
    cfg = ModelConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                      max_position=256)
    return T.LLM(model=cfg, device="cpu", skip_tokenizer_init=True,
                 max_seq_len=128, max_batch_size=8, kv_num_blocks=64,
                 kv_block_size=4, seed=3, **kw)


@pytest.mark.parametrize("copy", [True, False])
def test_e2e_partial_reuse_exact_decode(copy):
    """Greedy decode with partial reuse equals decode with reuse off:
    the copied (or adopted) page and the prefill resumed mid-block give
    the same tokens."""
    sp = T.SamplingParams(max_tokens=8, ignore_eos=True, temperature=0.0)
    first = [5, 6, 7, 8, 20, 21, 22, 23, 30, 31]
    second = [5, 6, 7, 8, 20, 21, 40, 41, 42, 43]
    llm = _llm(copy_on_partial_reuse=copy)
    try:
        out_first = llm.generate([first], sp)[0].outputs[0].token_ids
        st0 = llm.get_kv_cache_stats()
        res = llm.generate([second], sp)[0]
        st1 = llm.get_kv_cache_stats()
    finally:
        llm.shutdown()
    assert st1["partial_reused_blocks"] > st0["partial_reused_blocks"]
    assert res.outputs[0].token_ids and res.prompt_token_ids == second
    ref = _llm(enable_block_reuse=False)
    try:
        ref_first = ref.generate([first], sp)[0].outputs[0].token_ids
        ref_second = ref.generate([second], sp)[0].outputs[0].token_ids
        assert ref.get_kv_cache_stats()["partial_reused_blocks"] == 0
    finally:
        ref.shutdown()
    assert out_first == ref_first
    assert res.outputs[0].token_ids == ref_second


def test_e2e_partial_reuse_cached_tokens():
    """The request's cached-token count includes the partial block's head
    tokens, so its first prefill chunk starts mid-block."""
    sp = T.SamplingParams(max_tokens=2, ignore_eos=True, temperature=0.0)
    llm = _llm(return_perf_metrics=True)
    try:
        llm.generate([[9, 8, 7, 6, 5, 4, 3, 2, 1]], sp)
        out = llm.generate([[9, 8, 7, 6, 5, 4, 77, 78, 79]], sp)[0]
    finally:
        llm.shutdown()
    assert out.metrics["kv_cache_hit_tokens"] == 6
    assert np.all(np.asarray(out.outputs[0].token_ids) >= 0)
