"""The port's host KV tier and connector (`runtime/kv_cache_manager.py`)
against the JAX package's specs `tests/test_kv_offload.py` and
`tests/test_kv_connector.py`, on both bookkeeping backends.

* Manager level: a fake page pool stands in for the engine's extract and
  inject, so that what was offloaded, saved and onboarded is checkable;
  the same operations drive the JAX manager (its Python backend), and the
  counters, matches and host-cache sizes agree.
* Serving level: a tiny `LLM(device="cpu")` whose pool is too small to
  keep a prompt's blocks across filler requests decodes the prompt again
  through onboarded blocks (host tier, connector) with the cold tokens.
* The ``removed`` KV events: a content that moves to the host tier or the
  connector stays matchable and gets none; one that leaves every tier gets
  one.  A failing connector never ends the executor loop.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tensorrt_llm_tpu.runtime import kv_cache_manager as jkv
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.models import ModelConfig
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
    KVCacheConfig, KVCacheManager, KvCacheConnector, _whash)

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ["python", "native"]


def _mgr(num_blocks=16, block_size=4, host_blocks=8, backend="python",
         **kw):
    cfg = KVCacheConfig(block_size=block_size, num_blocks=num_blocks,
                        enable_block_reuse=True,
                        host_cache_blocks=host_blocks, bookkeeping=backend,
                        **kw)
    return KVCacheManager(cfg, num_layers=1, num_kv_heads=1, head_dim=4,
                          num_blocks=num_blocks, device="cpu")


def _jax_mgr(num_blocks=16, block_size=4, host_blocks=8, **kw):
    cfg = jkv.KVCacheConfig(block_size=block_size, num_blocks=num_blocks,
                            enable_block_reuse=True,
                            host_cache_blocks=host_blocks, **kw)
    return jkv.KVCacheManager(cfg, num_layers=1, num_kv_heads=1, head_dim=4,
                              num_blocks=num_blocks, bookkeeping="python")


class FakePagePool:
    """The engine's extract/inject over one numpy 'pool' whose rows are
    block contents."""

    def __init__(self, num_blocks, width=6):
        self.pool = np.zeros((num_blocks, width), np.float32)

    def extract(self, block_ids):
        return [np.array(self.pool[list(block_ids)])]

    def inject(self, block_ids, payload):
        self.pool[list(block_ids)] = payload[0]


class DictConnector(KvCacheConnector):
    def __init__(self):
        self.store = {}
        self.saves = 0
        self.loads = 0

    def save(self, key, payload):
        self.saves += 1
        self.store[key] = [np.array(p) if isinstance(p, np.ndarray)
                           else p for p in payload]

    def load(self, key):
        p = self.store.get(key)
        if p is not None:
            self.loads += 1
        return p


def _both(backend, connector=False, **kw):
    """(port manager, JAX manager, their fake pools), block io attached,
    each with a `DictConnector` of its own when `connector`."""
    out = []
    for make in (lambda **k: _mgr(backend=backend, **k), _jax_mgr):
        if connector:
            kw["kv_connector"] = DictConnector()
        kv = make(**kw)
        pages = FakePagePool(kv.num_blocks)
        kv.attach_block_io(pages.extract, pages.inject)
        out.append((kv, pages))
    return out


def _counters(kv):
    return (kv.num_offloaded, kv.num_onboarded, len(kv.host_cache),
            kv.num_connector_saves, kv.num_connector_loads)


@pytest.mark.parametrize("backend", BACKENDS)
def test_offload_and_onboard_roundtrip(backend):
    bs = 4
    for kv, pages in _both(backend, num_blocks=8, block_size=bs,
                           host_blocks=8):
        prompt = list(range(100, 100 + 2 * bs + 1))
        assert kv.add_sequence(1, prompt) == 0
        kv.grow_sequence(1, len(prompt))
        for b in kv.block_table(1, 3):
            pages.pool[b] = b
        kv.seal_full_blocks(1, prompt)
        kv.free_sequence(1)
        filler = list(range(500, 500 + 7 * bs))
        kv.add_sequence(2, filler)
        kv.grow_sequence(2, len(filler))
        assert kv.num_offloaded == 2
        assert kv.stats()["host_cached_blocks"] == 2
        saved = sorted(float(p[0][0][0]) for p in kv.host_cache.values())
        kv.free_sequence(2)
        assert kv.add_sequence(3, prompt) == 2 * bs
        assert kv.num_onboarded == 2
        got = sorted(float(pages.pool[b][0]) for b in kv.block_table(3, 2))
        assert got == saved, "onboarded blocks hold the offloaded pages"
        kv.free_sequence(3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_match_prefix_counts_host_tier(backend):
    bs = 4
    for kv, _ in _both(backend, num_blocks=8, block_size=bs, host_blocks=8):
        prompt = list(range(7, 7 + 2 * bs + 1))
        kv.add_sequence(1, prompt)
        kv.grow_sequence(1, len(prompt))
        kv.seal_full_blocks(1, prompt)
        kv.free_sequence(1)
        assert kv.match_prefix(prompt) == 2 * bs
        filler = list(range(900, 900 + 7 * bs))
        kv.add_sequence(2, filler)
        kv.grow_sequence(2, len(filler))
        kv.free_sequence(2)
        assert kv.match_prefix(prompt) == 2 * bs     # the host tier now
        assert kv.match_prefix(prompt, cache_salt="other") == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_priority_eviction_order(backend):
    bs = 4
    for kv in (_mgr(num_blocks=7, block_size=bs, host_blocks=0,
                    backend=backend),
               _jax_mgr(num_blocks=7, block_size=bs, host_blocks=0)):
        pa = list(range(10, 10 + bs + 1))
        kv.add_sequence(1, pa)
        kv.set_seq_priority(1, 80)
        kv.grow_sequence(1, len(pa))
        kv.seal_full_blocks(1, pa)
        kv.free_sequence(1)
        pb = list(range(40, 40 + bs + 1))
        kv.add_sequence(2, pb)
        kv.set_seq_priority(2, 10)
        kv.grow_sequence(2, len(pb))
        kv.seal_full_blocks(2, pb)
        kv.free_sequence(2)
        pc = list(range(70, 70 + 5 * bs))
        kv.add_sequence(3, pc)
        kv.grow_sequence(3, len(pc))
        assert kv.match_prefix(pa) == bs
        assert kv.match_prefix(pb) == 0
        kv.grow_sequence(3, len(pc) + bs)
        assert kv.match_prefix(pa) == 0
        kv.free_sequence(3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_onboard_stops_at_device_capacity(backend):
    bs = 4
    for kv, _ in _both(backend, num_blocks=5, block_size=bs, host_blocks=8):
        prompt = list(range(0, 3 * bs + 1))
        kv.add_sequence(1, prompt)
        kv.grow_sequence(1, len(prompt))
        kv.seal_full_blocks(1, prompt)
        kv.free_sequence(1)
        filler = list(range(200, 200 + 4 * bs))
        kv.add_sequence(2, filler)
        kv.grow_sequence(2, len(filler))
        assert kv.num_offloaded >= 3
        matched = kv.add_sequence(3, prompt)   # the filler holds the pool
        assert matched < 3 * bs
        kv.free_sequence(3)
        kv.free_sequence(2)


@pytest.mark.parametrize("backend", BACKENDS)
def test_secondary_offload_min_priority_gate(backend):
    bs = 4
    for kv, _ in _both(backend, num_blocks=8, block_size=bs, host_blocks=8,
                       secondary_offload_min_priority=50):
        def run_seq(seq_id, prompt, priority):
            kv.add_sequence(seq_id, prompt)
            kv.set_seq_priority(seq_id, priority)
            kv.grow_sequence(seq_id, len(prompt))
            kv.seal_full_blocks(seq_id, prompt)
            kv.free_sequence(seq_id)

        run_seq(1, list(range(100, 100 + 2 * bs + 1)), priority=10)
        filler = list(range(500, 500 + 7 * bs))
        kv.add_sequence(2, filler)
        kv.grow_sequence(2, len(filler))
        assert kv.num_offloaded == 0
        kv.free_sequence(2)
        run_seq(3, list(range(900, 900 + 2 * bs + 1)), priority=80)
        filler2 = list(range(700, 700 + 7 * bs))
        kv.add_sequence(4, filler2)
        kv.grow_sequence(4, len(filler2))
        assert kv.num_offloaded == 2
        kv.free_sequence(4)


def _seed_and_churn(kv, pages, prompt, bs):
    assert kv.add_sequence(1, prompt) == 0
    kv.grow_sequence(1, len(prompt))
    for b in kv.block_table(1, 3):
        pages.pool[b] = b
    kv.seal_full_blocks(1, prompt)
    kv.free_sequence(1)
    filler = list(range(500, 500 + 7 * bs))
    kv.add_sequence(2, filler)
    kv.grow_sequence(2, len(filler))
    kv.free_sequence(2)


@pytest.mark.parametrize("backend", BACKENDS)
def test_connector_save_and_load_without_host_tier(backend):
    bs = 4
    counters = []
    for kv, pages in _both(backend, num_blocks=8, block_size=bs,
                           host_blocks=0, connector=True):
        conn = kv.cfg.kv_connector
        prompt = list(range(100, 100 + 2 * bs + 1))
        _seed_and_churn(kv, pages, prompt, bs)
        assert conn.saves == 2 and len(conn.store) == 2
        assert kv.stats()["host_cached_blocks"] == 0
        assert kv.add_sequence(3, prompt) == 2 * bs
        assert conn.loads == 2 and kv.stats()["connector_loads"] == 2
        got = sorted(float(pages.pool[b][0]) for b in kv.block_table(3, 2))
        want = sorted(float(p[0][0][0]) for p in conn.store.values())
        assert got == want
        counters.append(_counters(kv))
    assert counters[0] == counters[1]


@pytest.mark.parametrize("backend", BACKENDS)
def test_connector_behind_host_tier(backend):
    bs = 4
    for kv, pages in _both(backend, num_blocks=8, block_size=bs,
                           host_blocks=1, connector=True):
        conn = kv.cfg.kv_connector
        prompt = list(range(100, 100 + 2 * bs + 1))
        _seed_and_churn(kv, pages, prompt, bs)
        assert kv.stats()["host_cached_blocks"] == 1
        assert len(conn.store) == 2
        assert kv.add_sequence(3, prompt) == 2 * bs
        assert conn.loads >= 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_match_prefix_counts_connector(backend):
    bs = 4
    for kv, pages in _both(backend, num_blocks=8, block_size=bs,
                           host_blocks=0, connector=True):
        prompt = list(range(100, 100 + 2 * bs + 1))
        _seed_and_churn(kv, pages, prompt, bs)
        assert kv.match_prefix(prompt) == 2 * bs
        assert kv.match_prefix(list(range(900, 909))) == 0


def test_stable_whash_across_processes():
    """Connector keys are process-stable and equal to the JAX package's."""
    code = ("from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import "
            "_whash; print(_whash(0, (1, 2, 3), 'salt'), "
            "_whash(7, (9,), None))")
    outs = {subprocess.run([sys.executable, "-c", code],
                           capture_output=True, text=True,
                           env=dict(os.environ, PYTHONHASHSEED=str(seed),
                                    PYTHONPATH=str(ROOT)),
                           cwd=str(ROOT)).stdout.strip()
            for seed in (1, 2)}
    assert len(outs) == 1 and "" not in outs, outs
    want = (f"{jkv.KVCacheManager._whash(0, (1, 2, 3), 'salt')} "
            f"{jkv.KVCacheManager._whash(7, (9,), None)}")
    assert outs == {want}
    assert _whash(7, (9,), None) == jkv.KVCacheManager._whash(7, (9,), None)


@pytest.mark.parametrize("backend", BACKENDS)
def test_removed_events_only_past_every_tier(backend):
    """A content offloaded to the host tier stays matchable (no removed
    event); trimmed from a full host cache, it is gone (one removed event);
    with a connector behind the host, even the trim is not an exit."""
    bs = 4
    kv, pages = _both(backend, num_blocks=8, block_size=bs,
                      host_blocks=1)[0]
    prompt = list(range(100, 100 + 2 * bs + 1))
    _seed_and_churn(kv, pages, prompt, bs)
    removed = [e["block_hash"] for e in kv.get_events()
               if e["type"] == "removed"]
    stored = [e["block_hash"] for e in kv.get_events()
              if e["type"] == "stored"]
    # two blocks left the device, one is still in the one-block host cache
    assert len(removed) == 1 and removed[0] in stored[:2]
    assert set(kv.reuse_block_hashes()) >= set(kv.host_cache)
    kv2, pages2 = _both(backend, num_blocks=8, block_size=bs, host_blocks=1,
                        connector=True)[0]
    _seed_and_churn(kv2, pages2, prompt, bs)
    assert not [e for e in kv2.get_events() if e["type"] == "removed"]
    kv3, pages3 = _both(backend, num_blocks=8, block_size=bs,
                        host_blocks=0)[0]
    _seed_and_churn(kv3, pages3, prompt, bs)   # no tier: both are removed
    assert len([e for e in kv3.get_events() if e["type"] == "removed"]) == 2


CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
           max_position=256)


def _llm(backend, **kw):
    return T.LLM(model=ModelConfig(**CFG), device="cpu",
                 skip_tokenizer_init=True, max_seq_len=128,
                 max_batch_size=4, kv_block_size=4, seed=5,
                 kv_bookkeeping=backend, **kw)


@pytest.mark.parametrize("backend", BACKENDS)
def test_e2e_decode_parity_through_host_tier(backend):
    """Evict a prompt's KV to the host, onboard it back, and decode the
    cold run's greedy tokens; the prefill runs only the tail."""
    llm = _llm(backend, kv_num_blocks=24, kv_host_cache_blocks=96)
    sp = T.SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
    prompt = [(7 * i + 3) % 128 for i in range(13)]
    try:
        first = llm.generate([prompt], sp)[0].outputs[0].token_ids
        for i in range(6):
            llm.generate([[(i * 31 + j) % 128 for j in range(40)]],
                         T.SamplingParams(max_tokens=2, ignore_eos=True))
        assert llm.get_kv_cache_stats()["offloaded_blocks"] > 0
        it0 = llm.executor.iteration
        again = llm.generate([prompt], sp)[0]
        st = llm.get_kv_cache_stats()
        tail = sum(s["num_prefill_tokens"] for s in llm.get_stats()
                   if s["iteration"] > it0)
    finally:
        llm.shutdown()
    assert st["onboarded_blocks"] >= 3
    assert tail == 1          # 3 blocks onboarded, the last token computed
    assert again.outputs[0].token_ids == first


@pytest.mark.parametrize("backend", BACKENDS)
def test_e2e_connector_decode_parity(backend):
    conn = DictConnector()
    llm = _llm(backend, kv_num_blocks=12, kv_connector=conn)
    sp = T.SamplingParams(max_tokens=4, ignore_eos=True, temperature=0.0)
    prompt = list(range(3, 3 + 9))
    try:
        cold = llm.generate([prompt], sp)[0].outputs[0].token_ids
        llm.generate([list(range(40 + 8 * i, 48 + 8 * i))
                      for i in range(4)], sp)
        again = llm.generate([prompt], sp)[0].outputs[0].token_ids
        st = llm.get_kv_cache_stats()
    finally:
        llm.shutdown()
    assert conn.saves > 0 and st["connector_loads"] > 0, st
    assert again == cold


@pytest.mark.parametrize("backend", BACKENDS)
def test_connector_failures_do_not_break_serving(backend):
    class Flaky(KvCacheConnector):
        def save(self, key, payload):
            raise IOError("store down")

        def load(self, key):
            raise IOError("store down")

        def contains(self, key):
            raise IOError("store down")

    llm = _llm(backend, kv_num_blocks=12, kv_connector=Flaky())
    sp = T.SamplingParams(max_tokens=4, ignore_eos=True, temperature=0.0)
    prompt = list(range(3, 12))
    try:
        cold = llm.generate([prompt], sp)[0].outputs[0].token_ids
        llm.generate([list(range(40 + 8 * i, 48 + 8 * i))
                      for i in range(4)], sp)
        again = llm.generate([prompt], sp)[0].outputs[0].token_ids
        assert again == cold
        assert llm.match_kv_prefix(prompt) >= 0
        st = llm.get_kv_cache_stats()
        assert st["connector_saves"] == 0 and st["connector_loads"] == 0
        assert llm.executor._error is None
    finally:
        llm.shutdown()
