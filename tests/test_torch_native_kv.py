"""Port KV bookkeeping: the native backend (`native/kv_bookkeeping.cc`
through ctypes), the port's Python backend and the JAX package's
`_PyBookkeeping` make the same decisions -- block tables, free counts,
reuse matches, evictions by retention priority -- for the same operation
sequences.  Allocation order (FIFO free list, priority buckets, LRU within
a bucket) is deterministic and independent of the hash values, so the three
are compared block id for block id.

The native library is built through the port's locked build: several
processes building it at once into an empty directory all load one
library, and a failed build raises with the compiler's output instead of
falling back to Python.
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

from tensorrt_llm_tpu.runtime.kv_cache_manager import (
    _PyBookkeeping as JaxPyBookkeeping)
from tensorrt_llm_tpu_torch import native
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
    DEFAULT_RETENTION_PRIORITY, KVCacheConfig, KVCacheManager,
    _NativeBookkeeping, _PyBookkeeping, make_bookkeeping)

ROOT = Path(__file__).resolve().parents[1]


def make_three(num_blocks=64, block_size=4, reuse=True):
    return (JaxPyBookkeeping(num_blocks, block_size, reuse),
            _PyBookkeeping(num_blocks, block_size, reuse),
            _NativeBookkeeping(native.load_native(), num_blocks, block_size,
                               reuse))


def check_same(bks, seq_ids, width=16):
    ref = bks[0]
    for bk in bks[1:]:
        assert bk.num_free_blocks() == ref.num_free_blocks()
        assert bk.stats() == ref.stats(), (bk.stats(), ref.stats())
        for sid in seq_ids:
            assert bk.num_seq_blocks(sid) == ref.num_seq_blocks(sid)
            if ref.num_seq_blocks(sid) >= 0:
                assert bk.block_table(sid, width) == \
                    ref.block_table(sid, width)


def test_basic_lifecycle_parity():
    bks = make_three()
    toks = list(range(10))
    for bk in bks:
        assert bk.add_sequence(1, toks) == 0
        bk.grow_sequence(1, 10)
        bk.seal_full_blocks(1, toks)
    check_same(bks, [1])
    for bk in bks:
        assert bk.slot_mapping(1, 0, 10) == [
            bk.block_table(1, 3)[i // 4] * 4 + i % 4 for i in range(10)]
        bk.free_sequence(1)
    check_same(bks, [1])


def test_prefix_reuse_and_salt_parity():
    bks = make_three()
    prompt = list(range(20))
    for bk in bks:
        bk.add_sequence(1, prompt, "tenant-a")
        bk.grow_sequence(1, 20)
        bk.seal_full_blocks(1, prompt)
        bk.free_sequence(1)
        assert bk.add_sequence(2, prompt) == 0            # unsalted
        assert bk.add_sequence(3, prompt, "tenant-b") == 0
        assert bk.add_sequence(4, prompt, "tenant-a") == 16
    check_same(bks, [2, 3, 4])


def test_lru_eviction_parity():
    bks = make_three(num_blocks=9, block_size=2)     # 8 usable blocks
    for bk in bks:
        for sid in range(3):
            toks = [100 * sid + i for i in range(4)]
            bk.add_sequence(sid, toks)
            bk.grow_sequence(sid, 4)
            bk.seal_full_blocks(sid, toks)
            bk.free_sequence(sid)
        bk.add_sequence(10, [7] * 8)
        bk.grow_sequence(10, 8)                       # evicts seq 0's
        assert bk.add_sequence(11, [0, 1, 2, 3]) == 0
        assert bk.add_sequence(12, [200, 201, 202, 203]) == 2
    check_same(bks, [10, 11, 12])


def test_out_of_blocks_raises():
    for bk in make_three(num_blocks=3, block_size=2):
        bk.add_sequence(1, [1, 2, 3, 4])
        bk.grow_sequence(1, 4)
        with pytest.raises(RuntimeError):
            bk.grow_sequence(1, 8)


def test_match_prefix_parity():
    bks = make_three()
    prompt = list(range(20))
    for bk in bks:
        bk.add_sequence(1, prompt)
        bk.grow_sequence(1, 20)
        bk.seal_full_blocks(1, prompt)
        bk.free_sequence(1)
        before = bk.stats()
        assert bk.match_prefix(prompt) == 16
        assert bk.match_prefix(prompt[:9]) == 8
        assert bk.match_prefix(list(range(100, 120))) == 0
        assert bk.stats() == before
    check_same(bks, [])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_parity_with_priorities(seed):
    """Adds (with salts), grows, seals, retention priorities and frees in
    random order on a small pool, so that blocks are evicted from several
    priority buckets."""
    bks = make_three(num_blocks=40, block_size=4)
    rng = random.Random(seed)
    live = {}
    next_id = 0
    for _ in range(400):
        op = rng.random()
        if op < 0.35 or not live:
            sid, next_id = next_id, next_id + 1
            toks = [rng.randrange(12) for _ in range(rng.randrange(1, 30))]
            if (len(toks) + 3) // 4 > min(bks[0].num_free_blocks(), 30):
                continue
            salt = rng.choice([None, "s1", "s2"])
            got = {bk.add_sequence(sid, toks, salt) for bk in bks}
            assert len(got) == 1
            if rng.random() < 0.5:
                prio = rng.choice([10, 35, 60, 90])
                for bk in bks:
                    bk.set_seq_priority(sid, prio)
            for bk in bks:
                bk.grow_sequence(sid, len(toks))
            live[sid] = toks
        elif op < 0.55:
            sid = rng.choice(list(live))
            grown = len(live[sid]) + rng.randrange(1, 5)
            need = (grown + 3) // 4 - bks[0].num_seq_blocks(sid)
            if need > bks[0].num_free_blocks():
                continue
            live[sid] = live[sid] + [rng.randrange(12)] * (
                grown - len(live[sid]))
            for bk in bks:
                bk.grow_sequence(sid, grown)
        elif op < 0.75:
            sid = rng.choice(list(live))
            for bk in bks:
                bk.seal_full_blocks(sid, live[sid])
        else:
            sid = rng.choice(list(live))
            for bk in bks:
                bk.free_sequence(sid)
            del live[sid]
        check_same(bks, list(live))
    assert bks[0].stats()["evicted_blocks"] > 0


def test_drop_cached_blocks_parity():
    """After a weight swap the reuse index is forgotten the same way by
    both port backends: cached blocks return to the free list in eviction
    order, blocks in use are freed, not cached, on release."""
    py, nat = _PyBookkeeping(16, 4, True), _NativeBookkeeping(
        native.load_native(), 16, 4, True)
    for bk in (py, nat):
        for sid, prio in ((1, 60), (2, 20)):
            toks = [sid * 10 + i for i in range(8)]
            bk.add_sequence(sid, toks)
            bk.set_seq_priority(sid, prio)
            bk.grow_sequence(sid, 8)
            bk.seal_full_blocks(sid, toks)
        bk.free_sequence(1)
        bk.drop_cached_blocks()
        bk.free_sequence(2)
        assert bk.stats()["evictable_blocks"] == 0
        assert bk.add_sequence(3, [10 + i for i in range(9)]) == 0
        bk.grow_sequence(3, 16)
    check_same((py, nat), [3])


def test_manager_backends_and_default():
    cfg = KVCacheConfig(block_size=4)
    assert cfg.bookkeeping == "native"
    kv = KVCacheManager(cfg, num_layers=1, num_kv_heads=1, head_dim=8,
                        num_blocks=16, device="cpu")
    assert kv.is_native
    kv.add_sequence(0, [1, 2, 3, 4, 5])
    kv.grow_sequence(0, 5)
    assert kv.num_seq_blocks(0) == 2
    assert kv.slot_mapping(0, 0, 5) == [
        kv.block_table(0, 2)[i // 4] * 4 + i % 4 for i in range(5)]
    kv.free_sequence(0)
    assert kv.stats()["active_sequences"] == 0
    py = KVCacheManager(KVCacheConfig(block_size=4, bookkeeping="python"),
                        1, 1, 8, 16, "cpu")
    assert not py.is_native
    with pytest.raises(ValueError):
        KVCacheConfig(bookkeeping="auto")
    with pytest.raises(ValueError):
        make_bookkeeping(16, 4, True, "fallback")


def test_llm_kv_bookkeeping_argument():
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.models import ModelConfig
    cfg = ModelConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                      num_layers=1, num_heads=2, num_kv_heads=1, head_dim=32,
                      max_position=64)
    sp = T.SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)
    out = {}
    for be in ("native", "python"):
        llm = T.LLM(model=cfg, device="cpu", skip_tokenizer_init=True,
                    max_seq_len=32, kv_num_blocks=32, kv_block_size=4,
                    kv_bookkeeping=be)
        try:
            assert llm.kv_manager.is_native == (be == "native")
            out[be] = [o.outputs[0].token_ids
                       for o in llm.generate([[1, 2, 3, 4, 5, 6]] * 2, sp)]
        finally:
            llm.shutdown()
    assert out["native"] == out["python"]


_BUILD = """
import sys
from pathlib import Path
from tensorrt_llm_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
lib = native.load_native()
h = lib.tllm_kvbm_create(8, 4, 1)
assert lib.tllm_kvbm_num_free(h) == 7
print(native.library_path())
"""


def test_concurrent_builds_share_one_library(tmp_path):
    """Four processes build into one empty directory at once: the lock
    lets one compile, the others load its library; no temporary file is
    left behind."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=str(ROOT))
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    libs = list(tmp_path.rglob("*.so"))
    assert [str(p) for p in libs] == list(paths)
    assert not list(tmp_path.rglob("kvbm_*"))


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    bad = tmp_path / "kv_bookkeeping.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="(?s)build failed.*error:"):
        native.load_native()
    with pytest.raises(RuntimeError, match="build failed"):
        KVCacheManager(KVCacheConfig(block_size=4), 1, 1, 8, 16, "cpu")
    assert not list((tmp_path / "build").rglob("*.so"))


def test_default_retention_priority_matches_jax():
    from tensorrt_llm_tpu.runtime import kv_cache_manager as J
    assert DEFAULT_RETENTION_PRIORITY == J.DEFAULT_RETENTION_PRIORITY
