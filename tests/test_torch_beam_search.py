"""Port parity for beam search: the KV fork and `LLM.generate` with
``use_beam_search`` against the JAX package.

* Fork: the port's Python and native bookkeeping and the JAX package's
  Python and native ones give the same block tables, copy pairs and free
  counts over one sequence of adds, grows, seals, forks and frees; a fork
  that finds the pool exhausted raises and registers nothing; the native
  fork never writes past its pair buffer.  The manager's fork carries the
  source's salt, priority and announced chain.
* Search: on the same tiny unquantized model and weights
  (`params_from_jax`), every beam's token ids equal the JAX `LLM`'s and its
  cumulative logprob lies within `LP_TOL` (both sides compute the same
  bf16 forward on the CPU): width 4, ``best_of > n``, ``max_tokens=1``,
  narrowing and widening `beam_width_array`, a length penalty, an EOS id,
  and per-token logprobs (whose sum is the cumulative logprob).
* A beam request beside greedy and sampled ones gives the beams it gives
  alone and the JAX greedy tokens; no block leaks; beam 0 lies between the
  greedy path's and the exhaustive 2-step optimum's scores, within the
  decode-vs-prefill tolerance `EPS`; overlap on and off agree; a pool too
  small for the forks ends that request alone; disaggregated beam requests
  are refused.
"""

import ctypes
import math
import os
import subprocess

import jax
import numpy as np
import pytest

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu import native as jnative
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.runtime.kv_cache_manager import (
    _NativeBookkeeping as JaxNativeBookkeeping,
    _PyBookkeeping as JaxPyBookkeeping)
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch import native
from tensorrt_llm_tpu_torch.llmapi.disagg_params import DisaggregatedParams
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
    KVCacheConfig, KVCacheManager, OutOfBlocksError, _NativeBookkeeping,
    _PyBookkeeping)

TINY = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position=128)
LLM_KW = dict(skip_tokenizer_init=True, max_seq_len=64, max_batch_size=8,
              kv_num_blocks=256, kv_block_size=4)
LP_TOL = 1e-4    # cumulative logprob, port vs JAX (same CPU forward)
EPS = 0.05       # bf16 decode-vs-prefill numerics (JAX test_beam_search)


# ---------------------------------------------------------------- fork ------
@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX package's bookkeeping library, built into a private
    directory (its own build writes a shared cache path unlocked)."""
    out = tmp_path_factory.mktemp("jax_native") / "libkvbm.so"
    srcs = [os.path.join(jnative._HERE, s) for s in jnative._SOURCES]
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", *srcs,
                    "-o", str(out)], check=True, capture_output=True,
                   timeout=300)
    return jnative._declare(ctypes.CDLL(str(out)))


def four(lib, num_blocks=24, block_size=4):
    return [JaxPyBookkeeping(num_blocks, block_size, True),
            JaxNativeBookkeeping(lib, num_blocks, block_size, True),
            _PyBookkeeping(num_blocks, block_size, True),
            _NativeBookkeeping(native.load_native(), num_blocks, block_size,
                               True)]


def test_fork_backends_parity(jax_native_lib):
    bks = four(jax_native_lib)
    seen = []
    for bk in bks:
        got = []
        toks = list(range(10))
        bk.add_sequence(1, toks)
        bk.grow_sequence(1, 10)            # 3 blocks, position 9 pending
        bk.seal_full_blocks(1, toks[:8])
        got.append(bk.fork_sequence(1, 2))
        bk.add_sequence(3, list(range(50, 58)))
        bk.grow_sequence(3, 8)             # exactly full: the tail is block 1
        got.append(bk.fork_sequence(3, 4))
        bk.grow_sequence(2, 13)            # the fork grows on its own
        got.append(bk.fork_sequence(2, 5))  # a fork of a fork
        bk.free_sequence(1)
        got.append(bk.num_free_blocks())
        bk.free_sequence(2)
        got.append(bk.num_free_blocks())
        got.append([bk.block_table(s, 5) for s in (3, 4, 5)])
        got.append(bk.fork_sequence(4, 6))
        for s in (3, 4, 5, 6):
            bk.free_sequence(s)
        got.append(bk.num_free_blocks())
        seen.append(got)
    assert all(g == seen[0] for g in seen[1:]), seen
    # shared prefix, private tails
    assert len(seen[0][0]) == 1 and len(seen[0][1]) == 1
    assert seen[0][-1] == 23


def test_fork_out_of_blocks_raises_and_registers_nothing(jax_native_lib):
    for bk in four(jax_native_lib, num_blocks=4, block_size=4):
        bk.add_sequence(1, list(range(9)))
        bk.grow_sequence(1, 9)             # all 3 usable blocks
        with pytest.raises(RuntimeError):
            bk.fork_sequence(1, 2)
        assert bk.num_seq_blocks(2) == -1
        assert bk.num_free_blocks() == 0
    for bk in four(jax_native_lib, num_blocks=4, block_size=4)[2:]:
        bk.add_sequence(1, list(range(9)))
        bk.grow_sequence(1, 9)
        with pytest.raises(OutOfBlocksError):
            bk.fork_sequence(1, 2)


def test_native_fork_never_truncates():
    """The library refuses (-3) a pair buffer shorter than the tail
    instead of truncating, and registers nothing; an unknown source is
    -2 (KeyError from the wrapper)."""
    lib = native.load_native()
    bk = _NativeBookkeeping(lib, 16, 4, True)
    bk.add_sequence(1, list(range(6)))
    bk.grow_sequence(1, 6)
    buf = np.zeros(1, np.int32)
    ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    assert lib.tllm_kvbm_fork(bk._h, 1, 2, ptr, ptr, 0) == -3
    assert bk.num_seq_blocks(2) == -1
    assert lib.tllm_kvbm_fork(bk._h, 9, 2, ptr, ptr, 1) == -2
    with pytest.raises(KeyError):
        bk.fork_sequence(9, 2)
    assert len(bk.fork_sequence(1, 2)) == 1


@pytest.mark.parametrize("backend", ["python", "native"])
def test_manager_fork_carries_identity(backend):
    """A seal on a fork hashes under the source's salt (its blocks serve a
    later prompt of that salt) and announces no block twice."""
    kv = KVCacheManager(KVCacheConfig(block_size=4, bookkeeping=backend), 1,
                        1, 8, num_blocks=32, device="cpu")
    toks = list(range(10))
    kv.add_sequence(1, toks, "tenant")
    kv.set_seq_priority(1, 60)
    kv.grow_sequence(1, 10)
    kv.seal_full_blocks(1, toks[:8])
    n_events = len(kv.get_events())
    pairs = kv.fork_sequence(1, 2)
    t1, t2 = kv.block_table(1, 3), kv.block_table(2, 3)
    assert t1[:2] == t2[:2] and pairs == [(t1[2], t2[2])]
    longer = toks + [77, 78]
    kv.grow_sequence(2, 12)
    kv.seal_full_blocks(2, longer)
    ev = kv.get_events()[n_events:]
    assert len(ev) == 1 and ev[0]["type"] == "stored"    # only block 2
    kv.free_sequence(1)
    kv.free_sequence(2)
    assert kv.match_prefix(longer + [5], "tenant") == 12
    assert kv.match_prefix(longer + [5]) == 0
    assert kv.num_free_blocks == 31


# ---------------------------------------------------------------- search ----
@pytest.fixture(scope="module")
def llms():
    """The JAX `LLM` (Python bookkeeping) and the port's on its weights."""
    os.environ["TLLM_KV_BOOKKEEPING"] = "python"
    try:
        jl = J.LLM(model=JCfg(**TINY), seed=11, **LLM_KW)
    finally:
        del os.environ["TLLM_KV_BOOKKEEPING"]
    params = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
    tl = T.LLM(model=ModelConfig(**TINY), device="cpu", params=params,
               **LLM_KW)
    yield jl, tl, params
    jl.shutdown()
    tl.shutdown()


CASES = {
    "width4": ([3, 9, 27], dict(max_tokens=4, n=4)),
    "best_of_gt_n": ([2, 9, 2, 9, 2, 9, 11], dict(max_tokens=8, n=2,
                                                  best_of=3)),
    "max_tokens_1": ([5, 9, 2], dict(max_tokens=1, n=3, best_of=3)),
    "narrowing": ([7, 3, 7, 3], dict(max_tokens=8, n=2, best_of=4,
                                     beam_width_array=[4, 4, 2, 2])),
    "widening": ([5, 9, 5, 9], dict(max_tokens=6, n=1, best_of=2,
                                    beam_width_array=[2, 2, 4])),
    "length_penalty": ([1, 2, 3, 4, 5, 6, 7], dict(max_tokens=10, n=3,
                                                   length_penalty=1.0)),
    "logprobs": ([7, 3, 7, 3], dict(max_tokens=6, n=2, best_of=3,
                                    logprobs=1)),
}


def _beam_sp(mod, kw, eos=None):
    return mod.SamplingParams(use_beam_search=True, temperature=0.0,
                              ignore_eos=eos is None, end_id=eos, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_beams_match_jax(llms, case):
    jl, tl, _ = llms
    prompt, kw = CASES[case]
    want = jl.generate([prompt], _beam_sp(J, kw))[0].outputs
    got = tl.generate([prompt], _beam_sp(T, kw))[0].outputs
    assert len(got) == len(want) == min(kw["n"], kw.get("best_of") or 99)
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids, (case, g.token_ids, w.token_ids)
        assert abs(g.cumulative_logprob - w.cumulative_logprob) <= LP_TOL
        assert len(g.token_ids) == kw["max_tokens"]
    scores = [g.cumulative_logprob for g in got]
    assert scores == sorted(scores, reverse=True)
    if kw.get("logprobs"):
        for w, g in zip(want, got):
            total = sum(next(iter(d.values())) for d in g.logprobs)
            assert math.isclose(total, g.cumulative_logprob, abs_tol=1e-4)
            assert [list(d) for d in g.logprobs] == \
                [list(d) for d in w.logprobs]
    else:
        assert all(g.logprobs is None for g in got)


def test_beams_with_eos_match_jax(llms):
    """An EOS id that the beams meet: finished beams leave the search
    early and their scores rank with the live ones."""
    jl, tl, _ = llms
    prompt, kw = [1, 2, 3, 4, 5, 6, 7], dict(max_tokens=10, n=3)
    eos = jl.generate([prompt], _beam_sp(J, kw))[0].outputs[0].token_ids[1]
    want = jl.generate([prompt], _beam_sp(J, kw, eos))[0].outputs
    got = tl.generate([prompt], _beam_sp(T, kw, eos))[0].outputs
    assert [g.token_ids for g in got] == [w.token_ids for w in want]
    assert any(g.token_ids[-1] == eos for g in got)
    for w, g in zip(want, got):
        assert abs(g.cumulative_logprob - w.cumulative_logprob) <= LP_TOL
        assert g.finish_reason == w.finish_reason


def test_mixed_batch_and_no_leak(llms):
    """A beam request batched with greedy and sampled ones: its beams are
    the ones it gets alone, the greedy tokens the JAX `LLM`'s; afterwards
    every block is free or evictable again and no sequence is left."""
    jl, tl, _ = llms
    kw = dict(max_tokens=5, n=2)
    alone = tl.generate([[1, 2, 3]], _beam_sp(T, kw))[0].outputs
    greedy = T.SamplingParams(max_tokens=5, temperature=0.0, ignore_eos=True)
    want = jl.generate([[4, 5]], J.SamplingParams(
        max_tokens=5, temperature=0.0, ignore_eos=True))[0].outputs[0]
    before = tl.get_kv_cache_stats()
    out = tl.generate([[1, 2, 3], [4, 5], [6, 7, 8]], [
        _beam_sp(T, kw), greedy,
        T.SamplingParams(max_tokens=5, temperature=0.8, seed=3,
                         ignore_eos=True)])
    after = tl.get_kv_cache_stats()
    assert [o.token_ids for o in out[0].outputs] == \
        [o.token_ids for o in alone]
    assert out[1].outputs[0].token_ids == want.token_ids
    assert len(out[2].outputs[0].token_ids) == 5
    assert after["active_sequences"] == 0
    assert after["free_blocks"] + after["evictable_blocks"] == \
        before["free_blocks"] + before["evictable_blocks"]
    stats = tl.get_stats()
    assert sum(s["beam_steps"] for s in stats) > 0


def _row_logprobs(tl, tokens):
    """log-softmax of the port's logits at every position of one prefill
    of `tokens` (f32 numpy [n, V])."""
    from torch_parity import port_logits
    from tensorrt_llm_tpu_torch.models import ModelConfig as C
    cfg = C(**TINY)
    params = tl.model.state()
    rows = np.stack([port_logits(cfg, params, tokens[:i + 1])
                     for i in range(len(tokens))])
    rows = rows - rows.max(-1, keepdims=True)
    return rows - np.log(np.exp(rows).sum(-1, keepdims=True))


def test_beam0_between_greedy_and_optimum(llms):
    """Beam 0 of width 4 at max_tokens=2 scores at least the greedy path
    and at most the exhaustive best 2-token path (both teacher forced by
    prefill), within EPS."""
    _, tl, _ = llms
    prompt = [3, 9, 27]
    lp1 = _row_logprobs(tl, prompt)[-1]
    V = lp1.shape[0]
    best_s, greedy_s = -np.inf, None
    for t1 in range(V):
        lp2 = _row_logprobs(tl, prompt + [t1])[-1]
        s = float(lp1[t1] + lp2.max())
        best_s = max(best_s, s)
        if t1 == int(lp1.argmax()):
            greedy_s = s
    out = tl.generate([prompt], _beam_sp(T, dict(max_tokens=2, n=4)))[0]
    beam_s = out.outputs[0].cumulative_logprob
    assert greedy_s - EPS <= beam_s <= best_s + EPS, (greedy_s, beam_s,
                                                      best_s)


def test_overlap_on_and_off_agree(llms):
    """Beam requests among plain ones under the overlap pipeline (kept
    full) give what they give with the pipeline off."""
    _, _, params = llms
    prompts = [[1, 2, 3], [4, 5, 6, 7], [9, 8], [10, 11, 12]]
    sps = [_beam_sp(T, dict(max_tokens=6, n=2)),
           T.SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True),
           _beam_sp(T, dict(max_tokens=4, n=3, best_of=3)),
           T.SamplingParams(max_tokens=9, temperature=0.0, ignore_eos=True)]
    res = []
    for overlap in (True, False):
        tl = T.LLM(model=ModelConfig(**TINY), device="cpu", params=params,
                   disable_overlap_scheduler=not overlap, max_decode_steps=4,
                   **LLM_KW)
        try:
            tl.executor._force_lag = True
            out = tl.generate(prompts, sps)
            res.append([[o.token_ids for o in r.outputs] for r in out])
            assert tl.get_kv_cache_stats()["active_sequences"] == 0
        finally:
            tl.shutdown()
    assert res[0] == res[1]


def test_pool_exhaustion_ends_only_that_request(llms):
    """Forks that find no free block end the beam request with an error,
    free every beam's blocks, and leave the executor serving."""
    _, _, params = llms
    tl = T.LLM(model=ModelConfig(**TINY), device="cpu", params=params,
               **dict(LLM_KW, kv_num_blocks=8))
    try:
        before = tl.get_kv_cache_stats()
        with pytest.raises(RuntimeError, match="beam search"):
            tl.generate([list(range(1, 21))], _beam_sp(
                T, dict(max_tokens=8, n=4)))
        out = tl.generate([[1, 2]], T.SamplingParams(max_tokens=3,
                                                     ignore_eos=True))
        assert len(out[0].outputs[0].token_ids) == 3
        after = tl.get_kv_cache_stats()
        assert after["active_sequences"] == 0
        assert after["free_blocks"] + after["evictable_blocks"] == \
            before["free_blocks"] + before["evictable_blocks"]
    finally:
        tl.shutdown()


def test_streaming_and_refusals(llms):
    """A streamed beam request ends with every beam; a disaggregated one,
    and beam search under guided decoding or at width 1, are refused."""
    _, tl, _ = llms
    kw = dict(max_tokens=4, n=3)
    pieces = list(tl.generate_async([3, 9, 27], _beam_sp(T, kw),
                                    streaming=True))
    whole = tl.generate([[3, 9, 27]], _beam_sp(T, kw))[0]
    assert pieces[-1].finished
    assert [o.token_ids for o in pieces[-1].outputs] == \
        [o.token_ids for o in whole.outputs]
    for dp in (DisaggregatedParams(request_type="context_only"),
               DisaggregatedParams(request_type="generation_only",
                                   kv_frames=object())):
        with pytest.raises(ValueError, match="beam"):
            tl.generate_async([1, 2], _beam_sp(T, dict(max_tokens=2, n=2)),
                              disaggregated_params=dp)
    # the executor's own check (the server submits requests directly)
    req = T.runtime.request.LlmRequest(
        [1, 2], _beam_sp(T, dict(max_tokens=2, n=2)),
        request_type="generation_only")
    with pytest.raises(ValueError, match="beam"):
        tl.executor.submit(req)
    with pytest.raises(ValueError):
        T.SamplingParams(use_beam_search=True, n=1)
    with pytest.raises(ValueError):
        T.SamplingParams(use_beam_search=True, n=2,
                         guided_decoding=T.GuidedDecodingParams(regex="a"))
