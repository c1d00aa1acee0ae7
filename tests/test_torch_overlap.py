"""The port's overlap decode pipeline: each decode chunk is dispatched from
the previous chunk's sampled tokens still on the device, and its results
are applied later, up to `overlap_depth` chunks behind.  Mirrors the JAX
package's `tests/test_overlap_decode.py`: setting `_force_lag` keeps the
pipeline full on the CPU (results never count as landed early), at depth
3, so the deferred apply, the drains and the cleanup all run.

Greedy tokens are compared with the port's synchronous run exactly and
with the JAX `LLM` on the same weights; should a token differ from JAX's
(or, where batch composition depends on thread timing, from the sync
run's), it is accepted only at a near-tie: the port's logits of that
position, teacher forced, rank both tokens within `TIE` of the top logit.
"""

import time

import jax
import numpy as np
import pytest

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax

from torch_parity import jax_generate, port_logits

TIE = 0.02
TINY = dict(vocab_size=199, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            max_position=512)
KW = dict(skip_tokenizer_init=True, max_seq_len=256, max_batch_size=8,
          kv_num_blocks=256, kv_block_size=8)
DEPTH = 3


@pytest.fixture(scope="module")
def params():
    """The JAX `LLM`'s random weights (seed 0), as the port's state; its
    KV bookkeeping in Python, so that it builds no native library while
    other test processes may be building it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TLLM_KV_BOOKKEEPING", "python")
        jl = J.LLM(model=JCfg(**TINY), seed=0, **KW)
    try:
        return params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
    finally:
        jl.shutdown()


def make_llm(params, overlap=True, **kw):
    args = dict(KW, **kw)
    llm = T.LLM(model=ModelConfig(**TINY), device="cpu", params=params,
                disable_overlap_scheduler=not overlap, overlap_depth=DEPTH,
                **args)
    llm.executor._force_lag = overlap
    return llm


def greedy(max_tokens=24):
    return T.SamplingParams(max_tokens=max_tokens, temperature=0.0,
                            ignore_eos=True)


def wait_idle(llm, timeout=5.0):
    """No chunk in flight, no virtual token, no live sequence."""
    ex = llm.executor
    t0 = time.time()
    while time.time() - t0 < timeout:
        if not ex._inflight and not ex._virtual and \
                llm.get_kv_cache_stats()["active_sequences"] == 0:
            return
        time.sleep(0.02)
    raise AssertionError(f"executor not idle: virtual={ex._virtual} "
                         f"inflight={len(ex._inflight)} "
                         f"kv={llm.get_kv_cache_stats()}")


def same_or_tie(params, prompts, want, got):
    """Every output equals `want`'s, or first differs at a near-tie."""
    exact = 0
    for p, a, b in zip(prompts, want, got):
        assert len(a) == len(b)
        if a == b:
            exact += 1
            continue
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        lg = port_logits(ModelConfig(**TINY), params, list(p) + a[:i])
        top = lg.max()
        assert lg[a[i]] >= top - TIE and lg[b[i]] >= top - TIE, (
            f"token {i} differs without a near-tie: {a[i]} ({lg[a[i]]}), "
            f"{b[i]} ({lg[b[i]]}), top {top}")
    return exact


def prompts_of(seed, lengths):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, 198, n)] for n in lengths]


def test_overlap_matches_sync_and_jax(params, monkeypatch):
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")
    prompts = prompts_of(0, (7, 12, 3, 21, 9))
    llm = make_llm(params)
    try:
        assert llm.executor._overlap_enabled and llm.executor._force_lag
        got = [o.outputs[0].token_ids for o in llm.generate(prompts,
                                                            greedy())]
        wait_idle(llm)
        depth = max(s["inflight_chunks"] for s in llm.get_stats())
    finally:
        llm.shutdown()
    assert depth == DEPTH                  # the pipeline ran full
    sync = make_llm(params, overlap=False)
    try:
        assert not sync.executor._overlap_enabled
        ref = [o.outputs[0].token_ids for o in sync.generate(prompts,
                                                             greedy())]
        assert max(s["inflight_chunks"] for s in sync.get_stats()) == 0
    finally:
        sync.shutdown()
    assert got == ref
    jl = J.LLM(model=JCfg(**TINY), seed=0, **KW)
    try:
        jout = jax_generate(jl, prompts, J.SamplingParams(
            max_tokens=24, temperature=0.0, ignore_eos=True))
    finally:
        jl.shutdown()
    assert same_or_tie(params, prompts, jout, got) >= 1


def test_overlap_with_eos_budget_stops(params):
    """Requests ending at different lengths mid-pipeline: the right token
    counts, every block freed."""
    prompts = prompts_of(1, (5, 5, 5, 5))
    llm = make_llm(params)
    try:
        futs = [llm.generate_async(p, greedy(m))
                for p, m in zip(prompts, (3, 9, 17, 24))]
        got = [f.result().outputs[0] for f in futs]
        assert [len(o.token_ids) for o in got] == [3, 9, 17, 24]
        assert {o.finish_reason for o in got} == {"length"}
        wait_idle(llm)
    finally:
        llm.shutdown()


def test_overlap_stops_on_eos(params):
    """A request that may stop on EOS (not `ignore_eos`) stops at the
    end id in the overlapped run as in the sync run; tokens past it in
    chunks already in flight are dropped."""
    prompts = prompts_of(6, (6,))
    out = {}
    for overlap in (False, True):
        llm = make_llm(params, overlap=overlap)
        try:
            free = llm.generate(prompts, greedy(30))[0].outputs[0].token_ids
            end = free[10]
            sp = T.SamplingParams(max_tokens=30, temperature=0.0,
                                  end_id=end)
            out[overlap] = (free, llm.generate(prompts, sp)[0].outputs[0])
            wait_idle(llm)
        finally:
            llm.shutdown()
    free, stopped = out[True]
    assert out[False][0] == free
    assert stopped.token_ids == out[False][1].token_ids
    assert stopped.token_ids[-1] == free[10]
    assert stopped.finish_reason == "stop"


def test_overlap_composition_churn(params):
    """New prefills joining mid-decode force pipeline drains; the outputs
    match the sync run's (at most a near-tie apart: which iteration the
    second wave joins depends on thread timing)."""
    first = prompts_of(2, (6, 6, 6))
    late = prompts_of(3, (11, 11, 11))

    def run(llm):
        hs = [llm.generate_async(p, greedy(20)) for p in first]
        time.sleep(0.15)
        hs += [llm.generate_async(p, greedy(20)) for p in late]
        return [h.result().outputs[0].token_ids for h in hs]

    llm = make_llm(params)
    try:
        got = run(llm)
        wait_idle(llm)
    finally:
        llm.shutdown()
    sync = make_llm(params, overlap=False)
    try:
        ref = run(sync)
    finally:
        sync.shutdown()
    same_or_tie(params, first + late, ref, got)


def test_overlap_cancel_mid_pipeline(params):
    """A request cancelled while its chunks are in flight ends with finish
    reason "cancelled" at the next step, its KV freed; the other request
    runs to its budget."""
    p_keep, p_cancel = prompts_of(4, (6, 6))
    llm = make_llm(params)
    try:
        keep = llm.generate_async(p_keep, greedy(120))
        h = llm.generate_async(p_cancel, greedy(120), streaming=True)
        pieces = iter(h)
        seen = 0
        while seen < 9:              # past the prefill and a decode chunk
            seen = len(next(pieces).outputs[0].token_ids)
        assert llm.executor._virtual.get(h.request_id, 0) > 0
        h.cancel()
        last = None
        for last in pieces:
            pass
        assert last.finished and last.outputs[0].finish_reason == \
            "cancelled"
        assert len(last.outputs[0].token_ids) < 120
        out = keep.result()
        assert len(out.outputs[0].token_ids) == 120
        wait_idle(llm)
        assert llm.executor._error is None
    finally:
        llm.shutdown()


def test_cancel_waiting_and_unknown(params):
    """Cancelling a request still waiting for a batch slot ends it with no
    token; a cancel of an unknown id is forgotten after a few steps."""
    llm = make_llm(params, max_batch_size=1)
    try:
        a = llm.generate_async(prompts_of(5, (6,))[0], greedy(60))
        b = llm.generate_async(prompts_of(5, (7,))[0], greedy(60))
        b.cancel()
        llm.executor.cancel(10 ** 9)
        rb = b.result()
        assert rb.outputs[0].finish_reason == "cancelled"
        assert len(a.result().outputs[0].token_ids) == 60
        llm.generate([[1, 2, 3]], greedy(12))
        wait_idle(llm)
        assert not llm.executor._cancelled
    finally:
        llm.shutdown()


def test_overlap_kv_exhaustion_recovers(params):
    """A nearly full pool (18 blocks of 8) under a full pipeline does not
    kill the loop: the block guard counts virtual positions and a failed
    grow drains and retries."""
    llm = make_llm(params, max_batch_size=4, kv_num_blocks=18)
    try:
        rng = np.random.RandomState(5)
        futs = [llm.generate_async([int(t) for t in rng.randint(1, 198, 10)],
                                   greedy(60)) for _ in range(3)]
        outs = [f.result(timeout=120).outputs[0].token_ids for f in futs]
        assert all(len(o) == 60 for o in outs)
        assert llm.executor._error is None
        wait_idle(llm)
    finally:
        llm.shutdown()


def test_seeded_sampling_under_overlap(params):
    """A seeded sampled request is reproducible with overlap on; greedy
    rows beside it are unchanged by it."""
    p = prompts_of(7, (8, 8))
    sp = T.SamplingParams(max_tokens=20, temperature=0.9, top_k=20,
                          top_p=0.9, seed=7, ignore_eos=True)
    runs = []
    for _ in range(2):
        llm = make_llm(params)
        try:
            outs = llm.generate(p, [sp, greedy(20)])
            runs.append([o.outputs[0].token_ids for o in outs])
        finally:
            llm.shutdown()
    assert runs[0] == runs[1]
    assert len(runs[0][0]) == 20
