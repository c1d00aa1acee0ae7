"""Port scheduler vs the JAX package's `Scheduler`: a recorded request
stream (arrivals, prompt lengths, output budgets, priorities), scheduled by
each on equal KV state, gives the same batches -- prefill chunks, decode
rows and paused rows -- at every iteration, under the three capacity
policies, with and without batch waiting and chunked prefill.  Also the
order in which retention priorities evict cached blocks equals the JAX
package's, and the executor sorts its waiting queue by priority.
"""

import numpy as np
import pytest

from tensorrt_llm_tpu.llmapi import SamplingParams as JSP
from tensorrt_llm_tpu.runtime.kv_cache_manager import (
    _PyBookkeeping as JaxPyBookkeeping)
from tensorrt_llm_tpu.runtime.request import LlmRequest as JReq
from tensorrt_llm_tpu.runtime.scheduler import Scheduler as JScheduler
from tensorrt_llm_tpu.runtime.scheduler import SchedulerConfig as JCfg
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.llmapi import SamplingParams
from tensorrt_llm_tpu_torch.models import ModelConfig
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
    _NativeBookkeeping, _PyBookkeeping)
from tensorrt_llm_tpu_torch.native import load_native
from tensorrt_llm_tpu_torch.runtime.request import LlmRequest
from tensorrt_llm_tpu_torch.runtime.scheduler import (
    CapacitySchedulerPolicy, Scheduler, SchedulerConfig)


class FakeKV:
    """Block accounting the schedulers read: free blocks, blocks per
    sequence, the block size."""

    def __init__(self, num_blocks, block_size):
        self.block_size = block_size
        self.free = num_blocks
        self.seqs = {}

    @property
    def num_free_blocks(self):
        return self.free

    def blocks_needed(self, n):
        return -(-n // self.block_size)

    def num_seq_blocks(self, sid):
        return self.seqs.get(sid, 0)

    def grow(self, sid, n):
        need = self.blocks_needed(n) - self.seqs.get(sid, 0)
        if need > 0:
            assert need <= self.free
            self.free -= need
            self.seqs[sid] = self.seqs.get(sid, 0) + need

    def release(self, sid):
        self.free += self.seqs.pop(sid, 0)


def stream(seed, n=40):
    """(arrival iteration, request id, prompt length, max tokens,
    priority) of a recorded stream."""
    rng = np.random.RandomState(seed)
    arrive = np.sort(rng.randint(0, 30, n))
    return [(int(a), 1000 + i, int(rng.randint(1, 90)),
             int(rng.randint(1, 24)),
             float(rng.choice([0.1, 0.5, 0.5, 0.9]))) for i, a in
            enumerate(arrive)]


def simulate(sched, make_req, kv, recs, iters=400):
    """Run `sched` over the stream like the executor: admit, prefill
    chunks, decode one token per row, finish at the budget, free.
    Returns the batches of every iteration."""
    active, waiting, out = [], [], []
    for it in range(iters):
        waiting += [make_req(r) for r in recs if r[0] == it]
        batch = sched.schedule(active, waiting)
        out.append(([(r.request_id, c) for r, c in batch.prefill],
                    [r.request_id for r in batch.decode],
                    [r.request_id for r in batch.paused]))
        for req, chunk in batch.prefill:
            if req in waiting:
                waiting.remove(req)
                active.append(req)
                req.start_context()
            kv.grow(req.request_id, req.context_position + chunk)
            req.context_position += chunk
            if req.remaining_context == 0:
                req.finish_context()
                req.append_token(1)
        for req in batch.decode:
            kv.grow(req.request_id, req.num_tokens + 1)
            req.append_token(1)
        for req in [r for r in active if r.is_generating and
                    r.num_output_tokens >= r.sampling_params.max_tokens]:
            req.state = type(req.state).GENERATION_COMPLETE
            active.remove(req)
            kv.release(req.request_id)
    return out


def jax_req(rec):
    _, rid, n, m, prio = rec
    return JReq(list(range(1, n + 1)), JSP(max_tokens=m), request_id=rid,
                priority=prio)


def port_req(rec):
    _, rid, n, m, prio = rec
    return LlmRequest(list(range(1, n + 1)), SamplingParams(max_tokens=m),
                      request_id=rid, priority=prio)


CASES = [(policy, wait, chunked)
         for policy in ("guaranteed_no_evict", "max_utilization",
                        "static_batch")
         for wait in ((0, 0.0), (3, 0.0), (0, 0.6), (4, 0.5))
         for chunked in (True, False)]


@pytest.mark.parametrize("policy,wait,chunked", CASES)
def test_batches_equal_jax(policy, wait, chunked):
    recs = stream(CASES.index((policy, wait, chunked)))
    kw = dict(max_batch_size=6, max_num_tokens=96,
              enable_chunked_prefill=chunked,
              batch_wait_timeout_iters=wait[0],
              batch_wait_max_tokens_ratio=wait[1])
    from tensorrt_llm_tpu.runtime.scheduler import (
        CapacitySchedulerPolicy as JPolicy)
    kv_j, kv_p = FakeKV(60, 8), FakeKV(60, 8)
    jb = simulate(JScheduler(JCfg(policy=JPolicy(policy), **kw), kv_j),
                  jax_req, kv_j, recs)
    pb = simulate(Scheduler(SchedulerConfig(
        policy=CapacitySchedulerPolicy(policy), **kw), kv_p),
        port_req, kv_p, recs)
    assert pb == jb
    assert sum(len(d) for _, d, _ in pb) > 50      # decode ran
    assert len({r for p, _, _ in pb for r, _ in p}) == 40   # all admitted


def test_max_chunk_size_caps_chunks():
    kv = FakeKV(64, 8)
    s = Scheduler(SchedulerConfig(max_num_tokens=256, max_chunk_size=24), kv)
    req = port_req((0, 1, 100, 4, 0.5))
    batch = s.schedule([], [req])
    assert batch.prefill == [(req, 24)]


def test_waiting_queue_sorted_by_priority():
    kv = FakeKV(64, 8)
    s = Scheduler(SchedulerConfig(max_batch_size=2), kv)
    reqs = [port_req((0, 10 + i, 5, 4, p))
            for i, p in enumerate((0.1, 0.9, 0.5, 0.9))]
    batch = s.schedule([], reqs)
    assert [r.request_id for r, _ in batch.prefill] == [11, 13]


def _retention_run(bk):
    """Seal three two-block chains at retention priorities 60, 10 and 35
    and free them, then grow one sequence block by block past the free
    list; returns which prefixes still match after each block."""
    chains = {1: 60, 2: 10, 3: 35}
    for sid, prio in chains.items():
        toks = [sid * 100 + i for i in range(8)]
        bk.add_sequence(sid, toks)
        bk.set_seq_priority(sid, prio)
        bk.grow_sequence(sid, 8)
        bk.seal_full_blocks(sid, toks)
        bk.free_sequence(sid)
    bk.add_sequence(50, [7] * 4)
    seen = []
    for n in range(9, 16):
        bk.grow_sequence(50, 4 * n)
        seen.append(tuple(bk.match_prefix([sid * 100 + i for i in range(9)])
                          for sid in chains))
    return seen, bk.stats(), bk.block_table(50, 16)


def test_retention_eviction_order_equals_jax():
    """Lowest retention priority evicts first, LRU within a priority."""
    ref = _retention_run(JaxPyBookkeeping(16, 4, True))
    for bk in (_PyBookkeeping(16, 4, True),
               _NativeBookkeeping(load_native(), 16, 4, True)):
        assert _retention_run(bk) == ref
    assert ref[0] == [(8, 8, 8), (8, 0, 8), (8, 0, 8), (8, 0, 0),
                      (8, 0, 0), (0, 0, 0), (0, 0, 0)]


def test_llm_priorities_admit_high_first():
    """With one batch slot, queued requests run in priority order; the
    retention priority reaches the KV manager."""
    cfg = ModelConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                      num_layers=1, num_heads=2, num_kv_heads=1, head_dim=32,
                      max_position=64)
    llm = T.LLM(model=cfg, device="cpu", skip_tokenizer_init=True,
                max_seq_len=32, max_batch_size=1, kv_num_blocks=32,
                kv_block_size=4, return_perf_metrics=True)
    seen = []
    orig = llm.kv_manager.set_seq_priority
    llm.kv_manager.set_seq_priority = lambda s, p: (seen.append(p),
                                                    orig(s, p))
    sp = T.SamplingParams(max_tokens=3, temperature=0.0, ignore_eos=True)
    try:
        fs = [llm._future([1, 2, 3, i + 4], sp, None, 20, p)
              for i, p in enumerate((0.2, 0.9, 0.5))]
        llm.executor.submit_many([f.req for f in fs])   # one admission
        outs = [f.result() for f in fs]
    finally:
        llm.shutdown()
    first = [o.metrics["first_scheduled_time"] for o in outs]
    assert first[1] < first[2] < first[0]
    assert seen == [20, 20, 20]
