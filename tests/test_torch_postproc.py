"""The port's stop-string scan worker (`runtime/postproc.py`) against the
JAX package's, and stop strings end to end.

* `StopScanWorker` against JAX's on the same token streams, with a
  tokenizer that declares incremental decoding and one that declares it
  does not (JAX's worker re-decodes the whole output for that one; the
  port's scans incrementally with every tokenizer, as its streamed text
  is detokenized): the same hits (tokens at the match, stop string), and
  the same treatment of special tokens under `skip_special_tokens`.
* End to end on a tiny model (the JAX `LLM`'s weights, its TINY config),
  with the overlap pipeline kept full (`_force_lag`), so that the chunks
  sample past a match: `result()` and the stream equal a synchronous scan
  of the same tokens (the first token count at which any stop string
  appears in the text), the tokens sampled past the match are dropped, the
  stop string is cut from the text unless `include_stop_str_in_output`;
  a stop string that completes in the chunk where the request reaches
  `max_tokens` wins; the scan runs off the executor thread; stop-string
  requests still decode in fused chunks (`decode_steps > 1`).
"""

import threading

import jax
import numpy as np
import pytest

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.runtime.postproc import StopScanWorker as JWorker
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax
from tensorrt_llm_tpu_torch.runtime.postproc import StopScanWorker
from tensorrt_llm_tpu_torch.runtime.request import LlmRequest

TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            max_position=256)
KW = dict(max_seq_len=128, max_batch_size=8, kv_num_blocks=128,
          kv_block_size=8, max_decode_steps=8, overlap_depth=4)


class RecordingTokenizer:
    """One printable character a token (id 0 is the special </s>); records
    the threads that decode."""
    eos_token_id = 0
    bos_token_id = None

    def __init__(self, incremental=True):
        self.decode_threads = set()
        self.supports_incremental_decode = incremental

    def encode(self, text):
        return [1 + (ord(c) - 33) % 255 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        self.decode_threads.add(threading.current_thread().name)
        return "".join(("" if skip_special_tokens else "</s>") if i == 0
                       else chr(33 + (i - 1) % 90) for i in ids)


def sync_scan(tok, tokens, stops, skip=True):
    """The synchronous reference scan: (tokens at the first match, stop)
    or None."""
    for n in range(1, len(tokens) + 1):
        text = tok.decode(tokens[:n], skip_special_tokens=skip)
        for s in stops:
            if s in text:
                return n, s
    return None


# ----------------------------------------------------------------- worker --
STREAMS = [
    ([5, 6, 7, 8, 9, 10, 11, 12], ["$%&"], [3, 8]),
    ([40, 41, 0, 42, 43, 44, 45, 46, 47, 48], ["JKL", "M"], [2, 5, 10]),
    ([20] * 12, ["555"], [1, 2, 3, 12]),
    ([70, 71, 72], ["zzz"], [3]),
]


@pytest.mark.parametrize("incremental", [True, False])
@pytest.mark.parametrize("case", range(len(STREAMS)))
def test_scan_worker_matches_jax(case, incremental):
    """Each stream fed in the pieces its cut points give, to both workers,
    as the executor feeds them (the whole output list each time)."""
    tokens, stops, cuts = STREAMS[case]
    tok = RecordingTokenizer(incremental)
    hits = []
    for cls in (JWorker, StopScanWorker):
        w = cls(tok)
        try:
            for c in cuts:
                w.feed(1, stops, tokens[:c], skip_special_tokens=True)
            assert w.flush()
            hits.append(w.poll())
        finally:
            w.close()
    assert hits[0] == hits[1]
    want = sync_scan(tok, tokens[:cuts[-1]], stops)
    assert hits[1] == ({} if want is None else {1: want})


def test_scan_respects_skip_special_tokens():
    """A stop string spanning a special token matches only when the
    request keeps special tokens, in both workers."""
    tok = RecordingTokenizer(incremental=False)
    toks = [1, 0, 2]                          # "!" </s> '"'
    got = []
    for cls in (JWorker, StopScanWorker):
        w = cls(tok)
        try:
            w.feed(1, ['!</s>"'], toks, skip_special_tokens=False)
            w.feed(2, ['!</s>"'], toks, skip_special_tokens=True)
            w.feed(3, ['!"'], toks, skip_special_tokens=True)
            assert w.flush()
            got.append(w.poll())
        finally:
            w.close()
    assert got[0] == got[1]
    assert set(got[1]) == {1, 3} and got[1][1] == (3, '!</s>"')


# ------------------------------------------------------------- end to end --
@pytest.fixture(scope="module")
def llm():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TLLM_KV_BOOKKEEPING", "python")
        jl = J.LLM(model=JCfg(**TINY), seed=0, skip_tokenizer_init=True,
                   max_seq_len=128, max_batch_size=8, kv_num_blocks=128,
                   kv_block_size=8)
    try:
        params = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
    finally:
        jl.shutdown()
    tl = T.LLM(model=ModelConfig(**TINY), tokenizer=RecordingTokenizer(),
               device="cpu", params=params, **KW)
    tl.executor._force_lag = True      # chunks stay in flight: overshoot
    yield tl
    tl.shutdown()


def greedy(**kw):
    return T.SamplingParams(temperature=0.0, ignore_eos=True, **kw)


def reference(llm, prompt, salt):
    """Greedy tokens and text of `prompt` without a stop string."""
    o = llm.generate(prompt, greedy(max_tokens=24), cache_salt=salt)[0]
    return o.outputs[0].token_ids, o.outputs[0].text


def stop_at(tok, ref, n):
    """A stop string whose first match completes at output token n - 1,
    spanning the boundary before it."""
    text = tok.decode(ref)
    for lo in range(n - 3, -1, -1):
        s = text[lo:n]
        if sync_scan(tok, ref, [s]) == (n, s):
            return s
    pytest.skip("no stop string completes first at this token")


def test_overshoot_is_truncated_in_result(llm):
    tok = llm.tokenizer
    ref, text = reference(llm, "abcde", "r1")
    stop = stop_at(tok, ref, 5)       # inside the first k=8 chunk
    fut = llm.generate_async("abcde", greedy(max_tokens=24, stop=stop),
                             cache_salt="r1b")
    out = fut.result(timeout=60).outputs[0]
    assert fut.req._truncated_to is not None        # sampled past it
    assert out.finish_reason == "stop_string"
    assert out.token_ids == ref[:5]
    assert out.text == text[:text.index(stop)] and stop not in out.text
    keep = llm.generate("abcde", greedy(
        max_tokens=24, stop=stop, include_stop_str_in_output=True),
        cache_salt="r1c")[0].outputs[0]
    assert keep.token_ids == ref[:5]
    assert keep.text == tok.decode(ref[:5]) and stop in keep.text


def test_overshoot_is_truncated_in_the_stream(llm):
    tok = llm.tokenizer
    ref, text = reference(llm, "stream", "r2")
    stop = stop_at(tok, ref, 5)
    pieces = list(llm.generate_async("stream", greedy(
        max_tokens=24, stop=stop), streaming=True, cache_salt="r2b"))
    final = pieces[-1].outputs[0]
    assert pieces[-1].finished and final.finish_reason == "stop_string"
    assert max(len(p.outputs[0].token_ids) for p in pieces) > 5  # streamed
    assert final.token_ids == ref[:5]
    assert final.text == text[:text.index(stop)]
    keep = list(llm.generate_async("stream", greedy(
        max_tokens=24, stop=stop, include_stop_str_in_output=True),
        streaming=True, cache_salt="r2c"))[-1].outputs[0]
    assert keep.token_ids == ref[:5] and keep.text == tok.decode(ref[:5])


def test_stop_beats_length_in_the_same_chunk(llm):
    """The match completes at token 5; max_tokens 7 ends the request two
    tokens later in the same fused chunk: the stop string wins, as in a
    synchronous scan."""
    tok = llm.tokenizer
    ref, text = reference(llm, "chunk", "r3")
    stop = stop_at(tok, ref, 5)
    out = llm.generate("chunk", greedy(max_tokens=7, stop=stop),
                       cache_salt="r3b")[0].outputs[0]
    assert out.finish_reason == "stop_string"
    assert out.token_ids == ref[:5] and stop not in out.text
    # a match at the finishing token itself: length (check_stop first)
    out = llm.generate("chunk", greedy(max_tokens=5, stop=stop),
                       cache_salt="r3c")[0].outputs[0]
    assert out.finish_reason == "length" and out.token_ids == ref[:5]


def test_scan_runs_off_the_executor_thread_and_stays_fused(llm):
    tok = llm.tokenizer
    ref, _ = reference(llm, "world", "r4")
    stop = stop_at(tok, ref, 12)
    it0 = llm.executor.iteration
    tok.decode_threads.clear()
    out = llm.generate("world", greedy(max_tokens=24, stop=stop),
                       cache_salt="r4b")[0].outputs[0]
    assert out.finish_reason == "stop_string" and out.token_ids == ref[:12]
    assert "tllm-torch-executor" not in tok.decode_threads
    assert "tllm-stop-scan" in tok.decode_threads
    steps = [s["decode_steps"] for s in llm.get_stats()
             if s["iteration"] > it0]
    assert max(steps) > 1                  # fused chunks, not the host path
    assert not llm.executor._host_logits(
        [LlmRequest([1], greedy(max_tokens=4, stop=["x"]))])
