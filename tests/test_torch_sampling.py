"""Port parity of the host logits path: penalties, logit controls, top-N
and prompt logprobs, context and generation logits, parallel sampling
(``n``) and the batched logits processor, against the JAX package.

* `apply_penalties` and `top_n_logprobs` against JAX's on seeded numpy
  inputs (f32; 1e-6 relative, 1e-5 absolute for the logprobs); the
  device-side `TokenCounts` against a bincount of the history.
* `apply_logit_controls` against the JAX executor's
  `_apply_logit_controls`, called on a stub, on the same rows and
  histories: equal in f32 (1e-6).
* End to end on the TINY model of `tests/test_sampling_features.py`, with
  the JAX `LLM`'s weights: greedy tokens under each penalty and control
  equal the JAX `LLM`'s, or first differ at a near-tie (both tokens within
  `TIE` of the top of the controlled row, the rule of
  `tests/test_torch_llm.py`); every port token is the argmax of its own
  raw row (returned as generation logits) after the port's plain control
  functions, applied here on the CPU.
* Prompt logprobs and context logits: the capture of a chunk's rows
  against JAX's on the same f32 rows (1e-6); end to end within `MODEL_TOL`
  of JAX's (the model-parity tolerance of `tests/test_torch_model.py`:
  the two frameworks round bf16 activations in another order, so 1e-4 end
  to end is out of reach; logprobs carry the log-sum-exp's difference too,
  hence twice that); against the port's own context logits within 1e-4;
  the last context row equal to the first generation row bit for bit;
  prefix reuse refused; chunked prefill within 2e-2 of one chunk.
* Parallel sampling: n outputs from siblings seeded ``seed + j``,
  repeated calls equal, greedy siblings equal or first
  differing at a near-tie, KV shared through prefix reuse, streaming
  refused.
* The batched processor, and the intended differences: a stop string
  without a tokenizer raises at submit (the JAX package ignores it),
  processors get torch tensors on the logits' device and may return a
  tensor or an array, penalty counts live on the device, a seeded request
  repeats on one `LLM` across iterations, control token ids are checked at
  submit; a processor's exception ends only its request.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.runtime.executor import PyExecutor as JExecutor
from tensorrt_llm_tpu.runtime.request import LlmRequest as JRequest
from tensorrt_llm_tpu.runtime.sampler import (
    apply_penalties as j_apply_penalties, top_n_logprobs as j_top_n)
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax
from tensorrt_llm_tpu_torch.runtime.executor import PyExecutor
from tensorrt_llm_tpu_torch.runtime.request import LlmRequest
from tensorrt_llm_tpu_torch.runtime.sampler import (
    TokenCounts, apply_logit_controls, apply_penalties, top_n_logprobs)

from torch_parity import jax_generate

TIE = 0.02          # ~2 bf16 ulps of the largest logits
MODEL_TOL = 0.03    # JAX vs port logits of one bf16 model
TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            max_position=256)
V = TINY["vocab_size"]
KW = dict(skip_tokenizer_init=True, max_seq_len=128, max_batch_size=8,
          kv_num_blocks=128, kv_block_size=8)
PROMPTS = [[3, 5, 3, 5, 7], [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
           [40, 2, 90, 2, 40]]


# ------------------------------------------------------------- unit ops ---
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_penalties_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, Vs = 5, 97
    logits = (rng.standard_normal((B, Vs)) * 3).astype(np.float32)
    counts = (rng.integers(0, 4, (B, Vs))
              * (rng.random((B, Vs)) < 0.3)).astype(np.int32)
    rep = rng.uniform(0.5, 2.0, B).astype(np.float32)
    pres = rng.uniform(-1, 1, B).astype(np.float32)
    freq = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    want = np.asarray(j_apply_penalties(*map(jnp.asarray, (
        logits, counts, rep, pres, freq))))
    got = apply_penalties(*map(torch.from_numpy, (
        logits, counts, rep, pres, freq))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_apply_penalties_worked_example():
    """The JAX spec's example: 2.0/2 - 0.1 - 0.05*3 and -1*2 - 0.1 - 0.05."""
    out = apply_penalties(torch.tensor([[2.0, -1.0, 0.5, 0.0]]),
                          torch.tensor([[3, 1, 0, 0]], dtype=torch.int32),
                          torch.tensor([2.0]), torch.tensor([0.1]),
                          torch.tensor([0.05]))[0]
    np.testing.assert_allclose(out.numpy(), [0.75, -2.15, 0.5, 0.0],
                               atol=1e-6)


@pytest.mark.parametrize("n", [1, 5])
def test_top_n_logprobs_matches_jax(n):
    rng = np.random.default_rng(n)
    logits = (rng.standard_normal((4, 300)) * 4).astype(np.float32)
    jv, ji = map(np.asarray, j_top_n(jnp.asarray(logits), n))
    tv, ti = top_n_logprobs(torch.from_numpy(logits), n)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6, atol=1e-5)


def test_token_counts_follow_the_history():
    """Rows equal a bincount of each request's tokens modulo V while the
    requests grow, past the pool's first 8 rows, and after a drop (the row
    is reused zeroed)."""
    Vs = 50
    tc = TokenCounts(Vs, "cpu")
    rng = np.random.default_rng(0)
    reqs = [LlmRequest([int(t) for t in rng.integers(0, 200, 6)],
                       T.SamplingParams()) for _ in range(11)]

    def check(rs):
        got = tc.rows(rs).numpy()
        for row, r in zip(got, rs):
            want = np.bincount(np.asarray(r.all_token_ids) % Vs,
                               minlength=Vs)
            np.testing.assert_array_equal(row, want)

    for step in range(4):
        for r in reqs:
            r.output_token_ids.append(int(rng.integers(0, 200)))
        check(reqs[: 3 + 3 * step])
    assert tc.pool.shape[0] == 16                     # grew once
    tc.drop(reqs[0].request_id)
    fresh = LlmRequest([1, 1, 2], T.SamplingParams())
    check([fresh] + reqs[1:])


# --------------------------------------------------------- logit controls --
def _proc(toks, row):
    """A processor the JAX package (numpy) and the port (torch) both run."""
    row[(toks[-1] * 7) % len(row)] += 4.0
    return row * 0.5


CONTROL_CASES = {
    "bias": dict(logit_bias={3: 2.5, 7: -1.25, 200: 0.1}),
    "min_tokens": dict(min_tokens=5, stop_token_ids=[9, 11]),
    "min_tokens_end_id": dict(min_tokens=5, end_id=4),
    "min_tokens_reached": dict(min_tokens=2, stop_token_ids=[9]),
    "bad_words": dict(bad_words=[[4], [1, 2, 6], [9, 9, 8]]),
    "ngram2": dict(no_repeat_ngram_size=2),
    "ngram3": dict(no_repeat_ngram_size=3),
    "processor": dict(logits_processor=_proc),
    "all": dict(logit_bias={6: 1.5}, min_tokens=9, bad_words=[[2, 6]],
                no_repeat_ngram_size=2, logits_processor=_proc),
}


@pytest.mark.parametrize("case", list(CONTROL_CASES))
def test_logit_controls_match_jax(case):
    """Three rows: the case's controls, a plain row, the controls again on
    another history; the same rows through JAX `_apply_logit_controls` on
    a stub executor and through the port's `apply_logit_controls`."""
    rng = np.random.default_rng(len(case))
    logits = (rng.standard_normal((3, V)) * 2).astype(np.float32)
    hist = [([5, 1, 2], [9, 1, 2]), ([7, 7], [3]), ([2, 6, 2, 6, 1], [2])]
    kw = CONTROL_CASES[case]
    sps = [kw, {}, kw]
    jreqs, treqs = [], []
    for (prompt, out), k in zip(hist, sps):
        for cls, SP, lst in ((JRequest, J.SamplingParams, jreqs),
                             (LlmRequest, T.SamplingParams, treqs)):
            r = cls(list(prompt), SP(max_tokens=16, **k))
            r.output_token_ids = list(out)
            lst.append(r)
    stub = types.SimpleNamespace(eos_token_id=0)
    want = np.asarray(JExecutor._apply_logit_controls(stub, jreqs,
                                                      logits.copy()))
    got = apply_logit_controls(torch.from_numpy(logits.copy()), treqs, 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[1], logits[1])


# ------------------------------------------------------------- end to end --
@pytest.fixture(scope="module")
def pair():
    """(JAX `LLM`, port `LLM` on its weights); the JAX one keeps its KV
    bookkeeping in Python, so that it builds no native library while other
    test processes may be building it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TLLM_KV_BOOKKEEPING", "python")
        jl = J.LLM(model=JCfg(**TINY), seed=0, **KW)
    tl = None
    try:
        params = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
        tl = T.LLM(model=ModelConfig(**TINY), device="cpu", params=params,
                   **KW)
        yield jl, tl
    finally:
        jl.shutdown()
        if tl is not None:
            tl.shutdown()


def controlled(raw, sp, prompt, out, eos=None):
    """The port's plain controls on the CPU, in f32: penalties on counts
    of the history, then the logit controls, on one raw row."""
    hist = list(prompt) + list(out)
    row = torch.from_numpy(np.array(raw, np.float32))[None]
    if (sp.repetition_penalty, sp.presence_penalty,
            sp.frequency_penalty) != (1.0, 0.0, 0.0):
        counts = torch.from_numpy(np.bincount(np.asarray(hist) % V,
                                              minlength=V).astype(np.int32))
        row = apply_penalties(row, counts[None],
                              torch.tensor([sp.repetition_penalty]),
                              torch.tensor([sp.presence_penalty]),
                              torch.tensor([sp.frequency_penalty]))
    req = types.SimpleNamespace(sampling_params=sp, all_token_ids=hist,
                                num_output_tokens=len(out))
    return apply_logit_controls(row, [req], eos)[0].numpy()


def assert_greedy_parity(prompts, jax_toks, outs, sp):
    """Each port output is its own controlled argmax, and equals JAX's or
    first differs at a near-tie of the controlled row; one is exact."""
    exact = 0
    for p, a, o in zip(prompts, jax_toks, outs):
        b = o.outputs[0].token_ids
        rows = o.outputs[0].generation_logits
        assert rows.shape == (len(b), V)
        for i, t in enumerate(b):
            c = controlled(rows[i], sp, p, b[:i])
            assert t == int(np.argmax(c)), (i, t, int(np.argmax(c)))
        if a == b:
            exact += 1
            continue
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        c = controlled(rows[i], sp, p, b[:i])
        top = c.max()
        assert c[a[i]] >= top - TIE and c[b[i]] >= top - TIE, (
            f"token {i} differs without a near-tie: jax {a[i]} "
            f"({c[a[i]]}), port {b[i]} ({c[b[i]]}), top {top}")
    assert exact >= 1


E2E_CASES = {
    "repetition": dict(repetition_penalty=1.6),
    "presence_frequency": dict(presence_penalty=0.8, frequency_penalty=0.5),
    "logit_bias": dict(logit_bias={41: 0.6, 100: 0.4}),
    "bad_words": dict(bad_words=[[17], [5, 7]]),
    "min_tokens": dict(min_tokens=6, stop_token_ids=[13],
                       logit_bias={13: 3.0}),
    "no_repeat_ngram": dict(no_repeat_ngram_size=2),
    "processor": dict(logits_processor=_proc),
    "all": dict(repetition_penalty=1.3, frequency_penalty=0.2,
                logit_bias={41: 0.5}, bad_words=[[5, 7]],
                no_repeat_ngram_size=3, logits_processor=_proc),
}


@pytest.mark.parametrize("case", list(E2E_CASES))
def test_controlled_greedy_tokens_match_jax(pair, case):
    jl, tl = pair
    kw = dict(max_tokens=8, temperature=0.0,
              ignore_eos="min_tokens" not in case, **E2E_CASES[case])
    jtoks = jax_generate(jl, PROMPTS, J.SamplingParams(**kw))
    sp = T.SamplingParams(return_generation_logits=True, **kw)
    outs = tl.generate(PROMPTS, sp)
    assert_greedy_parity(PROMPTS, jtoks, outs, sp)
    if case == "min_tokens":
        # 13 is banned before 6 outputs and wins (bias) once allowed
        for o in outs:
            t = o.outputs[0].token_ids
            assert 13 not in t[:5]
    steps = [s["decode_steps"] for s in tl.get_stats()[-3:]]
    assert max(steps) == 1                       # the host path's k = 1


def test_logprobs_top_n_of_controlled_rows(pair):
    """`logprobs=5` are the top 5 (and the chosen token) of the log-softmax
    of the controlled row."""
    _, tl = pair
    sp = T.SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True,
                          logprobs=5, presence_penalty=0.7,
                          return_generation_logits=True)
    o = tl.generate([PROMPTS[1]], sp)[0].outputs[0]
    assert len(o.logprobs) == 6
    for i, (t, d) in enumerate(zip(o.token_ids, o.logprobs)):
        c = controlled(o.generation_logits[i], sp, PROMPTS[1],
                       o.token_ids[:i]).astype(np.float64)
        lsm = c - (np.log(np.exp(c - c.max()).sum()) + c.max())
        assert set(d) == set(np.argsort(-lsm)[:5].tolist()) | {t}
        for k, v in d.items():
            assert abs(v - lsm[k]) < 1e-4


def test_generation_logits_in_a_mixed_batch(pair):
    """One decode batch on the host path where only one request returns
    generation logits: that one gets a raw row per token, the plain one
    none, and the executor keeps serving."""
    _, tl = pair
    with_rows = T.SamplingParams(max_tokens=6, temperature=0.0,
                                 ignore_eos=True,
                                 return_generation_logits=True)
    plain = T.SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True)
    a, b = tl.generate(PROMPTS[:2], [with_rows, plain])
    rows = a.outputs[0].generation_logits
    assert rows.shape == (6, V)
    assert a.outputs[0].token_ids == np.argmax(rows, axis=-1).tolist()
    assert len(b.outputs[0].token_ids) == 6
    assert b.outputs[0].generation_logits is None
    assert max(s["decode_steps"] for s in tl.get_stats()[-3:]) == 1
    assert tl.executor._error is None


# -------------------------------------------- prompt logprobs and logits --
def test_capture_prompt_rows_matches_jax():
    """The same f32 rows in two chunks (0..5, 5..9) of a 10-token prompt
    through JAX's `_capture_prompt_rows` and the port's."""
    rng = np.random.default_rng(3)
    prompt = [int(t) for t in rng.integers(0, V, 10)]
    rows = (rng.standard_normal((10, V)) * 3).astype(np.float32)
    sp = dict(max_tokens=2, prompt_logprobs=4, return_context_logits=True)
    jr = JRequest(prompt, J.SamplingParams(**sp))
    tr = LlmRequest(prompt, T.SamplingParams(**sp))
    for start, chunk in ((0, 5), (5, 5)):
        JExecutor._capture_prompt_rows(None, jr, start, chunk,
                                       rows[start:start + chunk])
        PyExecutor._capture_prompt_rows(tr, start, chunk,
                                        rows[start:start + chunk])
    np.testing.assert_array_equal(tr.context_logits, jr.context_logits)
    assert len(tr.prompt_logprobs) == len(jr.prompt_logprobs) == 10
    assert tr.prompt_logprobs[0] is None and jr.prompt_logprobs[0] is None
    for a, b in zip(tr.prompt_logprobs[1:], jr.prompt_logprobs[1:]):
        assert set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) < 1e-6


def _lsm(row):
    row = np.asarray(row, np.float64)
    return row - (np.log(np.exp(row - row.max()).sum()) + row.max())


def test_prompt_logprobs_and_logits_match_jax(pair):
    jl, tl = pair
    prompt = list(range(3, 20))
    kw = dict(max_tokens=4, temperature=0.0, ignore_eos=True,
              prompt_logprobs=4, return_context_logits=True,
              return_generation_logits=True)
    j = jl.generate([prompt], J.SamplingParams(**kw))[0]
    t = tl.generate([prompt], T.SamplingParams(**kw))[0]
    cl = t.context_logits
    assert cl.shape == j.context_logits.shape == (len(prompt), V)
    np.testing.assert_allclose(cl, j.context_logits, atol=MODEL_TOL, rtol=0)
    jt, tt = j.outputs[0].token_ids, t.outputs[0].token_ids
    same = next((i for i, (a, b) in enumerate(zip(jt, tt)) if a != b),
                len(tt))
    np.testing.assert_allclose(t.outputs[0].generation_logits[:same + 1],
                               j.outputs[0].generation_logits[:same + 1],
                               atol=MODEL_TOL, rtol=0)
    # the last context row is the first generation row, bit for bit
    assert np.array_equal(cl[-1], t.outputs[0].generation_logits[0])
    pl, jpl = t.prompt_logprobs, j.prompt_logprobs
    assert len(pl) == len(prompt) and pl[0] is None
    for pos in range(1, len(prompt)):
        tok = prompt[pos]
        assert len(pl[pos]) >= 4 and tok in pl[pos]
        assert abs(pl[pos][tok] - jpl[pos][tok]) < 2 * MODEL_TOL
        lsm = _lsm(cl[pos - 1])
        for k, v in pl[pos].items():
            assert abs(v - lsm[k]) < 1e-4


def test_prompt_logprobs_refuse_prefix_reuse(pair):
    """A second identical prompt computes every row again: no cached
    tokens, the same prompt logprobs."""
    _, tl = pair
    prompt = [int(t) for t in np.random.default_rng(9).integers(1, V, 27)]
    sp = T.SamplingParams(max_tokens=2, temperature=0.0, ignore_eos=True,
                          prompt_logprobs=2)
    a = tl.generate_async(prompt, sp)
    ra = a.result()
    b = tl.generate_async(prompt, sp)
    rb = b.result()
    assert b.req.num_cached_tokens == 0
    assert len(ra.prompt_logprobs) == len(rb.prompt_logprobs) == len(prompt)
    assert ra.prompt_logprobs == rb.prompt_logprobs
    # their blocks were sealed under salts of their own: a plain request
    # of the same prompt finds none of them
    c = tl.generate_async(prompt, T.SamplingParams(max_tokens=2))
    c.result()
    assert c.req.num_cached_tokens == 0


def test_context_logits_chunked_prefill_consistent(pair):
    jl, tl = pair
    prompt = list(range(3, 27))
    sp = T.SamplingParams(max_tokens=2, ignore_eos=True, temperature=0.0,
                          return_context_logits=True)
    whole = tl.generate([prompt], sp)[0].context_logits
    llm = T.LLM(model=ModelConfig(**TINY), device="cpu",
                params=tl.model.state(), **dict(KW, max_num_tokens=8))
    try:
        chunked = llm.generate([prompt], sp)[0].context_logits
        assert max(s["num_prefill_chunks"] for s in llm.get_stats()) == 1
        assert sum(s["num_prefill_chunks"] for s in llm.get_stats()) == 3
    finally:
        llm.shutdown()
    assert whole.shape == chunked.shape == (24, V)
    np.testing.assert_allclose(chunked, whole, rtol=0, atol=2e-2)


# ------------------------------------------------------ parallel sampling --
def test_parallel_sampling_fans_out(pair):
    """n sibling requests seeded seed + j share the prompt's KV; a second
    call under a fresh cache salt (the same schedule) repeats them."""
    _, tl = pair
    prompt = list(range(30, 51))
    sp = T.SamplingParams(max_tokens=6, temperature=0.8, seed=5, n=3,
                          ignore_eos=True)
    runs = []
    for salt in ("n1", "n2"):
        reused0 = tl.get_kv_cache_stats()["reused_blocks"]
        fut = tl.generate_async(prompt, sp, cache_salt=salt)
        assert [s.req.sampling_params.seed for s in fut.subs] == [5, 6, 7]
        assert all(s.req.sampling_params.n == 1 for s in fut.subs)
        r = fut.result()
        assert tl.get_kv_cache_stats()["reused_blocks"] > reused0
        assert [o.index for o in r.outputs] == [0, 1, 2]
        runs.append([o.token_ids for o in r.outputs])
    assert runs[0] == runs[1]
    assert len({tuple(t) for t in runs[0]}) > 1
    with pytest.raises(ValueError, match="streaming"):
        tl.generate_async(prompt, sp, streaming=True)


def test_parallel_sampling_greedy_siblings_agree(pair):
    """Greedy siblings give one output, or first differ at a near-tie (the
    siblings after the first compute only the prompt's tail: another
    summation order)."""
    _, tl = pair
    sp = T.SamplingParams(max_tokens=8, temperature=0.0, n=4, logprobs=2,
                          ignore_eos=True)
    outs = tl.generate([list(range(60, 83))], sp)[0].outputs
    first = outs[0]
    for o in outs[1:]:
        if o.token_ids == first.token_ids:
            continue
        i = next(i for i, (x, y) in enumerate(zip(first.token_ids,
                                                  o.token_ids)) if x != y)
        d = first.logprobs[i]
        assert o.token_ids[i] in d and \
            d[first.token_ids[i]] - d[o.token_ids[i]] <= TIE


# ----------------------------------------------------- batched processor --
def test_batched_logits_processor():
    """One callable over each batch: it gets the request ids, their token
    lists and the batch's logits as a tensor on the model's device, and
    forces token (len(tokens) * 31) % V in every row."""
    seen = {"calls": 0, "batch": 0, "types": set()}

    def proc(req_ids, token_lists, logits):
        seen["calls"] += 1
        seen["batch"] = max(seen["batch"], len(req_ids))
        seen["types"].add((type(logits), logits.device.type))
        assert len(req_ids) == len(token_lists) == logits.shape[0]
        want = torch.tensor([len(t) * 31 % V for t in token_lists])
        logits[torch.arange(len(req_ids)), want] = 1e9
        return logits

    llm = T.LLM(model=ModelConfig(**TINY), device="cpu", seed=1,
                batched_logits_processor=proc, **KW)
    try:
        prompts = [[1, 2], [3, 4, 5]]
        outs = llm.generate(prompts, T.SamplingParams(
            max_tokens=4, temperature=0.0, ignore_eos=True))
        for p, o in zip(prompts, outs):
            assert o.outputs[0].token_ids == [
                (len(p) + i) * 31 % V for i in range(4)]
        assert max(s["decode_steps"] for s in llm.get_stats()) == 1
    finally:
        llm.shutdown()
    assert seen["calls"] >= 5 and seen["batch"] == 2
    assert seen["types"] == {(torch.Tensor, "cpu")}


# --------------------------------------------------- intended differences --
def test_stop_string_without_tokenizer_raises_at_submit(pair):
    jl, tl = pair
    j = jl.generate([[5, 6, 7]], J.SamplingParams(max_tokens=3, stop="x",
                                                  ignore_eos=True))[0]
    assert len(j.outputs[0].token_ids) == 3         # JAX: ignored silently
    with pytest.raises(ValueError, match="stop strings need a tokenizer"):
        tl.generate([[5, 6, 7]], T.SamplingParams(max_tokens=3, stop="x"))


def test_processors_get_tensors_and_may_return_arrays(pair):
    _, tl = pair
    seen = []

    def proc(toks, row):
        seen.append((type(row), row.device))
        out = row.numpy().copy()           # an array back
        out[:] = -1e30
        out[13] = 0.0
        return out

    o = tl.generate([[1, 2, 3]], T.SamplingParams(
        max_tokens=3, temperature=0.0, ignore_eos=True,
        logits_processor=proc))[0].outputs[0]
    assert o.token_ids == [13, 13, 13]
    assert set(seen) == {(torch.Tensor, tl.engine.device)}


def test_penalty_counts_live_on_the_device(pair):
    _, tl = pair
    ex = tl.executor
    tl.generate([PROMPTS[0]], T.SamplingParams(
        max_tokens=4, temperature=0.0, ignore_eos=True,
        repetition_penalty=1.2))
    assert ex._counts.pool.device == tl.engine.device
    assert not ex._counts.slot                    # freed with the request


def test_seeded_request_repeats_across_iterations(pair):
    _, tl = pair
    sp = T.SamplingParams(max_tokens=8, temperature=0.9, seed=21,
                          ignore_eos=True)
    a = tl.generate([PROMPTS[2]], sp, cache_salt="s1")[0]
    tl.generate([PROMPTS[0]], T.SamplingParams(max_tokens=5))  # iterations
    b = tl.generate([PROMPTS[2]], sp, cache_salt="s2")[0]
    assert b.outputs[0].token_ids == a.outputs[0].token_ids
    # without a seed, two requests draw apart (the default follows the id)
    free = T.SamplingParams(max_tokens=12, temperature=2.0, ignore_eos=True)
    c, d = (tl.generate([PROMPTS[2]], free, cache_salt=f"u{i}")[0]
            .outputs[0].token_ids for i in range(2))
    assert c != d


def test_processor_error_ends_only_its_request(pair):
    _, tl = pair

    def boom(toks, row):
        raise RuntimeError("boom")

    bad = tl.generate_async([1, 2], T.SamplingParams(
        max_tokens=3, logits_processor=boom))
    good = tl.generate_async([1, 2], T.SamplingParams(
        max_tokens=3, ignore_eos=True, temperature=0.0))
    with pytest.raises(RuntimeError, match="logits processor"):
        bad.result(timeout=60)
    assert len(good.result(timeout=60).outputs[0].token_ids) == 3
    assert tl.executor._error is None


@pytest.mark.parametrize("kw", [dict(logit_bias={V: 1.0}),
                                dict(bad_words=[[1, -1]]),
                                dict(bad_words=[[]]),
                                dict(stop_token_ids=[V + 3]),
                                dict(end_id=-2)])
def test_control_ids_are_checked_at_submit(pair, kw):
    """A token id past the logits (or an empty bad word) is refused at
    submit; the executor keeps serving."""
    _, tl = pair
    with pytest.raises(ValueError):
        tl.generate([[1, 2]], T.SamplingParams(max_tokens=2, **kw))
    assert len(tl.generate([[1, 2]], T.SamplingParams(
        max_tokens=2, ignore_eos=True))[0].outputs[0].token_ids) == 2
