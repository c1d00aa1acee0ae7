"""Port parity of speculative decoding's features around the rounds: which
requests speculate (not sampled ones, not those asking for logprobs or
generation logits; stop strings and penalties keep plain tokens), the gate
(`draft_len_schedule`, `acceptance_window`), relaxed acceptance inside
thinking spans only, SAVE_HIDDEN_STATES shards, the overlap pipeline on
and off, streamed pieces, the server's counters, MTP on an MLA checkpoint
whose extra layer `load_hf_weights` hands to the drafter, and the
refusals (TP, DP, PP, star CP).  Tokens and `spec_stats` are held against
the JAX package's under the same config wherever its result does not
depend on thread timing.
"""

import http.client
import json

import jax
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.speculative import SpeculativeConfig as JSpec
from tensorrt_llm_tpu.speculative import SpeculativeMode as JM
from tensorrt_llm_tpu.speculative.save_hidden import (
    load_hidden_state_shards as jax_load_shards)
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.models import params_from_jax
from tensorrt_llm_tpu_torch.runtime.executor import PyExecutor
from tensorrt_llm_tpu_torch.speculative import (
    SpeculativeConfig, SpeculativeMode)
from tensorrt_llm_tpu_torch.speculative.save_hidden import (
    load_hidden_state_shards)

from torch_parity import hf_tensor_shapes, jax_generate, write_hf_checkpoint
from torch_spec import (LLM_KW, TINY, assert_parity, assert_same_or_tie,
                        configs, greedy_params, mtp_tensors, run_pair,
                        serve_port)

V = TINY["vocab_size"]
BT, ET = 60, 61      # begin / end thinking tokens


@pytest.fixture(autouse=True)
def _python_bookkeeping(monkeypatch):
    monkeypatch.setenv("TLLM_KV_BOOKKEEPING", "python")


def _mode(name):
    return lambda side, jl: JM(name) if side == "jax" \
        else SpeculativeMode(name)


def _user(proposer, **kw):
    return dict(mode=_mode("USER_PROVIDED"), proposer=proposer, **kw)


class Tok:
    """Character-level tokenizer of the JAX speculative tests."""
    eos_token_id = 0
    bos_token_id = None
    chat_template = None

    def encode(self, text, add_special_tokens=True):
        return [max(1, ord(c) % 64) for c in text] or [1]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(48 + (i % 40)) for i in ids)


def _ngram():
    return SpeculativeConfig(mode=SpeculativeMode.NGRAM, max_draft_len=4)


def test_spec_skipped_for_sampled_logprobs_and_generation_logits():
    _, tcfg = configs()
    llm = T.LLM(model=tcfg, device="cpu", seed=0, speculative_config=_ngram(),
                **LLM_KW)
    try:
        out = llm.generate([1, 2, 1, 2, 1], T.SamplingParams(
            max_tokens=8, temperature=1.0, ignore_eos=True))
        assert len(out[0].outputs[0].token_ids) == 8
        out = llm.generate([[3, 5, 3, 5, 3, 5, 7]], greedy_params(
            T, 8, logprobs=1, return_generation_logits=True))[0].outputs[0]
        assert len(out.logprobs) == len(out.token_ids) == 8
        assert out.generation_logits.shape[0] == 8
        assert [int(t) for t in np.argmax(out.generation_logits, -1)] \
            == out.token_ids
        assert llm.executor.spec_stats["rounds"] == 0
    finally:
        llm.shutdown()


@pytest.mark.parametrize("kind", ["penalty", "stop"])
def test_stop_strings_and_penalties_keep_plain_tokens(kind):
    """A repetition penalty sends its request to the host logits path (no
    rounds); a stop string rides the rounds and cuts at the match.  Both
    give the plain run's tokens, and JAX's under the same config."""
    jcfg, tcfg = configs()
    kw = dict(LLM_KW, skip_tokenizer_init=False)
    sp = dict(max_tokens=24, temperature=0.0, ignore_eos=True)
    if kind == "penalty":
        sp["repetition_penalty"] = 1.4
    jl = J.LLM(model=jcfg, tokenizer=Tok(), seed=4,
               speculative_config=JSpec(mode=JM.NGRAM, max_draft_len=4), **kw)
    try:
        params = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
        if kind == "stop":
            plain = serve_port(tcfg, params, None, ["ababab"], 24,
                               dict(kw, tokenizer=Tok()))[0]
            sp["stop"] = [Tok().decode(plain[10:13])]
        jout = jl.generate("ababab", J.SamplingParams(**sp))[0].outputs[0]
    finally:
        jl.shutdown()
    results = []
    for spec in (None, _ngram()):
        tl = T.LLM(model=tcfg, tokenizer=Tok(), device="cpu", params=params,
                   speculative_config=spec, **kw)
        try:
            o = tl.generate("ababab", T.SamplingParams(**sp))[0].outputs[0]
            results.append((o.token_ids, o.text,
                            getattr(tl.executor, "spec_stats", {})))
        finally:
            tl.shutdown()
    (plain_ids, plain_text, _), (ids, text, st) = results
    assert ids == plain_ids and text == plain_text
    assert ids == jout.token_ids and text == jout.text
    if kind == "penalty":
        assert st["rounds"] == 0
    else:
        assert st["rounds"] > 0 and len(ids) < 24


def test_draft_len_schedule_caps_drafts():
    r = run_pair(_user(lambda req: [9] * 6, max_draft_len=6,
                       draft_len_schedule={1: 2}), [[3, 5, 3, 5]], n=10)
    assert_parity(r)
    st = r["port_stats"]
    assert st["proposed"] <= 2 * st["rounds"], st


def test_acceptance_window_disables_speculation():
    r = run_pair(_user(lambda req: [63, 62, 61], max_draft_len=3,
                       acceptance_window=3, acceptance_length_threshold=1.5),
                 [[3, 5, 3, 5]], n=20)
    assert_parity(r)
    assert r["port_stats"]["rounds"] <= 4, r["port_stats"]


def test_relaxed_accept_unit():
    row = np.log(np.array([0.5, 0.3, 0.15, 0.05]))
    assert PyExecutor._relaxed_accept(row, 1, topk=2, delta=0.25)
    assert not PyExecutor._relaxed_accept(row, 1, topk=2, delta=0.1)
    assert not PyExecutor._relaxed_accept(row, 2, topk=2, delta=1.0)
    assert PyExecutor._relaxed_accept(row, 0, topk=1, delta=0.0)
    assert not PyExecutor._relaxed_accept(row, 1, topk=1, delta=0.0)


def _relaxed(proposer, on=True, k=4):
    return _user(proposer, max_draft_len=k,
                 use_relaxed_acceptance_for_thinking=on, relaxed_topk=V,
                 relaxed_delta=1.0, begin_thinking_phase_token=BT,
                 end_thinking_phase_token=ET)


def test_relaxed_acceptance_inside_thinking_only():
    """Inside <think> every draft is accepted (the outputs follow the
    drafter) and equal JAX's; a closed span or strict mode keeps plain
    greedy."""
    const = lambda req: [9, 9, 9, 9]   # noqa: E731
    r = run_pair(_relaxed(const), [[3, 5, BT, 7]], n=8)
    assert r["port"] == r["jax"] and r["port_stats"] == r["jax_stats"]
    assert r["port"][0][:4].count(9) >= 3, r["port"]
    assert_parity(run_pair(_relaxed(const, on=False), [[3, 5, BT, 7]], n=8))
    assert_parity(run_pair(_relaxed(const), [[3, BT, 5, ET, 7]], n=8))


def test_relaxed_exits_on_end_token():
    """A relaxed-accepted END token closes the span mid-chunk: the drafts
    after it are verified strictly."""
    r = run_pair(_relaxed(lambda req: [ET, 9, 9], k=3), [[3, 5, BT, 7]],
                 n=8)
    assert r["port"] == r["jax"] and r["port_stats"] == r["jax_stats"]
    got = r["port"][0]
    assert got[1] == ET, got
    prefix = [3, 5, BT, 7] + got[:2]
    tail = serve_port(r["cfg"], r["params"], None, [prefix], len(got) - 2,
                      LLM_KW)
    assert_same_or_tie(r["cfg"], r["params"], [prefix], [got[2:]], tail)


@pytest.mark.parametrize("capture", ["final", "eagle3"])
def test_save_hidden_shards_match_jax(capture, tmp_path):
    """SAVE_HIDDEN_STATES: the port's shards, read back by both packages'
    readers, hold JAX's records: the same ids and one hidden row a token,
    within a bf16 rounding of JAX's."""
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9]]
    out = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        r = run_pair(dict(mode=_mode("SAVE_HIDDEN_STATES"),
                          save_dir=str(d), save_write_interval=1,
                          save_capture=capture), prompts, n=5)
        out[side] = (d, r)
    jrecs = jax_load_shards(str(out["jax"][0]))
    precs = load_hidden_state_shards(str(out["port"][0]))
    assert len(precs) == len(jrecs) == 2
    assert [len(x["input_ids"]) for x in jax_load_shards(
        str(out["port"][0]))] == [len(x["input_ids"]) for x in precs]
    width = TINY["hidden_size"] * (3 if capture == "eagle3" else 1)
    for p, j in zip(precs, jrecs):
        assert p["input_ids"].tolist() == j["input_ids"].tolist()
        assert p["hidden_state"].shape == (len(p["input_ids"]), width)
        big = float(np.abs(j["hidden_state"]).max())
        np.testing.assert_allclose(p["hidden_state"], j["hidden_state"],
                                   atol=2.0 ** -6 * big, rtol=0)


@pytest.mark.parametrize("mode", ["ngram", "mtp"])
def test_overlap_on_and_off_agree(mode):
    """The pipeline on (default) and off give the same tokens and rounds;
    the fallback decodes of a round without drafts ride it."""
    spec = (_ngram() if mode == "ngram" else SpeculativeConfig(
        mode=SpeculativeMode.MTP, max_draft_len=3,
        mtp_weights=mtp_tensors().get))
    prompts = [[3, 5, 3, 5, 3, 5, 7], [2, 9, 11, 4, 6], [7, 7, 7, 1]]
    _, tcfg = configs()
    res = []
    for off in (False, True):
        tl = T.LLM(model=tcfg, device="cpu", seed=1, speculative_config=spec,
                   disable_overlap_scheduler=off, **LLM_KW)
        tl.executor._force_lag = True     # keep the pipeline full
        try:
            toks = [o.outputs[0].token_ids for o in tl.generate(
                prompts, greedy_params(T, 20))]
            res.append((toks, dict(tl.executor.spec_stats)))
        finally:
            tl.shutdown()
    assert res[0] == res[1]
    assert res[0][1]["rounds"] > 0


def test_streamed_pieces_carry_every_token():
    """A round appends several tokens: streamed pieces carry all of them,
    and the stream rebuilds the unstreamed tokens."""
    _, tcfg = configs()
    tl = T.LLM(model=tcfg, device="cpu", seed=0, speculative_config=_ngram(),
               **LLM_KW)
    try:
        prompt = [3, 5, 3, 5, 3, 5, 7]
        whole = tl.generate(prompt, greedy_params(T, 24))[0].outputs[0]
        pieces = [o.outputs[0].token_ids for o in tl.generate_async(
            prompt, greedy_params(T, 24), streaming=True)]
    finally:
        tl.shutdown()
    assert pieces[-1] == whole.token_ids
    steps = [len(b) - len(a) for a, b in zip([[]] + pieces, pieces)]
    assert max(steps) > 1, steps


def test_server_metrics_and_sse_carry_spec_tokens():
    """`/metrics` gains the JAX server's spec counters once a round ran;
    a streamed completion's SSE deltas rebuild the whole text."""
    from tensorrt_llm_tpu_torch.serve.openai_server import OpenAIServer
    _, tcfg = configs()
    tl = T.LLM(model=tcfg, tokenizer=Tok(), device="cpu", seed=0,
               speculative_config=_ngram(),
               **dict(LLM_KW, skip_tokenizer_init=False))
    st = OpenAIServer(tl, "tiny").start_in_thread()

    def call(method, path, body=None):
        c = http.client.HTTPConnection("127.0.0.1", st.port, timeout=120)
        c.request(method, path, body=None if body is None
                  else json.dumps(body).encode(),
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        out = r.status, r.read()
        c.close()
        return out

    try:
        _, raw = call("GET", "/metrics")
        assert b"tllm_tpu_spec_rounds" not in raw
        body = dict(model="tiny", prompt="ababab", max_tokens=24,
                    temperature=0.0, ignore_eos=True)
        s, raw = call("POST", "/v1/completions", body)
        assert s == 200
        whole = json.loads(raw)["choices"][0]["text"]
        s, raw = call("POST", "/v1/completions", dict(body, stream=True))
        deltas = [json.loads(line[6:])["choices"][0]["text"]
                  for line in raw.decode().splitlines()
                  if line.startswith("data: {")]
        assert "".join(deltas) == whole
        _, raw = call("GET", "/metrics")
        got = dict(line.split() for line in raw.decode().splitlines())
        sp = tl.executor.spec_stats
        assert sp["rounds"] > 0
        assert int(got["tllm_tpu_spec_proposed_tokens"]) == sp["proposed"]
        assert int(got["tllm_tpu_spec_accepted_tokens"]) == sp["accepted"]
        assert int(got["tllm_tpu_spec_rounds"]) == sp["rounds"]
    finally:
        st.stop()
        tl.shutdown()


# ---- MTP on an MLA checkpoint --------------------------------------------
_DS = dict(architectures=["DeepseekV3ForCausalLM"], model_type="deepseek_v3",
           vocab_size=64, hidden_size=128, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
           max_position_embeddings=256, moe_intermediate_size=64,
           n_routed_experts=8, num_experts_per_tok=3, n_shared_experts=1,
           first_k_dense_replace=1, kv_lora_rank=48, qk_rope_head_dim=16,
           qk_nope_head_dim=32, v_head_dim=32, q_lora_rank=None,
           num_nextn_predict_layers=1)


def _mtp_checkpoint(path):
    """A tiny DeepSeek checkpoint with its MTP block as layer 2 (an MoE
    layer, DeepSeek's names); returns the tensors as written (bf16)."""
    rng = np.random.default_rng(7)
    L = _DS["num_hidden_layers"]
    names = hf_tensor_shapes(dict(_DS, num_hidden_layers=L + 1))
    out = {}
    for name, (shape, kind) in names.items():
        std = 0.02 if kind in ("embed", "norm", "bias") else (
            0.05 if kind == "score_bias" else 0.5 / np.sqrt(shape[-1]))
        a = rng.standard_normal(shape).astype(np.float32) * std
        out[name] = a + 1.0 if kind == "norm" else a
    H = _DS["hidden_size"]
    pre = f"model.layers.{L}."
    out[pre + "eh_proj.weight"] = (rng.standard_normal((H, 2 * H))
                                   * 0.5 / np.sqrt(2 * H)).astype(np.float32)
    for n in ("enorm", "hnorm", "shared_head.norm"):
        out[pre + n + ".weight"] = (1 + 0.02 * rng.standard_normal(H)
                                    ).astype(np.float32)
    return write_hf_checkpoint(path, _DS, tensors=out)


def test_mtp_on_mla_checkpoint_matches_jax(tmp_path):
    """`LLM(model=<DeepSeek dir>, speculative_config=MTP)`: the port's
    drafter takes the checkpoint's layer 2 (handed over by
    `load_hf_weights`); the JAX drafter gets the same tensors through
    `mtp_weights`.  Tokens and spec_stats equal; tokens also equal the
    port's plain greedy (or first differ at a near-tie)."""
    written = _mtp_checkpoint(tmp_path)
    host = {k: v.to(torch.float32).numpy() for k, v in written.items()}
    kw = dict(LLM_KW, max_num_tokens=16)
    prompts = [[4, 8, 4, 8, 15, 3, 9, 22, 31, 5, 17, 2, 40, 41, 6, 7, 8, 9,
                10, 11], [5, 6, 5, 6, 5]]
    jl = J.LLM(model=str(tmp_path), speculative_config=JSpec(
        mode=JM.MTP, max_draft_len=3, mtp_weights=host.get), **kw)
    try:
        jout = jax_generate(jl, prompts, greedy_params(J, 12))
        jst = dict(jl.executor.spec_stats)
    finally:
        jl.shutdown()
    tl = T.LLM(model=str(tmp_path), device="cpu",
               speculative_config=SpeculativeConfig(
                   mode=SpeculativeMode.MTP, max_draft_len=3), **kw)
    try:
        d = tl.executor.drafter
        assert torch.equal(d.params["eh_proj"].to(torch.float32),
                           written["model.layers.2.eh_proj.weight"].to(
                               torch.float32).t())
        tout = [o.outputs[0].token_ids
                for o in tl.generate(prompts, greedy_params(T, 12))]
        tst = dict(tl.executor.spec_stats)
        params, cfg = tl.model.state(), tl.model_config
    finally:
        tl.shutdown()
    assert tout == jout and tst == jst and tst["rounds"] > 0, (tst, jst)
    plain = serve_port(cfg, params, None, prompts, 12, kw)
    assert_same_or_tie(cfg, params, prompts, tout, plain)


# ---- refusals ----------------------------------------------------------------
@pytest.mark.parametrize("kw,err", [
    (dict(tensor_parallel_size=2), NotImplementedError),
    (dict(data_parallel_size=2), NotImplementedError),
    (dict(pipeline_parallel_size=2), NotImplementedError),
    (dict(context_parallel_size=2, context_parallel_type="star"),
     AssertionError),
    (dict(pipeline_parallel_size=2, speculative_config=SpeculativeConfig(
        mode=SpeculativeMode.MTP)), AssertionError),
], ids=["tp", "dp", "pp", "star_cp", "pp_hidden"])
def test_parallel_refusals(kw, err):
    _, tcfg = configs()
    kw = dict(kw)
    kw.setdefault("speculative_config", _ngram())
    with pytest.raises(err):
        T.LLM(model=tcfg, device="cpu", **LLM_KW, **kw)


# ---- launch attribution --------------------------------------------------------
def test_launch_scopes_count_each_engine_apart():
    """Every executor's loop runs in a launch scope of its own, and a draft
    engine's launches inside it count under "draft" only (the innermost
    scope): two engines of one process are counted apart."""
    import threading
    from tensorrt_llm_tpu_torch.ops import cuda_build as CB
    _, tcfg = configs()
    llms = [T.LLM(model=tcfg, device="cpu", **LLM_KW) for _ in range(2)]
    try:
        seen = [llm.read_kv(lambda kv: getattr(CB._scope, "name", None))
                for llm in llms]
        assert seen == [llm.executor.launch_scope for llm in llms]
        assert seen[0] != seen[1]
    finally:
        for llm in llms:
            llm.shutdown()

    def work(scope):
        with CB.launch_scope(scope):
            CB.count_launch("k")
            with CB.launch_scope("draft"):
                CB.count_launch("k")
            CB.count_launch("k")

    CB.reset_launch_counts()
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in seen]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert CB.launch_counts["k"] == 6
        assert {s: dict(c) for s, c in CB.launch_counts_by_scope.items()} \
            == {seen[0]: {"k": 2}, seen[1]: {"k": 2}, "draft": {"k": 2}}
        assert getattr(CB._scope, "name", None) is None
    finally:
        CB.reset_launch_counts()
