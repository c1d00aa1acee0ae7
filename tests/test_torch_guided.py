"""The port's guided decoding (`runtime/guided_decoder.py`, `regex_fsm.py`,
`grammar_fsm.py`) against the JAX package's.

* For every constraint kind of `tests/test_guided.py` (choice, regex, JSON
  Schema with required and optional properties, any JSON value, GBNF
  grammars, structural tags), the port's matcher and JAX's walk the same
  seeded token paths: the allowed-token sets are equal at every step, and
  so are `advance`'s answers and `completed`.
* The grammar PDA and the structural-tag matcher on the cases of
  `tests/test_guided.py`.
* `GuidedDecoder.mask_logits` bans exactly what JAX's additive mask bans.
* End to end on the TINY model with the JAX `LLM`'s weights: greedy guided
  outputs equal the JAX `LLM`'s, or first differ at a near-tie of the
  masked row (`TIE`); sampled outputs obey their constraint; a malformed
  spec, and a dead end, end only their own request.
"""

import json
import re
import types

import jax
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.llmapi.sampling_params import (
    GuidedDecodingParams as JGuided)
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.runtime import guided_decoder as jgd
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.llmapi import GuidedDecodingParams
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax
from tensorrt_llm_tpu_torch.runtime import guided_decoder as tgd
from tensorrt_llm_tpu_torch.runtime.grammar_fsm import GrammarPDA
from tensorrt_llm_tpu_torch.runtime.regex_fsm import (
    DFA, json_schema_to_regex)

TIE = 0.02
TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            max_position=256)
V = TINY["vocab_size"]
KW = dict(max_seq_len=128, max_batch_size=8, kv_num_blocks=128,
          kv_block_size=8)


class CharTokenizer:
    eos_token_id = 0
    bos_token_id = None

    def encode(self, text):
        return [max(1, ord(c) % 256) for c in text] or [1]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) if 0 < i < 128 else "" for i in ids)


TOK = CharTokenizer()
STAG = {
    "triggers": ["<f="],
    "structures": [{
        "begin": "<f=get>",
        "schema": {"type": "object",
                   "properties": {"q": {"type": "string"}},
                   "required": ["q"]},
        "end": "</f>",
    }],
}
SCHEMA = {"type": "object",
          "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}},
          "required": ["ok", "n"]}
SPECS = {
    "choice": dict(choice=["yes", "no", "abc", "abd"]),
    "regex": dict(regex=r"(yes|no) [0-9]{2}"),
    "regex_enum": dict(regex=r"(red|green|blue)"),
    "json_schema": dict(json=SCHEMA),
    "json_optional": dict(json={"type": "object", "properties": {
        "ok": {"type": "boolean"}, "n": {"type": "integer"}}}),
    "json_string": dict(json=json.dumps(SCHEMA)),
    "json_object": dict(json_object=True),
    "json_empty": dict(json={}),
    "grammar": dict(grammar='root ::= "(" root ")" | "ok"'),
    "grammar_gbnf": dict(grammar=r'''
        root  ::= "{" (pair ("," pair)*)? "}"
        pair  ::= string ":" value
        string ::= "\"" [a-z]+ "\""
        value ::= string | number | root
        number ::= "-"? [0-9]+
    '''),
    "structural_tag": dict(structural_tag=STAG),
}
FREE_TEXT = 'so <f=get>{"q":"x"}</f> done'


def _allowed(m):
    a = m.allowed_tokens()
    return None if a is None else sorted(int(t) for t in a)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", list(SPECS))
def test_matchers_match_jax(kind, seed):
    jm = jgd.create_matcher(JGuided(**SPECS[kind]), TOK, 0, vocab_size=V)
    tm = tgd.create_matcher(GuidedDecodingParams(**SPECS[kind]), TOK, 0,
                            vocab_size=V)
    assert type(tm).__name__ == type(jm).__name__
    rng = np.random.default_rng(seed)
    free = iter(FREE_TEXT)
    for _ in range(40):
        a, b = _allowed(jm), _allowed(tm)
        assert a == b
        assert jm.completed == tm.completed
        if a is None:                      # structural tag, free text
            ch = next(free, None)
            tok = 0 if ch is None else TOK.encode(ch)[0]
        else:
            tok = int(rng.choice(a))
        ok = jm.advance(tok)
        assert tm.advance(tok) == ok
        if not ok or tok == 0:
            break


def test_grammar_pda():
    pda = GrammarPDA('root ::= "(" root ")" | "x"')
    for s, ok in (("x", True), ("(x)", True), ("((((x))))", True),
                  ("((x)", False), ("(x))", False), ("", False)):
        assert pda.matches(s) == ok, s
    pda = GrammarPDA(SPECS["grammar_gbnf"]["grammar"])
    for s, ok in (("{}", True), ('{"a":1}', True),
                  ('{"a":-42,"b":"xy"}', True), ('{"a":{"b":{"c":7}}}', True),
                  ('{"a":}', False), ('{"a":1,}', False),
                  ('{"A":1}', False)):
        assert pda.matches(s) == ok, s
    pda = GrammarPDA('root ::= "a"{2,3} "b"+ "c"?')
    for s, ok in (("aab", True), ("aaabbbc", True), ("ab", False),
                  ("aaaab", False)):
        assert pda.matches(s) == ok, s


def test_structural_tag_matcher():
    m = tgd.StructuralTagMatcher(STAG, TOK, eos_token_id=0, vocab_size=V)
    assert m.allowed_tokens() is None and m.completed
    for ch in "let me call <f=":
        assert m.advance(TOK.encode(ch)[0])
    assert m.mode == "struct" and not m.completed
    ids = set(m.allowed_tokens().tolist())
    assert ord("g") in ids and ord("z") not in ids
    assert not m.advance(0)                       # EOS mid-structure
    for ch in 'get>{"q":"tpu"}</f> done':
        assert m.advance(TOK.encode(ch)[0])
    assert m.mode == "free" and m.completed and m.advance(0)


def test_mask_logits_matches_jax_mask():
    """Two guided rows (one in a state that constrains, one in structural
    free mode), one plain row: the same tokens banned as JAX's additive
    [B, V] mask bans."""
    reqs = [types.SimpleNamespace(request_id=i) for i in range(3)]
    jdec, tdec = jgd.GuidedDecoder(V), tgd.GuidedDecoder(V)
    for mod, dec, G in ((jgd, jdec, JGuided), (tgd, tdec,
                                               GuidedDecodingParams)):
        dec.register(0, mod.create_matcher(G(**SPECS["regex"]), TOK, 0,
                                           vocab_size=V))
        dec.register(2, mod.create_matcher(G(**SPECS["structural_tag"]),
                                           TOK, 0, vocab_size=V))
        dec.matchers[0].advance(ord("y"))
    logits = np.random.default_rng(0).standard_normal((3, V)).astype(
        np.float32)
    want = logits + jdec.build_mask(reqs, 3)
    got = tdec.mask_logits(reqs, torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0] > -1e30).sum() == 1                   # only 'e'
    np.testing.assert_array_equal(got[1:], logits[1:])


# ------------------------------------------------------------- end to end --
@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TLLM_KV_BOOKKEEPING", "python")
        jl = J.LLM(model=JCfg(**TINY), tokenizer=CharTokenizer(), seed=0,
                   **KW)
    tl = None
    try:
        params = params_from_jax(jax.tree.map(np.asarray, jl.engine.params))
        tl = T.LLM(model=ModelConfig(**TINY), tokenizer=CharTokenizer(),
                   device="cpu", params=params, **KW)
        yield jl, tl
    finally:
        jl.shutdown()
        if tl is not None:
            tl.shutdown()


@pytest.mark.parametrize("kind", ["choice", "regex", "regex_enum",
                                  "json_schema", "grammar"])
def test_guided_greedy_outputs_match_jax(pair, kind):
    jl, tl = pair
    kw = dict(max_tokens=40, temperature=0.0)
    j = jl.generate("q", J.SamplingParams(
        guided_decoding=JGuided(**SPECS[kind]), **kw))[0].outputs[0]
    t = tl.generate("q", T.SamplingParams(
        guided_decoding=GuidedDecodingParams(**SPECS[kind]),
        return_generation_logits=True, **kw))[0].outputs[0]
    a, b = j.token_ids, t.token_ids
    if a != b:
        # the first difference is a near-tie of the port's masked row
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        m = tgd.create_matcher(GuidedDecodingParams(**SPECS[kind]), TOK, 0,
                               vocab_size=V)
        for tok in b[:i]:
            assert m.advance(tok)
        row = t.generation_logits[i].astype(np.float64)
        allowed = m.allowed_tokens()
        top = row[allowed].max()
        assert row[a[i]] >= top - TIE and row[b[i]] >= top - TIE, (i, a, b)
    else:
        assert t.text == j.text and t.finish_reason == j.finish_reason


def test_guided_sampled_outputs_obey_constraints(pair):
    _, tl = pair
    sps = [T.SamplingParams(max_tokens=40, temperature=1.0, seed=s,
                            guided_decoding=GuidedDecodingParams(**SPECS[k]))
           for s, k in enumerate(("choice", "regex", "json_schema",
                                  "json_object", "grammar"))]
    outs = [o.outputs[0] for o in tl.generate(["q"] * len(sps), sps)]
    assert outs[0].text in SPECS["choice"]["choice"]
    assert re.fullmatch(SPECS["regex"]["regex"], outs[1].text)
    obj = json.loads(outs[2].text)
    assert isinstance(obj["ok"], bool) and isinstance(obj["n"], int)
    if outs[3].finish_reason == "stop":
        json.loads(outs[3].text)
    else:
        dfa = DFA(json_schema_to_regex({}))
        assert dfa.walk(dfa.start, outs[3].text) >= 0
    assert GrammarPDA(SPECS["grammar"]["grammar"]).matches(outs[4].text)
    assert all(o.finish_reason == "stop" for i, o in enumerate(outs)
               if i != 3)
    assert max(s["decode_steps"] for s in tl.get_stats()[-3:]) == 1


def test_bad_spec_and_dead_end_end_only_their_request(pair):
    _, tl = pair
    bad = GuidedDecodingParams(structural_tag={"structures": [{"schema": {}}]})
    with pytest.raises(RuntimeError, match="guided decoding"):
        tl.generate("x", T.SamplingParams(max_tokens=4, guided_decoding=bad))

    def force_z(toks, row):          # a token the regex cannot take
        row[:] = -1e30
        row[ord("z")] = 0.0
        return row

    dead = tl.generate_async("x", T.SamplingParams(
        max_tokens=4, guided_decoding=GuidedDecodingParams(regex="[0-9]+"),
        logits_processor=force_z))
    ok = tl.generate_async("ok", T.SamplingParams(max_tokens=3,
                                                  ignore_eos=True))
    with pytest.raises(RuntimeError, match="dead end"):
        dead.result(timeout=60)
    assert len(ok.result(timeout=60).outputs[0].token_ids) == 3
    assert not tl.executor.guided.matchers
    assert tl.executor._error is None
