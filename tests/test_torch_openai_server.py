"""Port parity of the OpenAI server (`tensorrt_llm_tpu_torch/serve/`)
against the JAX package's aiohttp server, on the CPU at a tiny size.

* One JAX `LLM` and one port `LLM` (``device="cpu"``, the JAX weights
  through `params_from_jax`) share one tokenizer object with
  `apply_chat_template`.  The JAX server runs under aiohttp's `TestClient`,
  the port's on 127.0.0.1:0 in a thread, driven with `http.client`.
* One table of bodies goes to both: greedy completions (stop, echo,
  logprobs, ``n=2``, token-id and several prompts), chat with the
  tokenizer's template and with the fallback one, logprobs, forced
  ``tool_choice`` and a ``json_schema`` ``response_format`` (guided),
  `/v1/responses`, malformed bodies and the stream refusals.  With ``id``,
  ``created``/``created_at`` and tool-call ids taken out, the JSON bodies
  and status codes are equal; logprob values are floats of two bf16
  models, equal within `LOGPROB_TOL` (twice the model-parity tolerance of
  `tests/test_torch_sampling.py`: a logprob carries the log-sum-exp's
  difference too).
* Streams: the concatenated SSE deltas equal the non-streamed text, and
  the chunk sequence (role chunk, content, ``finish_reason``, ``[DONE]``;
  runs of content chunks merged, as chunk boundaries follow each
  executor's pieces) equals the JAX server's.
* KV events of the same request sequence: equal types, ids and hashes;
  the KV manager's events against the JAX manager's under eviction with
  both port bookkeeping backends.
* Release and resume (tokens equal before and after, 409 with a request
  in flight), a dropped stream freeing its blocks, forty concurrent
  streams (also with `/prefix_match` and `/kv_cache_events` polled all
  the while, their KV reads on the executor thread), the
  `trtllm-torch-serve` CLI in a subprocess, and the imports
  with `jax`, `aiohttp` and `pydantic` blocked.
* The disaggregated worker routes (``/disagg/*``) answer as the JAX
  server's; the CLI's ``--register-to``, ``--advertise-url`` and
  ``--disagg-role`` register a worker with a front end, and the
  ``disaggregated`` subcommand starts and stops in a subprocess.
* Intended differences, each a test: bodies that the JAX server fails
  with 500 get 400; `/v1/mm_embeddings` is not registered (404); ``owned_by`` names the port's package; a block whose
  content another device block already caches carries no event hash.
"""

import asyncio
import http.client
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
from tensorrt_llm_tpu.runtime import kv_cache_manager as jkv
from tensorrt_llm_tpu.serve import openai_protocol as jproto
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax
from tensorrt_llm_tpu_torch.runtime import kv_cache_manager as pkv
from tensorrt_llm_tpu_torch.serve import openai_protocol as pproto
from tensorrt_llm_tpu_torch.serve.openai_server import OpenAIServer

ROOT = Path(__file__).resolve().parents[1]
LOGPROB_TOL = 0.06
TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            max_position=256)
KW = dict(max_seq_len=256, max_batch_size=64, kv_num_blocks=256,
          kv_block_size=8)
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "weather lookup",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string", "maxLength": 6},
                                  "days": {"type": "integer", "minimum": 1,
                                           "maximum": 7}},
                   "required": ["city", "days"]}}}]
FORCE = {"type": "function", "function": {"name": "get_weather"}}


class Tok:
    """Byte-like tokenizer shared by both servers; `chat_template` is
    switched on for the template bodies."""
    eos_token_id = 0
    chat_template = None

    def encode(self, text):
        return [max(1, min(255, ord(c) % 256)) for c in text[-64:]] or [1]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(min(i, 127)) for i in ids
                       if i or not skip_special_tokens)

    def apply_chat_template(self, msgs, tokenize=False,
                            add_generation_prompt=True, tools=None):
        return "\n".join(str(m["content"]) for m in msgs) + \
            ("\n[tools]" if tools else "")


class Pair:
    """The two servers: `call(method, path, body)` -> ((status, bytes) of
    JAX, (status, bytes) of the port)."""

    def __init__(self):
        from aiohttp.test_utils import TestClient, TestServer
        from tensorrt_llm_tpu.serve.openai_server import (
            OpenAIServer as JServer)
        self.tok = Tok()
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TLLM_KV_BOOKKEEPING", "python")
            self.jl = J.LLM(model=JCfg(**TINY), tokenizer=self.tok, seed=0,
                            **KW)
        params = params_from_jax(jax.tree.map(np.asarray,
                                              self.jl.engine.params))
        self.tl = T.LLM(model=ModelConfig(**TINY), tokenizer=self.tok,
                        device="cpu", params=params, **KW)
        self.loop = asyncio.new_event_loop()
        self.tc = TestClient(TestServer(JServer(self.jl, "tiny").app,
                                        loop=self.loop), loop=self.loop)
        self.loop.run_until_complete(self.tc.start_server())
        self.st = OpenAIServer(self.tl, "tiny").start_in_thread()

    def jax(self, method, path, body=None, raw=None):
        async def go():
            kw = ({"data": raw} if raw is not None else
                  {"json": body} if body is not None else {})
            r = await self.tc.request(method, path, **kw)
            return r.status, await r.read()
        return self.loop.run_until_complete(go())

    def port(self, method, path, body=None, raw=None):
        c = http.client.HTTPConnection("127.0.0.1", self.st.port,
                                       timeout=120)
        data = raw if raw is not None else (
            None if body is None else json.dumps(body).encode())
        c.request(method, path, body=data,
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        out = r.status, r.read()
        c.close()
        return out

    def call(self, method, path, body=None, raw=None):
        return (self.jax(method, path, body, raw),
                self.port(method, path, body, raw))

    def close(self):
        self.st.stop()
        self.loop.run_until_complete(self.tc.close())
        self.loop.close()
        self.jl.shutdown()
        self.tl.shutdown()


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    try:
        yield p
    finally:
        p.close()


# ---------------------------------------------------------------- helpers --
STRIP = {"id", "created", "created_at", "call_id"}


def strip(obj):
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in STRIP}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    return obj


def assert_json_equal(a, b, path="$"):
    """Equal JSON, floats within `LOGPROB_TOL`."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (path, a, b)
        assert abs(a - b) <= LOGPROB_TOL or a == b, (path, a, b)
        return
    assert type(a) is type(b), (path, a, b)
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (path, sorted(a), sorted(b))
        for k in a:
            assert_json_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_json_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def sse(raw: bytes):
    """[(event name or None, data)] of an SSE body."""
    out = []
    for block in raw.decode().split("\n\n"):
        if not block.strip():
            continue
        name = data = None
        for line in block.split("\n"):
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                data = line[len("data: "):]
        out.append((name, data))
    return out


def shape_of(events):
    """The chunk sequence with runs of equal entries merged: per chunk the
    event name, the delta's keys (chat) or "text" (completions), and the
    finish reason; "[DONE]" as itself."""
    seq = []
    for name, data in events:
        if data == "[DONE]":
            ent = "[DONE]"
        else:
            d = json.loads(data)
            if name is not None:
                ent = (name,)
            else:
                ch = d["choices"][0]
                keys = tuple(sorted(ch["delta"])) if "delta" in ch \
                    else ("text",)
                ent = (keys, ch["finish_reason"])
        if not seq or seq[-1] != ent:
            seq.append(ent)
    return seq


def streamed_text(events):
    parts = []
    for name, data in events:
        if data == "[DONE]":
            continue
        d = json.loads(data)
        if name == "response.output_text.delta":
            parts.append(d["delta"])
        elif name is None:
            ch = d["choices"][0]
            parts.append(ch["delta"].get("content") or ""
                         if "delta" in ch else ch["text"])
    return "".join(parts)


def whole_text(kind, body):
    if kind == "completions":
        return body["choices"][0]["text"]
    if kind == "chat":
        return body["choices"][0]["message"]["content"] or ""
    return "".join(c["text"] for o in body["output"]
                   if o["type"] == "message" for c in o["content"])


PATHS = {"completions": "/v1/completions", "chat": "/v1/chat/completions",
         "responses": "/v1/responses"}
G = dict(model="tiny", temperature=0.0)
HI = [{"role": "user", "content": "hi there"}]

# (name, kind, body); "template" bodies run with the tokenizer's template
BODIES = [
    ("greedy", "completions", dict(G, prompt="hello there", max_tokens=8,
                                   ignore_eos=True)),
    ("eos_stop", "completions", dict(G, prompt="tell me", max_tokens=24)),
    ("echo", "completions", dict(G, prompt="echo me", max_tokens=4,
                                 echo=True, ignore_eos=True)),
    ("logprobs", "completions", dict(G, prompt="probs", max_tokens=5,
                                     logprobs=2, ignore_eos=True)),
    ("echo_logprobs", "completions", dict(G, prompt="both", max_tokens=3,
                                          logprobs=1, echo=True,
                                          ignore_eos=True)),
    ("n2", "completions", dict(G, prompt="twice", max_tokens=4, n=2,
                               ignore_eos=True)),
    ("token_ids", "completions", dict(G, prompt=[5, 6, 7, 8, 9],
                                      max_tokens=6, ignore_eos=True)),
    ("two_id_prompts", "completions", dict(G, prompt=[[5, 6, 7], [40, 41]],
                                           max_tokens=4, ignore_eos=True)),
    ("two_text_prompts", "completions", dict(G, prompt=["ab", "cd"],
                                             max_tokens=3, ignore_eos=True)),
    ("chat_fallback", "chat", dict(G, messages=HI, max_tokens=6,
                                   ignore_eos=True)),
    ("chat_template", "chat", dict(G, messages=HI, max_tokens=6,
                                   ignore_eos=True)),
    ("chat_system", "chat", dict(G, messages=[
        {"role": "system", "content": "be brief"}] + HI, max_tokens=5,
        ignore_eos=True)),
    ("chat_logprobs", "chat", dict(G, messages=HI, max_tokens=4,
                                   logprobs=True, top_logprobs=2,
                                   ignore_eos=True)),
    ("chat_n2", "chat", dict(G, messages=HI, max_tokens=3, n=2,
                             ignore_eos=True)),
    ("chat_tools_auto", "chat", dict(G, messages=HI, max_tokens=5,
                                     tools=TOOLS, ignore_eos=True)),
    ("chat_forced_tool", "chat", dict(G, messages=HI, max_tokens=48,
                                      tools=TOOLS, tool_choice=FORCE)),
    ("chat_json_schema", "chat", dict(G, messages=HI, max_tokens=48,
                                      response_format={
                                          "type": "json_schema",
                                          "json_schema": {"schema": TOOLS[0][
                                              "function"]["parameters"]}})),
    ("responses", "responses", dict(G, input="hi there",
                                    max_output_tokens=6, ignore_eos=True)),
    ("responses_instructions", "responses", dict(
        G, input=[{"type": "message", "role": "user", "content": "yo"}],
        instructions="be brief", max_output_tokens=5, ignore_eos=True)),
]
STREAMED = ["greedy", "eos_stop", "token_ids", "chat_fallback",
            "chat_template", "chat_tools_auto", "chat_forced_tool",
            "responses", "responses_instructions"]


def run_body(pair, name, kind, body):
    if name.endswith("template"):
        pair.tok.chat_template = "tmpl"
    try:
        return pair.call("POST", PATHS[kind], body)
    finally:
        pair.tok.chat_template = None


# ----------------------------------------------------------- parity table --
@pytest.mark.parametrize("name,kind,body", BODIES,
                         ids=[b[0] for b in BODIES])
def test_bodies_match_jax(pair, name, kind, body):
    (js, jb), (ps, pb) = run_body(pair, name, kind, body)
    assert js == 200, jb
    assert ps == js, pb
    a, b = json.loads(jb), json.loads(pb)
    assert_json_equal(strip(a), strip(b))
    if name == "chat_forced_tool":
        call = b["choices"][0]["message"]["tool_calls"][0]
        assert call["function"]["name"] == "get_weather"
        assert b["choices"][0]["finish_reason"] == "tool_calls"
        if b["usage"]["completion_tokens"] < body["max_tokens"]:
            # the schema's string admits raw control characters (the JAX
            # grammar's), hence strict=False
            assert set(json.loads(call["function"]["arguments"],
                                  strict=False)) == {"city", "days"}


def test_stop_string_matches_jax(pair):
    """A stop string taken from the greedy text itself, so that it
    matches: cut from the text, non-streamed and streamed."""
    body = dict(G, prompt="hello there", max_tokens=8, ignore_eos=True)
    (_, jb), _ = pair.call("POST", "/v1/completions", body)
    text = json.loads(jb)["choices"][0]["text"]
    stop = text[3:5]
    body = dict(body, stop=[stop, "zzz"])
    (js, jb), (ps, pb) = pair.call("POST", "/v1/completions", body)
    assert js == ps == 200
    a, b = json.loads(jb), json.loads(pb)
    assert_json_equal(strip(a), strip(b))
    assert b["choices"][0]["text"] == text[:text.find(stop)]
    (_, jraw), (_, praw) = pair.call("POST", "/v1/completions",
                                     dict(body, stream=True))
    assert streamed_text(sse(praw)) == b["choices"][0]["text"]
    assert shape_of(sse(praw)) == shape_of(sse(jraw))


@pytest.mark.parametrize("name", STREAMED)
def test_streams_match_jax(pair, name):
    _, kind, body = next(b for b in BODIES if b[0] == name)
    (js, jraw), (ps, praw) = run_body(pair, name, kind,
                                      dict(body, stream=True))
    assert js == ps == 200, (jraw, praw)
    jev, pev = sse(jraw), sse(praw)
    assert shape_of(pev) == shape_of(jev)
    _, (_, pb) = run_body(pair, name, kind, body)
    whole = json.loads(pb)
    if name == "chat_forced_tool":   # the non-streamed text is the call
        want = whole["choices"][0]["message"]["tool_calls"][0][
            "function"]["arguments"]
    else:
        want = whole_text(kind, whole)
    assert streamed_text(pev) == want
    assert streamed_text(pev) == streamed_text(jev)
    if kind != "responses":
        assert pev[-1] == (None, "[DONE]")
    else:
        done = json.loads(pev[-1][1])
        assert done["type"] == "response.completed"
        assert_json_equal(strip(done), strip(json.loads(jev[-1][1])))
    if name == "chat_forced_tool":
        calls = [json.loads(d) for n, d in pev if d != "[DONE]"
                 and "tool_calls" in json.loads(d)["choices"][0]["delta"]]
        assert calls == []   # a forced call streams as content (JAX's)


MALFORMED = [
    ("not_json", "completions", b"not json"),
    ("json_array", "completions", []),
    ("no_model", "completions", {"prompt": "x"}),
    ("no_prompt", "completions", {"model": "tiny"}),
    ("prompt_dict", "completions", {"model": "tiny", "prompt": {"a": 1}}),
    ("prompt_mixed", "completions", {"model": "tiny", "prompt": [1, "a"]}),
    ("prompt_empty", "completions", {"model": "tiny", "prompt": []}),
    ("prompt_too_long", "completions", {"model": "tiny",
                                        "prompt": [1 + i % 200 for i in range(300)],
                                        "max_tokens": 4}),
    ("max_tokens_str", "completions", {"model": "tiny", "prompt": "x",
                                       "max_tokens": "abc"}),
    ("max_tokens_frac", "completions", {"model": "tiny", "prompt": "x",
                                        "max_tokens": 7.5}),
    ("stream_maybe", "completions", {"model": "tiny", "prompt": "x",
                                     "stream": "maybe"}),
    ("stop_int", "completions", {"model": "tiny", "prompt": "x",
                                 "stop": 5}),
    ("temperature_null", "completions", {"model": "tiny", "prompt": "x",
                                         "temperature": None}),
    ("response_format_str", "completions", {"model": "tiny", "prompt": "x",
                                            "response_format": "json"}),
    ("stream_n2", "completions", {"model": "tiny", "prompt": "x",
                                  "stream": True, "n": 2}),
    ("stream_two_prompts", "completions", {"model": "tiny",
                                           "prompt": ["a", "b"],
                                           "stream": True}),
    ("chat_no_messages", "chat", {"model": "tiny"}),
    ("chat_messages_dict", "chat", {"model": "tiny", "messages": {}}),
    ("chat_no_role", "chat", {"model": "tiny",
                              "messages": [{"content": "x"}]}),
    ("chat_content_int", "chat", {"model": "tiny", "messages": [
        {"role": "user", "content": 5}]}),
    ("chat_tools_dict", "chat", {"model": "tiny", "messages": HI,
                                 "tools": {}}),
    ("chat_tool_choice_int", "chat", {"model": "tiny", "messages": HI,
                                      "tool_choice": 3}),
    ("chat_stream_n2", "chat", {"model": "tiny", "messages": HI,
                                "stream": True, "n": 2}),
    ("responses_no_input", "responses", {"model": "tiny"}),
    ("responses_input_int", "responses", {"model": "tiny", "input": 4}),
]


@pytest.mark.parametrize("name,kind,body", MALFORMED,
                         ids=[m[0] for m in MALFORMED])
def test_malformed_bodies_get_400(pair, name, kind, body):
    raw = body if isinstance(body, bytes) else None
    (js, jb), (ps, pb) = pair.call("POST", PATHS[kind],
                                   None if raw else body, raw)
    assert js == 400, jb
    assert ps == 400, pb
    assert "error" in json.loads(pb)


@pytest.mark.parametrize("body", [
    {"prompt": "x", "max_tokens": 0}, {"prompt": "x", "top_p": 0},
    {"prompt": "x", "temperature": -1}, {"prompt": "x", "top_k": 65}],
    ids=["max_tokens0", "top_p0", "temperature_neg", "top_k65"])
def test_sampling_refusals_are_400_where_jax_fails(pair, body):
    """Intended difference: `SamplingParams` refuses these; the JAX server
    lets the ValueError escape (500), the port answers 400."""
    (js, _), (ps, pb) = pair.call("POST", "/v1/completions",
                                  dict(body, model="tiny"))
    assert js == 500
    assert ps == 400 and "error" in json.loads(pb)


def test_routes_match_jax(pair):
    for path in ("/health", "/version"):
        (js, jb), (ps, pb) = pair.call("GET", path)
        assert js == ps == 200 and json.loads(jb) == json.loads(pb)
    (js, jb), (ps, pb) = pair.call("GET", "/v1/models")
    a, b = json.loads(jb), json.loads(pb)
    assert b["data"][0].pop("owned_by") == "tensorrt_llm_tpu_torch"
    a["data"][0].pop("owned_by")
    assert strip(a) == strip(b)
    (js, jb), (ps, pb) = pair.call("GET", "/steady_clock_offset")
    assert js == ps == 200 and json.loads(jb).keys() == json.loads(pb).keys()
    (js, jb), (ps, pb) = pair.call("POST", "/v1/embeddings",
                                   {"input": "x"})
    assert js == ps == 400 and json.loads(jb) == json.loads(pb)
    (js, jb), (ps, pb) = pair.call("GET", "/health_generate")
    assert js == ps == 200 and json.loads(jb) == json.loads(pb)
    (js, jb), (ps, pb) = pair.call("GET", "/metrics")
    names = [set(line.split()[0] for line in raw.decode().splitlines())
             for raw in (jb, pb)]
    assert js == ps == 200 and names[1] == names[0] - {
        n for n in names[0] if n.startswith("tllm_tpu_spec_")}
    (js, jb), (ps, pb) = pair.call("GET", "/traces")
    assert js == ps == 200
    jt, pt = json.loads(jb), json.loads(pb)
    assert pt and set(pt[-1]) == set(jt[-1])
    (js, jb), (ps, pb) = pair.call("GET", "/perf_metrics")
    assert js == ps == 200 and isinstance(json.loads(pb), list)
    (js, jb), (ps, pb) = pair.call("POST", "/prefix_match",
                                   {"prompt_token_ids": [5, 6, 7]})
    assert js == ps == 200 and json.loads(jb) == json.loads(pb)
    (js, _), (ps, _) = pair.call("GET", "/no/such/route")
    assert js == ps == 404
    (js, _), (ps, _) = pair.call("GET", "/v1/completions")
    assert js == ps == 405


@pytest.mark.parametrize("path", ["/v1/mm_embeddings"])
def test_later_slice_routes_not_registered(pair, path):
    """Intended difference: the JAX server registers this; the port's
    multimodal slice is not in yet."""
    (js, _), (ps, pb) = pair.call("POST", path, {"model": "tiny"})
    assert js != 404
    assert ps == 404 and "error" in json.loads(pb)


DISAGG_PROMPT = [int(t) for t in np.random.RandomState(21).randint(1, 255, 37)]
DISAGG_BODY = {"model": "tiny", "prompt_token_ids": DISAGG_PROMPT,
               "max_tokens": 6, "temperature": 0.0, "ignore_eos": True}


def _frames(raw: bytes):
    from tensorrt_llm_tpu_torch.llmapi.disagg_params import frame_from_bytes
    out, off = [], 0
    while off < len(raw):
        n = int.from_bytes(raw[off:off + 8], "little")
        out.append(frame_from_bytes(raw[off + 8:off + 8 + n]))
        off += 8 + n
    return out


def _close_pages(port_layers, jax_layers, engine, n_tokens):
    """The JAX pages (lane-packed at D 32) reshaped to the port's pools
    hold the port's values, within bf16 rounding of two models, in the
    `n_tokens` rows the prompt wrote (a last block's other rows are what
    its block held before)."""
    ours = engine.check_kv_layers(port_layers)
    theirs = engine.check_kv_layers(jax_layers)
    for a, b in zip(ours, theirs):
        # [n, Hkv, BS, D] -> token rows [n * BS, Hkv, D]
        a, b = (t.float().transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])
                [:n_tokens] for t in (a, b))
        assert (a - b).abs().max() <= 0.02 * b.abs().max() + 1e-3


@pytest.mark.parametrize("path", [
    "/disagg/context", "/disagg/generate", "/disagg/context_stream",
    "/disagg/generate_streamed"])
def test_disagg_routes_answer_as_jax(pair, path):
    """The disaggregated worker routes (`serve/disagg_server.py`) answer
    the JAX server's bodies alike: the same first token and pages, the same
    frames, the same greedy tokens."""
    import base64
    from tensorrt_llm_tpu_torch.llmapi.disagg_params import (
        payload_from_bytes)
    # the same request on both sides keeps their KV events alike
    jw = pair.jl.generate([DISAGG_PROMPT], J.SamplingParams(
        max_tokens=6, temperature=0.0, ignore_eos=True))[0]
    want = pair.tl.generate([DISAGG_PROMPT], T.SamplingParams(
        max_tokens=6, temperature=0.0, ignore_eos=True))[0]
    want = want.outputs[0].token_ids
    assert jw.outputs[0].token_ids == want
    if path == "/disagg/context":
        (js, jb), (ps, pb) = pair.call("POST", path, DISAGG_BODY)
        assert js == ps == 200
        j, p = json.loads(jb), json.loads(pb)
        assert set(j) == set(p) == {"first_gen_tokens", "kv_payload_b64"}
        assert j["first_gen_tokens"] == p["first_gen_tokens"] == want[:1]
        jp, pp = (payload_from_bytes(base64.b64decode(x["kv_payload_b64"]))
                  for x in (j, p))
        assert jp["num_tokens"] == pp["num_tokens"] == len(DISAGG_PROMPT)
        _close_pages(pp["layers"], jp["layers"], pair.tl.engine,
                     len(DISAGG_PROMPT))
    elif path == "/disagg/generate":
        (js, jb), _ = pair.call("POST", "/disagg/context", DISAGG_BODY)
        body = dict(DISAGG_BODY, **json.loads(jb))    # JAX's pages to both
        (js, jb), (ps, pb) = pair.call("POST", path, body)
        assert js == ps == 200
        j, p = json.loads(jb), json.loads(pb)
        assert strip(j) == strip(p)
        assert p["choices"][0]["token_ids"] == want
    elif path == "/disagg/context_stream":
        (js, jb), (ps, pb) = pair.call("POST", path, DISAGG_BODY)
        assert js == ps == 200
        jf, pf = _frames(jb), _frames(pb)
        assert [f.get("start_block") for f in jf] == \
            [f.get("start_block") for f in pf]
        assert jf[-1] == pf[-1] == {
            "end": True, "num_tokens": len(DISAGG_PROMPT), "block_size": 8,
            "first_gen_tokens": want[:1]}
        _close_pages(pf[0]["layers"], jf[0]["layers"], pair.tl.engine,
                     len(DISAGG_PROMPT))
    else:
        ju = str(pair.tc.make_url("")).rstrip("/")
        js, jb = pair.jax("POST", path, dict(DISAGG_BODY, ctx_url=ju))
        ps, pb = pair.port("POST", path, dict(
            DISAGG_BODY, ctx_url=f"http://127.0.0.1:{pair.st.port}"))
        assert js == ps == 200
        assert strip(json.loads(jb)) == strip(json.loads(pb))
        assert json.loads(pb)["choices"][0]["token_ids"] == want
    assert pair.tl.get_kv_cache_stats()["active_sequences"] == 0


def test_image_parts_refused(pair):
    _, (ps, pb) = pair.call("POST", "/v1/chat/completions", dict(
        G, messages=[{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": "data:,x"}}]}]))
    assert ps == 400 and "image" in json.loads(pb)["error"]


# -------------------------------------------------------------- KV events --
def test_kv_cache_events_match_jax(pair):
    """A shared-prefix pair of prompts (neither a multiple of the block
    size long): equal events, cursors, prefix matches and hashes."""
    before = [json.loads(b) for _, b in pair.call("GET", "/kv_cache_events")]
    assert before[0]["next_since_id"] == before[1]["next_since_id"]
    since = before[1]["next_since_id"]
    base = list(range(20, 61))          # 41 tokens: 5 full blocks
    for p in (base, base[:30] + [7, 8, 9, 10, 11, 12, 13]):
        (js, _), (ps, _) = pair.call("POST", "/v1/completions", dict(
            G, prompt=p, max_tokens=3, ignore_eos=True))
        assert js == ps == 200
    (js, jb), (ps, pb) = pair.call(
        "GET", f"/kv_cache_events?since_id={since}&full=1")
    a, b = json.loads(jb), json.loads(pb)
    assert js == ps == 200
    for k in ("next_since_id", "oldest_retained_id", "events",
              "block_size"):
        assert a[k] == b[k], k
    assert len(b["events"]) == 5 + 4
    assert [e["type"] for e in b["events"]] == ["stored"] * 9
    assert set(b["block_hashes"]) <= set(a["block_hashes"])
    assert {e["block_hash"] for e in b["events"]} <= set(b["block_hashes"])
    assert len(b["epoch"]) == 32 and b["epoch"] != a["epoch"]
    (js, jb), (ps, pb) = pair.call("POST", "/prefix_match", {
        "prompt_token_ids": base[:30] + [1, 2, 3]})
    assert json.loads(jb) == json.loads(pb) == {"matched_tokens": 30}
    (js, _), (ps, pb) = pair.call("GET", "/kv_cache_events?since_id=x")
    assert ps == 400


def kv_ops(seed, n_ops=60):
    """A random sequence of (op, args) on a small pool: prompts from a few
    shared prefixes, lengths never a multiple of the block size (4)."""
    rng = random.Random(seed)
    roots = [[rng.randrange(1, 50) for _ in range(24)] for _ in range(3)]
    ops, live, sid = [], [], 0
    for _ in range(n_ops):
        if live and (rng.random() < 0.4 or len(live) > 5):
            ops.append(("free", live.pop(rng.randrange(len(live)))))
            continue
        n = rng.choice([5, 7, 9, 11, 13, 18, 23])
        root = rng.choice(roots)
        cut = rng.randrange(0, n)
        toks = root[:cut] + [rng.randrange(50, 99) for _ in range(n - cut)]
        sid += 1
        ops.append(("add", sid, toks, rng.choice([None, "salt-a"])))
        live.append(sid)
    return ops


def run_kv_ops(kv, ops, block_size=4):
    toks_of, hits = {}, []
    for op in ops:
        if op[0] == "free":
            kv.free_sequence(op[1])
            continue
        _, sid, toks, salt = op
        if kv.num_free_blocks < -(-len(toks) // block_size) + 1:
            continue
        hits.append(kv.add_sequence(sid, toks, salt))
        kv.grow_sequence(sid, len(toks))
        kv.seal_full_blocks(sid, toks)
        toks_of[sid] = toks
    probe = [kv.match_prefix(t) for t in toks_of.values()]
    return hits, probe


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_manager_events_match_jax(backend, seed):
    """Stored and removed events (eviction from a 24-block pool), cursor,
    resync hashes and prefix matches equal the JAX manager's."""
    jm = jkv.KVCacheManager(jkv.KVCacheConfig(block_size=4), 1, 1, 4, 24,
                            bookkeeping="python")
    pm = pkv.KVCacheManager(pkv.KVCacheConfig(block_size=4,
                                              bookkeeping=backend),
                            1, 1, 4, 24, device="cpu")
    ops = kv_ops(seed)
    assert run_kv_ops(pm, ops) == run_kv_ops(jm, ops)
    assert pm.get_events() == jm.get_events()
    assert any(e["type"] == "removed" for e in pm.get_events())
    assert pm.get_events(7) == jm.get_events(7)
    assert pm.event_cursor() == jm.event_cursor()
    assert sorted(pm.reuse_block_hashes()) == sorted(jm.reuse_block_hashes())


def test_kv_event_ring_is_bounded():
    pm = pkv.KVCacheManager(pkv.KVCacheConfig(block_size=2,
                                              bookkeeping="python"),
                            1, 1, 4, 4096 + 64, device="cpu")
    toks = list(range(1, 2 * 3000 + 2))
    pm.add_sequence(1, toks)
    pm.grow_sequence(1, len(toks))
    pm.seal_full_blocks(1, toks)
    nxt, oldest = pm.event_cursor()
    assert nxt == 3000 and oldest == 0
    pm.free_sequence(1)
    pm.add_sequence(2, toks)        # re-announces the reused blocks
    pm.grow_sequence(2, len(toks))
    pm.seal_full_blocks(2, toks)
    nxt, oldest = pm.event_cursor()
    assert nxt == 6000 and oldest == 6000 - pkv.EVENT_RING
    assert len(pm.get_events()) == pkv.EVENT_RING
    assert pm.get_events(5990)[0]["id"] == 5990


def test_kv_duplicate_block_intended_difference():
    """Two sequences of one 8-token prompt (block size 4): the second
    matches one block and seals a copy of the second.  The JAX manager
    maps the copy to the hash as well and, once the cached original is
    evicted, never reports the content removed; the port's copy carries
    no hash, so the eviction is reported."""
    jm = jkv.KVCacheManager(jkv.KVCacheConfig(block_size=4), 1, 1, 4, 6,
                            bookkeeping="python")
    pm = pkv.KVCacheManager(pkv.KVCacheConfig(block_size=4,
                                              bookkeeping="python"),
                            1, 1, 4, 6, device="cpu")
    p = list(range(1, 9))
    for kv in (jm, pm):
        kv.add_sequence(1, p)
        kv.grow_sequence(1, 8)
        kv.seal_full_blocks(1, p)
        kv.free_sequence(1)
        kv.add_sequence(2, p)
        kv.grow_sequence(2, 8)
        kv.seal_full_blocks(2, p)
        kv.free_sequence(2)
        kv.add_sequence(3, list(range(50, 70)))   # evicts every cached block
        kv.grow_sequence(3, 20)
    jr = [e for e in jm.get_events() if e["type"] == "removed"]
    pr = [e for e in pm.get_events() if e["type"] == "removed"]
    stored = [e["block_hash"] for e in pm.get_events()
              if e["type"] == "stored"]
    assert sorted(e["block_hash"] for e in pr) == sorted(stored[:2])
    assert [e["block_hash"] for e in jr] == stored[:1]
    assert pm.reuse_block_hashes() == []
    assert jm.reuse_block_hashes() == [stored[1]]


# ------------------------------------------------------ memory and streams --
def test_release_resume_memory(pair):
    body = dict(G, prompt=[11, 12, 13], max_tokens=6, ignore_eos=True)
    _, (ps, before) = pair.call("POST", "/v1/completions", body)
    assert ps == 200
    (js, _), (ps, _) = pair.call("POST", "/release_memory")
    assert js == ps == 200
    assert pair.tl.model.state() == {}     # every weight left the device
    (js, _), (ps, pb) = pair.call("POST", "/v1/completions", body)
    assert js == ps == 500 and "resume_memory" in json.loads(pb)["error"]
    (js, _), (ps, _) = pair.call("POST", "/resume_memory")
    assert js == ps == 200
    _, (ps, after) = pair.call("POST", "/v1/completions", body)
    assert ps == 200
    assert strip(json.loads(after)) == strip(json.loads(before))


def test_release_refused_in_flight(pair):
    """A release while a stream runs gets 409 and leaves the weights."""
    c = http.client.HTTPConnection("127.0.0.1", pair.st.port, timeout=120)
    c.request("POST", "/v1/completions", body=json.dumps(dict(
        G, prompt=[3, 4, 5], max_tokens=200, ignore_eos=True,
        stream=True)).encode(), headers={"Content-Type": "application/json"})
    r = c.getresponse()
    first = r.readline()
    assert first.startswith(b"data: ")
    _, (ps, pb) = (None, pair.port("POST", "/release_memory"))
    assert ps == 409 and "in flight" in json.loads(pb)["error"]
    rest = r.read()
    c.close()
    assert rest.rstrip().endswith(b"data: [DONE]")
    assert pair.tl.model.state()
    _, (ps, _) = pair.call("POST", "/v1/completions", dict(
        G, prompt=[3, 4], max_tokens=2))
    assert ps == 200


def test_dropped_stream_frees_its_blocks(pair):
    tl = pair.tl
    deadline = time.time() + 30
    while tl.get_kv_cache_stats()["active_sequences"] and \
            time.time() < deadline:
        time.sleep(0.01)
    free0 = tl.get_kv_cache_stats()["free_blocks"]
    made0 = tl.executor.total_tokens_generated
    s = socket.create_connection(("127.0.0.1", pair.st.port), timeout=60)
    body = json.dumps(dict(G, prompt=[9, 8, 7], max_tokens=240,
                           ignore_eos=True, stream=True)).encode()
    s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
              b"Content-Type: application/json\r\nContent-Length: "
              + str(len(body)).encode() + b"\r\n\r\n" + body)
    got = b""
    while b"data: " not in got:
        got += s.recv(4096)
    s.close()
    deadline = time.time() + 60
    while time.time() < deadline:
        st = tl.get_kv_cache_stats()
        if st["active_sequences"] == 0 and st["free_blocks"] == free0:
            break
        time.sleep(0.01)
    assert tl.get_kv_cache_stats()["free_blocks"] == free0
    assert tl.get_kv_cache_stats()["active_sequences"] == 0
    assert tl.executor.total_tokens_generated - made0 < 240   # cancelled


def test_forty_concurrent_streams(pair):
    """More open streams than the default thread pool has threads: all
    finish, each with its own tokens, while no thread waits per stream."""
    from tensorrt_llm_tpu_torch.commands.benchmark_serving import (
        post_stream)
    url = f"http://127.0.0.1:{pair.st.port}/v1/chat/completions"
    threads0 = threading.active_count()

    async def one(i):
        text, done = "", False
        async for line in post_stream(url, dict(
                G, messages=[{"role": "user", "content": f"n{i}"}],
                max_tokens=12, ignore_eos=True, stream=True)):
            line = line.decode().strip()
            if line == "data: [DONE]":
                done = True
            elif line.startswith("data: "):
                d = json.loads(line[6:])["choices"][0]["delta"]
                text += d.get("content") or ""
        return done, text, threading.active_count()

    async def all_():
        return await asyncio.gather(*[one(i) for i in range(40)])

    res = asyncio.run(all_())
    assert all(done for done, _, _ in res)
    assert all(len(t) == 12 for _, t, _ in res)
    assert max(n for _, _, n in res) <= threads0 + 2


def test_kv_routes_polled_during_forty_streams(pair, monkeypatch):
    """A router polls `/prefix_match` and `/kv_cache_events` while forty
    streams run on the native bookkeeping: every poll answers, its events
    are in order, and every read of the KV manager ran on the executor
    thread (the C++ bookkeeping is mutated there, without the GIL)."""
    from tensorrt_llm_tpu_torch.commands.benchmark_serving import (
        post_stream)
    tl = pair.tl
    kv = tl.kv_manager
    assert kv.is_native
    off_thread = []
    for name in ("stats", "get_events", "event_cursor",
                 "reuse_block_hashes", "match_prefix"):
        def wrap(*a, _f=getattr(kv, name), _n=name, **k):
            if threading.current_thread() is not tl.executor._thread:
                off_thread.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(kv, name, wrap)
    url = f"http://127.0.0.1:{pair.st.port}/v1/completions"
    prefix = list(range(20, 44))
    running, polls = threading.Event(), []

    def poll():
        c = http.client.HTTPConnection("127.0.0.1", pair.st.port,
                                       timeout=120)
        while running.is_set():
            for method, path, body in (
                    ("POST", "/prefix_match", {"prompt_token_ids": prefix}),
                    ("GET", "/kv_cache_events?since_id=0&full=1", None)):
                c.request(method, path, body=None if body is None
                          else json.dumps(body).encode(),
                          headers={"Content-Type": "application/json"})
                r = c.getresponse()
                polls.append((path, r.status, json.loads(r.read())))
        c.close()

    async def one(i):
        done = False
        async for line in post_stream(url, dict(
                G, prompt=prefix + [50 + i] * 3, max_tokens=12,
                ignore_eos=True, stream=True)):
            done = done or line.strip() == b"data: [DONE]"
        return done

    async def all_():
        return await asyncio.gather(*[one(i) for i in range(40)])

    running.set()
    poller = threading.Thread(target=poll)
    poller.start()
    try:
        res = asyncio.run(all_())
    finally:
        running.clear()
        poller.join(timeout=120)
    assert all(res)
    assert len(polls) >= 4 and all(st == 200 for _, st, _ in polls), \
        polls[:3]
    for path, _, body in polls:
        if path == "/prefix_match":
            assert 0 <= body["matched_tokens"] <= len(prefix)
        else:
            ids = [e["id"] for e in body["events"]]
            assert ids == sorted(set(ids))
            assert not ids or ids[-1] < body["next_since_id"]
    assert off_thread == []


# ----------------------------------------------------------------- schema --
SCHEMA_CASES = [
    dict(model="m", prompt="x", max_tokens="7"),
    dict(model="m", prompt="x", max_tokens=7.0),
    dict(model="m", prompt="x", max_tokens=True),
    dict(model="m", prompt="x", max_tokens=" 7 "),
    dict(model="m", prompt="x", n="2.0"),
    dict(model="m", prompt="x", stream="yes"),
    dict(model="m", prompt="x", stream=1),
    dict(model="m", prompt="x", stream=2),
    dict(model="m", prompt="x", echo="TRUE"),
    dict(model="m", prompt="x", temperature="0.5"),
    dict(model="m", prompt="x", temperature=True),
    dict(model="m", prompt=[]),
    dict(model="m", prompt=[[1, 2], [3]]),
    dict(model="m", prompt=[1.0, 2]),
    dict(model="m", prompt=["1", 2]),
    dict(model="m", prompt=["a", ["b"]]),
    dict(model="m", prompt=True),
    dict(model=5, prompt="x"),
    dict(model="m", prompt="x", stop=["a", 1]),
    dict(model="m", prompt="x", logprobs="2", seed="3", extra=1),
    dict(model="m", prompt="x", n=None),
]


@pytest.mark.parametrize("body", SCHEMA_CASES,
                         ids=[str(i) for i in range(len(SCHEMA_CASES))])
def test_request_schema_matches_pydantic(body):
    """The dataclass schema accepts, coerces and refuses as the JAX
    package's pydantic models do."""
    try:
        want = jproto.CompletionRequest(**body).model_dump()
    except Exception:  # noqa: BLE001 -- pydantic's ValidationError
        want = None
    try:
        got = vars(pproto.parse_request(pproto.CompletionRequest, body))
    except pproto.RequestError:
        got = None
    assert got == want


# -------------------------------------------------------------------- CLI --
def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request("GET", path)
    r = c.getresponse()
    out = r.status, r.read()
    c.close()
    return out


def test_serve_cli_subprocess(tmp_path):
    """`python -m tensorrt_llm_tpu_torch.commands.serve` on a 2-layer
    checkpoint: /health, one token-id completion, a clean exit on
    SIGINT."""
    from torch_parity import write_hf_checkpoint
    hf = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
          "vocab_size": 320, "hidden_size": 128, "intermediate_size": 256,
          "num_hidden_layers": 2, "num_attention_heads": 4,
          "num_key_value_heads": 2, "max_position_embeddings": 256,
          "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
          "tie_word_embeddings": False}
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    write_hf_checkpoint(ckpt, hf, seed=0)
    opts = tmp_path / "opts.json"
    opts.write_text(json.dumps({"skip_tokenizer_init": True,
                                "kv_bookkeeping": "python",
                                "kv_num_blocks": 64}))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorrt_llm_tpu_torch.commands.serve",
         str(ckpt), "--device", "cpu", "--host", "127.0.0.1", "--port",
         str(port), "--max-seq-len", "128", "--max-batch-size", "4",
         "--kv-block-size", "8", "--served-model-name", "ckpt",
         "--extra-llm-api-options", str(opts)],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 120
        while True:
            try:
                if get(port, "/health")[0] == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.stdout.read().decode()
            assert time.time() < deadline
            time.sleep(0.2)
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("POST", "/v1/completions", body=json.dumps(
            {"model": "ckpt", "prompt": [1, 2, 3], "max_tokens": 4,
             "ignore_eos": True, "temperature": 0}).encode())
        r = c.getresponse()
        body = json.loads(r.read())
        c.close()
        assert r.status == 200 and body["usage"]["completion_tokens"] == 4
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("argv,match", [
    (["m", "--tp-size", "2"], "tensor-parallel"),
    (["m", "--mm-encoder-only"], "multimodal"),
])
def test_serve_cli_refuses_later_slices(argv, match):
    from tensorrt_llm_tpu_torch.commands import serve
    with pytest.raises(NotImplementedError, match=match):
        serve.main(argv + ["--device", "cpu"] if argv[0] == "m" else argv)


@pytest.fixture(scope="module")
def cli_ckpt(tmp_path_factory):
    """A 2-layer checkpoint and the overrides the CLI tests serve it
    with."""
    from torch_parity import write_hf_checkpoint
    d = tmp_path_factory.mktemp("cli")
    hf = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
          "vocab_size": 320, "hidden_size": 128, "intermediate_size": 256,
          "num_hidden_layers": 2, "num_attention_heads": 4,
          "num_key_value_heads": 2, "max_position_embeddings": 256,
          "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
          "tie_word_embeddings": False}
    (d / "ckpt").mkdir()
    write_hf_checkpoint(d / "ckpt", hf, seed=0)
    (d / "opts.json").write_text(json.dumps({
        "skip_tokenizer_init": True, "kv_bookkeeping": "python",
        "kv_num_blocks": 64}))
    return d


def _wait(pred, proc, what, timeout=120):
    deadline = time.time() + timeout
    while True:
        try:
            if pred():
                return
        except OSError:
            pass
        assert proc.poll() is None, proc.stdout.read().decode()
        assert time.time() < deadline, what
        time.sleep(0.2)


def _stop(proc):
    try:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0, proc.stdout.read().decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("flag", ["--register-to", "--advertise-url",
                                  "--disagg-role"])
def test_serve_cli_registers_worker(cli_ckpt, flag):
    """The worker CLI joins a front end once it listens (``--register-to``;
    ``--advertise-url`` names the URL it announces, ``--disagg-role`` its
    pool; by default http://<host>:<port> and the generation pool) and
    leaves it on SIGINT."""
    from tensorrt_llm_tpu_torch.serve.disagg_server import OpenAIDisaggServer
    front = OpenAIDisaggServer([], [], health_interval=0)
    fs = front.start_in_thread()
    port = free_port()
    extra, role, url = [], "generation", f"http://127.0.0.1:{port}"
    if flag == "--advertise-url":
        url = "http://worker.example:9"
        extra = [flag, url]
    elif flag == "--disagg-role":
        role, extra = "context", [flag, "context"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorrt_llm_tpu_torch.commands.serve",
         str(cli_ckpt / "ckpt"), "--device", "cpu", "--host", "127.0.0.1",
         "--port", str(port), "--max-seq-len", "128", "--kv-block-size", "8",
         "--extra-llm-api-options", str(cli_ckpt / "opts.json"),
         "--register-to", f"http://127.0.0.1:{fs.port}"] + extra,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=str(cli_ckpt),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    pool = front.ctx_pool if role == "context" else front.gen_pool
    try:
        _wait(lambda: pool.urls == [url], proc, "worker never registered")
        assert get(port, "/health")[0] == 200
        _stop(proc)
        assert pool.urls == []
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        fs.stop()


def test_serve_cli_disaggregated_subprocess(tmp_path):
    """`trtllm-torch-serve disaggregated` starts with its pools, takes a
    registration and stops on SIGINT."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorrt_llm_tpu_torch.commands.serve",
         "disaggregated", "--ctx-servers", "http://127.0.0.1:1",
         "--gen-servers", "http://127.0.0.1:2", "http://127.0.0.1:3",
         "--router", "kv_aware", "--health-interval", "0", "--stream-kv",
         "--host", "127.0.0.1", "--port", str(port)],
        env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        _wait(lambda: get(port, "/health")[0] == 200, proc, "no front end")
        cl = json.loads(get(port, "/cluster")[1])
        assert [s["url"] for s in cl["context"]] == ["http://127.0.0.1:1"]
        assert len(cl["generation"]) == 2
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        c.request("POST", "/register", body=json.dumps(
            {"url": "http://127.0.0.1:4", "role": "context"}).encode())
        assert c.getresponse().status == 200
        c.close()
        cl = json.loads(get(port, "/cluster")[1])
        assert len(cl["context"]) == 2
        _stop(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serve_cli_overrides(tmp_path, monkeypatch):
    from tensorrt_llm_tpu_torch.commands import serve
    p = tmp_path / "o.json"
    p.write_text('{"max_decode_steps": 4}')
    assert serve.load_overrides(str(p)) == {"max_decode_steps": 4}
    y = tmp_path / "o.yaml"
    y.write_text("max_decode_steps: 4\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ValueError, match="yaml"):
        serve.load_overrides(str(y))
    bad = tmp_path / "bad.json"
    bad.write_text('{"no_such_field": 1}')
    with pytest.raises(ValueError, match="no_such_field"):
        serve.main(["tinyllama-1.1b", "--device", "cpu",
                    "--extra-llm-api-options", str(bad)])


def test_new_modules_import_without_jax_aiohttp_pydantic():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'aiohttp', 'pydantic', 'yaml',\n"
        "          'tensorrt_llm_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, tensorrt_llm_tpu_torch as P\n"
        "for mod in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import chip_smoke\n"
        "from tensorrt_llm_tpu_torch.serve import openai_server, "
        "openai_protocol, tool_parser, reasoning_parser\n"
        "from tensorrt_llm_tpu_torch.commands import serve, "
        "benchmark_serving\n"
        "from tensorrt_llm_tpu_torch.llmapi import tracing\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'aiohttp', 'pydantic', 'tensorrt_llm_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       env=dict(os.environ, PYTHONPATH=str(ROOT)),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr
