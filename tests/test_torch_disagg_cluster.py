"""The port's disaggregated front end and worker routes
(`serve/disagg_server.py`, `serve/http_client.py`) against the JAX
package's, on the CPU at a tiny size.

* Cluster parity: a JAX cluster (aiohttp front end, JAX context and
  generation workers) and a port cluster (standard-library front end, port
  workers holding the JAX weights through `params_from_jax`) answer the
  same ``/v1/completions`` bodies alike in the two-phase, ``stream_kv`` and
  conditional modes: equal greedy ``token_ids`` (or a first difference at
  a near-tie of the port's logits), and in the conditional mode, where the
  body is a plain completion, equal text and finish reasons.
* The pool, router and KV-view cases of JAX `tests/test_disagg.py` and
  `tests/test_disagg_cluster.py` on the port's classes: membership,
  fencing and rejoin, round robin over a changing pool, 503 with no healthy
  worker, the ``kv_aware`` router preferring a warm worker over HTTP with
  and without a ``/prefix_match`` probe, event cursors, gaps, epochs and
  ``removed`` events, registration and health sweeps, worker
  self-registration and the conditional skip of the context hop.
* The client: keep-alive reuse, chunked and sized bodies, `readexactly`
  across chunk boundaries.
"""

import asyncio
import http.client
import json

import jax
import numpy as np
import pytest

import tensorrt_llm_tpu as J
from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu_torch.models import ModelConfig, params_from_jax
from tensorrt_llm_tpu_torch.serve.disagg_server import (
    KvView, OpenAIDisaggServer, Router, ServerPool)
from tensorrt_llm_tpu_torch.serve.http_client import ClientSession
from tensorrt_llm_tpu_torch.serve.openai_server import (
    HTTPApp, HTTPError, OpenAIServer, _json)

from torch_parity import port_logits

TIE = 0.02
TINY = dict(vocab_size=128, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            max_position=256)
KW = dict(max_seq_len=128, max_batch_size=8, kv_num_blocks=96,
          kv_block_size=8)


class Tok:
    """A byte-like tokenizer shared by both clusters."""
    eos_token_id = 0

    def encode(self, text):
        return [max(1, min(127, ord(c))) for c in text] or [1]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if i or not skip_special_tokens)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def call(port, method, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    c.request(method, path, None if body is None else json.dumps(body))
    r = c.getresponse()
    out = r.status, r.read()
    c.close()
    return out


# --------------------------------------------------------- cluster parity --
class Clusters:
    """A JAX cluster on one aiohttp loop and a port cluster of threads;
    `mode(name)` sets both front ends to two-phase, stream_kv or
    conditional."""

    def __init__(self):
        from aiohttp.test_utils import TestServer
        from tensorrt_llm_tpu.serve import disagg_server as jds
        from tensorrt_llm_tpu.serve.openai_server import (
            OpenAIServer as JServer)
        self.tok = Tok()
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TLLM_KV_BOOKKEEPING", "python")
            self.jctx = J.LLM(model=JCfg(**TINY), tokenizer=self.tok,
                              seed=0, max_num_tokens=16, **KW)
            self.jgen = J.LLM(model=JCfg(**TINY), tokenizer=self.tok,
                              seed=0, **KW)
        self.params = params_from_jax(jax.tree.map(np.asarray,
                                                   self.jgen.engine.params))
        self.tctx = T.LLM(model=ModelConfig(**TINY), tokenizer=self.tok,
                          device="cpu", params=self.params,
                          max_num_tokens=16, **KW)
        self.tgen = T.LLM(model=ModelConfig(**TINY), tokenizer=self.tok,
                          device="cpu", params=self.params, **KW)
        self.loop = asyncio.new_event_loop()
        self.jservers = [TestServer(JServer(llm, "tiny").app, loop=self.loop)
                         for llm in (self.jctx, self.jgen)]
        for s in self.jservers:
            self.loop.run_until_complete(s.start_server())
        ju = [str(s.make_url("")).rstrip("/") for s in self.jservers]
        self.jfront = jds.OpenAIDisaggServer([ju[0]], [ju[1]],
                                             health_interval=0)
        self.jfs = TestServer(self.jfront.app, loop=self.loop)
        self.loop.run_until_complete(self.jfs.start_server())
        self.tws = [OpenAIServer(llm, "tiny").start_in_thread()
                    for llm in (self.tctx, self.tgen)]
        self.tfront = OpenAIDisaggServer(
            [f"http://127.0.0.1:{self.tws[0].port}"],
            [f"http://127.0.0.1:{self.tws[1].port}"], health_interval=0)
        self.tfs = self.tfront.start_in_thread()

    def mode(self, name):
        for f in (self.jfront, self.tfront):
            f.stream_kv = name == "stream_kv"
            f.conditional_max_prompt = 1000 if name == "conditional" else 0

    def post(self, body):
        async def go():
            from aiohttp import ClientSession as AS
            async with AS() as s:
                async with s.post(str(self.jfs.make_url("/v1/completions")),
                                  json=body) as r:
                    return r.status, await r.read()
        j = self.loop.run_until_complete(go())
        return j, call(self.tfs.port, "POST", "/v1/completions", body)

    def close(self):
        self.tfs.stop()
        for w in self.tws:
            w.stop()
        self.loop.run_until_complete(self.jfs.close())
        for s in self.jservers:
            self.loop.run_until_complete(s.close())
        self.loop.close()
        for llm in (self.jctx, self.jgen, self.tctx, self.tgen):
            llm.shutdown()


@pytest.fixture(scope="module")
def clusters():
    c = Clusters()
    try:
        yield c
    finally:
        c.close()


PROMPTS = [[int(t) for t in np.random.RandomState(s).randint(1, 127, n)]
           for s, n in ((1, 40), (2, 13), (3, 27))]


@pytest.mark.parametrize("mode", ["two_phase", "stream_kv", "conditional"])
def test_clusters_answer_alike(clusters, mode):
    clusters.mode(mode)
    for p in PROMPTS:
        body = {"model": "tiny", "prompt": p, "prompt_token_ids": p,
                "max_tokens": 6, "temperature": 0.0, "ignore_eos": True}
        if mode == "conditional":
            body["logprobs"] = 0     # the plain body's tokens, one a string
        (js, jb), (ts, tb) = clusters.post(body)
        assert js == ts == 200, (jb, tb)
        jc, tc = json.loads(jb)["choices"][0], json.loads(tb)["choices"][0]
        assert jc["finish_reason"] == tc["finish_reason"] == "length"
        if mode == "conditional":    # a plain completion body
            assert "token_ids" not in jc and "token_ids" not in tc
            want, got = ([ord(t) if t else 0 for t in c["logprobs"]["tokens"]]
                         for c in (jc, tc))
            assert len(want) == len(got) == 6
            if want == got:
                assert jc["text"] == tc["text"]
        else:
            want, got = jc["token_ids"], tc["token_ids"]
        if want != got:
            i = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
            lg = port_logits(ModelConfig(**TINY), clusters.params,
                             p + want[:i])
            top = lg.max()
            assert lg[want[i]] >= top - TIE and lg[got[i]] >= top - TIE, (
                mode, want, got)
    kv = clusters.tctx.get_kv_cache_stats()
    assert kv["active_sequences"] == 0


def test_cluster_errors_match(clusters):
    """A worker's refusal passes through both front ends with its status."""
    clusters.mode("two_phase")
    body = {"model": "tiny", "prompt_token_ids": [1, 2, 3],
            "max_tokens": 0, "temperature": 0.0}
    (js, _), (ts, tb) = clusters.post(body)
    assert js >= 400 and ts >= 400 and "error" in json.loads(tb)


# ------------------------------------------------------------ pool/router --
def test_pool_membership_and_fencing():
    pool = ServerPool(["http://a", "http://b"], fail_threshold=2)
    assert sorted(pool.urls) == ["http://a", "http://b"]
    pool.add("http://c/")
    assert "http://c" in pool.urls
    pool.remove("http://b")
    assert "http://b" not in pool.urls
    pool.mark("http://a", False)
    assert pool.healthy_urls() == ["http://a", "http://c"]
    pool.mark("http://a", False)
    assert pool.healthy_urls() == ["http://c"]
    pool.mark("http://a", True)
    assert sorted(pool.healthy_urls()) == ["http://a", "http://c"]


def test_router_round_robin():
    r = Router(["a", "b"], "round_robin")
    assert [run(r.pick(None)) for _ in range(4)] == ["a", "b", "a", "b"]


def test_router_skips_fenced_and_rebuilds_cycle():
    pool = ServerPool(["a", "b", "c"], fail_threshold=1)
    r = Router(pool, "round_robin")
    assert sorted({run(r.pick(None)) for _ in range(3)}) == ["a", "b", "c"]
    pool.mark("b", False)
    assert "b" not in [run(r.pick(None)) for _ in range(4)]


def test_router_unavailable_when_all_fenced():
    pool = ServerPool(["a"], fail_threshold=1)
    pool.mark("a", False)
    with pytest.raises(HTTPError) as e:
        run(Router(pool, "round_robin").pick(None))
    assert e.value.status == 503


def test_router_refuses_unknown_policy():
    with pytest.raises(ValueError):
        Router(["a"], "random")


def _mk(seed=4, **kw):
    return T.LLM(model=ModelConfig(**TINY), skip_tokenizer_init=True,
                 device="cpu", seed=seed, kv_bookkeeping="python",
                 **dict(KW, **kw))


def _warm_pair(prompt_seed):
    prompt = [int(x) for x in
              np.random.RandomState(prompt_seed).randint(1, 120, 30)]
    a, b = _mk(), _mk()
    a.generate([prompt], T.SamplingParams(max_tokens=4, temperature=0.0,
                                          ignore_eos=True))
    return prompt, a, b


def test_kv_aware_router_prefers_warm_server():
    prompt, a, b = _warm_pair(3)
    sa, sb = (OpenAIServer(x, "t").start_in_thread() for x in (a, b))
    ua, ub = (f"http://127.0.0.1:{s.port}" for s in (sa, sb))
    try:
        assert a.match_kv_prefix(prompt) >= 16
        assert b.match_kv_prefix(prompt) == 0

        async def route(urls, ids):
            async with ClientSession() as s:
                return await Router(urls, "kv_aware").pick(s, ids)

        assert run(route([ub, ua], prompt)) == ua
        assert run(route([ua, ub], prompt)) == ua
        assert run(route([ua, ub], None)) in (ua, ub)   # load-based then
    finally:
        sa.stop()
        sb.stop()
        a.shutdown()
        b.shutdown()


def test_kv_aware_router_event_view_no_probe(monkeypatch):
    prompt, a, b = _warm_pair(7)
    sa, sb = (OpenAIServer(x, "t").start_in_thread() for x in (a, b))
    ua, ub = (f"http://127.0.0.1:{s.port}" for s in (sa, sb))
    probes = []

    async def counting_probe(session, url, token_ids):
        probes.append(url)
        return 0

    try:
        exact = a.match_kv_prefix(prompt)
        assert exact >= 16
        monkeypatch.setattr(Router, "prefix_match",
                            staticmethod(counting_probe))
        r = Router([ub, ua], "kv_aware")

        async def route():
            async with ClientSession() as s:
                return await r.pick(s, prompt), await r.pick(s, prompt)

        assert run(route()) == (ua, ua)
        assert probes == []
        assert r._views[ua].match(prompt) == exact
        assert r._views[ub].match(prompt) == 0
    finally:
        sa.stop()
        sb.stop()
        a.shutdown()
        b.shutdown()


def test_kv_aware_router_probes_while_resyncing(monkeypatch):
    """A view that still needs its snapshot scores by `/prefix_match`."""
    prompt, a, b = _warm_pair(8)
    sa, sb = (OpenAIServer(x, "t").start_in_thread() for x in (a, b))
    ua, ub = (f"http://127.0.0.1:{s.port}" for s in (sa, sb))
    real = KvView.apply
    probes = []

    def no_snapshot(self, resp):
        resp.pop("block_hashes", None)       # the snapshot never lands
        real(self, resp)

    orig = Router.prefix_match

    async def probe(session, url, ids):
        probes.append(url)
        return await orig(session, url, ids)

    try:
        monkeypatch.setattr(KvView, "apply", no_snapshot)
        monkeypatch.setattr(Router, "prefix_match", staticmethod(probe))

        async def route():
            async with ClientSession() as s:
                return await Router([ub, ua], "kv_aware").pick(s, prompt)

        assert run(route()) == ua
        assert sorted(probes) == sorted([ua, ub])
    finally:
        sa.stop()
        sb.stop()
        a.shutdown()
        b.shutdown()


def test_kv_view_removed_events():
    llm = _mk(kv_num_blocks=24)
    try:
        prompt = [int(x) for x in
                  np.random.RandomState(9).randint(1, 60, 30)]
        llm.generate([prompt], T.SamplingParams(max_tokens=4,
                                                temperature=0.0,
                                                ignore_eos=True))
        view = KvView()
        view.apply({"block_size": llm.kv_manager.block_size,
                    "events": llm.get_kv_cache_events(0),
                    "block_hashes": llm.read_kv(
                        lambda kv: kv.reuse_block_hashes())})
        assert view.match(prompt) >= 16
        for i in range(40):
            p = [int(x) for x in
                 np.random.RandomState(100 + i).randint(60, 120, 30)]
            llm.generate([p], T.SamplingParams(max_tokens=2,
                                               temperature=0.0,
                                               ignore_eos=True))
            view.apply({"events": llm.get_kv_cache_events(view.cursor)})
            if llm.match_kv_prefix(prompt) == 0:
                break
        assert llm.match_kv_prefix(prompt) == 0
        view.apply({"events": llm.get_kv_cache_events(view.cursor)})
        assert view.match(prompt) == 0
    finally:
        llm.shutdown()


def test_kv_view_explicit_cursor_non_contiguous_ids():
    view = KvView()
    view.apply({"epoch": "e1", "block_size": 8, "block_hashes": [],
                "next_since_id": 0, "oldest_retained_id": 0})
    assert not view.need_full
    view.apply({"epoch": "e1",
                "events": [{"id": 0, "type": "stored", "block_hash": 11},
                           {"id": 2, "type": "stored", "block_hash": 22},
                           {"id": 4, "type": "stored", "block_hash": 33}],
                "next_since_id": 5, "oldest_retained_id": 0})
    assert not view.need_full and view.cursor == 5
    assert view.blocks == {11, 22, 33}
    view.apply({"epoch": "e1",
                "events": [{"id": 12, "type": "stored", "block_hash": 44}],
                "next_since_id": 7, "oldest_retained_id": 0})
    assert view.cursor == 7 and not view.need_full


def test_kv_view_gap_and_epoch_reset():
    view = KvView()
    view.apply({"epoch": "e1", "block_size": 8, "block_hashes": [5],
                "next_since_id": 3, "oldest_retained_id": 0})
    assert not view.need_full and view.blocks == {5}
    view.apply({"epoch": "e1", "events": [],
                "next_since_id": 900, "oldest_retained_id": 800})
    assert view.need_full
    view.apply({"epoch": "e1", "block_size": 8, "block_hashes": [5, 6],
                "next_since_id": 900, "oldest_retained_id": 800})
    assert not view.need_full and view.cursor == 900
    view.apply({"epoch": "e2", "events": [],
                "next_since_id": 0, "oldest_retained_id": 0})
    assert view.need_full and view.blocks == set() and view.cursor == 0


def test_kv_view_legacy_gap_heuristic():
    """A server without explicit cursors: a first event past the cursor
    is a gap."""
    view = KvView()
    view.apply({"block_size": 8, "block_hashes": [1]})
    view.apply({"events": [{"id": 3, "type": "stored", "block_hash": 2}]})
    assert view.need_full and view.cursor == 4 and view.blocks == {1, 2}


def test_kv_view_matches_the_jax_view():
    """The same event sequence gives the JAX `KvView` and the port's the
    same blocks, cursor and scores."""
    from tensorrt_llm_tpu.serve.disagg_server import KvView as JView
    prompt, a, b = _warm_pair(10)
    try:
        resp = {"block_size": 8, "events": a.get_kv_cache_events(0),
                "next_since_id": a.read_kv(lambda kv: kv.event_cursor()[0]),
                "oldest_retained_id": 0}
        tv, jv = KvView(), JView()
        tv.apply(dict(resp))
        jv.apply(dict(resp))
        assert tv.blocks == jv.blocks and tv.cursor == jv.cursor
        assert tv.match(prompt) == jv.match(prompt) >= 16
    finally:
        a.shutdown()
        b.shutdown()


def test_event_cursor_wire_fields():
    llm = _mk()
    srv = OpenAIServer(llm, "t").start_in_thread()
    try:
        prompt = [int(x) for x in
                  np.random.RandomState(3).randint(1, 60, 30)]
        llm.generate([prompt], T.SamplingParams(max_tokens=4,
                                                temperature=0.0,
                                                ignore_eos=True))
        nxt, oldest = llm.read_kv(lambda kv: kv.event_cursor())
        assert oldest == 0
        evs = llm.get_kv_cache_events(0)
        assert evs and nxt == max(e["id"] for e in evs) + 1
        assert llm.get_kv_cache_events(nxt) == []
        st, body = call(srv.port, "GET", f"/kv_cache_events?since_id={nxt}")
        out = json.loads(body)
        assert st == 200 and out["events"] == [] and out["epoch"]
        assert out["next_since_id"] == nxt
    finally:
        srv.stop()
        llm.shutdown()


# ---------------------------------------------------------- front end ------
def test_register_unregister_and_health_sweep():
    llm = _mk()
    worker = OpenAIServer(llm, "tiny").start_in_thread()
    front = OpenAIDisaggServer([], [], "round_robin", health_interval=0)
    fs = front.start_in_thread()
    wurl = f"http://127.0.0.1:{worker.port}"
    try:
        assert call(fs.port, "POST", "/register",
                    {"url": wurl, "role": "generation"})[0] == 200
        call(fs.port, "POST", "/register",
             {"url": "http://127.0.0.1:1", "role": "generation"})
        cl = json.loads(call(fs.port, "GET", "/cluster")[1])
        assert len(cl["generation"]) == 2 and cl["context"] == []
        assert call(fs.port, "POST", "/register",
                    {"url": wurl, "role": "nobody"})[0] == 400

        async def sweeps():
            async with ClientSession() as s:
                for _ in range(3):
                    await front.gen_pool.check_health(s, timeout=0.5)
        run(sweeps())
        assert front.gen_pool.healthy_urls() == [wurl]
        call(fs.port, "POST", "/unregister",
             {"url": wurl, "role": "generation"})
        cl = json.loads(call(fs.port, "GET", "/cluster")[1])
        assert [s["url"] for s in cl["generation"]] == ["http://127.0.0.1:1"]
        assert call(fs.port, "GET", "/health")[0] == 200
        # no healthy generation worker: the front end answers 503
        st, body = call(fs.port, "POST", "/v1/completions", {
            "prompt_token_ids": [1, 2], "max_tokens": 2})
        assert st == 503 and "healthy" in json.loads(body)["error"]
    finally:
        fs.stop()
        worker.stop()
        llm.shutdown()


def test_health_loop_fences_and_rejoins():
    """The background health loop fences a dead worker and lets a live one
    rejoin."""
    llm = _mk()
    worker = OpenAIServer(llm, "tiny").start_in_thread()
    wurl = f"http://127.0.0.1:{worker.port}"
    front = OpenAIDisaggServer([], [wurl, "http://127.0.0.1:1"],
                               health_interval=0.05)
    front.gen_pool.fail_threshold = 1
    front.gen_pool.mark(wurl, False)        # fenced before the loop runs
    fs = front.start_in_thread()
    try:
        import time
        deadline = time.time() + 20
        while front.gen_pool.healthy_urls() != [wurl]:
            assert time.time() < deadline, front.gen_pool.snapshot()
            time.sleep(0.05)
    finally:
        fs.stop()
        worker.stop()
        llm.shutdown()
    assert front._health_task.cancelled() or front._health_task.done()


def test_worker_self_registration():
    front = OpenAIDisaggServer([], [], health_interval=0)
    fs = front.start_in_thread()
    llm = _mk()
    try:
        furl = f"http://127.0.0.1:{fs.port}"
        worker = OpenAIServer(llm, "tiny", register_to=furl,
                              advertise_url="http://me:9",
                              disagg_role="context").start_in_thread()
        assert front.ctx_pool.urls == ["http://me:9"]
        worker.stop()
        assert front.ctx_pool.urls == []
        worker = OpenAIServer(llm, "tiny", register_to=furl
                              ).start_in_thread()   # default URL and role
        assert front.gen_pool.urls == [f"http://127.0.0.1:{worker.port}"]
        worker.stop()
        assert front.gen_pool.urls == []
        with pytest.raises(ValueError):
            OpenAIServer(llm, "tiny", disagg_role="decode")
    finally:
        fs.stop()
        llm.shutdown()


def test_conditional_disagg_short_prompt_skips_prefill_hop():
    prompt = [int(x) for x in np.random.RandomState(5).randint(1, 60, 10)]
    ref = _mk(seed=3)
    try:
        want = ref.generate([prompt], T.SamplingParams(
            max_tokens=5, temperature=0.0, ignore_eos=True))[0]
    finally:
        ref.shutdown()
    llm = _mk(seed=3)
    worker = OpenAIServer(llm, "tiny").start_in_thread()
    front = OpenAIDisaggServer(
        [], [f"http://127.0.0.1:{worker.port}"], health_interval=0,
        conditional_max_prompt=32)          # the context pool is empty
    fs = front.start_in_thread()
    try:
        st, body = call(fs.port, "POST", "/v1/completions", {
            "model": "tiny", "prompt": prompt, "prompt_token_ids": prompt,
            "max_tokens": 5, "temperature": 0.0, "ignore_eos": True,
            "logprobs": 0})
        out = json.loads(body)
        assert st == 200, body
        assert out["choices"][0]["finish_reason"] == "length"
        toks = [int(t) for t in out["choices"][0]["logprobs"]["tokens"]]
        assert toks == want.outputs[0].token_ids
        # a long prompt needs the context pool, which is empty
        st, body = call(fs.port, "POST", "/v1/completions", {
            "prompt_token_ids": list(range(1, 40)), "max_tokens": 2})
        assert st == 503
    finally:
        fs.stop()
        worker.stop()
        llm.shutdown()


def test_conditional_cached_fraction_skips_prefill_hop():
    """A prompt a generation worker mostly caches skips the context hop
    (the context pool names a dead worker, so a hop would fail)."""
    prompt, a, b = _warm_pair(12)
    b.shutdown()
    worker = OpenAIServer(a, "tiny").start_in_thread()
    front = OpenAIDisaggServer(
        ["http://127.0.0.1:1"], [f"http://127.0.0.1:{worker.port}"],
        health_interval=0, conditional_cached_fraction=0.5)
    fs = front.start_in_thread()
    try:
        st, body = call(fs.port, "POST", "/v1/completions", {
            "model": "tiny", "prompt_token_ids": prompt, "max_tokens": 2,
            "temperature": 0.0})
        assert st == 200, body
        cold = [int(x) for x in np.random.RandomState(99).randint(1, 120, 30)]
        st, _ = call(fs.port, "POST", "/v1/completions", {
            "prompt_token_ids": cold, "max_tokens": 2})
        assert st >= 500                 # the hop to the dead worker
    finally:
        fs.stop()
        worker.stop()
        a.shutdown()


# ----------------------------------------------------------------- client --
class _Echo(HTTPApp):
    def __init__(self):
        super().__init__()
        self.routes = {("POST", "/echo"): self.echo,
                       ("GET", "/chunks"): self.chunks}
        self.conns = 0

    async def _handle(self, reader, writer):
        self.conns += 1
        await super()._handle(reader, writer)

    async def echo(self, req, conn):
        return _json(req.json())

    async def chunks(self, req, conn):
        await conn.start_stream("application/octet-stream")
        for piece in (b"abc", b"defgh", b"i", b"jklmnop"):
            await conn.send(piece)
        await conn.end_stream()


def test_client_keep_alive_and_bodies():
    app = _Echo()
    srv = app.start_in_thread()
    url = f"http://127.0.0.1:{srv.port}"

    async def go():
        async with ClientSession(timeout=10) as s:
            outs = []
            for i in range(5):
                r = await s.post(f"{url}/echo", json={"i": i})
                outs.append((r.status, await r.json()))
            r = await s.get(f"{url}/chunks")
            parts = [await r.readexactly(2), await r.readexactly(7)]
            rest = await r.read()
            r = await s.get(f"{url}/nothing")
            missing = r.status, await r.json()
            return outs, parts, rest, missing

    try:
        outs, parts, rest, missing = run(go())
    finally:
        srv.stop()
    assert outs == [(200, {"i": i}) for i in range(5)]
    assert parts == [b"ab", b"cdefghi"] and rest == b"jklmnop"
    assert missing[0] == 404 and "error" in missing[1]
    assert app.conns == 1                    # one kept-alive connection
