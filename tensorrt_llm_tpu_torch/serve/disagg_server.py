"""Disaggregated serving: a front end over a context (prefill) pool and a
generation (decode) pool, and the worker routes behind it.

Counterpart of `tensorrt_llm_tpu/serve/disagg_server.py`, on the port's
standard-library server (`openai_server.HTTPApp`) and client
(`http_client.ClientSession`) instead of aiohttp.  A ``/v1/completions``
request runs in one of three modes:

* two-phase: a context worker's ``/disagg/context`` prefills and returns
  the first token and the prompt's KV payload (base64 of
  `payload_to_bytes`), which a generation worker's ``/disagg/generate``
  injects before decoding;
* ``stream_kv``: one request to a generation worker's
  ``/disagg/generate_streamed``, which pulls length-prefixed KV frames from
  the context worker's ``/disagg/context_stream`` and injects each as it
  arrives, while the prefill still runs;
* conditional: a prompt of at most `conditional_max_prompt` tokens, or one
  of which a generation worker caches at least
  `conditional_cached_fraction`, skips the context hop and runs on a
  generation worker's ``/v1/completions``.

`ServerPool` keeps a pool's members: workers POST ``/register`` and
``/unregister``; a health loop probes ``/health`` every `health_interval`
seconds and fences a worker after `fail_threshold` failures in a row; a
fenced worker rejoins at its next good probe.  `Router` picks a worker:
``round_robin``, ``load_based`` (fewest active sequences, one concurrent
``/kv_cache_events`` probe per candidate) or ``kv_aware`` (longest cached
prefix, then load): the same probe feeds each worker's `KvView`, a mirror
of its matchable block hashes kept by the stored/removed events, with a
``full=1`` snapshot when the view starts, falls behind the event ring or
sees a new process epoch; while a view resyncs it scores by an exact
``/prefix_match`` probe.

Not copied from the JAX package: its streamed context route can send
``prefill failed`` between the request's finish and its end frame; here
`next_frame` looks at the frame queue once more before it declares a
failure (and the executor puts the end frame before the request reads as
finished).
"""

from __future__ import annotations

import asyncio
import base64
import itertools
import json
import queue
import time
from typing import Dict, List, Optional

from tensorrt_llm_tpu_torch.llmapi.disagg_params import (
    DisaggregatedParams, frame_from_bytes, frame_to_bytes, payload_from_bytes,
    payload_to_bytes)
from tensorrt_llm_tpu_torch.llmapi.sampling_params import SamplingParams
from tensorrt_llm_tpu_torch.runtime.executor import RECEIVE_DEADLINE_S
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (
    prefix_chain_hashes)
from tensorrt_llm_tpu_torch.serve.http_client import ClientSession
from tensorrt_llm_tpu_torch.serve.openai_protocol import RequestError
from tensorrt_llm_tpu_torch.serve.openai_server import (
    HTTPApp, HTTPError, PAYLOAD_MAX_BODY, _error, _json, result_of)
from tensorrt_llm_tpu_torch.utils import logger

_JSON = "application/json; charset=utf-8"


class ServerPool:
    """A pool's members, their health and fencing."""

    def __init__(self, urls: Optional[List[str]] = None,
                 fail_threshold: int = 3):
        self.servers: Dict[str, dict] = {}
        self.fail_threshold = fail_threshold
        for u in urls or []:
            self.add(u)

    def add(self, url: str):
        url = url.rstrip("/")
        if url not in self.servers:
            self.servers[url] = {"healthy": True, "fails": 0,
                                 "joined": time.time()}
            logger.info("pool: %s joined", url)

    def remove(self, url: str):
        if self.servers.pop(url.rstrip("/"), None) is not None:
            logger.info("pool: %s left", url)

    @property
    def urls(self) -> List[str]:
        return list(self.servers)

    def healthy_urls(self) -> List[str]:
        return [u for u, s in self.servers.items() if s["healthy"]]

    def mark(self, url: str, ok: bool):
        s = self.servers.get(url)
        if s is None:
            return
        if ok:
            if not s["healthy"]:
                logger.info("pool: %s recovered", url)
            s["fails"] = 0
            s["healthy"] = True
        else:
            s["fails"] += 1
            if s["fails"] >= self.fail_threshold and s["healthy"]:
                s["healthy"] = False
                logger.warning("pool: %s fenced after %d failed health "
                               "checks", url, s["fails"])

    async def check_health(self, session: ClientSession,
                           timeout: float = 2.0):
        """One probe of every member, the fenced ones too (so they can
        rejoin)."""
        for u in self.urls:
            try:
                r = await session.get(f"{u}/health", timeout=timeout)
                await r.read()
                self.mark(u, r.status == 200)
            except Exception:  # noqa: BLE001
                self.mark(u, False)

    def snapshot(self) -> List[dict]:
        return [{"url": u, **s} for u, s in self.servers.items()]


class KvView:
    """One worker's matchable block hashes, kept by its KV events.  A chain
    hash encodes its whole prefix, so a set and a walk over the prompt's
    chain stand in for a radix tree.  `need_full` asks the next probe for a
    ``full=1`` snapshot (at the start, after a cursor gap, after a new
    epoch)."""

    def __init__(self):
        self.blocks: set = set()
        self.cursor = 0          # the next event id wanted
        self.block_size = 0
        self.need_full = True
        self.epoch = None        # the worker process's identity

    def apply(self, resp: dict):
        ep = resp.get("epoch")
        if ep is not None and ep != self.epoch:
            if self.epoch is not None:
                # a restarted worker: its ids start again and its cache is
                # cold
                self.blocks.clear()
                self.cursor = 0
                self.need_full = True
            self.epoch = ep
        self.block_size = resp.get("block_size") or self.block_size
        full = "block_hashes" in resp
        if full:
            self.blocks = set(resp["block_hashes"])
            self.need_full = False
        events = resp.get("events") or []
        oldest = resp.get("oldest_retained_id")
        if oldest is not None:
            # events below the retained floor are gone (ids themselves may
            # be non-contiguous: never infer a gap from them)
            if oldest > self.cursor and not full:
                self.need_full = True
        elif events and events[0]["id"] > self.cursor and not full:
            self.need_full = True   # a server without cursors
        start = seen = self.cursor
        for e in events:
            if e["type"] == "stored":
                self.blocks.add(e["block_hash"])
            elif e["type"] == "removed":
                self.blocks.discard(e["block_hash"])
            seen = max(seen, e["id"] + 1)
        nxt = resp.get("next_since_id")
        # an explicit cursor is taken as it is (replayed events are
        # idempotent; skipping past it could lose a slow rank's events)
        self.cursor = max(start, nxt) if nxt is not None else seen

    def match(self, token_ids) -> int:
        if not self.block_size or not self.blocks:
            return 0
        n = 0
        for h in prefix_chain_hashes(token_ids, self.block_size):
            if h not in self.blocks:
                break
            n += self.block_size
        return n


class Router:
    """Picks a worker of a pool for the next request."""

    def __init__(self, urls, policy: str = "round_robin"):
        if policy not in ("round_robin", "load_based", "kv_aware"):
            raise ValueError(f"unknown router policy {policy!r}")
        self.pool = urls if isinstance(urls, ServerPool) else ServerPool(urls)
        self.policy = policy
        self._rr = itertools.cycle([])
        self._rr_urls: List[str] = []
        self._views: Dict[str, KvView] = {}

    @property
    def urls(self) -> List[str]:
        return self.pool.urls

    def _candidates(self) -> List[str]:
        urls = self.pool.healthy_urls()
        if not urls:
            raise HTTPError(503, "no healthy backend")
        return urls

    async def pick(self, session: Optional[ClientSession],
                   token_ids: Optional[List[int]] = None) -> str:
        cands = self._candidates()
        if self.policy == "round_robin" or len(cands) == 1:
            if cands != self._rr_urls:   # the membership changed
                self._rr_urls = cands
                self._rr = itertools.cycle(cands)
            return next(self._rr)
        kv_aware = self.policy == "kv_aware" and token_ids

        async def probe(u):
            view = self._views.setdefault(u, KvView())
            q = f"?since_id={view.cursor}"
            if kv_aware and view.need_full:
                q += "&full=1"
            try:
                r = await session.get(f"{u}/kv_cache_events{q}")
                stats = await r.json()
                if r.status != 200:
                    raise RuntimeError(f"HTTP {r.status}")
                self.pool.mark(u, True)
                view.apply(stats)
                return (stats.get("active_sequences", 0), u)
            except Exception:  # noqa: BLE001 -- skip an unhealthy worker
                self.pool.mark(u, False)
                return None

        loads = [x for x in await asyncio.gather(*(probe(u) for u in cands))
                 if x is not None]
        if not loads:
            raise HTTPError(503, "no healthy backend")
        if kv_aware:
            async def score(load, u):
                view = self._views[u]
                if view.need_full:
                    m = await self.prefix_match(session, u, token_ids)
                else:
                    m = view.match(token_ids)
                return (-m, load, u)
            scored = sorted(await asyncio.gather(
                *(score(load, u) for load, u in loads)))
            return scored[0][2]
        loads.sort()
        return loads[0][1]

    @staticmethod
    async def prefix_match(session: ClientSession, url: str,
                           token_ids) -> int:
        try:
            r = await session.post(
                f"{url}/prefix_match",
                json={"prompt_token_ids": list(token_ids)})
            return (await r.json()).get("matched_tokens", 0)
        except Exception:  # noqa: BLE001
            return 0


class OpenAIDisaggServer(HTTPApp):
    def __init__(self, ctx_urls: List[str], gen_urls: List[str],
                 router_policy: str = "round_robin",
                 model_name: str = "tpu-llm",
                 health_interval: float = 5.0,
                 conditional_max_prompt: int = 0,
                 conditional_cached_fraction: float = 0.0,
                 stream_kv: bool = False):
        """conditional_max_prompt: prompts of at most this many tokens
        skip the context hop (0: off); conditional_cached_fraction: so do
        prompts of which a generation worker caches at least this fraction
        (0: off); stream_kv: the streamed mode (module docstring)."""
        super().__init__()
        self.ctx_pool = ServerPool(ctx_urls)
        self.gen_pool = ServerPool(gen_urls)
        self.ctx_router = Router(self.ctx_pool, router_policy)
        self.gen_router = Router(self.gen_pool, router_policy)
        self.model_name = model_name
        self.health_interval = health_interval
        self.conditional_max_prompt = conditional_max_prompt
        self.conditional_cached_fraction = conditional_cached_fraction
        self.stream_kv = stream_kv
        self._health_task = None
        self._session: Optional[ClientSession] = None
        self.routes = {
            ("GET", "/health"): self.health,
            ("GET", "/cluster"): self.cluster,
            ("POST", "/register"): self.register,
            ("POST", "/unregister"): self.unregister,
            ("POST", "/v1/completions"): self.completions,
        }
        self.on_startup.append(self._start_health_loop)
        self.on_cleanup.append(self._stop)

    def body_limit(self, path: str) -> int:
        return PAYLOAD_MAX_BODY

    @property
    def session(self) -> ClientSession:
        """One pooled session to the workers, made on the serving loop."""
        if self._session is None or self._session.closed:
            self._session = ClientSession(timeout=RECEIVE_DEADLINE_S)
        return self._session

    # ------------------------------------------------------------ cluster --
    async def _start_health_loop(self):
        if self.health_interval > 0:
            self._health_task = asyncio.ensure_future(self._health_loop())

    async def _stop(self):
        if self._health_task is not None:
            self._health_task.cancel()
        if self._session is not None:
            await self._session.close()

    async def _health_loop(self):
        async with ClientSession() as session:
            while True:
                await asyncio.sleep(self.health_interval)
                await self.ctx_pool.check_health(session)
                await self.gen_pool.check_health(session)

    def _pool(self, role) -> ServerPool:
        if role not in ("context", "generation", "ctx", "gen"):
            raise RequestError(f"bad role {role!r}")
        return self.ctx_pool if role.startswith("c") else self.gen_pool

    @staticmethod
    def _member(req) -> tuple:
        body = req.json()
        if not isinstance(body, dict) or not isinstance(body.get("url"), str):
            raise RequestError('body must be {"url": ..., "role": ...}')
        return body["url"], body.get("role", "")

    async def register(self, req, conn):
        """A worker joins: {"url": ..., "role": "context" | "generation"}."""
        url, role = self._member(req)
        self._pool(role).add(url)
        return _json({"status": "ok"})

    async def unregister(self, req, conn):
        url, role = self._member(req)
        self._pool(role).remove(url)
        return _json({"status": "ok"})

    async def cluster(self, req, conn):
        return _json({"context": self.ctx_pool.snapshot(),
                      "generation": self.gen_pool.snapshot()})

    async def health(self, req, conn):
        return _json({"status": "ok"})

    # ------------------------------------------------------------ serving --
    async def _should_skip_prefill_hop(self, body) -> bool:
        ids = body.get("prompt_token_ids")
        if ids is None:
            return False
        if self.conditional_max_prompt and \
                len(ids) <= self.conditional_max_prompt:
            return True
        if self.conditional_cached_fraction > 0:
            for u in self.gen_pool.healthy_urls():
                m = await Router.prefix_match(self.session, u, ids)
                if m >= self.conditional_cached_fraction * len(ids):
                    return True
        return False

    async def _relay(self, url: str, body: dict):
        """POST `body` to a worker; its status and body, passed through."""
        data = await asyncio.to_thread(json.dumps, body)
        r = await self.session.post(url, data=data.encode())
        return r.status, await r.read(), _JSON

    async def completions(self, req, conn):
        body = req.json()
        if not isinstance(body, dict):
            raise RequestError("body must be a JSON object")
        ids = body.get("prompt_token_ids")
        if await self._should_skip_prefill_hop(body):
            gen_url = await self.gen_router.pick(self.session, ids)
            fwd = dict(body)
            fwd.pop("prompt_token_ids", None)
            if ids is not None and "prompt" not in fwd:
                # /v1/completions takes token ids as its prompt
                fwd["prompt"] = list(ids)
            return await self._relay(f"{gen_url}/v1/completions", fwd)
        if self.stream_kv:
            ctx_url = await self.ctx_router.pick(self.session, ids)
            gen_url = await self.gen_router.pick(self.session)
            return await self._relay(f"{gen_url}/disagg/generate_streamed",
                                     dict(body, ctx_url=ctx_url))
        ctx_url = await self.ctx_router.pick(self.session, ids)
        status, raw, ctype = await self._relay(f"{ctx_url}/disagg/context",
                                               body)
        if status != 200:
            return status, raw, ctype
        ctx = await asyncio.to_thread(json.loads, raw)
        gen_url = await self.gen_router.pick(self.session)
        return await self._relay(f"{gen_url}/disagg/generate", dict(
            body, first_gen_tokens=ctx["first_gen_tokens"],
            kv_payload_b64=ctx["kv_payload_b64"]))


# ---- the worker's routes (`OpenAIServer.disagg_*`) ---------------------------
def _sampling_from_body(body: dict, max_tokens_default=None
                        ) -> SamplingParams:
    """The request's sampling parameters (the whole surface a plain server
    takes, not only temperature)."""
    kw = {}
    for key in ("temperature", "top_p", "top_k", "min_p", "seed", "stop",
                "stop_token_ids", "presence_penalty", "frequency_penalty",
                "repetition_penalty", "logprobs", "min_tokens",
                "no_repeat_ngram_size", "logit_bias", "ignore_eos"):
        if body.get(key) is not None:
            kw[key] = body[key]
    if max_tokens_default is not None:
        kw["max_tokens"] = int(body.get("max_tokens", max_tokens_default))
    kw["ignore_eos"] = bool(body.get("ignore_eos", False))
    if isinstance(kw.get("logit_bias"), dict):
        kw["logit_bias"] = {int(k): float(v)
                            for k, v in kw["logit_bias"].items()}
    try:
        return SamplingParams(**kw)
    except (TypeError, ValueError) as e:
        raise RequestError(str(e)) from None


def _prompt_ids(server, body) -> List[int]:
    if not isinstance(body, dict):
        raise RequestError("body must be a JSON object")
    ids = body.get("prompt_token_ids")
    if ids is None:
        p = body.get("prompt")
        if isinstance(p, list):
            ids = p
        elif isinstance(p, str) and server.llm.tokenizer is not None:
            ids = server.llm.tokenizer.encode(p)
        else:
            raise RequestError("prompt_token_ids (or a prompt the "
                               "tokenizer encodes) is required")
    if not ids or not all(isinstance(t, int) and not isinstance(t, bool)
                          for t in ids):
        raise RequestError("prompt_token_ids must be a non-empty list of "
                           "ints")
    return list(ids)


def _submit(server, ids, sp, dp):
    try:
        return server.llm.generate_async(ids, sp, disaggregated_params=dp)
    except ValueError as e:
        raise RequestError(str(e)) from None


def _completion(server, out) -> tuple:
    text = ""
    tok = server.llm.tokenizer
    if tok is not None:
        text = tok.decode(out.outputs[0].token_ids)
    return _json({
        "id": f"cmpl-{out.request_id}", "object": "text_completion",
        "model": server.model_name,
        "choices": [{"index": 0, "text": text,
                     "token_ids": out.outputs[0].token_ids,
                     "finish_reason": out.outputs[0].finish_reason}]})


async def disagg_context(server, req, conn):
    """The context phase: the first token and the prompt's KV payload."""
    body = req.json()
    fut = _submit(server, _prompt_ids(server, body),
                  _sampling_from_body(body),
                  DisaggregatedParams(request_type="context_only"))
    out = await result_of(fut)
    payload = fut.req.kv_payload
    if payload is None:
        return _error(f"context phase ended without its KV "
                      f"({out.outputs[0].finish_reason})", 500)
    blob = await asyncio.to_thread(payload_to_bytes, payload)
    return _json({"first_gen_tokens": out.outputs[0].token_ids,
                  "kv_payload_b64": base64.b64encode(blob).decode()})


async def disagg_generate(server, req, conn):
    """The generation phase from a whole payload."""
    body = req.json()
    ids = _prompt_ids(server, body)
    try:
        raw = base64.b64decode(body["kv_payload_b64"])
        first = [int(t) for t in body["first_gen_tokens"]]
    except (KeyError, TypeError, ValueError) as e:
        raise RequestError(f"kv_payload_b64 and first_gen_tokens: {e}") \
            from None
    payload = await asyncio.to_thread(payload_from_bytes, raw)
    dp = DisaggregatedParams(request_type="generation_only",
                             first_gen_tokens=first, kv_payload=payload)
    fut = _submit(server, ids, _sampling_from_body(body, 32), dp)
    return _completion(server, await result_of(fut))


def next_frame(req, frames: "queue.Queue", deadline_s: float =
               RECEIVE_DEADLINE_S, poll_s: float = 1.0) -> dict:
    """The next frame of a streamed context request, waiting for it; an
    error end frame when the request failed or no frame came within
    `deadline_s`.  Before declaring a failure it looks at the queue once
    more, so a frame put just after a timed-out wait is not lost."""
    waited = 0.0
    while True:
        try:
            return frames.get(timeout=poll_s)
        except queue.Empty:
            waited += poll_s
        err = req.error or ("prefill timed out" if waited >= deadline_s
                            else None)
        if err is None and req.is_finished and req.kv_payload is None:
            err = "prefill failed"
        if err is not None:
            try:
                return frames.get_nowait()
            except queue.Empty:
                return {"end": True, "error": str(err)}


async def disagg_context_stream(server, req, conn):
    """The context phase as a chunked stream of 8-byte length-prefixed KV
    frames, each sent as its prefill chunk finishes.  A client that goes
    away cancels the request."""
    body = req.json()
    sp = _sampling_from_body(body)
    try:
        fut, frames = server.llm.generate_context_only_streamed(
            _prompt_ids(server, body), sp)
    except ValueError as e:
        raise RequestError(str(e)) from None
    await conn.start_stream("application/octet-stream")
    try:
        while True:
            frame = await asyncio.to_thread(next_frame, fut.req, frames)
            data = await asyncio.to_thread(frame_to_bytes, frame)
            await conn.send(len(data).to_bytes(8, "little") + data)
            if frame.get("end") or frame.get("error"):
                break
    except ConnectionError:
        fut.cancel()
        raise
    await conn.end_stream()


async def disagg_generate_streamed(server, req, conn):
    """The generation phase pulling KV frames straight from the context
    worker named by ``ctx_url`` and injecting each as it arrives; decode
    starts at the end frame."""
    body = req.json()
    ids = _prompt_ids(server, body)
    ctx_url = body.get("ctx_url")
    if not isinstance(ctx_url, str):
        raise RequestError("ctx_url is required")
    rx: "queue.Queue" = queue.Queue()
    fut = _submit(server, ids, _sampling_from_body(body, 32),
                  DisaggregatedParams(request_type="generation_only",
                                      kv_frames=rx))
    ctx_body = {k: v for k, v in body.items() if k != "ctx_url"}
    ctx_body["prompt_token_ids"] = ids
    try:
        async with ClientSession(timeout=RECEIVE_DEADLINE_S) as session:
            r = await session.post(f"{ctx_url.rstrip('/')}"
                                   "/disagg/context_stream", json=ctx_body)
            if r.status != 200:
                raise RuntimeError(f"ctx stream HTTP {r.status}: "
                                   f"{await r.text()}")
            while True:
                n = int.from_bytes(await r.readexactly(8), "little")
                frame = await asyncio.to_thread(frame_from_bytes,
                                                await r.readexactly(n))
                if frame.get("error"):
                    raise RuntimeError(f"ctx stream: {frame['error']}")
                rx.put(frame)
                if frame.get("end"):
                    break
            r.close()
    except Exception as e:  # noqa: BLE001 -- the receive ends first
        rx.put({"error": str(e)})
        return _error(str(e), 502)
    return _completion(server, await result_of(fut))
