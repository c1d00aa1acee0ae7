"""OpenAI-compatible HTTP server on the standard library.

Counterpart of `tensorrt_llm_tpu/serve/openai_server.py`, which is built on
aiohttp (the card's machine has none): an `asyncio.start_server` loop with
a small HTTP/1.1 reader (keep-alive, ``Content-Length`` request bodies,
``Expect: 100-continue``; a chunked request body gets 400) and JSON or
server-sent-event responses
(SSE in chunked transfer encoding).  The routes, status codes, JSON bodies
and SSE framing (``data: {...}\\n\\n``, then ``data: [DONE]\\n\\n``; the
Responses API's ``event: ...`` lines) are the JAX server's:

* ``GET /health``, ``/v1/models``, ``/version``, ``/steady_clock_offset``,
  ``/metrics`` (Prometheus text), ``/perf_metrics``, ``/kv_cache_events``
  (``since_id``, ``full``, the process ``epoch``), ``/traces``,
  ``/health_generate``;
* ``POST /v1/completions``, ``/v1/chat/completions``, ``/v1/responses``,
  ``/v1/embeddings`` (400: the port serves decoders only),
  ``/prefix_match``, ``/update_weights``, ``/release_memory`` (409 with a
  request in flight), ``/resume_memory``;
* the disaggregated worker routes ``POST /disagg/context``,
  ``/disagg/generate``, ``/disagg/context_stream`` (a chunked
  ``application/octet-stream`` of 8-byte length-prefixed KV frames) and
  ``/disagg/generate_streamed`` (`serve/disagg_server.py`).  With
  `register_to`, the worker POSTs ``/register`` (its `advertise_url` and
  `disagg_role`) to a disaggregated front end once it listens, and
  ``/unregister`` when it stops.

Generation runs on the executor's thread.  The loop never blocks a thread
on a request: each request's `LlmRequest.listener` wakes the loop
(`loop.call_soon_threadsafe`) when a piece is queued, and the piece goes
through the future's `fold` / `stream_fold`, so any number of streams are
open at once.  A streaming client that closes its connection (EOF on the
reader, or a failed write) cancels its request, whose KV blocks are then
freed.  The KV routes (``/kv_cache_events``, ``/prefix_match``,
``/metrics``) read the KV bookkeeping on the executor thread between two
steps (`LLM.read_kv`), from a pool thread.  Kept from the JAX server: the stop-string holdback of a stream
(`_stop_holdback`), the fallback chat template when the tokenizer has
none, the refusals of ``stream`` with ``n`` > 1 or with several prompts.

Intended differences: a body whose sampling parameters `SamplingParams`
refuses (``max_tokens`` 0, ``top_p`` 0, ...) or a malformed query or
message gets 400 where the JAX server fails with 500; a generation error
is a JSON 500 (mid-stream: an ``error`` event, then the stream ends).
Multimodal input (image parts, ``multi_modal_embeddings``,
``/v1/mm_embeddings``) belongs to a later slice: the route is not
registered and image parts get 400.

`HTTPApp` is the server itself (routes, connections, start and stop, the
startup and cleanup hooks); `OpenAIServer` and the disaggregated front end
(`serve/disagg_server.py`) are its routes.
"""

from __future__ import annotations

import asyncio
import json
import queue
import threading
import time
import uuid
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from tensorrt_llm_tpu_torch.llmapi.llm import LLM, _FanoutFuture
from tensorrt_llm_tpu_torch.llmapi.sampling_params import SamplingParams
from tensorrt_llm_tpu_torch.serve.openai_protocol import (
    ChatCompletionRequest, CompletionRequest, RequestError, ResponsesRequest,
    chat_choice, chat_chunk, chat_response, completion_response,
    parse_request, random_id, responses_response)
from tensorrt_llm_tpu_torch.serve.reasoning_parser import get_reasoning_parser
from tensorrt_llm_tpu_torch.serve.tool_parser import ToolCall, get_tool_parser
from tensorrt_llm_tpu_torch.utils import logger

MAX_BODY = 64 << 20          # bytes of one request body
PAYLOAD_MAX_BODY = 1 << 30   # a body that carries a KV payload (JAX's)
_REASONS = {200: "OK", 400: "Bad Request",
            404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
            413: "Payload Too Large", 500: "Internal Server Error",
            502: "Bad Gateway", 503: "Service Unavailable"}


class HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


# ---- HTTP/1.1 ----------------------------------------------------------------
class Request:
    def __init__(self, method: str, target: str, body: bytes):
        self.method = method
        u = urlsplit(target)
        self.path = u.path
        self.query = {k: v[0] for k, v in parse_qs(u.query).items()}
        self.body = body

    def json(self):
        try:
            return json.loads(self.body or b"")
        except ValueError as e:
            raise RequestError(f"invalid JSON body: {e}") from None


class Connection:
    """One client connection: reads requests, writes responses; while a
    stream is open it watches the reader for the client's EOF."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.buf = b""            # bytes read ahead by the EOF watcher
        self.closed = False       # the client went away
        self.streaming = False    # SSE headers of this request are out
        self.on_close = None
        self._watch: Optional[asyncio.Task] = None

    async def _readline(self) -> bytes:
        if self.buf:
            i = self.buf.find(b"\n")
            if i >= 0:
                line, self.buf = self.buf[:i + 1], self.buf[i + 1:]
                return line
            line, self.buf = self.buf, b""
            return line + await self.reader.readline()
        return await self.reader.readline()

    async def _read(self, n: int) -> bytes:
        head, self.buf = self.buf[:n], self.buf[n:]
        if len(head) < n:
            head += await self.reader.readexactly(n - len(head))
        return head

    async def read_request(self, body_limit=lambda path: MAX_BODY
                           ) -> Optional[Request]:
        """The next request, or None at the end of the connection;
        `body_limit(path)` bounds its body's bytes."""
        line = await self._readline()
        while line in (b"\r\n", b"\n"):
            line = await self._readline()
        if not line:
            return None
        parts = line.decode("latin-1").split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise HTTPError(400, "malformed request line")
        method, target, version = parts
        headers = {}
        while True:
            h = await self._readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, sep, value = h.decode("latin-1").partition(":")
            if not sep:
                raise HTTPError(400, "malformed header line")
            headers[name.strip().lower()] = value.strip()
        conn_hdr = headers.get("connection", "").lower()
        self.keep_alive = ("close" not in conn_hdr if version == "HTTP/1.1"
                           else "keep-alive" in conn_hdr)
        if headers.get("expect", "").lower() == "100-continue":
            self.writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        if "transfer-encoding" in headers:
            raise HTTPError(400, "send the request body with Content-Length")
        try:
            n = int(headers.get("content-length", "0"))
        except ValueError:
            raise HTTPError(400, "malformed Content-Length") from None
        if n > body_limit(urlsplit(target).path):
            raise HTTPError(413, "request body too large")
        body = await self._read(n) if n else b""
        return Request(method, target, body)

    def _head(self, status: int, ctype: str, extra: str = "") -> bytes:
        return (f"HTTP/1.1 {status} {_REASONS.get(status, 'Status')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Connection: {'keep-alive' if self.keep_alive else 'close'}"
                f"\r\n{extra}\r\n").encode("latin-1")

    async def respond(self, status: int, body: bytes, ctype: str):
        self.writer.write(self._head(status, ctype,
                                     f"Content-Length: {len(body)}\r\n")
                          + body)
        await self.writer.drain()

    async def start_stream(self, ctype: str = "text/event-stream"):
        """Headers of a chunked (by default SSE) response; the client's EOF
        is watched from now on."""
        self.writer.write(self._head(
            200, ctype,
            "Transfer-Encoding: chunked\r\nCache-Control: no-cache\r\n"))
        await self.writer.drain()
        self.streaming = True
        self._watch = asyncio.ensure_future(self._watch_eof())

    async def _watch_eof(self):
        data = await self.reader.read(65536)
        if data:                   # the client's next request, read ahead
            self.buf += data
            return
        self.closed = True
        if self.on_close is not None:
            self.on_close()

    async def send(self, data: bytes):
        if self.closed or self.writer.is_closing():
            raise ConnectionResetError("client disconnected")
        self.writer.write(b"%x\r\n%s\r\n" % (len(data), data))
        await self.writer.drain()

    async def end_stream(self):
        self.writer.write(b"0\r\n\r\n")
        await self.writer.drain()
        await self.stop_watching()

    async def stop_watching(self):
        """End the EOF watch; the reader is free once its read has
        unwound."""
        w, self._watch = self._watch, None
        if w is not None:
            w.cancel()
            try:
                await w
            except asyncio.CancelledError:
                pass


def _json(obj, status: int = 200):
    return status, json.dumps(obj).encode(), "application/json; charset=utf-8"


def _error(message: str, status: int = 400):
    return _json({"error": message}, status)


class _Pieces:
    """A request's output pieces, read on the event loop: the request's
    listener wakes the loop when the executor queues one, so no thread
    waits on it.  With a connection, its EOF ends the wait with
    ConnectionResetError."""

    def __init__(self, req, conn: Optional[Connection] = None):
        loop = asyncio.get_running_loop()
        self.req, self.conn = req, conn
        self.ev = asyncio.Event()

        def wake():
            try:
                loop.call_soon_threadsafe(self.ev.set)
            except RuntimeError:   # the loop has closed
                pass
        req.listener = wake
        if conn is not None:
            conn.on_close = self.ev.set

    async def get(self):
        while True:
            if self.conn is not None and self.conn.closed:
                raise ConnectionResetError("client disconnected")
            try:
                return self.req.out_queue.get_nowait()
            except queue.Empty:
                await self.ev.wait()
                self.ev.clear()

    def close(self):
        self.req.listener = None
        if self.conn is not None:
            self.conn.on_close = None


async def result_of(fut):
    """The whole `RequestOutput` of a future (`GenerationFuture` or
    `_FanoutFuture`), awaited on the loop."""
    if isinstance(fut, _FanoutFuture):
        return _FanoutFuture.combine(
            list(await asyncio.gather(*[result_of(s) for s in fut.subs])))
    fold = fut.fold()
    next(fold)
    pieces = _Pieces(fut.req)
    try:
        while True:
            out = fold.send(await pieces.get())
            if out is not None:
                return out
    finally:
        pieces.close()


class HTTPApp:
    """An HTTP/1.1 server of `routes` ({(method, path): handler(req,
    conn)}) on asyncio streams.  `on_startup` coroutines run once it
    listens, `on_cleanup` ones when it stops (`cleanup`)."""

    def __init__(self):
        self.routes = {}
        self.on_startup: list = []
        self.on_cleanup: list = []
        self.port: Optional[int] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: set = set()     # open client connections
        self._cleaned = False

    async def _handle(self, reader, writer):
        conn = Connection(reader, writer)
        self._writers.add(writer)
        try:
            while True:
                conn.keep_alive = False
                try:
                    req = await conn.read_request(self.body_limit)
                except HTTPError as e:
                    await conn.respond(*_error(str(e), e.status))
                    break
                if req is None:
                    break
                await self._dispatch(req, conn)
                if not conn.keep_alive or conn.closed:
                    break
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError, ValueError):
            pass
        finally:
            await conn.stop_watching()
            self._writers.discard(writer)
            writer.close()

    def body_limit(self, path: str) -> int:
        """The most bytes a request body to `path` may have."""
        return MAX_BODY

    async def _dispatch(self, req: Request, conn: Connection):
        conn.streaming = False
        handler = self.routes.get((req.method, req.path))
        if handler is None:
            if any(p == req.path for _, p in self.routes):
                resp = _error("method not allowed", 405)
            else:
                resp = _error(f"no route {req.path}", 404)
        else:
            try:
                resp = await handler(req, conn)
            except RequestError as e:
                resp = _error(str(e), 400)
            except HTTPError as e:
                resp = _error(str(e), e.status)
            except (ConnectionError, asyncio.CancelledError):
                raise
            except Exception as e:  # noqa: BLE001 -- one request's failure
                logger.exception("request to %s failed", req.path)
                if conn.streaming or conn.writer.is_closing():
                    raise ConnectionResetError from e
                resp = _error(str(e), 500)
        if resp is not None:
            await conn.respond(*resp)

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Listen on (host, port) in the running loop, then run the
        startup hooks; returns the port."""
        self._server = await asyncio.start_server(
            self._handle, host, port, limit=1 << 20)
        self.port = self._server.sockets[0].getsockname()[1]
        for hook in self.on_startup:
            await hook()
        return self.port

    async def cleanup(self):
        """Run the cleanup hooks once."""
        if self._cleaned:
            return
        self._cleaned = True
        for hook in self.on_cleanup:
            try:
                await hook()
            except Exception:  # noqa: BLE001 -- the rest still run
                logger.exception("cleanup hook failed")

    async def serve(self, host: str, port: int):
        await self.start(host, port)
        logger.info("serving on %s:%d", host, self.port)
        try:
            async with self._server:
                await self._server.serve_forever()
        finally:
            await self.cleanup()

    def run(self, host: str = "0.0.0.0", port: int = 8000):
        """Serve until interrupted (SIGINT ends it cleanly, cleanup hooks
        included)."""
        try:
            asyncio.run(self.serve(host, port))
        except KeyboardInterrupt:
            pass

    def start_in_thread(self, host: str = "127.0.0.1",
                        port: int = 0) -> "ServerThread":
        """Serve from a thread of this process (tests, in-process
        benchmarks); `ServerThread.port` is the bound port."""
        return ServerThread(self, host, port)


class OpenAIServer(HTTPApp):
    def __init__(self, llm: LLM, model_name: str = "tpu-llm",
                 tool_parser: Optional[str] = None,
                 reasoning_parser: Optional[str] = None,
                 register_to: Optional[str] = None,
                 advertise_url: Optional[str] = None,
                 disagg_role: str = "generation"):
        """tool_parser: model family of the function-call markup ("qwen3",
        "deepseek_v3", "harmony", ... `tool_parser._PARSERS`);
        reasoning_parser: "deepseek-r1" | "qwen3" | "nano-v3" splits
        <think> blocks into reasoning_content.  register_to /
        advertise_url / disagg_role: join a disaggregated front end once
        listening (advertise_url defaults to http://127.0.0.1:<port>) and
        leave it at cleanup."""
        super().__init__()
        if disagg_role not in ("context", "generation"):
            raise ValueError(f"disagg_role {disagg_role!r}: 'context' or "
                             "'generation'")
        self.llm = llm
        self.register_to = register_to.rstrip("/") if register_to else None
        self.advertise_url = advertise_url
        self.disagg_role = disagg_role
        if self.register_to:
            self.on_startup.append(self._register_worker)
            self.on_cleanup.append(self._unregister_worker)
        # per-process event-stream epoch: a restart resets KV event ids,
        # so routers must be able to detect it and drop their stale view
        self._epoch = uuid.uuid4().hex
        self.model_name = model_name
        self.tool_parser_name = tool_parser
        self.reasoning_parser_name = reasoning_parser
        get_tool_parser(tool_parser)               # unknown names raise
        get_reasoning_parser(reasoning_parser)
        self.started_at = time.time()
        self.routes = {
            ("GET", "/health"): self.health,
            ("GET", "/v1/models"): self.models,
            ("POST", "/v1/completions"): self.completions,
            ("POST", "/v1/chat/completions"): self.chat_completions,
            ("POST", "/v1/responses"): self.responses,
            ("GET", "/metrics"): self.metrics,
            ("GET", "/perf_metrics"): self.perf_metrics,
            ("GET", "/kv_cache_events"): self.kv_cache_events,
            ("POST", "/prefix_match"): self.prefix_match,
            ("POST", "/v1/embeddings"): self.embeddings,
            ("GET", "/traces"): self.traces,
            ("POST", "/update_weights"): self.update_weights,
            ("POST", "/release_memory"): self.release_memory,
            ("POST", "/resume_memory"): self.resume_memory,
            ("GET", "/health_generate"): self.health_generate,
            ("GET", "/version"): self.version,
            ("GET", "/steady_clock_offset"): self.steady_clock_offset,
            ("POST", "/disagg/context"): self.disagg_context,
            ("POST", "/disagg/generate"): self.disagg_generate,
            ("POST", "/disagg/context_stream"): self.disagg_context_stream,
            ("POST", "/disagg/generate_streamed"):
                self.disagg_generate_streamed,
        }

    # ------------------------------------------------------------- disagg --
    def body_limit(self, path: str) -> int:
        return PAYLOAD_MAX_BODY if path == "/disagg/generate" else MAX_BODY

    async def _announce(self, path: str):
        from tensorrt_llm_tpu_torch.serve.http_client import ClientSession
        url = self.advertise_url or f"http://127.0.0.1:{self.port}"
        async with ClientSession(timeout=10.0) as s:
            r = await s.post(f"{self.register_to}{path}",
                             json={"url": url, "role": self.disagg_role})
            await r.read()
            if r.status != 200:
                raise RuntimeError(f"{path} answered HTTP {r.status}")

    async def _register_worker(self):
        try:
            await self._announce("/register")
        except Exception as e:  # noqa: BLE001 -- the front end may come later
            logger.warning("worker registration with %s failed: %s",
                           self.register_to, e)

    async def _unregister_worker(self):
        try:
            await self._announce("/unregister")
        except Exception:  # noqa: BLE001
            pass

    async def disagg_context(self, req, conn):
        """The context phase (`serve/disagg_server.py`)."""
        from tensorrt_llm_tpu_torch.serve import disagg_server
        return await disagg_server.disagg_context(self, req, conn)

    async def disagg_generate(self, req, conn):
        """The generation phase from a whole payload."""
        from tensorrt_llm_tpu_torch.serve import disagg_server
        return await disagg_server.disagg_generate(self, req, conn)

    async def disagg_context_stream(self, req, conn):
        """The context phase as a stream of KV frames."""
        from tensorrt_llm_tpu_torch.serve import disagg_server
        return await disagg_server.disagg_context_stream(self, req, conn)

    async def disagg_generate_streamed(self, req, conn):
        """The generation phase pulling KV frames from a context worker."""
        from tensorrt_llm_tpu_torch.serve import disagg_server
        return await disagg_server.disagg_generate_streamed(self, req, conn)

    # --------------------------------------------------------------- misc --
    async def health(self, req, conn):
        return _json({"status": "ok"})

    async def models(self, req, conn):
        return _json({
            "object": "list",
            "data": [{"id": self.model_name, "object": "model",
                      "created": int(self.started_at),
                      "owned_by": "tensorrt_llm_tpu_torch"}],
        })

    async def metrics(self, req, conn):
        """Prometheus-style metrics (the JAX server's names)."""
        ex = self.llm.executor
        stats = ex.stats_history[-1] if ex.stats_history else None
        kv = await asyncio.to_thread(self.llm.get_kv_cache_stats)
        lines = [
            f"tllm_tpu_total_tokens_generated {ex.total_tokens_generated}",
            f"tllm_tpu_iterations {ex.iteration}",
            f"tllm_tpu_kv_free_blocks {kv['free_blocks']}",
            f"tllm_tpu_kv_total_blocks {kv['num_blocks']}",
            f"tllm_tpu_kv_reused_blocks {kv['reused_blocks']}",
            f"tllm_tpu_kv_partial_reused_blocks "
            f"{kv.get('partial_reused_blocks', 0)}",
            f"tllm_tpu_kv_offloaded_blocks {kv.get('offloaded_blocks', 0)}",
            f"tllm_tpu_kv_onboarded_blocks {kv.get('onboarded_blocks', 0)}",
            f"tllm_tpu_active_sequences {kv['active_sequences']}",
        ]
        if stats:
            lines.append(f"tllm_tpu_last_step_ms {stats.step_time_ms:.3f}")
        return 200, ("\n".join(lines) + "\n").encode(), \
            "text/plain; charset=utf-8"

    async def perf_metrics(self, req, conn):
        return _json(self.llm.get_stats())

    async def kv_cache_events(self, req, conn):
        """KV stats and the stored/removed block events from ``since_id``;
        ``full=1`` adds every matchable block hash (a router's resync).
        All of it is read in one snapshot between two executor steps, so
        the cursor, the events and the hashes agree."""
        try:
            since = int(req.query.get("since_id", 0))
        except ValueError:
            raise RequestError("since_id must be an integer") from None
        full = bool(req.query.get("full"))

        def snapshot(kv):
            out = dict(kv.stats())
            out["epoch"] = self._epoch
            out["next_since_id"], out["oldest_retained_id"] = \
                kv.event_cursor()
            out["events"] = kv.get_events(since)
            out["block_size"] = kv.block_size
            if full:
                out["block_hashes"] = kv.reuse_block_hashes()
            return out
        return _json(await asyncio.to_thread(self.llm.read_kv, snapshot))

    async def embeddings(self, req, conn):
        return _error("model is not an encoder")

    async def prefix_match(self, req, conn):
        """Cached-prefix probe of a KV-aware router: body
        {"prompt_token_ids": [...]} -> {"matched_tokens": N}."""
        body = req.json()
        ids = (body.get("prompt_token_ids") if isinstance(body, dict)
               else None) or []
        if not isinstance(ids, list) or not all(
                isinstance(t, int) and not isinstance(t, bool) for t in ids):
            raise RequestError("prompt_token_ids must be a list of ints")
        n = await asyncio.to_thread(self.llm.match_kv_prefix, ids)
        return _json({"matched_tokens": n})

    async def traces(self, req, conn):
        """Per-request trace records (queue time, TTFT, e2e)."""
        return _json(list(self.llm.executor.tracer.records))

    async def update_weights(self, req, conn):
        """Weight swap: body {"checkpoint_dir": "/path/to/hf/checkpoint"}."""
        try:
            body = req.json()
            await asyncio.to_thread(self.llm.update_weights,
                                    body["checkpoint_dir"])
        except Exception as e:  # noqa: BLE001
            return _error(str(e))
        return _json({"status": "ok"})

    async def release_memory(self, req, conn):
        """Move the weights off the device between RL rollouts (409 with
        a request in flight)."""
        try:
            await asyncio.to_thread(self.llm.release_memory)
        except Exception as e:  # noqa: BLE001
            return _error(str(e), 409)
        return _json({"status": "ok"})

    async def resume_memory(self, req, conn):
        try:
            await asyncio.to_thread(self.llm.resume_memory)
        except Exception as e:  # noqa: BLE001
            return _error(str(e))
        return _json({"status": "ok"})

    async def health_generate(self, req, conn):
        """Liveness probe that generates one token."""
        try:
            fut = self.llm.generate_async(
                [1], SamplingParams(max_tokens=1, ignore_eos=True))
            await asyncio.wait_for(result_of(fut), 30.0)
        except Exception as e:  # noqa: BLE001
            return _error(str(e), 500)
        return _json({"status": "ok"})

    async def version(self, req, conn):
        from tensorrt_llm_tpu_torch import __version__
        return _json({"version": __version__})

    async def steady_clock_offset(self, req, conn):
        """This server's monotonic and wall clocks, so that a router can
        correlate timestamps across servers."""
        return _json({"monotonic": time.monotonic(), "wall": time.time()})

    # -------------------------------------------------------- completions --
    def _submit(self, prompt, sp, streaming=False):
        """`generate_async`, its refusals (ValueError) as 400."""
        try:
            return self.llm.generate_async(prompt, sp, streaming=streaming)
        except ValueError as e:
            raise RequestError(str(e)) from None

    @staticmethod
    def _sampling(body) -> SamplingParams:
        try:
            return body.to_sampling_params()
        except ValueError as e:
            raise RequestError(str(e)) from None

    async def completions(self, req, conn):
        body = parse_request(CompletionRequest, req.json())
        prompts = body.prompt if isinstance(body.prompt, list) and \
            body.prompt and isinstance(body.prompt[0], (str, list)) \
            else [body.prompt]
        if body.stream and body.n > 1:
            return _error("streaming with n > 1 is not supported")
        if body.stream and len(prompts) > 1:
            # only one SSE stream can be returned
            return _error("streaming supports a single prompt per request")
        sp = self._sampling(body)
        futures = []
        try:
            for p in prompts:
                futures.append(self._submit(p, sp))
        except RequestError:
            for f in futures:
                f.cancel()
            raise

        if body.stream:
            return await self._stream_completion(conn, body, futures[0])

        outs = await asyncio.gather(*[result_of(f) for f in futures])
        # n > 1 fans out to several outputs per prompt; choices flatten
        # prompt-major (OpenAI semantics)
        if body.echo:
            # OpenAI echo: the prompt text leads each choice
            def full(out, o):
                p = out.prompt
                if p is None and self.llm.tokenizer is not None:
                    p = self.llm.tokenizer.decode(out.prompt_token_ids)
                return (p or "") + (o.text or "")
            texts = [full(out, o) for out in outs for o in out.outputs]
        else:
            texts = [o.text for out in outs for o in out.outputs]
        reasons = [o.finish_reason for out in outs for o in out.outputs]
        lp_objs = None
        if body.logprobs is not None:
            lp_objs = [self._completion_logprobs(out, o, body.echo)
                       for out in outs for o in out.outputs]
        p_toks = sum(len(o.prompt_token_ids) for o in outs)
        c_toks = sum(len(o.token_ids) for out in outs for o in out.outputs)
        return _json(completion_response(
            body, texts, reasons,
            {"prompt_tokens": p_toks, "completion_tokens": c_toks,
             "total_tokens": p_toks + c_toks}, logprobs=lp_objs))

    def _tok_str(self, tid: int) -> str:
        tk = self.llm.tokenizer
        return tk.decode([tid]) if tk is not None else str(tid)

    def _completion_logprobs(self, out, o, echo: bool):
        """OpenAI text-completion logprobs object; with echo the prompt
        tokens lead (the first has no logprob)."""
        tokens, tlps, tops = [], [], []

        def push(tid, d):
            tokens.append(self._tok_str(tid))
            tlps.append(None if d is None else d.get(tid))
            tops.append(None if d is None else
                        {self._tok_str(t): lp for t, lp in d.items()})
        if echo:
            pl = (out.prompt_logprobs
                  or [None] * len(out.prompt_token_ids))
            for tid, d in zip(out.prompt_token_ids, pl):
                push(tid, d)
        gl = o.logprobs or [None] * len(o.token_ids)
        for tid, d in zip(o.token_ids, gl):
            push(tid, d)
        return {"tokens": tokens, "token_logprobs": tlps,
                "top_logprobs": tops, "text_offset": []}

    def _chat_logprobs(self, o):
        """OpenAI chat logprobs object: per-token content entries."""
        content = []
        gl = o.logprobs or [None] * len(o.token_ids)
        for tid, d in zip(o.token_ids, gl):
            d = d or {}
            content.append({
                "token": self._tok_str(tid),
                "logprob": d.get(tid),
                "top_logprobs": [
                    {"token": self._tok_str(t), "logprob": lp}
                    for t, lp in sorted(d.items(), key=lambda kv: -kv[1])],
            })
        return {"content": content}

    @staticmethod
    def _stop_holdback(body) -> int:
        """Streaming with stop strings: the last piece may take back a
        partial stop string already decoded (the cumulative text shrinks
        when the stop matches), and SSE cannot take characters back, so
        the stream holds back the longest stop's length - 1 characters
        until it ends."""
        stop = getattr(body, "stop", None)
        if not stop:
            return 0
        stops = [stop] if isinstance(stop, str) else list(stop)
        return max((len(s) for s in stops), default=1) - 1

    async def _pump(self, fut, conn, on_output):
        """Stream `fut` to `conn`: `on_output(out)` per cumulative output
        (`GenerationFuture.stream_fold`, one a piece).  A client that goes
        away cancels the request."""
        fold = fut.stream_fold()
        next(fold)
        pieces = _Pieces(fut.req, conn)
        try:
            while True:
                out = fold.send(await pieces.get())
                await on_output(out)
                if out.finished:
                    return
        except ConnectionError:
            fut.cancel()
            raise
        except RuntimeError as e:    # the request failed mid-stream
            await conn.send(
                f"data: {json.dumps({'error': str(e)})}\n\n".encode())
        finally:
            pieces.close()

    async def _stream_completion(self, conn, body, future):
        await conn.start_stream()
        rid = random_id("cmpl")
        hold = self._stop_holdback(body)
        prev = [0]

        async def on_output(out):
            text = out.outputs[0].text
            upto = (len(text) if out.finished
                    else max(prev[0], len(text) - hold))
            delta = text[prev[0]:upto]
            prev[0] = upto
            chunk = {
                "id": rid, "object": "text_completion",
                "created": int(time.time()), "model": body.model,
                "choices": [{"index": 0, "text": delta,
                             "finish_reason": out.outputs[0].finish_reason
                             if out.finished else None}],
            }
            await conn.send(f"data: {json.dumps(chunk)}\n\n".encode())
            if out.finished:
                await conn.send(b"data: [DONE]\n\n")

        await self._pump(future, conn, on_output)
        await conn.end_stream()

    # --------------------------------------------------------------- chat --
    @staticmethod
    def _template_messages(messages):
        """Messages as template dicts; image parts are refused (the
        multimodal slice is not in the port yet)."""
        msgs = []
        for m in messages:
            if isinstance(m.content, list) and any(
                    isinstance(p, dict) and p.get("type") == "image_url"
                    for p in m.content):
                raise RequestError("image input is not supported by this "
                                   "server")
            d = {"role": m.role, "content": m.content}
            if m.tool_calls:
                d["tool_calls"] = m.tool_calls
            msgs.append(d)
        return msgs

    def _apply_chat_template(self, messages, tools=None):
        tok = self.llm.tokenizer
        msgs = self._template_messages(messages)
        if tok is not None and getattr(tok, "chat_template", None):
            kwargs = dict(tokenize=False, add_generation_prompt=True)
            if tools:
                # HF chat templates accept tool definitions directly
                try:
                    return tok.apply_chat_template(msgs, tools=tools,
                                                   **kwargs)
                except TypeError:
                    pass
            return tok.apply_chat_template(msgs, **kwargs)
        # fallback template
        text = ""
        if tools:
            text += ("<|system|>\nYou may call these tools; reply with "
                     '<tool_call>\\n{"name": ..., "arguments": {...}}\\n'
                     "</tool_call> to invoke one:\n"
                     + json.dumps(tools) + "\n")
        for m in msgs:
            c = m["content"]
            if isinstance(c, list):
                c = "".join("<image>" if p.get("type") == "image"
                            else str(p.get("text", ""))
                            for p in c if isinstance(p, dict))
            text += f"<|{m['role']}|>\n{c}\n"
        return text + "<|assistant|>\n"

    def _make_tool_parser(self, body):
        """Parser of this request (None when tools are absent, parsing is
        off, or tool_choice forces a schema-guided call)."""
        if not body.tools or body.tool_choice == "none" \
                or body.forced_tool() is not None:
            return None
        return get_tool_parser(self.tool_parser_name)

    async def chat_completions(self, req, conn):
        body = parse_request(ChatCompletionRequest, req.json())
        if body.multi_modal_embeddings:
            return _error("multimodal embeddings are not supported by this "
                          "server")
        prompt = self._apply_chat_template(body.messages, body.tools)
        sp = self._sampling(body)
        future = self._submit(prompt, sp, streaming=body.stream)
        parser = self._make_tool_parser(body)

        if body.stream:
            return await self._stream_chat(conn, body, future, parser)

        out = await result_of(future)
        p = len(out.prompt_token_ids)
        c = sum(len(o.token_ids) for o in out.outputs)
        usage = {"prompt_tokens": p, "completion_tokens": c,
                 "total_tokens": p + c}

        def parse_one(o):
            text, calls, reasoning = o.text, [], None
            forced = body.forced_tool()
            if forced is not None:
                # schema-guided forced call: the completion is arguments
                calls = [ToolCall(name=forced["function"]["name"],
                                  arguments=text)]
                text = None
            elif parser is not None:
                ev = parser.parse_full(text)
                text, calls = ev.text, ev.calls
                reasoning = ev.reasoning or None
            if reasoning is None and self.reasoning_parser_name:
                d = get_reasoning_parser(
                    self.reasoning_parser_name).parse_full(text or "")
                text, reasoning = d.content, d.reasoning or None
            return (text, o.finish_reason,
                    [c.to_openai(i) for i, c in enumerate(calls)] or None,
                    reasoning)

        first = parse_one(out.outputs[0])
        want_lp = bool(body.logprobs)
        extra = [chat_choice(j, *parse_one(o),
                             logprobs=(self._chat_logprobs(o) if want_lp
                                       else None))
                 for j, o in enumerate(out.outputs[1:], start=1)]
        return _json(chat_response(
            body, first[0], first[1], usage, tool_calls=first[2],
            reasoning=first[3], extra_choices=extra,
            logprobs=(self._chat_logprobs(out.outputs[0]) if want_lp
                      else None)))

    async def _stream_chat(self, conn, body, future, parser):
        await conn.start_stream()
        rid = random_id("chatcmpl")

        async def emit(delta, fr=None):
            await conn.send(
                f"data: {json.dumps(chat_chunk(rid, body.model, delta, fr))}"
                "\n\n".encode())

        await emit({"role": "assistant"})
        rparser = get_reasoning_parser(self.reasoning_parser_name)

        async def emit_text(seg, fr=None):
            """Route a content delta through the reasoning parser."""
            if rparser is None:
                if seg or fr:
                    await emit({"content": seg} if seg else {}, fr)
                return
            d = rparser.feed(seg)
            if fr:
                tail = rparser.flush()
                d.content += tail.content
                d.reasoning += tail.reasoning
            if d.reasoning:
                await emit({"reasoning_content": d.reasoning})
            if d.content or fr:
                await emit({"content": d.content} if d.content else {}, fr)

        hold = self._stop_holdback(body)
        st = {"prev": 0, "calls": 0}

        async def on_output(out):
            text = out.outputs[0].text
            upto = (len(text) if out.finished
                    else max(st["prev"], len(text) - hold))
            delta = text[st["prev"]:upto]
            st["prev"] = upto
            fr = out.outputs[0].finish_reason if out.finished else None
            if parser is None:
                await emit_text(delta, fr)
            else:
                events = [parser.feed(delta)]
                if out.finished:
                    events.append(parser.flush())
                for ev in events:
                    if ev.text:
                        await emit_text(ev.text)
                    if ev.reasoning:
                        await emit({"reasoning_content": ev.reasoning})
                    for call in ev.calls:
                        await emit({"tool_calls": [
                            call.to_openai(st["calls"])]})
                        st["calls"] += 1
                if fr:
                    # flush the reasoning parser's held-back tail, then
                    # send the terminal chunk
                    await emit_text("", "tool_calls" if st["calls"] else fr)
            if out.finished:
                await conn.send(b"data: [DONE]\n\n")

        await self._pump(future, conn, on_output)
        await conn.end_stream()

    # ---------------------------------------------------------- responses --
    async def responses(self, req, conn):
        """OpenAI Responses API."""
        body = parse_request(ResponsesRequest, req.json())
        tools = body.chat_tools()
        prompt = self._apply_chat_template(body.to_messages(), tools)
        sp = self._sampling(body)
        future = self._submit(prompt, sp, streaming=body.stream)
        parser = get_tool_parser(self.tool_parser_name) if tools else None

        if not body.stream:
            out = await result_of(future)
            p, c = len(out.prompt_token_ids), len(out.outputs[0].token_ids)
            text = out.outputs[0].text
            calls, reasoning = [], None
            if parser is not None:
                ev = parser.parse_full(text)
                text, calls, reasoning = ev.text, ev.calls, \
                    (ev.reasoning or None)
            return _json(responses_response(
                body.model, text,
                {"prompt_tokens": p, "completion_tokens": c,
                 "total_tokens": p + c},
                tool_calls=[cl.to_openai(i) for i, cl in enumerate(calls)],
                reasoning=reasoning))

        # streaming: response.created / output_text.delta / completed
        await conn.start_stream()
        rid = random_id("resp")

        async def ev(etype, data):
            await conn.send(
                f"event: {etype}\ndata: {json.dumps(data)}\n\n".encode())

        await ev("response.created",
                 {"type": "response.created",
                  "response": {"id": rid, "object": "response",
                               "status": "in_progress",
                               "model": body.model}})
        hold = self._stop_holdback(body)
        prev = [0]

        async def on_output(out):
            text = out.outputs[0].text
            upto = (len(text) if out.finished
                    else max(prev[0], len(text) - hold))
            delta, prev[0] = text[prev[0]:upto], upto
            if delta:
                await ev("response.output_text.delta",
                         {"type": "response.output_text.delta",
                          "delta": delta})
            if out.finished:
                p = len(out.prompt_token_ids)
                c = len(out.outputs[0].token_ids)
                full, calls = text, []
                if parser is not None:
                    full, calls = parser.parse(full)
                final = responses_response(
                    body.model, full,
                    {"prompt_tokens": p, "completion_tokens": c,
                     "total_tokens": p + c},
                    tool_calls=[cl.to_openai(i)
                                for i, cl in enumerate(calls)])
                final["id"] = rid
                await ev("response.completed",
                         {"type": "response.completed", "response": final})

        await self._pump(future, conn, on_output)
        await conn.end_stream()


class ServerThread:
    """An `HTTPApp` on an event loop of its own thread."""

    def __init__(self, server: HTTPApp, host: str, port: int):
        self.server = server
        self.loop = asyncio.new_event_loop()
        ready = threading.Event()
        box = {}

        def main():
            asyncio.set_event_loop(self.loop)
            try:
                box["port"] = self.loop.run_until_complete(
                    server.start(host, port))
            except BaseException as e:  # noqa: BLE001
                box["error"] = e
                ready.set()
                return
            ready.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=main, daemon=True,
                                       name="tllm-torch-openai")
        self.thread.start()
        ready.wait()
        if "error" in box:
            raise box["error"]
        self.host, self.port = host, box["port"]

    def stop(self):
        async def close():
            await self.server.cleanup()
            srv = self.server._server
            srv.close()
            for w in list(self.server._writers):
                w.close()
            await srv.wait_closed()

        if not self.thread.is_alive():
            return
        fut = asyncio.run_coroutine_threadsafe(close(), self.loop)
        try:
            fut.result(timeout=10)
        except Exception:  # noqa: BLE001 -- a connection left open
            pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        self.loop.close()
