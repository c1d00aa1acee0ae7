"""A small asyncio HTTP/1.1 client on the standard library.

It stands in for aiohttp's `ClientSession` (the card's machine has no
aiohttp) wherever the port talks HTTP to its own servers: the
disaggregated front end and workers (`serve/disagg_server.py`, worker
registration in `serve/openai_server.py`) and the load generator
(`commands/benchmark_serving.py`).  A `ClientSession` keeps idle
connections per (host, port) and reuses them (keep-alive); a request sends
a JSON body (or none) with ``Content-Length``; a response body is read
whole (`read`, `json`, `text`), by exact byte counts over a chunked or
sized body (`readexactly`, the length-prefixed KV frames of
``/disagg/context_stream``), or as it arrives (`iter_chunks`).  A
connection whose response was read to its end goes back to the pool; one
closed by the server, or dropped mid-body, does not.  A request that fails
on a pooled connection before any response byte is retried once on a new
one (the server may have closed it while idle).
"""

from __future__ import annotations

import asyncio
import json as _json
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlsplit

MAX_IDLE_PER_HOST = 32     # idle connections a session keeps to one host


class ClientError(Exception):
    """A connection failed or a response was malformed."""


class ClientResponse:
    def __init__(self, session: "ClientSession", key, reader, writer,
                 status: int, headers: Dict[str, str], method: str,
                 timeout: Optional[float]):
        self._session, self._key = session, key
        self._reader, self._writer = reader, writer
        self.status = status
        self.headers = headers
        self._timeout = timeout
        self._buf = b""
        self._done = False
        te = headers.get("transfer-encoding", "").lower()
        self._chunked = "chunked" in te
        self._left = (0 if method == "HEAD" or status in (204, 304)
                      else int(headers["content-length"])
                      if "content-length" in headers and not self._chunked
                      else None)
        self._keep = (headers.get("connection", "").lower() != "close"
                      and (self._chunked or self._left is not None))
        if self._left == 0 and not self._chunked:
            self._finish()

    async def _wait(self, coro):
        if self._timeout is None:
            return await coro
        return await asyncio.wait_for(coro, self._timeout)

    async def _next_piece(self) -> bytes:
        """The body's next bytes as they arrive; b"" at its end."""
        if self._done:
            return b""
        r = self._reader
        if self._chunked:
            line = await self._wait(r.readline())
            try:
                n = int(line.split(b";")[0].strip(), 16)
            except ValueError:
                self.close()
                raise ClientError(f"malformed chunk size {line!r}") from None
            if n == 0:
                while (await self._wait(r.readline())) not in (
                        b"\r\n", b"\n", b""):
                    pass            # trailers
                self._finish()
                return b""
            data = await self._wait(r.readexactly(n))
            await self._wait(r.readline())
            return data
        if self._left is not None:
            data = await self._wait(r.read(min(self._left, 1 << 20)))
            if not data:
                self.close()
                raise ClientError("connection closed mid-body")
            self._left -= len(data)
            if self._left == 0:
                self._finish()
            return data
        data = await self._wait(r.read(1 << 20))
        if not data:
            self._finish()
        return data

    async def iter_chunks(self):
        """The body's bytes, as they arrive."""
        if self._buf:
            data, self._buf = self._buf, b""
            yield data
        while True:
            data = await self._next_piece()
            if not data:
                return
            yield data

    async def readexactly(self, n: int) -> bytes:
        """The body's next `n` bytes; IncompleteReadError at its end."""
        while len(self._buf) < n:
            data = await self._next_piece()
            if not data:
                partial, self._buf = self._buf, b""
                raise asyncio.IncompleteReadError(partial, n)
            self._buf += data
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    async def read(self) -> bytes:
        parts = [p async for p in self.iter_chunks()]
        return b"".join(parts)

    async def text(self) -> str:
        return (await self.read()).decode("utf-8", errors="replace")

    async def json(self):
        return _json.loads(await self.read() or b"null")

    def _finish(self):
        """The body was read to its end: the connection may serve again."""
        if self._done:
            return
        self._done = True
        if self._keep:
            self._session._release(self._key, self._reader, self._writer)
        else:
            self._writer.close()

    def close(self):
        """Drop the connection (a body not read to its end)."""
        if not self._done:
            self._done = True
            self._writer.close()


class ClientSession:
    """Pooled keep-alive connections; `timeout` (seconds, None: none) bounds
    connecting, the response head and each body read."""

    def __init__(self, timeout: Optional[float] = None):
        self.timeout = timeout
        self._idle: Dict[Tuple[str, int], List[tuple]] = {}
        self.closed = False

    def _release(self, key, reader, writer):
        idle = self._idle.setdefault(key, [])
        if self.closed or len(idle) >= MAX_IDLE_PER_HOST \
                or writer.is_closing():
            writer.close()
        else:
            idle.append((reader, writer))

    async def request(self, method: str, url: str, json=None,
                      data: Optional[bytes] = None,
                      timeout: Optional[float] = -1.0) -> ClientResponse:
        """Send a request (`json` as a JSON body, or `data`, bytes of one)
        and read its status line and headers."""
        if self.closed:
            raise ClientError("session is closed")
        timeout = self.timeout if timeout == -1.0 else timeout
        u = urlsplit(url)
        if u.scheme not in ("http", ""):
            raise ClientError(f"only http:// URLs: {url}")
        key = (u.hostname or "127.0.0.1", u.port or 80)
        body = (_json.dumps(json).encode() if json is not None
                else (data or b""))
        path = (u.path or "/") + (f"?{u.query}" if u.query else "")
        head = (f"{method} {path} HTTP/1.1\r\nHost: {u.netloc}\r\n"
                "Connection: keep-alive\r\n"
                + ("Content-Type: application/json\r\n" if body else "")
                + f"Content-Length: {len(body)}\r\n\r\n").encode("latin-1")
        while True:
            idle = self._idle.get(key)
            pooled = bool(idle)
            if pooled:
                reader, writer = idle.pop()
            else:
                try:
                    reader, writer = await _wait(
                        asyncio.open_connection(*key, limit=1 << 22),
                        timeout)
                except (OSError, asyncio.TimeoutError) as e:
                    raise ClientError(f"cannot connect to {u.netloc}: "
                                      f"{e!r}") from e
            try:
                writer.write(head + body)
                await _wait(writer.drain(), timeout)
                status, headers = await _wait(_read_head(reader), timeout)
            except (OSError, asyncio.IncompleteReadError, ClientError,
                    asyncio.TimeoutError) as e:
                writer.close()
                if pooled and not isinstance(e, asyncio.TimeoutError):
                    continue        # the server closed an idle connection
                raise ClientError(f"{method} {url}: {e!r}") from e
            return ClientResponse(self, key, reader, writer, status, headers,
                                  method, timeout)

    async def get(self, url: str, **kw) -> ClientResponse:
        return await self.request("GET", url, **kw)

    async def post(self, url: str, **kw) -> ClientResponse:
        return await self.request("POST", url, **kw)

    async def close(self):
        self.closed = True
        for conns in self._idle.values():
            for _, w in conns:
                w.close()
        self._idle.clear()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()


async def _wait(coro, timeout):
    if timeout is None:
        return await coro
    return await asyncio.wait_for(coro, timeout)


async def _read_head(reader) -> Tuple[int, Dict[str, str]]:
    line = await reader.readline()
    while line in (b"\r\n", b"\n"):
        line = await reader.readline()
    if not line:
        raise ClientError("connection closed before a response")
    parts = line.split()
    if len(parts) < 2 or not parts[0].startswith(b"HTTP/1."):
        raise ClientError(f"malformed status line {line!r}")
    status = int(parts[1])
    headers = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    if status == 100:                    # an interim response
        return await _read_head(reader)
    return status, headers
