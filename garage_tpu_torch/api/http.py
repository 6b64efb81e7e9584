"""Copy of garage_tpu/api/http.py: import paths rewritten, issue and PR tags dropped.

Minimal asyncio HTTP/1.1 server for the API frontends.

Ref parity: src/api/common/generic_server.rs:48-330 (there: hyper). No
third-party HTTP dependency: requests are parsed from the stream, bodies
are exposed as a bounded async reader (content-length or chunked), and
responses stream either bytes or an async byte-chunk generator.
Keep-alive and graceful shutdown (drain live connections) included.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import AsyncIterator, Callable, Optional
from urllib.parse import unquote_plus

log = logging.getLogger("garage_tpu_torch.api.http")

MAX_HEADER_BYTES = 64 * 1024
MAX_LINE = 16 * 1024


class HttpError(Exception):
    def __init__(self, status: int, reason: str = ""):
        self.status = status
        self.reason = reason or STATUS_REASONS.get(status, "Error")
        super().__init__(f"{status} {self.reason}")


STATUS_REASONS = {
    100: "Continue", 200: "OK", 204: "No Content", 206: "Partial Content",
    301: "Moved Permanently", 304: "Not Modified", 307: "Temporary Redirect",
    400: "Bad Request", 403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 409: "Conflict", 411: "Length Required",
    412: "Precondition Failed", 413: "Payload Too Large",
    416: "Range Not Satisfiable", 500: "Internal Server Error",
    501: "Not Implemented", 503: "Service Unavailable",
}


class BodyReader:
    """Bounded body reader over the connection stream."""

    def __init__(self, reader: asyncio.StreamReader,
                 content_length: Optional[int], chunked: bool):
        self.r = reader
        self.remaining = content_length
        self.chunked = chunked
        self._chunk_left = 0
        self._done = content_length == 0 and not chunked

    async def read(self, n: int = 65536) -> bytes:
        """Next ≤ n body bytes; b"" at end."""
        if self._done:
            return b""
        if self.chunked:
            return await self._read_chunked(n)
        take = min(n, self.remaining)
        data = await self.r.read(take)
        if not data:
            raise HttpError(400, "truncated body")
        self.remaining -= len(data)
        if self.remaining == 0:
            self._done = True
        return data

    async def _read_chunked(self, n: int) -> bytes:
        if self._chunk_left == 0:
            line = await self.r.readline()
            if not line:
                raise HttpError(400, "truncated chunked body")
            try:
                size = int(line.split(b";")[0].strip(), 16)
            except ValueError:
                raise HttpError(400, "bad chunk size")
            if size == 0:
                # trailers until blank line
                while True:
                    t = await self.r.readline()
                    if t in (b"\r\n", b"\n", b""):
                        break
                self._done = True
                return b""
            self._chunk_left = size
        data = await self.r.read(min(n, self._chunk_left))
        if not data:
            raise HttpError(400, "truncated chunk")
        self._chunk_left -= len(data)
        if self._chunk_left == 0:
            await self.r.readexactly(2)  # CRLF
        return data

    async def readinto1(self, mv: memoryview) -> int:
        """One read landed directly into `mv` (a leased ingest-buffer
        slice); -> bytes written, 0 at end of body. asyncio's
        StreamReader has no recv_into, so the socket bytes materialize
        once in read() — the copy into `mv` here is the PUT path's ONE
        allowed materialization (counted under s3_put_copy_bytes
        path="ingest"); everything downstream reads views over the
        same buffer."""
        chunk = await self.read(len(mv))
        n = len(chunk)
        if n:
            mv[:n] = chunk
            from ..utils.metrics import registry

            registry().inc("s3_put_copy_bytes", n, path="ingest")
        return n

    async def read_all(self, limit: int = 1 << 30) -> bytes:
        out = bytearray()
        while True:
            chunk = await self.read()
            if not chunk:
                return bytes(out)
            out.extend(chunk)
            if len(out) > limit:
                raise HttpError(413)

    async def drain(self) -> None:
        try:
            while await self.read(1 << 20):
                pass
        except HttpError:
            pass


class Request:
    __slots__ = ("method", "raw_path", "raw_query", "path", "query",
                 "headers", "body", "peer", "version")

    def __init__(self, method: str, raw_path: str, raw_query: str, path: str,
                 query: dict[str, str], headers: dict[str, str],
                 body: BodyReader, peer, version: str):
        self.method = method
        self.raw_path = raw_path  # undecoded path, needed for SigV4
        self.raw_query = raw_query  # undecoded query string, for SigV4
        self.path = path
        self.query = query  # decoded; empty-valued keys present as ""
        self.headers = headers  # lowercased names
        self.body = body
        self.peer = peer
        self.version = version

    def header(self, name: str, default: Optional[str] = None) -> Optional[str]:
        return self.headers.get(name.lower(), default)


class Response:
    def __init__(self, status: int = 200,
                 headers: Optional[list[tuple[str, str]]] = None,
                 body: bytes | AsyncIterator[bytes] = b""):
        self.status = status
        self.headers = headers or []
        self.body = body


def parse_query(qs: str) -> tuple[dict[str, str], list[tuple[str, str]]]:
    """-> (decoded dict, raw pair list in order). Keys with no '=' map
    to ""."""
    d: dict[str, str] = {}
    raw: list[tuple[str, str]] = []
    if not qs:
        return d, raw
    for part in qs.split("&"):
        if not part:
            continue
        if "=" in part:
            k, _, v = part.partition("=")
        else:
            k, v = part, ""
        raw.append((k, v))
        d[unquote_plus(k)] = unquote_plus(v)
    return d, raw


async def read_request(reader: asyncio.StreamReader,
                       peer) -> Optional[Request]:
    """Parse one request head; None on clean EOF."""
    try:
        line = await reader.readline()
    except (ConnectionError, asyncio.IncompleteReadError):
        return None
    if not line:
        return None
    if len(line) > MAX_LINE:
        raise HttpError(400, "request line too long")
    try:
        method, target, version = line.decode("ascii").split()
    except ValueError:
        raise HttpError(400, "malformed request line")
    headers: dict[str, str] = {}
    total = 0
    while True:
        h = await reader.readline()
        total += len(h)
        if total > MAX_HEADER_BYTES:
            raise HttpError(400, "headers too large")
        if h in (b"\r\n", b"\n"):
            break
        if not h:
            raise HttpError(400, "truncated headers")
        name, _, value = h.decode("latin-1").partition(":")
        name = name.strip().lower()
        value = value.strip()
        if name in headers:
            headers[name] += "," + value
        else:
            headers[name] = value
    raw_path, _, qs = target.partition("?")
    query, _ = parse_query(qs)
    te = headers.get("transfer-encoding", "").lower()
    chunked = "chunked" in te
    cl = headers.get("content-length")
    clen = int(cl) if cl is not None and not chunked else (None if chunked else 0)
    body = BodyReader(reader, clen, chunked)
    # decode path segments (keep raw for signing)
    from urllib.parse import unquote

    path = unquote(raw_path)
    return Request(method, raw_path, qs, path, query, headers, body, peer,
                   version)


# bytes buffered in the transport before the writer pauses to drain.
# Draining after EVERY chunk costs an await (and often a scheduler trip)
# per block; draining only past a high-water mark keeps the hot GET loop
# on the fast path while still bounding memory to ~one mark per
# connection on top of the transport's own buffer. Runtime-visible via
# admin GET /v1/s3/tuning.
DRAIN_HIGH_WATER = 1 << 20

# coalesce head+body into one transport write below this body size: one
# syscall for the whole response (the common XML/JSON/error case). Large
# bodies are handed to the transport unjoined — no copy.
_COALESCE_MAX = 64 * 1024


async def write_response(writer: asyncio.StreamWriter, req: Optional[Request],
                         resp: Response, keep_alive: bool) -> None:
    head = [f"HTTP/1.1 {resp.status} {STATUS_REASONS.get(resp.status, 'X')}"]
    names = {n.lower() for n, _ in resp.headers}
    body = resp.body
    fixed = isinstance(body, (bytes, bytearray, memoryview))
    # RFC 7230 §3.3.2: a message must not carry both Content-Length and
    # Transfer-Encoding. Streams whose length the handler declared are
    # written with content-length framing; only unknown-length streams
    # get chunked.
    chunked = not fixed and "content-length" not in names
    if fixed and "content-length" not in names:
        resp.headers.append(("content-length", str(len(body))))
    if chunked:
        resp.headers.append(("transfer-encoding", "chunked"))
    if "connection" not in names:
        resp.headers.append(("connection", "keep-alive" if keep_alive else "close"))
    for n, v in resp.headers:
        head.append(f"{n}: {v}")
    head_bytes = ("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
    if req is not None and req.method == "HEAD":
        writer.write(head_bytes)
        await writer.drain()
        if not fixed:
            await _aclose_body(body)
        return
    if fixed:
        # zero-copy: bytes-like bodies go to the transport as-is (the
        # old path re-materialized bytes(body), copying every bytearray
        # and memoryview). Small responses coalesce head+body into one
        # write — one packet for the whole response.
        if body and len(body) <= _COALESCE_MAX:
            writer.write(head_bytes + bytes(body))
        else:
            writer.write(head_bytes)
            if body:
                writer.write(body)
        await writer.drain()
        return
    try:
        if chunked:
            pending = len(head_bytes)
            first = True
            async for chunk in body:
                if not chunk:
                    continue
                # head (first time) + chunk-size line coalesce into one
                # small write; the chunk itself is never copied
                frame = b"%x\r\n" % len(chunk)
                writer.write(head_bytes + frame if first else frame)
                first = False
                writer.write(chunk)
                writer.write(b"\r\n")
                pending += len(chunk)
                if pending >= DRAIN_HIGH_WATER:
                    await writer.drain()
                    pending = 0
            writer.write(head_bytes + b"0\r\n\r\n" if first
                         else b"0\r\n\r\n")
            await writer.drain()
        else:
            declared = int(dict((n.lower(), v) for n, v in resp.headers)
                           ["content-length"])
            written = 0
            pending = len(head_bytes)
            first = True
            async for chunk in body:
                if not chunk:
                    continue
                if written + len(chunk) > declared:
                    # never write past the declared boundary: the client
                    # would parse the excess as the next response
                    raise ConnectionError(
                        f"stream exceeds declared {declared} bytes")
                if first:
                    writer.write(head_bytes)
                    first = False
                writer.write(chunk)
                written += len(chunk)
                pending += len(chunk)
                if pending >= DRAIN_HIGH_WATER:
                    await writer.drain()
                    pending = 0
            if first:
                writer.write(head_bytes)
            await writer.drain()
            if written != declared:
                # short stream would desync a keep-alive conn: abort
                raise ConnectionError(
                    f"stream wrote {written} of {declared} declared bytes")
    finally:
        # deterministic generator shutdown: a client disconnect (write
        # raising) or a mid-stream error must cancel the readahead
        # pipeline NOW, not whenever the GC finalizes the generator
        await _aclose_body(body)


async def _aclose_body(body) -> None:
    aclose = getattr(body, "aclose", None)
    if aclose is None:
        return
    try:
        await aclose()
    except Exception as e:
        # the response is already dead; nothing to salvage
        log.debug("body aclose failed: %s", e)


class HttpServer:
    """ref: generic_server.rs ApiServer::run_server."""

    def __init__(self, handler: Callable, name: str = "api"):
        self.handler = handler  # async (Request) -> Response
        self.name = name
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set[asyncio.Task] = set()
        self.bound_port: Optional[int] = None
        self.metrics = {"requests": 0, "errors": 0}

    async def start(self, host: str, port: int,
                    reuse_port: bool = False) -> None:
        # default StreamReader limit is 64 KiB, which caps body reads
        # and costs ~16 loop iterations per 1 MiB block on the PUT path
        #
        # reuse_port=True is the multi-process gateway's accept loop:
        # every worker binds the same port with SO_REUSEPORT and the
        # kernel balances incoming connections across them (the
        # nginx/Envoy worker model; gateway/worker.py)
        kwargs = {"limit": 1 << 20}
        if reuse_port:
            kwargs["reuse_port"] = True
        self._server = await asyncio.start_server(self._conn, host, port,
                                                  **kwargs)
        self.bound_port = self._server.sockets[0].getsockname()[1]
        log.info("%s server listening on %s:%d", self.name, host, self.bound_port)

    async def start_unix(self, path: str, mode: int = 0o222) -> None:
        """Listen on a Unix-domain socket instead of TCP (ref:
        api/common/generic_server.rs:120-131 — same 0o222 default mode
        as the reference: reachable by anyone who may traverse the
        directory, not readable as a file)."""
        import os as _os
        import stat as _stat

        try:
            st = _os.stat(path)
            if not _stat.S_ISSOCK(st.st_mode):
                # never delete a real file someone pointed the bind at
                raise OSError(f"{path} exists and is not a socket")
            _os.remove(path)  # stale socket from a previous run
        except FileNotFoundError:
            pass
        self._server = await asyncio.start_unix_server(self._conn, path,
                                                       limit=1 << 20)
        _os.chmod(path, mode)
        self.bound_port = None
        log.info("%s server listening on unix:%s", self.name, path)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for t in list(self._conns):
            t.cancel()

    async def _conn(self, reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter) -> None:
        t = asyncio.current_task()
        self._conns.add(t)
        peer = writer.get_extra_info("peername")
        sock = writer.get_extra_info("socket")
        if sock is not None:
            import socket as _s

            try:
                # response flushes are already whole buffers: never
                # wait out Nagle. A wide receive window keeps 1 MiB
                # PUT bodies flowing while the loop serves other conns.
                sock.setsockopt(_s.IPPROTO_TCP, _s.TCP_NODELAY, 1)
                sock.setsockopt(_s.SOL_SOCKET, _s.SO_RCVBUF, 1 << 21)
            except OSError:
                pass  # unix sockets / restricted environments
        try:
            while True:
                try:
                    req = await read_request(reader, peer)
                except HttpError as e:
                    await write_response(
                        writer, None, Response(e.status), False)
                    break
                if req is None:
                    break
                if req.header("expect", "").lower() == "100-continue":
                    writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                    await writer.drain()
                keep = req.header("connection", "").lower() != "close"
                self.metrics["requests"] += 1
                from ..utils.metrics import registry

                from ..utils.tracing import span

                t0 = time.perf_counter()
                try:
                    async with span("http.request", api=self.name,
                                    method=req.method, path=req.path[:128]):
                        resp = await self.handler(req)
                except HttpError as e:
                    resp = Response(e.status, [("content-type", "text/plain")],
                                    e.reason.encode())
                except Exception:
                    log.exception("%s handler error", self.name)
                    self.metrics["errors"] += 1
                    resp = Response(500, [("content-type", "text/plain")],
                                    b"internal error")
                registry().observe(
                    "api_request_duration_seconds",
                    time.perf_counter() - t0,
                    api=self.name,
                    # label cardinality is bounded: arbitrary client
                    # method strings must not grow the registry forever
                    method=(req.method if req.method in (
                        "GET", "HEAD", "PUT", "POST", "DELETE",
                        "OPTIONS") else "OTHER"),
                    status=resp.status // 100 * 100)
                try:
                    await req.body.drain()  # finish consuming the body
                except Exception:
                    keep = False
                try:
                    await write_response(writer, req, resp, keep)
                except (ConnectionError, asyncio.CancelledError):
                    break
                if not keep:
                    break
        finally:
            self._conns.discard(t)
            try:
                writer.close()
            except Exception:
                pass  # lint: ignore[GL05] socket already dead; close is best-effort
