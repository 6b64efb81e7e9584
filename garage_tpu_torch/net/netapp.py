"""Copy of garage_tpu/net/netapp.py: import paths rewritten, issue and PR tags dropped.

NetApp: node identity, connection registry, listen/connect, dispatch.

Ref parity: src/net/netapp.rs:65-470. Node identity is an ed25519 public
key (NodeID); the cluster secret `netid` gates the handshake; typed
endpoints are registered by path. Divergences: one duplex connection per
peer pair instead of separate client/server connections, and loopback
calls short-circuit in-process without serialization.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Optional

try:
    from cryptography.hazmat.primitives.asymmetric.ed25519 import \
        Ed25519PrivateKey
except ModuleNotFoundError:
    Ed25519PrivateKey = None

from ..utils.background import spawn
from ..utils.error import RpcError
from .conn import Conn, SecureChannel, client_handshake, server_handshake
from .endpoint import Endpoint
from .stream import ByteStream

log = logging.getLogger("garage_tpu_torch.net")


class HashIdentityKey:
    """Stand-in node key when the `cryptography` wheel is absent.

    The in-process LocalNetwork transport never signs anything — a node
    key there is pure identity, so 32 random private bytes with a
    blake2b-derived "public" id give the same uniqueness and
    persistence semantics. Same raw-bytes (de)serialization surface as
    Ed25519PrivateKey so load_or_gen_node_key round-trips either kind
    (though a key file is only portable between same-capability
    builds). TCP handshakes refuse separately (conn.py HAVE_CRYPTO)."""

    def __init__(self, raw: bytes):
        self._raw = raw
        import hashlib

        self._pub = hashlib.blake2b(b"gt-node-id" + raw,
                                    digest_size=32).digest()

    @classmethod
    def generate(cls) -> "HashIdentityKey":
        import os

        return cls(os.urandom(32))

    def public_key(self) -> "HashIdentityKey":
        return self  # duck-typed: caller only wants public_bytes_raw()

    def public_bytes_raw(self) -> bytes:
        return self._pub

    def private_bytes_raw(self) -> bytes:
        return self._raw

    def sign(self, _msg: bytes) -> bytes:
        raise RpcError("node key cannot sign: `cryptography` wheel "
                       "not installed")


def gen_node_key():
    if Ed25519PrivateKey is None:
        return HashIdentityKey.generate()
    return Ed25519PrivateKey.generate()


def node_key_from_bytes(raw: bytes):
    if Ed25519PrivateKey is None:
        return HashIdentityKey(raw)
    return Ed25519PrivateKey.from_private_bytes(raw)


def node_key_to_bytes(key) -> bytes:
    return key.private_bytes_raw()


class _OrderedDispatch:
    """Runs handlers carrying the same OrderTag stream in seq order
    (ref: src/net/message.rs:62-88). Cancelled/failed seqs are tombstoned
    via done() so later seqs never stall behind a seq that will never
    complete."""

    def __init__(self):
        self._streams: dict[tuple[bytes, int], dict] = {}

    async def gate(self, peer: bytes, stream_id: int, seq: int):
        key = (peer, stream_id)
        st = self._streams.get(key)
        if st is None:
            st = self._streams[key] = {
                "next": 0, "finished": set(), "ev": asyncio.Event(),
                "t": time.monotonic(), "waiters": 0,
            }
        st["waiters"] += 1
        try:
            while st["next"] < seq:
                st["ev"].clear()
                await st["ev"].wait()
        finally:
            st["waiters"] -= 1
        st["t"] = time.monotonic()

    def done(self, peer: bytes, stream_id: int, seq: int):
        st = self._streams.get((peer, stream_id))
        if st is None:
            return
        st["finished"].add(seq)
        while st["next"] in st["finished"]:
            st["finished"].discard(st["next"])
            st["next"] += 1
        st["t"] = time.monotonic()
        st["ev"].set()

    def prune(self, max_age: float = 600.0):
        # never prune a stream someone is gated on — deleting the entry
        # would orphan the waiter's event and hang it forever
        cutoff = time.monotonic() - max_age
        for key in [
            k
            for k, v in self._streams.items()
            if v["t"] < cutoff and v["waiters"] == 0
        ]:
            del self._streams[key]


class NetApp:
    """Connection manager + endpoint dispatcher for one node."""

    def __init__(
        self,
        netid: bytes,
        privkey: Optional[Ed25519PrivateKey] = None,
        bind_addr: Optional[tuple[str, int]] = None,
        public_addr: Optional[tuple[str, int]] = None,
    ):
        self.netid = netid
        self.privkey = privkey or gen_node_key()
        self.id: bytes = self.privkey.public_key().public_bytes_raw()
        self.bind_addr = bind_addr
        self.public_addr = public_addr or bind_addr
        self.endpoints: dict[str, Endpoint] = {}
        self.conns: dict[bytes, Conn] = {}
        self.on_connected: list[Callable[[bytes, bool], None]] = []
        self.on_disconnected: list[Callable[[bytes], None]] = []
        self._server: Optional[asyncio.base_events.Server] = None
        self._ordered = _OrderedDispatch()
        self._connecting: dict[bytes, asyncio.Future] = {}
        self.local_net = None  # set by local.LocalNetwork.register

    # ---- endpoints -----------------------------------------------------

    def endpoint(self, path: str) -> Endpoint:
        ep = self.endpoints.get(path)
        if ep is None:
            ep = self.endpoints[path] = Endpoint(self, path)
        return ep

    # ---- listen / connect ---------------------------------------------

    async def listen(self) -> None:
        if self._server is not None:
            return  # already listening (idempotent for composition roots)
        assert self.bind_addr is not None, "no bind_addr configured"
        host, port = self.bind_addr
        # lint: ignore[GL12] listen() is called once from the composition root before any request task exists; the None check above is an idempotence guard, not concurrency control
        self._server = await asyncio.start_server(self._accept, host, port)
        if port == 0:  # test convenience: recover the kernel-chosen port
            port = self._server.sockets[0].getsockname()[1]
            # lint: ignore[GL12] same single-task startup window as _server above
            self.bind_addr = (host, port)
            if self.public_addr is None or self.public_addr[1] == 0:
                self.public_addr = (host, port)
        log.info("listening on %s:%d", host, port)

    async def _accept(self, reader, writer) -> None:
        try:
            peer_id, chan = await asyncio.wait_for(
                server_handshake(reader, writer, self.netid, self.privkey), 10.0
            )
        except Exception as e:
            log.debug("handshake failed from %s: %s", writer.get_extra_info("peername"), e)
            writer.close()
            return
        self._register(peer_id, chan, initiator=False)

    async def try_connect(self, addr: tuple[str, int], expected_id: Optional[bytes] = None) -> bytes:
        """Connect to a peer at addr; returns its node id."""
        if self.local_net is not None:
            return await self.local_net.connect_from(self, addr, expected_id)
        if expected_id is not None:
            if expected_id == self.id:
                return self.id
            existing = self.conns.get(expected_id)
            if existing is not None:
                return expected_id
            inflight = self._connecting.get(expected_id)
            if inflight is not None:
                return await asyncio.shield(inflight)
            self._connecting[expected_id] = asyncio.get_event_loop().create_future()
        try:
            reader, writer = await asyncio.wait_for(asyncio.open_connection(*addr), 10.0)
            peer_id, chan = await asyncio.wait_for(
                client_handshake(reader, writer, self.netid, self.privkey), 10.0
            )
            if expected_id is not None and peer_id != expected_id:
                chan.close()
                raise RpcError("peer identity mismatch")
            self._register(peer_id, chan, initiator=True)
            if expected_id is not None:
                fut = self._connecting.pop(expected_id, None)
                if fut and not fut.done():
                    fut.set_result(peer_id)
            return peer_id
        except BaseException as e:
            if expected_id is not None:
                fut = self._connecting.pop(expected_id, None)
                if fut and not fut.done():
                    fut.set_exception(e if isinstance(e, Exception) else RpcError(str(e)))
                    # consume so "exception never retrieved" isn't logged
                    fut.exception()
            raise

    def _register(self, peer_id: bytes, chan, initiator: bool) -> None:
        old = self.conns.get(peer_id)
        if old is not None and old.closed.done():
            # a dead conn lingers in the map until its done-callback
            # tick; it must never win a tiebreak against a fresh channel
            del self.conns[peer_id]
            old = None
        if old is not None:
            # simultaneous-connect tiebreak: keep the connection whose
            # initiator is the lexicographically smaller node id
            we_should_initiate = self.id < peer_id
            if old_is_initiated(old) == we_should_initiate != initiator:
                chan.close()
                return
            spawn(old.close(), "netapp-replace-conn-close")
        conn = Conn(peer_id, chan, self._handle_request, initiator,
                    local_id=self.id)
        self.conns[peer_id] = conn
        conn.start()
        conn.closed.add_done_callback(lambda _: self._on_conn_closed(peer_id, conn))
        for cb in self.on_connected:
            try:
                cb(peer_id, not initiator)
            except Exception:
                log.exception("on_connected callback failed")

    def _on_conn_closed(self, peer_id: bytes, conn: Conn) -> None:
        if self.conns.get(peer_id) is conn:
            del self.conns[peer_id]
            for cb in self.on_disconnected:
                try:
                    cb(peer_id)
                except Exception:
                    log.exception("on_disconnected callback failed")

    def is_connected(self, node: bytes) -> bool:
        return node == self.id or node in self.conns

    # ---- calls ---------------------------------------------------------

    async def call(
        self,
        node: bytes,
        path: str,
        payload,
        prio: int,
        stream: Optional[ByteStream] = None,
        timeout: Optional[float] = None,
        order: Optional[tuple[int, int]] = None,
    ):
        if node == self.id:
            result, reply_stream = await self._handle_request(
                self.id, path, prio, order, payload, stream
            )
            return result, reply_stream
        conn = self.conns.get(node)
        if conn is None:
            raise RpcError(f"not connected to {node[:4].hex()}")
        return await conn.call(path, payload, prio, stream=stream, timeout=timeout, order=order)

    async def _handle_request(self, from_node, path, prio, order, payload, stream):
        ep = self.endpoints.get(path)
        if ep is None:
            raise RpcError(f"no such endpoint: {path}")
        if order is not None:
            sid, seq = order
            try:
                await self._ordered.gate(from_node, sid, seq)
                return await ep.handle(from_node, payload, stream)
            finally:
                # also on cancellation while gated: tombstone this seq so
                # later seqs of the stream don't stall forever
                self._ordered.done(from_node, sid, seq)
        return await ep.handle(from_node, payload, stream)

    # ---- lifecycle -----------------------------------------------------

    async def shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
        # pop-then-close (GL12): iterating a snapshot and then
        # clear()ing raced _register() — a connection accepted while an
        # earlier close() awaited survived the snapshot and was then
        # dropped from the map WITHOUT being closed (leaked socket, the
        # peer kept a half-open channel). Popping drains whatever is
        # present at each step, including late registrations.
        while self.conns:
            _, conn = self.conns.popitem()
            await conn.close()


def old_is_initiated(conn: Conn) -> bool:
    return conn._next_id % 2 == 0
