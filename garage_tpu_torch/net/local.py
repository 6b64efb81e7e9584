"""Copy of garage_tpu/net/local.py: import paths rewritten, issue and PR tags dropped.

In-process loopback network for deterministic multi-node tests.

SURVEY.md §4 notes the reference can only test multi-node behavior by
forking real server processes; this transport runs any number of NetApp
nodes in one event loop with the exact same Conn framing/dispatch code,
minus TCP and crypto. Also powers the single-process dev cluster.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..utils.background import spawn
from ..utils.error import RpcError
from .conn import Conn


class LocalChannel:
    """Queue-backed duck-type of SecureChannel (send_frame/recv_frame).
    Frames pass through as (req_id, field, parts) tuples — zero copies,
    zero serialization — and max_chunk is effectively unbounded so a
    whole message is one queue item (there is no wire to preempt)."""

    max_chunk = 1 << 27

    def __init__(self, tx: asyncio.Queue, rx: asyncio.Queue):
        self.tx = tx
        self.rx = rx
        self._closed = False

    async def send_frame(self, req_id: int, field: int,
                         parts: list = ()) -> None:
        if self._closed:
            raise ConnectionError("channel closed")
        await self.tx.put((req_id, field, list(parts)))

    async def recv_frame(self):
        item = await self.rx.get()
        if item is None:
            raise ConnectionError("channel closed by peer")
        return item

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self.tx.put_nowait(None)
                self.rx.put_nowait(None)
            except Exception:
                pass  # lint: ignore[GL05] eof marker into a full/closed queue is a no-op


class LocalNetwork:
    """Registry of in-process nodes, addressable as ("local", n)."""

    def __init__(self):
        self.nodes: dict[bytes, "NetApp"] = {}  # noqa: F821
        self.addrs: dict[tuple, bytes] = {}
        self._n = 0
        self.partitions: set[frozenset] = set()  # failure injection

    def register(self, netapp) -> tuple[str, int]:
        addr = ("local", self._n)
        self._n += 1
        self.nodes[netapp.id] = netapp
        self.addrs[addr] = netapp.id
        netapp.local_net = self
        netapp.public_addr = addr
        netapp.bind_addr = addr
        return addr

    def partition(self, a: bytes, b: bytes) -> None:
        """Cut the link between two nodes (and drop live connections)."""
        self.partitions.add(frozenset((a, b)))
        for x, y in ((a, b), (b, a)):
            node = self.nodes.get(x)
            conn = node.conns.get(y) if node else None
            if conn is not None:
                spawn(conn.close(), "localnet-partition-close")

    def heal(self, a: bytes, b: bytes) -> None:
        self.partitions.discard(frozenset((a, b)))

    async def connect_from(self, src, addr, expected_id: Optional[bytes]) -> bytes:
        target_id = self.addrs.get(tuple(addr)) if addr is not None else expected_id
        if target_id is None:
            target_id = expected_id
        dst = self.nodes.get(target_id) if target_id else None
        if dst is None:
            raise RpcError(f"no local node at {addr}")
        if frozenset((src.id, dst.id)) in self.partitions:
            raise RpcError("network partition")
        if expected_id is not None and dst.id != expected_id:
            raise RpcError("peer identity mismatch")
        a, b = src.conns.get(dst.id), dst.conns.get(src.id)
        if a is not None and b is not None \
                and not a.closed.done() and not b.closed.done():
            return dst.id
        # one-sided remnant (e.g. a partition or a register-tiebreak
        # closed only one end): messages into it hang until timeout —
        # drop both ends before wiring a fresh pair
        for x, y in ((src, dst), (dst, src)):
            c = x.conns.get(y.id)
            if c is not None:
                await c.close()
        q_ab: asyncio.Queue = asyncio.Queue()
        q_ba: asyncio.Queue = asyncio.Queue()
        chan_a = LocalChannel(q_ab, q_ba)
        chan_b = LocalChannel(q_ba, q_ab)
        src._register(dst.id, chan_a, initiator=True)
        dst._register(src.id, chan_b, initiator=False)
        return dst.id
