"""Copy of garage_tpu/net/endpoint.py: import paths rewritten, issue and PR tags dropped.

Typed endpoints: path-keyed handler registry.

Ref parity: src/net/endpoint.rs:18-104 — endpoints are named by path
strings like "garage_table/table.rs/Rpc:object"; handlers receive the
decoded payload plus the sender's node id, and may consume/produce byte
streams.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Optional

from ..chaos import injector as _chaos
from ..utils.error import RpcError
from .stream import ByteStream

# handler(from_node: bytes, payload, stream: Optional[ByteStream])
#   -> payload | (payload, Optional[ByteStream])
Handler = Callable[..., Awaitable]


class Endpoint:
    """One named RPC endpoint on a NetApp."""

    def __init__(self, netapp, path: str):
        self.netapp = netapp
        self.path = path
        self._handler: Optional[Handler] = None

    def set_handler(self, handler: Handler) -> "Endpoint":
        self._handler = handler
        return self

    async def handle(self, from_node: bytes, payload, stream: Optional[ByteStream]):
        if self._handler is None:
            raise RpcError(f"no handler for {self.path}")
        result = await self._handler(from_node, payload, stream)
        if isinstance(result, tuple) and len(result) == 2 and (
            result[1] is None or isinstance(result[1], ByteStream)
        ):
            return result
        return result, None

    async def call(
        self,
        node: bytes,
        payload,
        prio: int,
        stream: Optional[ByteStream] = None,
        timeout: Optional[float] = None,
        order: Optional[tuple[int, int]] = None,
    ):
        """Call this endpoint on `node` (loopback if node is ourself).
        Returns (payload, reply_stream|None)."""
        from ..utils.metrics import registry
        from ..utils.tracing import span

        # bg label partitions foreground (interactive) from background
        # (resync/scrub bulk) series so the qos governor can sample
        # foreground latency without chasing its own repair traffic
        from .message import PRIO_BACKGROUND

        with registry().timer("rpc_request_duration_seconds",
                              endpoint=self.path,
                              bg="1" if prio >= PRIO_BACKGROUND else "0"):
            try:
                # chaos seam (rpc): error/hang injection scoped by
                # endpoint path + target node; one attribute load and a
                # None check when disarmed
                if _chaos.ACTIVE is not None:
                    await _chaos.ACTIVE.rpc_call(self.path, node, timeout)
                async with span("rpc.call", endpoint=self.path,
                                node=node[:4].hex()):
                    return await self.netapp.call(
                        node, self.path, payload, prio, stream=stream,
                        timeout=timeout, order=order
                    )
            except Exception:
                registry().inc("rpc_request_errors", endpoint=self.path)
                raise
