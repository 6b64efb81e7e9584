"""A replicate PUT returns at its write quorum, before the writer's own
copy may have landed; a GET on the writer in that window reads a remote
holder and never touches the local disk.

tests/test_chaos.py::test_local_disk_eio_degrades_to_remote_read arms a
disk_read_error on node 0 right after node 0's PUT and asserts that the
fault fired: it takes for granted that node 0's own copy landed before
the quorum of 2 out of 3 answered. Both packages return at the quorum
(rpc_helper.py try_write_many_sets, a copy in the port), so whether the
fault fires depends on that order. Here node 0's own write is held
until after the GET, in a cluster of JAX nodes and one of port nodes:
both must read remotely without firing the fault, then read locally
(the fault fires, the GET degrades to a remote holder) once the write
lands."""

from __future__ import annotations

import asyncio
import importlib
import threading

import pytest

import test_block as jax_block
from test_torch_copies import port_helper


@pytest.mark.parametrize("package", ["garage_tpu", "garage_tpu_torch"])
def test_get_reads_remote_while_the_writers_copy_is_in_flight(package,
                                                              tmp_path):
    mod = jax_block if package == "garage_tpu" else port_helper("test_block")
    chaos = importlib.import_module(package + ".chaos")

    async def main():
        net, systems, managers, tasks = await mod.make_block_cluster(
            tmp_path, n=3, rf=3)
        m0, gate = managers[0], threading.Event()
        write = m0.write_local_payload

        def held(*a, **kw):
            gate.wait(30)
            return write(*a, **kw)
        m0.write_local_payload = held
        try:
            data = b"chaos-eio-payload " * 4000
            h = await m0.hash_block(data)
            await m0.rpc_put_block(h, data, compress=False)
            assert not m0.has_local(h)
            assert sum(m.has_local(h) for m in managers) == 2
            m0.cache.configure(max_bytes=0)
            c = chaos.arm(seed=8)
            c.add(chaos.FaultSpec(kind="disk_read_error",
                                  node=systems[0].id.hex()[:8],
                                  hash_prefix=h.hex()[:8]))
            assert await m0.rpc_get_block(h, cacheable=False) == data
            assert c.total_fired == 0
            gate.set()
            for _ in range(500):
                if m0.has_local(h):
                    break
                await asyncio.sleep(0.01)
            assert m0.has_local(h)
            assert await m0.rpc_get_block(h, cacheable=False) == data
            assert c.total_fired == 1
        finally:
            gate.set()
            chaos.disarm()
            await mod.stop_all(systems, tasks)

    jax_block.run(main())
