"""Copy of garage_tpu/table/queue.py: import paths rewritten, issue and PR tags dropped.

Async insert queue: local writes that propagate via normal quorum path.

Ref parity: src/table/queue.rs:1-77. Triggers (`TableSchema.updated`)
often need to insert into *other* tables; doing a quorum RPC inside a db
transaction would deadlock, so they enqueue locally (atomic with the
triggering commit) and this worker drains the queue through
`Table.insert_many` in batches, removing entries only if unchanged.
"""

from __future__ import annotations

import asyncio
import logging

from ..utils.background import Worker, WState

log = logging.getLogger("garage_tpu_torch.table.queue")

BATCH_SIZE = 1024


class InsertQueueWorker(Worker):
    def __init__(self, table):
        self.table = table
        self.data = table.data
        self.name = f"{table.name} queue"

    async def work(self):
        batch = await asyncio.to_thread(
            lambda: list(self.data.insert_queue.iter())[:BATCH_SIZE])
        if not batch:
            return WState.IDLE
        await self.table.propagate_queue_batch(batch)
        return WState.BUSY

    async def wait_for_work(self):
        while not len(self.data.insert_queue):
            await asyncio.sleep(0.1)

    def info(self):
        from ..utils.background import WorkerInfo

        return WorkerInfo(name=self.name,
                          queue_length=len(self.data.insert_queue))
