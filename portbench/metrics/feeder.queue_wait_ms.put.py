"""Feeder queue and batching: the mean time an item waited in the
nodes' feeder queues in the window, from its submit to its batch's
dispatch (DeviceFeeder.stats queue_wait_us over queued_items), ms."""


def read(r):
    n = r.feeder.get("queued_items", 0)
    if n <= 0:
        return None
    return r.feeder.get("queue_wait_us", 0) / n / 1e3
