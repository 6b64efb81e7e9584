"""Feeder queue and batching: items over batches the nodes' feeders
shipped in the window (DeviceFeeder.stats)."""


def read(r):
    b = r.feeder.get("batches", 0)
    return r.feeder.get("items", 0) / b if b > 0 else None
