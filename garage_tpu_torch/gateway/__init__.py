"""Copy of garage_tpu/gateway/__init__.py: import paths rewritten, issue and PR tags dropped.

Multi-process S3/K2V/web gateway (no reference analogue).

One asyncio loop plus the GIL caps a node's frontend throughput
regardless of how fast the data plane underneath it is (BENCH_r05:
s3_put 0.16 GB/s vs internal put 0.36 GB/s vs host RS encode
1.56 GB/s). The standard answer is shared-nothing per-core frontends
(Seastar/ScyllaDB thread-per-core; nginx/Envoy `SO_REUSEPORT` worker
processes), and that is what this package builds:

  * `supervisor.py` — runs inside the store node process. Forks N
    worker processes, respawns crashed ones (rate-limited), brokers
    qos budget leases, aggregates per-worker /metrics under a `worker`
    label and fans runtime-tuning writes out to every worker.
  * `worker.py` — the worker process entry point. Each worker is an
    API-only Garage node (no capacity, memory metadata engine) that
    binds the S3/K2V/web ports with SO_REUSEPORT — the kernel balances
    accepts across workers — and talks to the store node over the
    existing loopback `net/` RPC transport.
  * `lease.py` — `BudgetLeaseBroker`: rents each worker a share of the
    node's req/s + bytes/s budgets and rebalances by observed demand,
    holding Σ(leases) ≤ budget at every instant. The same lease
    protocol cluster-wide distributed rate limiting needs (ROADMAP).
  * `ring.py` — rendezvous-hash ownership of cacheable block hashes
    across workers, so the node holds one decoded copy per hot block
    instead of N.

`[gateway] workers = 1` (the default) keeps the single-process
frontends exactly as before; `0` means auto(cpu_count).
"""

from .lease import BudgetLeaseBroker, Lease  # noqa: F401
from .ring import CacheRing  # noqa: F401

GATEWAY_RPC_PATH = "garage_tpu/gateway"
