"""Copy of garage_tpu/qos/__init__.py: import paths rewritten, issue and PR tags dropped.

QoS admission control: what work enters the node, how fast
background work runs.

No reference analogue — the reference Garage ships request *priorities*
(net/message.rs PRIO bits, reproduced in `garage_tpu/net/`) but nothing
stands between a burst of S3 PUTs (or a deep-scrub storm) and unbounded
queueing. This subsystem adds the three missing pieces:

  limiters   composable token buckets (requests/s, bytes/s) and a
             bounded concurrency gate, enforced at the API layer
             per-global / per-key / per-bucket; a request whose bounded
             wait would be exceeded is SHED with the S3-correct
             `503 SlowDown` + `Retry-After` instead of queueing.
  governor   a feedback loop sampling foreground API/RPC latency (EWMA
             over utils/metrics series) that dynamically retunes the
             Tranquilizer tranquility of resync and scrub workers —
             background repair yields when users are waiting and
             sprints when the cluster is idle (the adaptive-concurrency
             shape inference-serving stacks use to protect p99).
  surface    admitted/shed/queued counters in the metrics registry,
             runtime get/set of every limit via the admin HTTP API
             (`/v1/qos`), and a bench.py scenario.
"""

from .limiter import (ConcurrencyLimiter, QosEngine, SlowDown,  # noqa: F401
                      TokenBucket)
from .governor import GovernorWorker  # noqa: F401
