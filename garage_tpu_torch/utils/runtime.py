"""Copy of garage_tpu/utils/runtime.py: import paths rewritten, issue and PR tags dropped.

Process-level runtime tuning for data-plane processes.

The CPython default GIL switch interval is 5 ms. On the block data path
the event loop and the native-kernel worker threads trade the GIL
thousands of times per second; at 5 ms a thread that finishes a
GIL-released C call can wait out most of a switch interval before the
loop runs again. Measured on the r4 loopback PUT bench this single
setting was worth >2x end-to-end throughput (0.115 -> 0.251 GB/s).

Called from server startup (cli/server.py) and bench entry points; not
from library import (a library must not mutate interpreter-global state
on import).
"""

from __future__ import annotations

import sys

SWITCH_INTERVAL = 0.0002


def tune() -> None:
    sys.setswitchinterval(SWITCH_INTERVAL)
