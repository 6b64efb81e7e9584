"""Copy of garage_tpu/net/__init__.py: import paths rewritten, issue and PR tags dropped.

Transport mesh: authenticated, multiplexed, priority-scheduled RPC.

The reference's custom netapp stack (src/net/, SURVEY.md §2.3) rebuilt on
asyncio: typed endpoints, chunked framing with priorities + order tags +
cancellation, streamed bodies, full-mesh peering with failure detection.
Two interchangeable transports: real TCP (`netapp.NetApp.listen`) and an
in-process loopback network (`local.LocalNetwork`) for deterministic
multi-node tests — the improvement SURVEY.md §4 calls for over the
reference's forked-process-only test strategy.
"""

from .message import (  # noqa: F401
    PRIO_BACKGROUND,
    PRIO_HIGH,
    PRIO_NORMAL,
    PRIO_PRIMARY,
    PRIO_SECONDARY,
    OrderTag,
)
from .netapp import NetApp  # noqa: F401
from .endpoint import Endpoint  # noqa: F401
from .peering import PeeringManager, PeerConnState  # noqa: F401
from .local import LocalNetwork  # noqa: F401
