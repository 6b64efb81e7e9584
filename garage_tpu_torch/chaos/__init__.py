"""Copy of garage_tpu/chaos/__init__.py: import paths rewritten, issue and PR tags dropped.

Deterministic fault injection (see injector.py for the design).

Usage from tests / the admin API:

    from garage_tpu_torch.chaos import arm, disarm, FaultSpec

    c = arm(seed=42)
    c.add(FaultSpec(kind="rpc_hang", peer=victim.hex()[:8],
                    endpoint="garage_tpu/block", count=10))
    try:
        ...drive the workload...
    finally:
        disarm()
"""

from .injector import (  # noqa: F401
    ALL_KINDS,
    ChaosController,
    ChaosError,
    FaultSpec,
    arm,
    controller,
    disarm,
)
