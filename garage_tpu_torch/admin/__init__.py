"""Copy of garage_tpu/admin/__init__.py: import paths rewritten, issue and PR tags dropped.

Admin control surface: in-cluster RPC + HTTP admin/metrics API."""

from .rpc import AdminRpcHandler

__all__ = ["AdminRpcHandler"]
