"""Copy of garage_tpu/api/k2v/__init__.py: import paths rewritten, issue and PR tags dropped.

K2V API: causally-consistent key-key-value store over HTTP.

Ref parity: src/api/k2v/. See api_server.K2VApiServer.
"""

from .api_server import K2VApiServer

__all__ = ["K2VApiServer"]
