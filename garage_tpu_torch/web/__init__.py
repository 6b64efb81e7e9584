"""Copy of garage_tpu/web/__init__.py: import paths rewritten, issue and PR tags dropped.

Static website server: serves buckets over vhost-style domains.

Ref parity: src/web/web_server.rs. See server.WebServer.
"""

from .server import WebServer, path_to_keys

__all__ = ["WebServer", "path_to_keys"]
