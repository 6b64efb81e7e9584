"""Copy of garage_tpu/api/s3/__init__.py: import paths rewritten, issue and PR tags dropped.

S3-compatible API (ref: src/api/s3/)."""

from .api_server import S3ApiServer

__all__ = ["S3ApiServer"]
