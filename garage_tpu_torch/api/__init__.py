"""Copy of garage_tpu/api/__init__.py: import paths rewritten, issue and PR tags dropped.

HTTP API layer (S3, admin; ref: src/api/)."""

from .http import HttpError, HttpServer, Request, Response
from .signature import verify_request

__all__ = ["HttpError", "HttpServer", "Request", "Response",
           "verify_request"]
