"""Copy of garage_tpu/utils/__init__.py: import paths rewritten, issue and PR tags dropped.

Foundation utilities (ref: src/util)."""
