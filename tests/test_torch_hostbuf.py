"""The JAX package's tests/test_hostbuf.py, run against the port: the
zero-copy ingest pool, the batched SHA-256 entry point
(`ops/sha256.sha256_hex_many`, here on the CPU: kernel S2's plain
version), the feeder's sha256 lane over the stub backend, the
aws-chunked `readinto1` decoder and the cache tier's local-owner rule.

The reference file is read as text and executed here with the import
and sibling-helper rewrite of tests/test_torch_copies.py
(`load_reference_suite`); it is never imported or changed. The test it
does not run here is in test_torch_copies.NOT_RUN, with its counterpart
in tests/test_torch_router.py.
"""

from test_torch_copies import load_reference_suite

load_reference_suite(
    "test_hostbuf", globals(),
    edits=[("sha.sha256_hex_many(cases)",
            'sha.sha256_hex_many(cases, device="cpu")'),
           ('sha.sha256_hex_many([spans, blob, [b"ab", b"", b"cd"]])',
            'sha.sha256_hex_many([spans, blob, [b"ab", b"", b"cd"]],'
            ' device="cpu")')])
