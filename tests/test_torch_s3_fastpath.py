"""The JAX package's S3 fast-path suite (tests/test_s3_fastpath.py),
run against the port's modules: the GET readahead pipeline, the
overlapped SigV4 hashing and aws-chunked reader (the port's
api/signature.py), the chunker and the response writer.

The reference file is read as text and executed here with the import
rewrite of tests/test_torch_copies.py (`load_reference_suite`); it is
never imported or changed.
"""

from test_torch_copies import load_reference_suite

load_reference_suite("test_s3_fastpath", globals())
