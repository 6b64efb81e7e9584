"""The JAX package's S3 conformance suite (tests/test_s3_api.py), run
against the port: every forked server is
`garage_tpu_torch.cli.server --device cpu` with jax and garage_tpu
blocked, set up through the port's CLI, and the suite's admin HTTP API,
K2V and web front-end tests reach the port's front ends. The suite's
in-test reads of the db and the config, and its K2V client, are the
port's modules.

The reference file is read as text and executed here with the import
rewrite of tests/test_torch_copies.py (`load_reference_suite`); it is
never imported or changed. Signed aws-chunked chunks of 64 KiB go to
the feeder's sha256 lane, which on the CPU is kernel S2's plain torch
version, so this file takes a few minutes.
"""

from test_torch_copies import load_reference_suite

load_reference_suite(
    "test_s3_api", globals(), n_entry_points=5,
    edits=[('"--config", self.config_path, "--log-level", "warning"],',
            '"--config", self.config_path, "--log-level", "warning",'
            ' "--device", "cpu"],')])
