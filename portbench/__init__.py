"""portbench: the benchmark of garage_tpu_torch, the PyTorch/CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the checkout root names every cell, configuration,
traffic mix and metric; the files under portbench/configs/,
portbench/traffic/ and portbench/metrics/ carry them, found by name.
The yardstick (traffic generator, SigV4 signer, reference, peaks and
roofline arithmetic, trace reduction) lives here so that a change to the
program cannot move it. Nothing here imports jax or garage_tpu; only
harness.py, cluster.py and faults.py import garage_tpu_torch, the
system under test."""
