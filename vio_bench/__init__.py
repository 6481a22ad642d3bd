"""The benchmark of the PyTorch and CUDA port (``mobile_slam_tpu_torch``).

One run is one process:

    python -m vio_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are named in ``BENCHMARK.json`` at the
root of the checkout; each configuration is ``configs/<name>.json``, each
traffic mix ``traffic/<name>.json`` (read by the module its ``entry`` names,
``entries/<entry>.py``) and each per-layer metric ``metrics/<name>.py``.
Nothing here imports JAX or the JAX package; ``reference/`` imports nothing
of the port either.
"""
