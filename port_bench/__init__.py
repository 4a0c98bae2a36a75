"""The benchmark of the PyTorch and CUDA port (``polyaxon_tpu_torch``).

One command runs one cell once::

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are named in ``BENCHMARK.json`` at the
root of the checkout; each has files of its own under this folder, found by
name (``manifest.py``). Nothing here imports JAX or the JAX package.
"""
