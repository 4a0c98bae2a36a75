"""Run one cell of the port's benchmark once.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``compared``: each number
the comparison held beside its limit); the last lines of standard error
repeat the numbers compared. Without a CUDA device, or with fewer than the
cell asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits with another code than 0.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# Python's compiled bytecode of the program and of its libraries, kept at a
# fixed path in the checkout (git-ignored), so that only a checkout's first
# run compiles the ~1,900 modules a run imports from source
sys.pycache_prefix = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  ".port_bench_cache", "pycache")
sys.dont_write_bytecode = False


def _args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    from port_bench import guard, harness, manifest

    cell = manifest.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    seed = args.seed % (1 << 63)
    try:
        result = harness.run_cell(cell, seed, args.seconds, bool(args.trace),
                                  torch.device("cuda", 0), STARTED)
    except harness.ForbiddenModules as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 4
    found = guard.loaded_forbidden()
    if found:
        print(f"port_bench: loaded in the run's process: {found}", file=sys.stderr)
        return 4
    for name, check in result["compared"].items():
        print(f"{name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
