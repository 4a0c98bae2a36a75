"""The readings a cell's limits are set from (not run by the benchmark's
own runs).

    python3 -m port_bench.calibrate --workload <cell> --seeds 11,12,... [--controls 3]

For each seed: the program's first steps (the run's set-up, no window)
against the f32 reference, the sound runs that set the lower reading. For
the first ``--controls`` seeds also the control (the reference with every
matrix product in float8, in the program's place) and the planted fault
"half of each microbatch's rows left out, the mean over the rest" (in the
reference, in the program's place), against the same f32 reference. A
state left unchanged reads 1 on ``grad_gap`` and ``update_gap`` by
construction and needs no run. One JSON line a reading, then a summary:
each number's largest sound reading and the control's and the fault's
smallest.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from port_bench import compare, harness, manifest


def readings_for_seed(cell: manifest.Cell, seed: int, device: torch.device,
                      controls: bool) -> list[dict]:
    prog = harness.program_setup(cell, seed, device)
    pool, spec, sound = prog.feed.pool, prog.spec, prog.readings
    anomalies = prog.anomalies
    harness.release(prog, device)
    del prog
    ref = harness.reference_readings(cell, spec, seed, device, pool)
    out = [{"seed": seed, "side": "program", "anomalies": anomalies,
            **compare.gaps(sound, ref)}]
    if controls:
        for side, kw in (("control_fp8", {"quant": True}),
                         ("fault_half_batch", {"keep_rows": 0.5})):
            other = harness.reference_readings(cell, spec, seed, device, pool, **kw)
            out.append({"seed": seed, "side": side, **compare.gaps(other, ref)})
    return out


def summary(lines: list[dict]) -> dict:
    names = ("loss_gap", "grad_gap", "update_gap")
    out = {}
    for side in sorted({ln["side"] for ln in lines}):
        rows = [ln for ln in lines if ln["side"] == side]
        pick = max if side == "program" else min
        out[side] = {n: pick(r[n] for r in rows) for n in names}
        out[side]["seeds"] = len(rows)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.calibrate", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    cell = manifest.resolve(args.workload)
    device = torch.device("cuda", 0)
    lines = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for line in readings_for_seed(cell, seed, device, i < args.controls):
            line["seconds"] = time.perf_counter() - t0
            lines.append(line)
            print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                      "summary": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
