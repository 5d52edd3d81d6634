"""The readings a cell's limits are set from, on a card, in one process:

    python3 -m qgdbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--seconds 0] [--out <file.jsonl>]

For each seed of `--seeds`: one run of the cell as the benchmark makes it
(`harness.measure`, with a window of `--seconds`; 0 runs one segment) and
the numbers it compares against the plain reference: the sound runs'
readings, whose largest is the lower reading of each limit.  For each seed
of `--control-seeds`: the plain reference computed in bfloat16, the nearest
precision below the configuration's float32, in the program's place (the
control, whose smallest reading is the upper one).  One JSON line a
reading, on standard output and appended to `--out`.  The benchmark's runs
do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import generator, harness


def control_gaps(cell, seed, dev) -> dict:
    """The numbers compared, with the bfloat16 reference in the program's
    place."""
    fam, cfg, n = cell.family, cell.cfg, cell.mix["segment_steps"]
    want = fam.reference(cfg, generator.fields(cfg, cell.mix, seed, dev), n)
    low = fam.reference(cfg, generator.fields(cfg, cell.mix, seed, dev), n,
                        dtype=torch.bfloat16)
    return fam.gaps(low, want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m qgdbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("qgdbench.calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.resolve(harness.load_benchmark(), args.workload)
    dev = torch.device("cuda")

    def emit(rec):
        rec = dict(rec, cell=cell.name,
                   card=torch.cuda.get_device_name(0),
                   power_limit_w=harness.card_power_limit())
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    for seed in (int(s) for s in args.seeds.split(",") if s):
        run = harness.measure(cell, seed, args.seconds)
        emit({"kind": "program", "seed": seed, "gaps": run.gaps,
              "correct": harness.correct(run), "failed": run.failed,
              "steps": run.steps, "window_s": run.window_s,
              "counts": run.counters, "reference_s": run.reference_s,
              "memory_peak_bytes": run.memory_peak_bytes})
        del run
        torch.cuda.empty_cache()
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        emit({"kind": "control bfloat16", "seed": seed,
              "gaps": control_gaps(cell, seed, dev)})
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
