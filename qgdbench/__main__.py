"""Run one cell of the benchmark on this machine's card and print its result.

    python3 -m qgdbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result as one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 3 and prints no result; if a module of JAX or of the JAX package
is loaded once the window has closed, with code 4.
"""
import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m qgdbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import harness

    # every cache a build or a compile keeps, at fixed paths in the checkout
    cache = harness.ROOT / "build" / "qgdbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")

    import torch

    cell = harness.resolve(harness.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"qgdbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    run = harness.measure(cell, args.seed, args.seconds, trace=bool(args.trace),
                          t0=T0)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"qgdbench: modules of JAX or of the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 4
    line = harness.result(run, cell, bool(args.trace))
    print(f"qgdbench: {args.workload} seed {args.seed}: {run.segments} "
          f"segments of {run.seg_steps} steps in {run.window_s:.3f} s, "
          f"set-up {run.setup_s:.3f} s (by part, s and the memory peak "
          "after it: " + ", ".join(f"{k} {v:.3f} {peak}"
                                   for k, v, peak in run.setup_parts)
          + f"), reference {run.reference_s:.3f} s", file=sys.stderr)
    print(json.dumps(line), flush=True)
    print("\n".join(harness.check_lines(run)), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
