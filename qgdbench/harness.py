"""The benchmark's harness: a cell of BENCHMARK.json resolved to its files,
set up, run for a timed window of whole segments, checked against its plain
reference, and reduced to the result line.

Everything particular to a cell is found by the names BENCHMARK.json gives:
`configs/<config>.json` (the configuration's sizes, constants and BCs, and
its `family`), `traffic/<traffic>.json` (read by `generator`),
`families/<family>.py` (how the family builds the program's step and its
reference, what `correct` compares, and the least bytes and operations of
its step, where it gives them), `checks/<cell>.json` (the limit of
each number compared) and `metrics/<metric>.py` (a reader of one metric).
Adding a cell adds files and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time
import types

import torch

from . import generator, timing

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names no run may load: JAX, and the JAX package the
# program was ported from (whose name the program's name begins with)
FORBIDDEN = ("jax", "jaxlib", "flax", "qgdsolver_tpu")


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_module(path: pathlib.Path):
    """A harness file by its path (metric names hold dots)."""
    key = "qgdbench._loaded." + path.relative_to(HERE).as_posix()
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def _applies(spec, cell) -> bool:
    return "workloads" not in spec or cell in spec["workloads"]


def resolve(bench: dict, workload: str) -> types.SimpleNamespace:
    """The cell `workload` of the benchmark with its configuration, traffic,
    family, limits and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[workload]
    cfg = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return types.SimpleNamespace(
        name=workload, chips=w["chips"], cfg=cfg, mix=mix,
        family=load_module(HERE / "families" / f"{cfg['family']}.py"),
        limits=json.loads((HERE / "checks" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def reader(metric: dict):
    return load_module(HERE / "metrics" / f"{metric['name']}.py").read


def card_power_limit():
    """The card's power limit in watts as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def measure(cell, seed: int, seconds: float, trace: bool = False,
            device="cuda", plain: bool = False, t0=None):
    """One run of a cell: set-up (the program's step, the traffic's fields,
    the carry, two warm segments), the timed window of whole segments from
    the set-up carry until `seconds` have passed, closed by a synchronise
    (traced by the profiler with `trace`), then the device's memory peak
    and the check of the last segment's outputs against the reference.
    `t0` is the process's start on the host clock.  With plain=True the
    program runs its plain torch path (a CPU run of the harness)."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    # (set-up part, its end, the memory peak so far)
    marks = [("imports", time.perf_counter(), None)]

    def mark(name):
        sync()
        marks.append((name, time.perf_counter(),
                      torch.cuda.max_memory_allocated(dev) if on_card
                      else None))

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    mark("card")
    fam, cfg, n = cell.family, cell.cfg, cell.mix["segment_steps"]
    prog = fam.Program(cfg, dev, plain=plain)
    mark("program")
    start = prog.start(generator.fields(cfg, cell.mix, seed, dev))
    mark("carry")
    # two segments, the first held while the second runs, as in the window
    out = prog.segment(start, n)
    out = prog.segment(start, n)
    del out
    mark("warm")
    setup_s = marks[-1][1] - t0
    setup_parts = [(k, b - a, peak) for (_, a, _), (k, b, peak) in
                   zip([("", t0, None)] + marks[:-1], marks)]

    def window():
        before = prog.counters()
        out, ends = None, []
        w0 = time.perf_counter()
        while True:
            out = prog.segment(start, n)
            ends.append(out.dt)
            if time.perf_counter() - w0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - w0
        counts = {k: v - before[k] for k, v in prog.counters().items()}
        return out, ends, window_s, counts

    if trace:
        (out, ends, window_s, counts), tr = timing.traced(window)
    else:
        (out, ends, window_s, counts), tr = window(), None
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    segments = len(ends)
    dts = torch.stack(ends)
    failed = int((~(torch.isfinite(dts) & (dts > 0))).sum())
    got = prog.outputs(out)
    del prog, start, out, ends, dts
    if on_card:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    want = fam.reference(cfg, generator.fields(cfg, cell.mix, seed, dev), n)
    gaps = fam.gaps(got, want)
    reference_s = time.perf_counter() - r0
    return types.SimpleNamespace(
        cell=cell.name, cfg=cfg, family=fam, cells=fam.cells(cfg),
        seg_steps=n,
        segments=segments, steps=segments * n, window_s=window_s,
        setup_s=setup_s, setup_parts=setup_parts,
        reference_s=reference_s, memory_peak_bytes=peak,
        counters=counts, trace=tr, gaps=gaps, limits=cell.limits,
        failed=failed, on_card=on_card)


def correct(run) -> bool:
    """Every segment ended with a finite positive dt, and every number
    compared is within its limit (a NaN is not)."""
    return run.failed == 0 and all(
        run.gaps[k] <= run.limits[k] for k in run.limits)


def _number(x):
    return x if math.isfinite(x) else repr(x)


def check_lines(run) -> list:
    return [f"check {k} {_number(run.gaps[k])} limit {run.limits[k]}"
            for k in run.limits]


def result(run, cell, trace: bool) -> dict:
    """The result line of a run on a card: the cell's end-to-end metrics
    (per-layer with `trace`), each reader that found something to read,
    the device, and last the numbers compared beside their limits."""
    if not run.on_card:
        raise RuntimeError("a run off the card has no device metrics")
    metrics = {}
    for spec in (cell.per_layer if trace else cell.end_to_end):
        value = reader(spec)(run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes,
              "power_limit_w": card_power_limit()}
    line = {"correct": correct(run), "attempted": run.segments,
            "failed": run.failed, "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=run.trace.busy_s, window_s=run.window_s)
        line["breakdown"] = {"device_ops": run.trace.device_ops(),
                             "idle_gaps": run.trace.idle_gaps()}
    line["checks"] = {k: {"value": _number(run.gaps[k]),
                          "limit": run.limits[k]} for k in run.limits}
    return line


def forbidden_loaded() -> list:
    """The loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (the program's name begins with the JAX package's)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
