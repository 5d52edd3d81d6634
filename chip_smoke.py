"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --profiler-check N   # the profiler's lost sessions
    python3 chip_smoke.py --fixed3   # phase 10's 3D smoothing fixed point

Builds the CUDA kernels of the fused 2D and 3D QGDFoam steps from the
sources in the checkout, and for each dimension checks each kernel against
its plain PyTorch version at the production size (1024x512 and 256x126x126
f32), runs the kernel path in lock-step with the plain path, drives the
library's main path (cases -> make_fused_step -> common.run_steps) for both
cases of that dimension, and times the kernel, plain and composable paths
(each kernel's launches per call in the kernels line, and printed by phase
10 for the 3D kernels); phases 3 and 7 also hold `qgd2d_dt`,
`qgd2d_dt_fold`, `qgd3d_dt` and `qgd3d_dt_fold` to a NaN dt where the plain
versions give one (a NaN T cell) and print each dt kernel's launch shape,
phase 3 with the launches per call of `qgd2d_dt`, `qgd2d_dt_fold` and
`qgd2d_ghosts` (one each); phase 7 holds `qgd3d_emit` (the raw sensor,
its first fvc::smooth ring and the ring's flag in one launch) and its
raw-only mode `qgd3d_sensor` against their plain versions, and
`qgd3d_smooth` (the rest of the 3D step's rings on the card) bitwise
against its plain version on the ring the varsc jet with a density bump
emits, and each of 10 kernel-path steps' sensor frames against
fvc_smooth of the raw sensor the step before emitted; phase 9 drives the
varsc jet at rest (no `qgd3d_smooth` launch, one host flag read a step)
and with the bump (the sensor active past ring 1: `qgd3d_smooth`'s fixed
point, one more read a step) through the main path, and phase 10
times both, with their rings, launches and host flag reads per step, and
the fixed point beside a launch of 4 rings and the ring loop on the ring 1
of the benchmark's shocked 3D jet cell at 640x318x318 (in a process of
its own: `--fixed3` runs that part alone).
Then the 4096x2048 varScModel5 + qgdFlux jet (phases 11-14): `qgd2d_emit`
against its plain version, K2's path in lock-step with its plain path and
with K1's, the case CLI (`python -m qgdsolver_tpu_torch <case>`) on an
OpenFOAM case directory with a write and a resume, and the times of the
three 2D paths; phase 14 also holds `qgd2d_smooth`'s continuation (the
fvc::smooth rings on the card) bitwise against its plain loop on the case's
active sensor and times it. Phases 15-19 run the domain-decomposed steps K3
(2D) and K5 (3D x-ring) on ranks started by `parallel.distributed.spawn`:
ranks that share this one card talk over gloo with halos through pinned
host memory, so their times are not a scaling figure. 15: K3 on the
1024x512 jet over 2x1 and 2x2 ranks against the serial kernel path, and
each flagged kernel against its flagged plain version on every block; 16:
K3 on the varsc + qgdFlux jet with a density bump, 2x2; 17: K5 on the 3D
duct and varsc jet over an x-ring of 2, and the flagged 3D kernels on each
slab; 18: K3 in a one-rank NCCL world, and the case CLI with --devices 2x1;
19: the times.  Phase 20 holds the smoothing kernels' division-free ring to
a correctly rounded division on every float of its check's ranges, for the
cases' maxRatio and a sweep.  Phase 21 runs what QGDFoam does beyond the
fused kernels on the composable path at 1024x512 f32: the case CLI with
implicit diffusion (CG Helmholtz solves), a Segmented inlet with a
waveTransmissive outlet, and a wedge, each against the same run on the
CPU, with ms/step, CG iterations and host reads per step.  Phase 22
runs the static-mesh QHD family, scalar transport, rhoQGDFoam and zQGDFoam
on the composable path (the reference has no Pallas kernel for any of
them): the buoyant cavity as QHDFoam at 128x128 and 512x512 f64, as
SRFQHDFoam and as mulesQHDFoam, the scalar box at 64x64 f64, and the
1024x512 f32 jet as rhoQGDFoam with a stiffened gas and as zQGDFoam, each
against the CPU over its first 3 steps, with ms/step, CG iterations a
solve by kind (p, U, T) and host reads per step.  Phase 23 runs
QHDDyMFoam and interQHDFoam the same way, and phase 24 the Lagrangian and
reacting applications: particlesQGDFoam on the 1024x512 f32 jet with
262144 parcels, particlesQHDFoam on the 128x128 f64 cavity with 65536,
reactingLagrangianQGDFoam through the CLI at 1024x512 f64 with its
DeviceISAT table's hits, lookups and evictions, and the two-way jet on 2x1
ranks sharing the card; no kernel is launched in either.  Phase 25 runs
the port's graft entry points: `graft_entry.entry()`'s step against the
same steps on the CPU, `graft_entry.dryrun_multichip(4)` on ranks sharing
the card (K3 and K5 bit for bit the serial kernel path), and
`utils.badcells.select_bad_cells` on four meshes against the CPU, and
tests/fixtures/particles_case built and stepped against the CPU.  One
line per phase; any failure exits non-zero. The last
line is {"ok": true, "device": {...}}. Without a CUDA device it fails
before printing any result. It imports nothing of JAX."""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SHAPE = (1024, 512)
CASES = ("supersonic_jet", "supersonic_jet_varsc")
SHAPE3 = (256, 126, 126)
CASES3 = ("supersonic_duct_3d", "supersonic_jet_3d_varsc")
BIG = (4096, 2048)  # the varsc + qgdFlux jet of phases 11-14
CSRC = "qgdsolver_tpu_torch/ops/csrc/"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    **{k: (CSRC + "qgd2d.cu", "qgdsolver_tpu/ops/fused_qgd2d.py:1000")
       for k in ("qgd2d_dt", "qgd2d_update", "qgd2d_ghosts")},
    "qgd2d_emit": (CSRC + "qgd2d.cu", "qgdsolver_tpu/ops/fused_qgd2d.py:1609"),
    # replaces XLA, not Pallas: the reference's smoothing loop
    "qgd2d_smooth": (CSRC + "qgd2d.cu",
                     "qgdsolver_tpu/physics/qgdcoeffs.py:254"),
    **{k: (CSRC + "qgd3d.cu", "qgdsolver_tpu/ops/fused_qgd3d.py:349")
       for k in ("qgd3d_dt", "qgd3d_update", "qgd3d_ghosts")},
    # the raw sensor K4 emits in-kernel (and, for qgd3d_emit, the first ring
    # of the XLA fvc_smooth between K4's calls, :841)
    **{k: (CSRC + "qgd3d.cu", "qgdsolver_tpu/ops/fused_qgd3d.py:537")
       for k in ("qgd3d_emit", "qgd3d_sensor")},
    # replaces XLA, not Pallas: the fvc_smooth between K4's calls
    "qgd3d_smooth": (CSRC + "qgd3d.cu",
                     "qgdsolver_tpu/ops/fused_qgd3d.py:841"),
}


# the least time the card could take, from NVIDIA's H100 SXM data sheet:
# HBM3 bytes/s, and float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def work_bytes(name, shape, varsc=False) -> int:
    """The bytes a kernel must move at `shape` cells: each input frame read
    once, each output written once."""
    cells = int(np.prod(shape))
    frame = int(np.prod([n + 2 for n in shape]))
    if len(shape) == 2:
        nx, ny = shape
        ghosts = 2 * (ny + nx + 2)  # ghost cells of one field
        io = {"qgd2d_dt": 3 * frame, "qgd2d_dt_fold": 3 * frame,
              "qgd2d_update": (4 + varsc) * frame + 4 * cells,
              "qgd2d_ghosts": 4 * 3 * ghosts,
              "qgd2d_emit": 5 * frame + 2 * cells,
              # per launch: one frame in, one out
              "qgd2d_smooth": 2 * frame}
    else:
        nx, ny, nz = shape
        ghosts = 2 * (ny * nz + (nx + 2) * nz + (nx + 2) * (ny + 2))
        io = {"qgd3d_dt": 4 * frame, "qgd3d_dt_fold": 4 * frame,
              "qgd3d_update": (5 + varsc) * frame + 5 * cells,
              "qgd3d_sensor": 3 * frame + cells,
              # p, T, sc in, the ring-1 frame out
              "qgd3d_emit": 4 * frame,
              "qgd3d_ghosts": 5 * 3 * ghosts,
              # per launch: the cells of a frame in, a frame out
              "qgd3d_smooth": cells + frame}
    return 4 * io[name]


def ghost_sector_bytes(shape) -> int:
    """What qgd3d_ghosts must move in whole 32-byte sectors: each z-ghost
    row's two end sectors of all five fields, read and written, and the x-
    and y-ghosts' values as work_bytes counts them (their rows run along
    z, whole sectors)."""
    nx, ny, nz = shape
    z_rows = (nx + 2) * (ny + 2)
    xy = 2 * ny * nz + 2 * (nx + 2) * nz
    return 5 * z_rows * 2 * 32 * 2 + 4 * 5 * 3 * xy


# what count_ops counts: one operation per output element of an elementwise
# op, one per input element of a reduction to fewer elements
POINTWISE = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt",
             "rsqrt", "reciprocal", "pow", "minimum", "maximum", "fmin",
             "fmax", "clamp", "clamp_min", "clamp_max", "where", "lt", "le",
             "gt", "ge", "eq", "ne"}
REDUCTIONS = {"max", "min", "amax", "amin", "sum", "any", "all"}


def count_ops(fn) -> int:
    """The float operations that one call of fn() does: fn is a kernel's
    plain version on this run's inputs.  The plain versions compute each
    face flux once per face and each cell's thermo and coefficients once per
    cell, so this counts the work the function needs, not the work a
    kernel repeats (a CUDA thread per cell rebuilds its four or six faces).
    Index, copy and fill ops count nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            ins = [a for a in args if torch.is_tensor(a)]
            if name in REDUCTIONS and len(ins) == 1:
                Counter.ops += ins[0].numel()
            elif name in POINTWISE or name in REDUCTIONS:
                Counter.ops += (out[0] if isinstance(out, tuple)
                                else out).numel()
            return out

    with Counter():
        fn()
    return Counter.ops


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int, warmup: int = 3) -> float:
    """Mean milliseconds of fn() over n calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


# a profiler session that launches at once sometimes records no event at
# all; one that first waits this long has not (`--profiler-check`)
PROFILE_SETTLE_S = 0.02


def profile_session(fn, n: int, settle: float):
    """(CUDA events, end of the marker or None) of one profiler session
    that waits `settle` seconds, runs n calls of fn(), a marker kernel
    (`torch.cuda._sleep`, named spin_kernel) and n calls more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(settle)
        for half in range(2):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            if half == 0:
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [e.time_range.end for e in events if "spin_kernel" in e.name]
    return events, (marks[0] if marks else None)


def device_events(fn, n: int, sessions: int = 5) -> list:
    """(name, microseconds) of each CUDA kernel, copy and fill that n calls
    of fn() ran, from the profiler.  A session can lose every event, or
    some at its start, so it waits PROFILE_SETTLE_S first and runs n calls
    before its marker kernel; only the events after the marker count.  A
    session that lost the marker all the same is taken again with twice
    the wait, at most `sessions` in all."""
    settle = PROFILE_SETTLE_S
    for _ in range(sessions):
        events, mark = profile_session(fn, n, settle)
        if mark is not None:
            return [(e.name, e.time_range.elapsed_us()) for e in events
                    if e.time_range.start >= mark
                    and "spin_kernel" not in e.name]
        settle *= 2
    raise AssertionError(f"the profiler lost the marker kernel in {sessions} "
                         "sessions")


def profiler_check(sessions: int) -> int:
    """`python3 chip_smoke.py --profiler-check N`: N profiler sessions that
    launch at once and N that wait PROFILE_SETTLE_S, taken in turn, each
    on 10 calls of a 1e5-float add; prints how many of each lost the
    marker, and how many recorded no event at all."""
    check(torch.cuda.is_available(), "no CUDA device")
    x = torch.zeros(100_000, device="cuda")
    fn = lambda: x.add_(1.0)  # noqa: E731
    fn()
    lost = {0.0: [0, 0], PROFILE_SETTLE_S: [0, 0]}
    for _ in range(sessions):
        for settle, count in lost.items():
            events, mark = profile_session(fn, 10, settle)
            count[0] += mark is None
            count[1] += not events
    for settle, (marker, empty) in lost.items():
        print(f"profiler sessions waiting {settle} s: {marker} of {sessions} "
              f"lost the marker, {empty} recorded no event")
    print(card_line())
    return 0


def device_ms(fn, n: int, warmup: int = 3, same: bool = True,
              match: str = "") -> float:
    """Device milliseconds of fn() per call over n calls: the durations of
    the CUDA kernels it launched whose names hold `match`, from the
    profiler (host gaps between launches excluded; `device_events`).
    same: every call launches the same kernels, and each kernel name is
    priced at its launches per call times the median of its durations
    (one launch a call: the port's kernels) or their mean (several, of
    other sizes: a plain version's elementwise kernels), which a lost
    event or an outlier does not move; else (a step whose smoothing rings
    depend on the data) the durations are summed and divided by n."""
    for _ in range(warmup):
        fn()
    by_name = {}
    for name, us in device_events(fn, n):
        if match in name:
            by_name.setdefault(name, []).append(us)
    if not by_name:
        raise AssertionError("the profiler saw no device time")
    if not same:
        return sum(sum(v) for v in by_name.values()) / n / 1e3
    total = 0.0
    for v in by_name.values():
        per_call = max(1, round(len(v) / n))
        total += (float(np.median(v)) if per_call == 1
                  else per_call * sum(v) / len(v))
    return total / 1e3


def launches_per_call(fn, n: int = 5) -> float:
    """The port's kernel launches per call of fn(), from the profiler."""
    fn()
    return sum("qgd" in name for name, _ in device_events(fn, n)) / n


def time_kernel(stats, kname, shape, kern, plain, n, n_plain, warmup=3):
    """Device ms per call of a kernel and of its plain version at `shape`
    cells, the kernel's launches per call and the plain version's
    operations (`count_ops`), into stats[kname]["by_shape"][shape].  The
    kernel's time is that of the port's kernels it launched, not of its
    fills."""
    stats[kname].setdefault("by_shape", {})[tuple(shape)] = {
        "ms": device_ms(kern, n, warmup=warmup, match="qgd"),
        "launches_per_call": launches_per_call(kern),
        "plain_ms": device_ms(plain, n_plain, warmup=1),
        "ops": count_ops(plain)}
    return stats[kname]["by_shape"][tuple(shape)]


def recorded(build, solver, fs, steps):
    """{"update": args, "emit": args}: what the last of `steps` steps of the
    2D path that `build` makes, from the carry fs, passed to `qgd2d_update`
    and `qgd2d_emit`."""
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F

    got = {}
    saved = F.qgd2d_update, F.qgd2d_emit

    def recorder(key, fn):
        def call(*args):
            got[key] = args
            return fn(*args)
        call.launches = 0  # the wrapper counts on the module's name
        return call

    F.qgd2d_update = recorder("update", saved[0])
    F.qgd2d_emit = recorder("emit", saved[1])
    try:
        step = build(solver)[0]
        for _ in range(steps):
            fs = step(fs)
        torch.cuda.synchronize()
    finally:
        F.qgd2d_update, F.qgd2d_emit = saved
    return got


def step_parts(advance, n: int, warm: bool = True) -> dict:
    """Device ms per call of `advance` (a step) by what ran: each of the
    port's kernels by name, PyTorch's own kernels, and copies and fills.
    warm: one call runs first."""
    if warm:
        advance()
    parts = {}
    for name, us in device_events(advance, n):
        found = re.search(r"(qgd\dd_\w+?)_kernel", name)
        key = (found.group(1) if found else "copies and fills"
               if name.startswith(("Memcpy", "Memset")) else "torch ops")
        parts[key] = parts.get(key, 0.0) + us / n / 1e3
    return dict(sorted(parts.items(), key=lambda kv: -kv[1]))


def window(step, start, n: int) -> dict:
    """Steps 1..n of `step` from the carry `start`, whose work changes from
    step to step (a sensor whose rings die out): wall ms per step (CUDA
    events), device ms per step by kernel (the profiler; `device_events`
    runs n calls twice a session, and each n calls here start again from
    `start`), the device idle share and the 3D smoothing's rings, launches
    and host flag reads per step."""
    box, calls = [start], [0]

    def advance():
        if calls[0] % n == 0:
            box[0] = start
        calls[0] += 1
        box[0] = step(box[0])

    was = smooth3_counts()
    ms = cuda_ms(advance, n, warmup=0)
    counts = [(a - b) / n for a, b in zip(smooth3_counts(), was)]
    calls[0] = 0
    parts = step_parts(advance, n, warm=False)
    return {"ms": ms, "parts": parts, "counts": counts,
            "idle": 1.0 - sum(parts.values()) / ms}


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))


def entry_err(a, b) -> float:
    """The largest error of any entry relative to that entry's own
    magnitude (a dt quad: the -min tau entry is some 1e-8 of the wave
    speeds beside it)."""
    return float(((a - b).abs() / a.abs().clamp(min=1e-30)).max())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_env():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs the card")
    from qgdsolver_tpu_torch.ops import _build

    card = card_line()
    print(f"phase 1 env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)!r} "
          f"count {torch.cuda.device_count()} | nvidia-smi: {card} | "
          f"nvcc {_build.nvcc_path()}", flush=True)
    return card


def phase_build():
    from qgdsolver_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
    keep = ("Compiling entry", "registers", "spill", "smem")
    lines = [ln.strip() for ln in _build.ptxas_report().splitlines()
             if any(k in ln for k in keep)]
    print(f"phase 2 build: ok in {secs:.1f} s (ptxas -v below)")
    for ln in lines:
        print(f"  {ln}")
    sys.stdout.flush()


def warm_state(name, shape, build, dev):
    """The case at `shape` after 20 plain steps of the fused step that
    `build` makes: (solver, fused state)."""
    from qgdsolver_tpu_torch import cases

    solver, state = getattr(cases, name)(shape=shape, device=dev)
    step, to_f, _ = build(solver, plain=True)
    fs = to_f(state)
    for _ in range(20):
        fs = step(fs)
    torch.cuda.synchronize()
    return solver, fs


def phase_kernels(warm, stats):
    """Each kernel against its plain version on the same inputs.  Returns
    (name, kernel call, plain call) at the plain jet's inputs (qgd2d_emit's
    at the varsc jet's), for timing."""
    from qgdsolver_tpu_torch.ops import _build
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F

    jobs = []
    for name in CASES:
        solver, fs = warm[name]
        prm, prof = F.make_params(solver)
        prof = solver.mesh.tensor(prof).contiguous()
        sc = None
        if prm.varsc:
            rho = solver.thermo.rho_from_p_T(fs.p[1:-1, 1:-1],
                                             fs.T[1:-1, 1:-1])
            sc = F._edge_frame(solver.tau_model.sc_update(
                solver.mesh, rho, fs.sc[1:-1, 1:-1]))
        args = (fs.T, fs.ux, fs.uy, fs.dt)

        dt_ref = F.dt_reference(prm, *args)
        dt_k = F.qgd2d_dt(prm, *args)
        err = abs(float(dt_k) - float(dt_ref))
        check(err <= 1e-6 * abs(float(dt_ref)),
              f"{name} qgd2d_dt {float(dt_k)!r} vs {float(dt_ref)!r}")
        q_ref = F.dt_fold_reference(prm, *args[:-1])
        q_k = F.qgd2d_dt_fold(prm, *args[:-1])
        q_err = entry_err(q_ref, q_k)
        check(q_err <= 1e-6, f"{name} qgd2d_dt_fold {q_k.tolist()} vs "
              f"{q_ref.tolist()}")
        msgs = [f"dt rel {err / float(dt_ref):.2e}, quad rel {q_err:.2e}",
                nan_dt_check(prm, args)]
        stats["qgd2d_dt"]["err"] = max(stats["qgd2d_dt"]["err"], err)

        upd = (fs.p, fs.T, fs.ux, fs.uy, sc, dt_ref)
        (ref, side_ref) = F.update_reference(prm, *upd)
        (new, side) = F.qgd2d_update(prm, *upd)
        torch.cuda.synchronize()
        worst = 0.0
        for k, (a, b) in enumerate(zip(ref, new)):
            ai, bi = a[1:-1, 1:-1], b[1:-1, 1:-1]
            r = rel_err(ai, bi)
            check(r <= 1e-5, f"{name} qgd2d_update {F.FIELDS[k]} rel {r:.2e}")
            worst = max(worst, r)
            stats["qgd2d_update"]["err"] = max(
                stats["qgd2d_update"]["err"], float((ai - bi).abs().max()))
        if solver._flux_sides():
            r = rel_err(side_ref[:, 1:-1], side[:, 1:-1])
            check(r <= 1e-5, f"{name} qgd2d_update qgdFlux side rel {r:.2e}")
            worst = max(worst, r)
        msgs.append(f"update rel {worst:.2e}")

        fa = [x.clone() for x in ref]
        fb = [x.clone() for x in ref]
        F.ghosts_reference(prm, fa, side_ref, prof)
        F.qgd2d_ghosts(prm, fb, side_ref, prof)
        torch.cuda.synchronize()
        worst = 0.0
        for k, (a, b) in enumerate(zip(fa, fb)):
            r = rel_err(a, b)
            check(r <= 1e-6, f"{name} qgd2d_ghosts {F.FIELDS[k]} rel {r:.2e}")
            worst = max(worst, r)
            stats["qgd2d_ghosts"]["err"] = max(
                stats["qgd2d_ghosts"]["err"], float((a - b).abs().max()))
        msgs.append(f"ghosts rel {worst:.2e}")

        if prm.varsc:
            # qgd2d_emit at this shape too (K2's path runs it here)
            em = (prm, fs.p, fs.T, fs.ux, fs.uy, sc)
            ref_e, got_e = F.emit_reference(*em), F.qgd2d_emit(*em)
            torch.cuda.synchronize()
            r = max(rel_err(a, b) for a, b in zip(ref_e[:4], got_e[:4]))
            check(r <= 1e-6 and float(ref_e[4]) == float(got_e[4]),
                  f"{name} qgd2d_emit rel {r:.2e}")
            msgs.append(f"emit rel {r:.2e}")
            jobs.append(("qgd2d_emit", lambda em=em: F.qgd2d_emit(*em),
                         lambda em=em: F.emit_reference(*em)))
        if name == "supersonic_jet":
            at = {sh: F.update_launch_shape(_build.QGDParams(nx=sh[0],
                                                             ny=sh[1]),
                                            fs.p.device)
                  for sh in (SHAPE, BIG)}
            msgs.append(
                f"qgd2d_update strip {at[SHAPE]['strip']} lanes, "
                f"{at[SHAPE]['smem_bytes']} B shared/block, "
                f"{at[SHAPE]['blocks_per_sm']} blocks/SM, " + ", ".join(
                    f"chunk {v['chunk']} rows ({v['blocks']} blocks) at "
                    f"{sh[0]}x{sh[1]}" for sh, v in at.items()))
            # the dt launch at this shape and on K3's 2x2 block
            dts = {sh: F.dt_launch_shape(_build.QGDParams(nx=sh[0],
                                                          ny=sh[1]),
                                         fs.p.device)
                   for sh in (SHAPE, (SHAPE[0] // 2, SHAPE[1] // 2))}
            d0 = dts[SHAPE]
            msgs.append(
                f"qgd2d_dt tile 1 row x {d0['lanes']} lanes a warp (+1 "
                f"lane loaded), {d0['warps']} warps a block, " + ", ".join(
                    f"chunk {v['chunk']} rows, {v['blocks']} blocks, "
                    f"{v['blocks_per_sm']} blocks/SM at {sh[0]}x{sh[1]}"
                    for sh, v in dts.items()))
            fresh = [x.clone() for x in ref]
            per_call = {
                "qgd2d_dt": launches_per_call(lambda: F.qgd2d_dt(prm, *args)),
                "qgd2d_dt_fold": launches_per_call(
                    lambda: F.qgd2d_dt_fold(prm, *args[:-1])),
                "qgd2d_ghosts": launches_per_call(
                    lambda: F.qgd2d_ghosts(prm, fresh, side_ref, prof))}
            check(all(v == 1 for v in per_call.values()),
                  f"2D launches per call {per_call}, expected 1 each")
            msgs.append("launches per call " + ", ".join(
                f"{k} {v:g}" for k, v in per_call.items()))
            # the calls bind this case's inputs (the loop rebinds the names)
            jobs += [("qgd2d_dt", lambda prm=prm, args=args:
                      F.qgd2d_dt(prm, *args),
                      lambda prm=prm, args=args: F.dt_reference(prm, *args)),
                     ("qgd2d_update", lambda prm=prm, upd=upd:
                      F.qgd2d_update(prm, *upd),
                      lambda prm=prm, upd=upd: F.update_reference(prm, *upd)),
                     ("qgd2d_ghosts",
                      lambda prm=prm, fb=fb, side=side_ref, prof=prof:
                      F.qgd2d_ghosts(prm, fb, side, prof),
                      lambda prm=prm, fa=fa, side=side_ref, prof=prof:
                      F.ghosts_reference(prm, fa, side, prof))]
        print(f"phase 3 kernels vs plain, {name} {SHAPE}: ok "
              + ", ".join(msgs), flush=True)
    return jobs


def phase_lockstep(num, warm, build, tols):
    """10 steps of the kernel path against the plain path, from the warm
    states; tols[case] = (dt rtol, field bound relative to its max)."""
    for name, (dt_tol, f_tol) in tols.items():
        solver, fs = warm[name]
        k_step, _, from_f = build(solver)
        p_step, _, _ = build(solver, plain=True)
        a = b = fs
        for _ in range(10):
            a = k_step(a)
            b = p_step(b)
        sa, sb = from_f(a), from_f(b)
        dt_r = abs(float(sa.dt) / float(sb.dt) - 1.0)
        check(dt_r <= dt_tol, f"{name} lock-step dt rel {dt_r:.2e}")
        msgs = [f"dt rel {dt_r:.2e}"]
        for fld in ("rho", "rhoU", "rhoE", "sc"):
            r = rel_err(getattr(sb, fld), getattr(sa, fld))
            check(r <= f_tol, f"{name} lock-step {fld} rel {r:.2e}")
            msgs.append(f"{fld} {r:.2e}")
        print(f"phase {num} lock-step 10 steps, {name}: ok "
              + ", ".join(msgs), flush=True)


def check_physical(name, solver, s) -> str:
    """Finite positive rho, T and e and a max Mach below 5; a summary."""
    U, e, T, p = solver.primitives(s)
    for fld, x in (("rho", s.rho), ("T", T), ("e", e)):
        check(bool(torch.isfinite(x).all()) and bool((x > 0).all()),
              f"{name}: {fld} not finite and positive")
    mach = float((U.norm(dim=0) / solver.thermo.c_from_pT(p, T)).max())
    check(mach < 5.0, f"{name}: max Mach {mach}")
    return f"t={float(s.t):.4e} max Mach {mach:.3f}"


def phase_main_path(num, dev, shape, runs, kernels, want, least=()):
    """cases -> make_fused_step -> common.run_steps, as a user calls it, for
    each (case, steps) of `runs` (or (case, steps, prep): the run starts
    from prep(solver, state), e.g. `with_bump`).  The launch counts of
    `kernels` are set to 0 just before and read just after; each must
    equal want[name] (the steps of the runs whose builder launches it,
    plus one per to_fused for qgd2d_emit), or for the kernels named in
    `least` be at least that (qgd2d_smooth: once per step and per
    to_fused, more on an active sensor; qgd3d_smooth: once or more on the
    3D varsc jet with a bump)."""
    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.solvers import common

    built = []
    for name, n, *prep in runs:
        solver, state = getattr(cases, name)(shape=shape, device=dev)
        check(solver.fused_supported(), f"{name} not fused-supported")
        for fn in prep:
            state = fn(solver, state)
            name += f" ({fn.__name__})"
        built.append((name, n, solver, state) + solver.make_fused_step())
    for k in kernels:
        k.launches = 0
    outs = []
    for name, n, solver, state, step, to_f, from_f in built:
        outs.append((name, n, solver,
                     from_f(common.run_steps(step, to_f(state), n))))
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    for k, v in launches.items():
        check(v >= want[k] if k in least else v == want[k],
              f"{k} launched {v} times, expected {want[k]}")
    msgs = [f"{name} ({solver.fused_builder().__name__}) {n} steps "
            + check_physical(name, solver, s) for name, n, solver, s in outs]
    print(f"phase {num} main path {shape}: ok " + "; ".join(msgs)
          + f" | launches {launches}", flush=True)
    return launches


def phase_time(dev, card, jobs, stats):
    """Grid points per second at SHAPE, plain jet: kernel path, plain frame
    path, composable make_step path (CUDA events); then, with the profiler,
    the device idle share of each path, the kernel path's launches and
    device time per step by kernel, and each kernel's device time against
    its plain version's."""
    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F

    solver, state = cases.supersonic_jet(shape=SHAPE, device=dev)
    pts = SHAPE[0] * SHAPE[1]
    rates = {}
    paths = []
    for label, steps in (("kernel", 200), ("plain", 50)):
        step, to_f, _ = F.build_fused_step(solver, plain=(label == "plain"))
        paths.append((label, steps, step, to_f(state)))
    paths.append(("composable", 20, solver.make_step(), state))
    advances = []
    for label, steps, step, s0 in paths:
        box = [s0]

        def advance(box=box, step=step):
            box[0] = step(box[0])

        ms = cuda_ms(advance, steps)
        rates[label] = (pts / (ms * 1e-3), ms)
        advances.append((label, steps, advance))
    idle = {label: 1.0 - device_ms(advance, min(steps, 50), same=False)
            / rates[label][1] for label, steps, advance in advances}
    parts = step_parts(advances[0][2], 20)
    per_step = launches_per_call(advances[0][2], 20)
    for kname, kern, plain in jobs:
        time_kernel(stats, kname, SHAPE, kern, plain, 50, 20)
    print("phase 6 time, supersonic_jet " + f"{SHAPE}: " + "; ".join(
        f"{k} {r:.4e} points/s ({ms:.4f} ms/step, device idle share "
        f"{idle[k]:.3f})" for k, (r, ms) in rates.items())
        + f" | kernel path: {per_step:g} launches of the port's kernels a "
        f"step, device ms per step {sum(parts.values()):.4f} by kernel: "
        + ", ".join(f"{n} {v:.4f}" for n, v in parts.items())
        + " | device ms/call kernel vs plain (emit on the varsc jet): "
        + ", ".join(f"{k} {stats[k]['by_shape'][SHAPE]['ms']:.4f} vs "
                    f"{stats[k]['by_shape'][SHAPE]['plain_ms']:.4f}"
                    for k, _, _ in jobs) + f" | card: {card}", flush=True)


def step_sensor(prm, fs):
    """The sensor frame the next 3D varsc step uses: fvc_smooth of the raw
    sensor, from the carried first ring and flag, in plain torch."""
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
    from qgdsolver_tpu_torch.ops import smoothing as S

    return S.smooth_sensor(prm, fs.sc_s1, fs.sc_chg, S._smooth_plain,
                           F3.SMOOTH3_RINGS)


def emit3_checks(prm, p, T, sc, stats) -> str:
    """qgd3d_emit on fresh frames against its plain version: the raw sensor
    within rel 1e-6 of sensor_reference_3d, ring 1 and the flag bitwise the
    plain ring of the kernel's own raw sensor, the same ring and flag when
    the raw sensor is not asked for, and qgd3d_sensor (the raw-only mode)
    bitwise the emit's raw sensor."""
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3

    raw, s1, chg = F3.qgd3d_emit(prm, p, T, sc, raw=True)
    _, s1b, chgb = F3.qgd3d_emit(prm, p, T, sc)
    only = F3.qgd3d_sensor(prm, p, T, sc)
    ref = F3.sensor_reference_3d(prm, p, T, sc)
    cells, flag = F3.smooth_reference_3d(prm, raw, 1)
    torch.cuda.synchronize()
    r = rel_err(ref, raw)
    check(r <= 1e-6, f"qgd3d_emit raw sensor rel {r:.2e}")
    check(torch.equal(s1, F3._edge_frame(cells))
          and float(chg) == float(flag), "qgd3d_emit's ring 1 and flag are "
          "not bitwise the plain ring of its raw sensor")
    check(torch.equal(s1b, s1) and float(chgb) == float(chg),
          "qgd3d_emit without the raw sensor gives another ring 1 or flag")
    check(torch.equal(only, raw),
          "qgd3d_sensor's raw sensor is not qgd3d_emit's")
    err = float((ref - raw).abs().max())
    for k in ("qgd3d_emit", "qgd3d_sensor"):
        stats[k]["err"] = max(stats[k]["err"], err)
    return (f"emit raw sensor rel {r:.2e}, ring 1 and flag "
            f"({float(chg):.0f}) bitwise the plain ring of its raw sensor, "
            "qgd3d_sensor bitwise the emit's raw sensor")


def phase_kernels3(warm, stats):
    """Each 3D kernel against its plain version on the same inputs.
    Returns (name, kernel call, plain call) at each case's inputs, for
    timing (the sensor's and the emit's at the varsc jet's, qgd3d_smooth's
    on the ring it emits with a density bump, the others' at the
    duct's)."""
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3

    C = (slice(1, -1),) * 3
    jobs = {}
    prm0 = F3.make_params(warm[CASES3[0]][0])[0]
    dev0 = warm[CASES3[0]][1].p.device
    shape = F3.update_launch_shape(prm0, dev0)
    dts = F3.dt_launch_shape(prm0, dev0)
    launch = (f"qgd3d_update tile {shape['tile'][0]}x{shape['tile'][1]} "
              f"(y x z), chunk {shape['chunk']} x-planes, dynamic shared "
              f"memory {shape['smem_bytes']} B/block, "
              f"{shape['blocks_per_sm']} blocks/SM; qgd3d_dt tile "
              f"{dts['tile'][0]}x{dts['tile'][1]}, chunk {dts['chunk']} "
              f"x-planes, {dts['blocks']} blocks, {dts['blocks_per_sm']} "
              "blocks/SM")
    for name in CASES3:
        solver, fs = warm[name]
        prm, planes = F3.make_params(solver)
        planes = solver.mesh.tensor(planes).contiguous()
        sc = step_sensor(prm, fs) if prm.varsc else None
        dts = (fs.T, fs.ux, fs.uy, fs.uz, fs.dt)
        dt_ref = F3.dt_reference_3d(prm, *dts)
        dt_k = F3.qgd3d_dt(prm, *dts)
        err = abs(float(dt_k) - float(dt_ref))
        check(err <= 1e-6 * abs(float(dt_ref)),
              f"{name} qgd3d_dt {float(dt_k)!r} vs {float(dt_ref)!r}")
        msgs = [f"dt rel {err / float(dt_ref):.2e}", nan_dt_check(prm, dts)]
        stats["qgd3d_dt"]["err"] = max(stats["qgd3d_dt"]["err"], err)

        upd = (fs.p, fs.T, fs.ux, fs.uy, fs.uz, sc, dt_ref)
        ref, side_ref = F3.update_reference_3d(prm, *upd)
        new, side = F3.qgd3d_update(prm, *upd)
        torch.cuda.synchronize()
        worst = 0.0
        for k, (a, b) in enumerate(zip(ref, new)):
            r = rel_err(a[C], b[C])
            check(r <= 1e-5, f"{name} qgd3d_update {F3.FIELDS[k]} rel {r:.2e}")
            worst = max(worst, r)
            stats["qgd3d_update"]["err"] = max(
                stats["qgd3d_update"]["err"], float((a[C] - b[C]).abs().max()))
        if solver._flux_sides():
            r = rel_err(side_ref, side)
            check(r <= 1e-5, f"{name} qgd3d_update qgdFlux side rel {r:.2e}")
            worst = max(worst, r)
        msgs.append(f"update rel {worst:.2e}")

        if prm.varsc:
            em = (prm, ref[0], ref[1], sc)
            msgs.append(emit3_checks(*em, stats))
            jobs["qgd3d_emit"] = (lambda em=em: F3.qgd3d_emit(*em),
                                  lambda em=em: F3.emit_reference_3d(*em))
            jobs["qgd3d_sensor"] = (
                lambda em=em: F3.qgd3d_sensor(*em),
                lambda em=em: F3.sensor_reference_3d(*em))
            at = F3.emit_launch_shape(prm, ref[0].device)
            msgs.append(f"qgd3d_emit tile {at['tile'][0]}x{at['tile'][1]} "
                        f"(y x z), chunk {at['chunk']} x-planes, "
                        f"{at['blocks']} blocks, {at['blocks_per_sm']} "
                        "blocks/SM")

        fa = [x.clone() for x in ref]
        fb = [x.clone() for x in ref]
        F3.ghosts_reference_3d(prm, fa, side_ref, planes)
        F3.qgd3d_ghosts(prm, fb, side_ref, planes)
        torch.cuda.synchronize()
        worst = 0.0
        for k, (a, b) in enumerate(zip(fa, fb)):
            r = rel_err(a, b)
            check(r <= 1e-6, f"{name} qgd3d_ghosts {F3.FIELDS[k]} rel {r:.2e}")
            worst = max(worst, r)
            stats["qgd3d_ghosts"]["err"] = max(
                stats["qgd3d_ghosts"]["err"], float((a - b).abs().max()))
        msgs.append(f"ghosts rel {worst:.2e}")

        if name == "supersonic_duct_3d":
            # the calls bind the duct's inputs (the loop rebinds the names)
            jobs["qgd3d_dt"] = (
                lambda prm=prm, dts=dts: F3.qgd3d_dt(prm, *dts),
                lambda prm=prm, dts=dts: F3.dt_reference_3d(prm, *dts))
            jobs["qgd3d_update"] = (
                lambda prm=prm, upd=upd: F3.qgd3d_update(prm, *upd),
                lambda prm=prm, upd=upd: F3.update_reference_3d(prm, *upd))
            jobs["qgd3d_ghosts"] = (
                lambda prm=prm, fb=fb, sd=side_ref, pl=planes:
                F3.qgd3d_ghosts(prm, fb, sd, pl),
                lambda prm=prm, fa=fa, sd=side_ref, pl=planes:
                F3.ghosts_reference_3d(prm, fa, sd, pl))
        print(f"phase 7 3D kernels vs plain, {name} {SHAPE3}: ok "
              + ", ".join(msgs) + f" | {launch}", flush=True)
    jobs["qgd3d_smooth"] = smooth3_checks(*warm[CASES3[1]], stats)
    return [(k,) + jobs[k] for k in ("qgd3d_dt", "qgd3d_update",
                                     "qgd3d_emit", "qgd3d_sensor",
                                     "qgd3d_ghosts", "qgd3d_smooth")]


def nan_dt_check(prm, dts) -> str:
    """The dt kernels of either dimension (qgd2d_dt and qgd2d_dt_fold on
    dts = (T, ux, uy, dt); qgd3d_dt and qgd3d_dt_fold on (T, ux, uy, uz,
    dt)) on the frames with one NaN T cell: NaN where the plain versions
    give NaN (an interior cell, an x-ghost cell that a boundary face
    reads, a y-ghost cell), finite where they stay finite (an edge ghost
    no face reads)."""
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3

    T, rest = dts[0], dts[1:]
    if len(dts) == 4:
        kern, plain, fold, fold_plain = (F.qgd2d_dt, F.dt_reference,
                                         F.qgd2d_dt_fold,
                                         F.dt_fold_reference)
        cells = {"interior": (prm.nx // 2, prm.ny // 2),
                 "x-ghost": (0, prm.ny // 3),
                 "y-ghost": (prm.nx // 2, prm.ny + 1),
                 "edge ghost": (0, 0)}
    else:
        kern, plain, fold, fold_plain = (F3.qgd3d_dt, F3.dt_reference_3d,
                                         F3.qgd3d_dt_fold,
                                         F3.dt_fold_reference_3d)
        cells = {"interior": (prm.nx // 2, prm.ny // 2, prm.nz // 2),
                 "x-ghost": (0, prm.ny // 2, prm.nz // 3),
                 "edge ghost": (0, 0, prm.nz // 2)}
    for label, idx in cells.items():
        bad = T.clone()
        bad[idx] = float("nan")
        ref = plain(prm, bad, *rest)
        got = kern(prm, bad, *rest)
        quad_ref = fold_plain(prm, bad, *rest[:-1])
        quad = fold(prm, bad, *rest[:-1])
        check(bool(torch.isnan(ref)) == (label != "edge ghost")
              and bool(torch.isnan(got)) == bool(torch.isnan(ref))
              and torch.equal(torch.isnan(quad), torch.isnan(quad_ref)),
              f"{kern.__name__} with a NaN T at the {label} cell {idx}: "
              f"{float(got)} vs plain {float(ref)}")
    return "a NaN T gives a NaN dt and quad where the plain versions do"


def smooth3_counts():
    """The counts of the 3D smoothing: qgd3d_smooth's rings and launches and
    the host flag reads of smooth_sensor."""
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
    from qgdsolver_tpu_torch.ops import smoothing as S

    return (F3.qgd3d_smooth.rings, F3.qgd3d_smooth.launches,
            S.smooth_sensor.reads)


def smooth3_checks(solver, fs, stats):
    """Phase 7's check of qgd3d_smooth on the first ring that the varsc
    jet's kernel step emits from its state with a density bump (so that
    the rings go on past ring 1): one launch of k rings, k = 1..KMAX,
    bitwise smooth_reference_3d (cells, ghosts, edges, corners and the
    last-ring flag); the step's continuation from that ring bitwise
    fvc_smooth of the raw sensor it came from, edge-framed; then 10 steps
    of the kernel path, each step's sensor frame bitwise
    `_edge_frame(fvc_smooth(...))` of the raw sensor that the step before
    emitted.  Returns (kernel call, plain call) of one launch of
    SMOOTH3_RINGS rings on that ring, the step's continuation launch, for
    timing, and keeps a call of one ring in stats["qgd3d_smooth"]
    ["ring_call"]."""
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
    from qgdsolver_tpu_torch.ops import smoothing as S

    coeff = solver.tau_model.smoothCoeff
    prm, _ = F3.make_params(solver)
    k_step, to_f, from_f = F3.build_fused_step_3d(solver)
    fs = k_step(to_f(with_bump(solver, from_f(fs))))
    raw, s1, chg = F3.qgd3d_emit(prm, fs.p, fs.T, fs.sc, raw=True)
    check(torch.equal(s1, fs.sc_s1) and float(chg) == float(fs.sc_chg) == 1.0,
          "the bumped 3D sensor must be active past its first ring")
    C = (slice(1, -1),) * 3
    ks = list(range(1, F3.SMOOTH3_KMAX + 1))
    for k in ks:
        out, flag = F3.qgd3d_smooth(prm, s1, k)
        cells, ref_flag = F3.smooth_reference_3d(prm, s1[C], k)
        check(torch.equal(out, F3._edge_frame(cells))
              and float(flag) == float(ref_flag),
              f"qgd3d_smooth, {k} rings, is not bitwise its plain version")
    was = smooth3_counts()
    got = S.smooth_sensor(prm, s1, chg, F3.qgd3d_smooth, F3.SMOOTH3_RINGS)
    rings = smooth3_counts()[0] - was[0]
    want = F3._edge_frame(F3.fvc_smooth(raw, coeff))
    check(torch.equal(got, want), "the 3D continuation on qgd3d_smooth is "
          "not bitwise fvc_smooth of the raw sensor")
    stats["qgd3d_smooth"]["err"] = float((got - want).abs().max())
    was = smooth3_counts()
    for i in range(10):
        raw_i = F3.qgd3d_emit(prm, fs.p, fs.T, fs.sc, raw=True)[0]
        new = k_step(fs)
        check(torch.equal(new.sc, F3._edge_frame(F3.fvc_smooth(raw_i, coeff))),
              f"kernel-path step {i}: the sensor frame is not fvc_smooth of "
              "the raw sensor the step before emitted")
        fs = new
    per = [(a - b) / 10 for a, b in zip(smooth3_counts(), was)]
    k = F3.SMOOTH3_RINGS
    at = F3.smooth_launch_shape(prm, k, raw.device)
    print(f"phase 7 qgd3d_smooth vs plain, {CASES3[1]} {SHAPE3} with a "
          f"density bump, on the emitted ring 1: ok, k = "
          f"{', '.join(map(str, ks))} bitwise (cells, ghosts, flag); the "
          f"continuation ({rings} rings) bitwise fvc_smooth of the raw "
          f"sensor; 10 kernel-path steps, each step's sensor frame bitwise "
          f"fvc_smooth of the raw sensor emitted the step before "
          f"({per[0]:.2f} rings in {per[1]:.2f} launches, {per[2]:.2f} host "
          f"flag reads per step) | qgd3d_smooth tile {at['tile'][0]}x"
          f"{at['tile'][1]} (y x z), chunk {at['chunk']} x-planes, dynamic "
          f"shared memory {at['smem_bytes']} B/block, {at['blocks_per_sm']} "
          "blocks/SM", flush=True)
    out = torch.empty_like(fs.p)
    flag = torch.empty((), dtype=raw.dtype, device=raw.device)
    stats["qgd3d_smooth"]["ring_call"] = (
        lambda: F3.qgd3d_smooth(prm, s1, 1, out, flag))
    return (lambda: F3.qgd3d_smooth(prm, s1, k, out, flag),
            lambda: S._smooth_plain(prm, s1, k, out, flag))


# the benchmark's 3D mesh (qgdbench/configs/jet3d_varsc.json)
BENCH3 = (640, 318, 318)


def shocked_carry(dev, seed=2000002201):
    """(prm, carry) of the benchmark's jet3d_varsc.shocked cell at BENCH3
    after one step of its program: the fields qgdbench's generator makes
    for `seed`, the carry through `solver.make_fused_step()`, one step,
    whose emitted ring 1 and flag the next step smooths."""
    from qgdbench import generator, harness
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3

    cell = harness.resolve(harness.load_benchmark(), "jet3d_varsc.shocked")
    check(tuple(cell.cfg["shape"]) == BENCH3, "the cell's mesh moved")
    prog = cell.family.Program(cell.cfg, dev)
    fs = prog.step(prog.start(generator.fields(cell.cfg, cell.mix, seed,
                                               dev)))
    return F3.make_params(prog.solver)[0], fs


def fixed_ptxas() -> str:
    """ptxas's registers, spills and shared memory of the fixed point's
    kernels (`qgd3d_smooth_kernel` of Fix3Rows, the z pass, and Fix3Cols,
    the y and x passes), by the cells a thread holds."""
    from qgdsolver_tpu_torch.ops import _build

    lines = _build.ptxas_report().splitlines()
    out = []
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry.*Fix3LILi(\d+)E.*?Fix3(Rows|Cols)", ln)
        if not m:
            continue
        got = [nxt.split(":", 1)[-1].strip() for nxt in lines[i + 1:i + 4]
               if "registers" in nxt or "spill" in nxt]
        out.append(f"{m.group(2)} L={m.group(1)}: " + "; ".join(got))
    return " | ".join(out) or "not reported"


def phase_fixed3(dev, card):
    """The 3D smoothing's fixed point at BENCH3 on the ring 1 that the
    shocked jet cell's first step emits: `qgd3d_smooth`'s fixed-point call
    held bitwise to the ring loop (`smooth_sensor` on rings of
    SMOOTH3_RINGS) and its flag 0; the device time of the call, of each of
    its passes beside the bound of a pass (the cells read and a frame
    written at the HBM rate), of one launch of SMOOTH3_RINGS rings and of
    the ring loop, with the loop's rings, launches and reads; the call's
    launch shape and its kernels' ptxas lines."""
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
    from qgdsolver_tpu_torch.ops import smoothing as S

    prm, fs = shocked_carry(dev)
    s1, chg = fs.sc_s1, fs.sc_chg
    check(float(chg) == 1.0, "the shocked jet's ring 1 must be raised")
    out = torch.empty_like(s1)
    flag = torch.empty((), dtype=s1.dtype, device=s1.device)

    def loop():
        return S.smooth_sensor(prm, s1, chg, F3.qgd3d_smooth,
                               F3.SMOOTH3_RINGS)

    def fixed():
        return F3.qgd3d_smooth(prm, s1, S.SMOOTH_FIXED, out, flag)

    was = smooth3_counts()
    ref = loop()
    counts = [a - b for a, b in zip(smooth3_counts(), was)]
    fixed()
    check(torch.equal(out, ref) and float(flag) == 0.0, "the fixed point "
          "is not bitwise the ring loop on the shocked jet's ring 1")
    del ref
    ms_fixed = device_ms(fixed, 20, match="qgd")
    passes = {}
    for name, us in device_events(fixed, 10):
        m = re.search(r"Fix3L<(\d+), (\d+)>.*Fix3(Rows|Cols)", name)
        if m:
            key = (f"{'z' if m.group(3) == 'Rows' else 'y or x'} pass "
                   f"(L={m.group(1)}, Z={m.group(2)})")
            passes.setdefault(key, []).append(us / 1e3)
    pass_ms = {k: float(np.median(v)) for k, v in passes.items()}
    ms_ring = device_ms(lambda: F3.qgd3d_smooth(prm, s1, F3.SMOOTH3_RINGS,
                                                out, flag), 10, match="qgd")
    ms_loop = device_ms(loop, 3, warmup=1, same=False, match="qgd")
    per_pass = bound(work_bytes("qgd3d_smooth", BENCH3), 0)[0]
    at = F3.fixed_launch_shape(prm, dev)
    print(f"phase 10 the 3D smoothing's fixed point, the jet3d_varsc.shocked "
          f"cell's ring 1 at {BENCH3}: bitwise the ring loop ({counts[0]} "
          f"rings in {counts[1]} launches, {counts[2]} host flag reads), "
          f"flag 0 | device ms: fixed point {ms_fixed:.4f} ("
          + ", ".join(f"{k} {v:.4f}" for k, v in pass_ms.items())
          + f"; bound {per_pass:.4f} a pass, {3 * per_pass:.4f} the call, "
          f"{per_pass:.4f} a frame in and out once), a launch of "
          f"{F3.SMOOTH3_RINGS} rings {ms_ring:.4f}, the ring loop "
          f"{ms_loop:.4f} | launch: z pass {at['z_cells']} cells a lane, 8 "
          f"rows a block; y pass {at['y_cells']} cells a thread, "
          f"{at['y_threads']} threads a block; x pass {at['x_cells']} cells "
          f"a thread, {at['x_threads']} threads a block | ptxas: "
          f"{fixed_ptxas()} "
          f"| card: {card}", flush=True)


def step_bound(kernels, varsc):
    """(ms, by) of a 3D step that launches each kernel of `kernels` (name:
    launches per step) at SHAPE3: the sum of their bounds by bytes."""
    return (sum(n * bound(work_bytes(k, SHAPE3, varsc=varsc), 0)[0]
                for k, n in kernels.items()), "bytes")


def phase_time3(dev, card, jobs, stats):
    """Grid points per second at SHAPE3: the duct's kernel, plain frame and
    composable paths and the varsc jet's kernel path at rest (CUDA events);
    the varsc jet over 20 steps from one kernel step after a density bump
    (`window`); then, with the profiler, each path's device idle share,
    the varsc jet's device time per step by kernel beside the step's bound,
    its launches a step at rest (4: dt, update, emit, ghosts), and each 3D
    kernel's device time against its plain version's."""
    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3

    pts = SHAPE3[0] * SHAPE3[1] * SHAPE3[2]
    solver, state = cases.supersonic_duct_3d(shape=SHAPE3, device=dev)
    vsolver, vstate = cases.supersonic_jet_3d_varsc(shape=SHAPE3, device=dev)
    paths = []
    for label, steps in (("kernel", 50), ("plain", 5)):
        step, to_f, _ = F3.build_fused_step_3d(solver,
                                               plain=(label == "plain"))
        paths.append((label, steps, step, to_f(state)))
    paths.append(("composable", 3, solver.make_step(), state))
    vstep, vto, _ = vsolver.make_fused_step()
    paths.append(("varsc kernel", 20, vstep, vto(vstate)))
    rates, advances, per_step = {}, [], {}
    for label, steps, step, s0 in paths:
        box = [s0]

        def advance(box=box, step=step):
            box[0] = step(box[0])

        was = smooth3_counts()
        ms = cuda_ms(advance, steps, warmup=2)
        per_step[label] = [(a - b) / (steps + 2)
                           for a, b in zip(smooth3_counts(), was)]
        rates[label] = (pts / (ms * 1e-3), ms)
        advances.append((label, steps, advance))
    idle = {label: 1.0 - device_ms(advance, min(steps, 20), warmup=1,
                                   same=False)
            / rates[label][1] for label, steps, advance in advances}
    rest = advances[-1][2]
    per_call = launches_per_call(rest, 10)
    check(per_call == 4, f"the 3D varsc step at rest ran {per_call:g} "
          "launches of the port's kernels a step, expected 4")
    parts_rest = step_parts(rest, 10)
    check("qgd3d_smooth" not in parts_rest and per_step["varsc kernel"][1]
          == 0, "qgd3d_smooth ran in the varsc jet's steps at rest")
    bumped = window(vstep, vstep(vto(with_bump(vsolver, vstate))), 20)
    check("qgd3d_smooth" in bumped["parts"], "the profiler saw no "
          f"qgd3d_smooth in the bumped varsc jet's steps: "
          f"{sorted(bumped['parts'])}")
    base = {"qgd3d_dt": 1, "qgd3d_update": 1, "qgd3d_emit": 1,
            "qgd3d_ghosts": 1}
    bound_rest = step_bound(base, True)
    for kname, kern, plain in jobs:
        time_kernel(stats, kname, SHAPE3, kern, plain, 20, 3, warmup=2)
    ring_ms = device_ms(stats["qgd3d_smooth"].pop("ring_call"), 20,
                        warmup=2, match="qgd")
    sm = stats["qgd3d_smooth"]["by_shape"][SHAPE3]
    sm_bound = bound(work_bytes("qgd3d_smooth", SHAPE3), sm["ops"])
    stats["qgd3d_smooth"]["extra"] = {
        "rings_per_launch": F3.SMOOTH3_RINGS,
        "rings_per_step_bumped": bumped["counts"][0],
        "launches_per_step_bumped": bumped["counts"][1],
        "reads_per_step_bumped": bumped["counts"][2],
        "launches_per_step_at_rest": per_step["varsc kernel"][1],
        "ms_per_step_bumped": bumped["parts"]["qgd3d_smooth"],
        "ms_1_ring": ring_ms}
    print(f"phase 10 time 3D {SHAPE3}: " + "; ".join(
        f"{k} {r:.4e} points/s ({ms:.4f} ms/step, device idle share "
        f"{idle[k]:.3f})" for k, (r, ms) in rates.items())
        + f" | varsc jet at rest: {per_step['varsc kernel'][2]:.2f} host "
        f"flag reads/step, {per_call:g} launches of the port's kernels a "
        f"step; device ms per step {sum(parts_rest.values()):.4f} (bound "
        f"{bound_rest[0]:.4f} by {bound_rest[1]}) by kernel: "
        + ", ".join(f"{n} {x:.4f}" for n, x in parts_rest.items())
        + f" | varsc jet, 20 steps after a density bump: "
        f"{bumped['ms']:.4f} ms/step (device idle share "
        f"{bumped['idle']:.3f}), {bumped['counts'][0]:.2f} qgd3d_smooth "
        f"rings/step in {bumped['counts'][1]:.2f} launches, "
        f"{bumped['counts'][2]:.2f} host flag reads/step; device ms per step "
        f"{sum(bumped['parts'].values()):.4f} (bound "
        f"{step_bound(dict(base, qgd3d_smooth=bumped['counts'][1]), True)[0]:.4f}"
        " by bytes) by kernel: "
        + ", ".join(f"{k} {x:.4f}" for k, x in bumped["parts"].items())
        + " | device ms/call kernel (launches per call) vs plain: "
        + ", ".join(
            f"{k} {stats[k]['by_shape'][SHAPE3]['ms']:.4f} "
            f"({stats[k]['by_shape'][SHAPE3]['launches_per_call']:g}) vs "
            f"{stats[k]['by_shape'][SHAPE3]['plain_ms']:.4f}"
            for k, _, _ in jobs)
        + f" (qgd3d_smooth: a launch of {F3.SMOOTH3_RINGS} rings on the "
        f"bumped jet's emitted ring 1, bound {sm_bound[0]:.4f} ms by "
        f"{sm_bound[1]}; of 1 ring {ring_ms:.4f} ms; qgd3d_ghosts: "
        f"computed z-lane sector floor "
        f"{ghost_sector_bytes(SHAPE3) / HBM_BYTES_PER_S * 1e3:.4f} ms, not "
        f"measured) | card: {card}",
        flush=True)


def phase_emit(dev, stats):
    """Phase 11: the 4096x2048 varsc jet after 20 plain steps of K2's path;
    qgd2d_emit against emit_reference on its fresh frames.  Returns (solver,
    warm TiledState, kernel call, plain call)."""
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F

    solver, ts = warm_state("supersonic_jet_varsc", BIG,
                            F.build_tiled_fused_step, dev)
    prm, _ = F.make_params(solver)
    args = (prm, ts.p, ts.T, ts.ux, ts.uy, ts.sc)
    ref = F.emit_reference(*args)
    got = F.qgd2d_emit(*args)
    torch.cuda.synchronize()
    msgs = []
    for name, a, b in zip(("co_rate", "tau_rate", "sc_raw", "sc_s1"), ref,
                          got):
        r = rel_err(a, b)
        check(r <= 1e-6, f"qgd2d_emit {name} rel {r:.2e}")
        msgs.append(f"{name} rel {r:.2e}")
        stats["qgd2d_emit"]["err"] = max(stats["qgd2d_emit"]["err"],
                                         float((a - b).abs().max()))
    check(float(ref[4]) == float(got[4]),
          f"qgd2d_emit flag {float(got[4])} vs {float(ref[4])}")
    msgs.append(f"flag {float(got[4]):.0f} (equal)")
    print(f"phase 11 qgd2d_emit vs plain, supersonic_jet_varsc {BIG}: ok "
          + ", ".join(msgs), flush=True)
    return solver, ts, (lambda: F.qgd2d_emit(*args),
                        lambda: F.emit_reference(*args))


def phase_lockstep_big(solver, ts):
    """Phase 12: from the warm state, 10 steps of K2's kernel path against
    its plain path (dt 1e-5, fields 2e-3 of their max) and against K1's
    kernel path with the plain sensor pre-pass (dt 1e-6, fields 2e-5: the
    reference's tiled-vs-whole bound)."""
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F

    k_step, _, from_f = F.build_tiled_fused_step(solver)
    p_step, _, _ = F.build_tiled_fused_step(solver, plain=True)
    w_step, _, _ = F.build_fused_step(solver)
    a = b = ts
    c = F.FusedState(*ts[:7])
    for _ in range(10):
        a, b, c = k_step(a), p_step(b), w_step(c)
    sa, sb, sc = from_f(a), from_f(b), from_f(c)
    msgs = []
    for other, label, dt_tol, f_tol in ((sb, "plain", 1e-5, 2e-3),
                                        (sc, "K1", 1e-6, 2e-5)):
        dt_r = abs(float(sa.dt) / float(other.dt) - 1.0)
        check(dt_r <= dt_tol, f"K2 vs {label} lock-step dt rel {dt_r:.2e}")
        part = [f"dt {dt_r:.2e}"]
        for fld in ("rho", "rhoU", "rhoE", "sc"):
            r = rel_err(getattr(other, fld), getattr(sa, fld))
            check(r <= f_tol, f"K2 vs {label} lock-step {fld} rel {r:.2e}")
            part.append(f"{fld} {r:.2e}")
        msgs.append(f"vs {label}: " + ", ".join(part))
    print(f"phase 12 lock-step 10 steps, K2 path {BIG}: ok "
          + "; ".join(msgs), flush=True)


def write_case(root: str, name: str, shape, varsc: bool) -> str:
    """An OpenFOAM case directory: tests/fixtures/jet_case (constScPrModel1
    and its qgdFlux outflow) at `shape` cells; with varsc, varScModel5 with
    the coefficients of cases.supersonic_jet_varsc."""
    edits = [("system/blockMeshDict", r"\(64 32 1\)",
              "(%d %d 1)" % tuple(shape))]
    if varsc:
        edits.append(("constant/thermophysicalProperties", r"QGD\s*\{.*?\}",
                      "QGD\n{\n    implicitDiffusion false;\n"
                      "    QGDCoeffs       varScModel5;\n    aQGD 0.5;\n"
                      "    PrQGD 1.0;\n    rC 0.5;\n    minSc 0.05;\n"
                      "    maxSc 1.0;\n    smoothCoeff 0.1;\n}"))
    return fixture_case(root, "jet_case", name, edits)


def fixture_case(root: str, fixture: str, name: str, edits) -> str:
    """A copy of tests/fixtures/<fixture> under root/name with `edits`, a
    list of (file, regex, replacement), each of which must match."""
    case = os.path.join(root, name)
    here = os.path.dirname(os.path.abspath(__file__))
    shutil.copytree(os.path.join(here, "tests", "fixtures", fixture), case)
    for rel, old, new in edits:
        path = os.path.join(case, rel)
        with open(path) as f:
            text = f.read()
        check(re.search(old, text, flags=re.S) is not None,
              f"{fixture}/{rel}: no {old!r}")
        with open(path, "w") as f:
            f.write(re.sub(old, new, text, count=1, flags=re.S))
    return case


def latest_state(case, dev):
    """(solver, State) of the case's latest written time."""
    from qgdsolver_tpu_torch.io import foam_case

    ctrl = os.path.join(case, "system", "controlDict")
    with open(ctrl) as f:
        text = f.read()
    with open(ctrl, "w") as f:
        f.write(text.replace("startFrom       startTime;",
                             "startFrom       latestTime;"))
    return foam_case.build_case(case, device=dev)


def run_cli(argv, kernels):
    """cli.main(argv) with the launch counts of `kernels` set to 0 just
    before and read just after; (log text, seconds, launches)."""
    from qgdsolver_tpu_torch import cli

    for k in kernels:
        k.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        check(cli.main(argv) == 0, f"cli.main({argv}) failed")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out.getvalue(), secs, {k.__name__: k.launches for k in kernels}


def phase_cli(dev, root):
    """Phase 13: `python -m qgdsolver_tpu_torch <case> --max-steps 50
    --device cuda` on the 4096x2048 case directory (one write, at the end),
    the written fields read back through build_case, then a resume from
    that time for 10 more steps.  Each run's launches must be K2's path:
    qgd2d_emit once per step plus once for to_fused, qgd2d_update and
    qgd2d_ghosts once per step, qgd2d_smooth at least as often as
    qgd2d_emit, qgd2d_dt never."""
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.ops import smoothing as S

    case = write_case(root, "jet_varsc_%dx%d" % BIG, BIG, varsc=True)
    msgs, total = [], {}
    for n in (50, 10):
        rings, reads = F.qgd2d_smooth.rings, S.smooth_sensor.reads
        log, secs, launches = run_cli(
            [case, "--max-steps", str(n), "--device", "cuda"], F.KERNELS)
        check("fused kernel path engaged: build_tiled_fused_step" in log,
              f"the CLI did not take K2's builder:\n{log}")
        want = {"qgd2d_dt": 0, "qgd2d_update": n, "qgd2d_ghosts": n,
                "qgd2d_emit": n + 1}
        smooth = launches.pop("qgd2d_smooth")
        check(launches == want and smooth >= n + 1,
              f"CLI launches {launches}, qgd2d_smooth {smooth}, expected "
              f"{want}, qgd2d_smooth >= {n + 1}")
        launches["qgd2d_smooth"] = smooth
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        writes = re.findall(r"writing fields to (\S+)", log)
        check(len(writes) == 1, f"{len(writes)} writes in one run:\n{log}")
        t0 = time.perf_counter()
        solver, state = latest_state(case, dev)
        read = time.perf_counter() - t0
        rings = (F.qgd2d_smooth.rings - rings) / n
        reads = (S.smooth_sensor.reads - reads) / n
        msgs.append(f"{n} steps in {secs:.1f} s, {rings:.2f} qgd2d_smooth "
                    f"rings/step in {smooth} launches, {reads:.2f} host flag "
                    f"reads/step (wrote "
                    f"{os.path.basename(writes[0])}; read back in "
                    f"{read:.1f} s: "
                    + check_physical("written case", solver, state) + ")")
    print(f"phase 13 CLI on the case directory {BIG}: ok " + "; ".join(msgs)
          + f" | launches {total}", flush=True)
    return total, solver, state


def phase_time_big(solver, state, card, emit_jobs, stats):
    """Phase 14, on the CLI's case at the time it wrote last (an impulsive
    start, so the sensor is active): qgd2d_emit against emit_reference once
    more (the change flag set); the smoothing continuation from the emitted
    ring 1 on qgd2d_smooth against the same loop on its plain version, bit
    for bit, with both ring counts; three K2 steps with the plain
    neighbour max and edge framing made to raise, so K2's path on the card
    reaches neither; grid points per second, ms/step and device idle share
    at 4096x2048 for K2's path, K1's path with the plain sensor pre-pass and
    K2's plain frame path, with K2's qgd2d_smooth rings, launches and host
    flag reads per step; device ms per call of qgd2d_update (on the inputs
    of a K2 step from the case), qgd2d_emit (on phase 11's frames) and one
    qgd2d_smooth launch of SMOOTH_RINGS rings against their plain versions,
    of qgd2d_ghosts, and the continuation's device and wall ms per step."""
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.ops import smoothing as S

    pts = BIG[0] * BIG[1]
    k_step, k_to, _ = F.build_tiled_fused_step(solver)
    w_step, w_to, _ = F.build_fused_step(solver)
    p_step, p_to, _ = F.build_tiled_fused_step(solver, plain=True)
    ts = k_to(state)
    prm, _ = F.make_params(solver)
    ref = F.emit_reference(prm, ts.p, ts.T, ts.ux, ts.uy, ts.sc)
    for name, a, b in zip(("co_rate", "tau_rate", "sc_raw", "sc_s1",
                           "flag"), ref, ts[7:]):
        r = rel_err(a, b)
        check(r <= 1e-6, f"qgd2d_emit on the case, {name} rel {r:.2e}")
    check(float(ts.sc_chg) == 1.0, "the case's sensor must be active")
    k = F.SMOOTH_RINGS
    before = S.smooth_sensor.rings
    got = S.smooth_sensor(prm, ts.sc_s1, ts.sc_chg, F.qgd2d_smooth, k)
    k_rings = S.smooth_sensor.rings - before
    ref_sc = S.smooth_sensor(prm, ts.sc_s1, ts.sc_chg, S._smooth_plain, k)
    p_rings = S.smooth_sensor.rings - before - k_rings
    torch.cuda.synchronize()
    check(torch.equal(got, ref_sc), "qgd2d_smooth's continuation is not "
          "bitwise its plain loop")
    stats["qgd2d_smooth"]["err"] = float((got - ref_sc).abs().max())

    def refuse(*_):
        raise AssertionError("K2's path on the card reached a plain ring")

    plain_fns = [(m, n, getattr(m, n)) for m, n in (
        (S, "_neighbour_max"), (S, "_edge_frame"), (F, "_edge_frame"))]
    for m, n, _ in plain_fns:
        setattr(m, n, refuse)
    try:
        probe = ts
        for _ in range(3):
            probe = k_step(probe)
        torch.cuda.synchronize()
    finally:
        for m, n, fn in plain_fns:
            setattr(m, n, fn)
    checked = (f"qgd2d_emit vs plain on the case ok, flag "
               f"{float(ts.sc_chg):.0f}; qgd2d_smooth continuation bitwise "
               f"its plain loop ({k_rings} rings on the kernel, {p_rings} on "
               f"the plain version); 3 K2 steps without _neighbour_max or "
               f"_edge_frame")
    paths = [("K2", 30, k_step, ts), ("K1+pre-pass", 20, w_step, w_to(state)),
             ("plain", 3, p_step, p_to(state))]
    rates, advances = {}, []
    for label, steps, step, s0 in paths:
        box = [s0]

        def advance(box=box, step=step):
            box[0] = step(box[0])

        counts = (S.smooth_sensor.rings, S.smooth_sensor.reads,
                  F.qgd2d_smooth.launches)
        ms = cuda_ms(advance, steps, warmup=2)
        if label == "K2":
            per_step = [(now - was) / (steps + 2) for now, was in zip(
                (S.smooth_sensor.rings, S.smooth_sensor.reads,
                 F.qgd2d_smooth.launches), counts)]
        rates[label] = (pts / (ms * 1e-3), ms)
        advances.append((label, steps, advance))
    idle = {label: 1.0 - device_ms(advance, min(steps, 10), warmup=1,
                                   same=False)
            / rates[label][1] for label, steps, advance in advances}
    parts = step_parts(advances[0][2], 10)
    # the step's parts at this size (device time): each kernel against its
    # plain version (the update on what a K2 step from ts hands it: the
    # smoothed sensor and the step's dt), and the continuation from the
    # case's ring 1
    prof = solver.mesh.tensor(F.make_params(solver)[1]).contiguous()
    upd = recorded(F.build_tiled_fused_step, solver, ts, 1)["update"]
    u = time_kernel(stats, "qgd2d_update", BIG, lambda: F.qgd2d_update(*upd),
                    lambda: F.update_reference(*upd), 10, 2)
    kern, plain = emit_jobs
    e = time_kernel(stats, "qgd2d_emit", BIG, kern, plain, 20, 5)
    out, flag = torch.empty_like(ts.p), torch.empty_like(ts.dt)
    sm = time_kernel(stats, "qgd2d_smooth", BIG,
                     lambda: F.qgd2d_smooth(prm, ts.sc_s1, k, out, flag),
                     lambda: S._smooth_plain(prm, ts.sc_s1, k, out, flag),
                     20, 3)
    new, side = F.qgd2d_update(*upd)
    ghosts = device_ms(lambda: F.qgd2d_ghosts(prm, new, side, prof), 10,
                       match="qgd")

    def cont():
        S.smooth_sensor(prm, ts.sc_s1, ts.sc_chg, F.qgd2d_smooth, k)

    extra = {"rings_per_launch": k,
             "ms_per_step": device_ms(cont, 5, same=False),
             "wall_ms_per_step": cuda_ms(cont, 5, warmup=1),
             "rings_per_step": per_step[0], "reads_per_step": per_step[1],
             "launches_per_step": per_step[2]}
    stats["qgd2d_smooth"]["extra"] = extra
    print(f"phase 14 time, the CLI's case {BIG}: {checked} | "
          + "; ".join(
        f"{k} {r:.4e} points/s ({ms:.4f} ms/step, device idle share "
        f"{idle[k]:.3f})" for k, (r, ms) in rates.items())
        + f" | timed K2 steps: {per_step[0]:.2f} qgd2d_smooth rings/step in "
        f"{per_step[2]:.2f} launches, {per_step[1]:.2f} host flag reads/step"
        + "; device ms per K2 step by kernel: " + ", ".join(
            f"{n} {v:.4f}" for n, v in parts.items())
        + " | device ms/call kernel vs plain: "
        + ", ".join(f"{n} {x['ms']:.4f} vs {x['plain_ms']:.4f}" for n, x in
                    (("qgd2d_update", u), ("qgd2d_emit", e),
                     (f"qgd2d_smooth ({k} rings)", sm)))
        + f", qgd2d_ghosts {ghosts:.4f} | the continuation from this ring 1 "
        f"({k_rings} rings): device {extra['ms_per_step']:.4f} ms, wall "
        f"{extra['wall_ms_per_step']:.4f} ms | card: {card}", flush=True)


# ---------------------------------------------------------------------------
# phases 15-19: the decomposed steps K3 and K5 on ranks sharing the card
# ---------------------------------------------------------------------------

SHARED = ("ranks sharing one card; halos through host memory; not a "
          "scaling figure")


def rank_jobs(jobs):
    """What every rank of phases 15-18 runs (parallel.distributed.spawn).
    A job: (kind "k3"/"k5", case, shape, (px, py), steps, State with numpy
    leaves).  For each: the launch counts of the flagged kernels set to 0
    just before `steps` decomposed steps and read just after, the gathered
    State, the wall ms per step of steps 3 on, then five more steps with
    every halo exchange and every MAX all-reduce timed (synchronized) for
    their share of the step: the exchange of the fresh frames and the dt
    quad's all-reduce, and in the varsc runs also the sensor pre-pass's
    halos and its smoothing's stopping tests."""
    import torch.distributed as dist

    from qgdsolver_tpu_torch import cases, interop
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
    from qgdsolver_tpu_torch.parallel import distributed, sharding, spmd

    dev = distributed.rank_device("cuda")
    spent = {}

    def timed(fn, key):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return run

    def sync():
        torch.cuda.synchronize()
        dist.barrier()

    out = []
    for kind, name, shape, grid, steps, state_np in jobs:
        solver, _ = getattr(cases, name)(shape=shape, device=dev)
        mod = F if kind == "k3" else F3
        build = (F.build_sharded_fused_step if kind == "k3"
                 else F3.build_sharded_fused_step_3d)
        step, to_s, from_s = build(solver, sharding.ProcessGrid(*grid))
        s = to_s(interop.state_from_numpy(state_np, device=dev))
        for k in mod.SHARDED_KERNELS:
            k.launches = 0
        sync()
        for i in range(steps):
            if i == 2:
                sync()
                t0 = time.perf_counter()
            s = step(s)
        sync()
        ms_step = (time.perf_counter() - t0) * 1e3 / (steps - 2)
        launches = {k.__name__: k.launches for k in mod.SHARDED_KERNELS}
        state = interop.state_to_numpy(from_s(s))
        plain = (spmd.exchange, spmd.all_max)
        spent.update(exchange=0.0, all_reduce=0.0)
        spmd.exchange = timed(plain[0], "exchange")
        spmd.all_max = timed(plain[1], "all_reduce")
        sync()
        t0 = time.perf_counter()
        for _ in range(5):
            s = step(s)
        sync()
        total = time.perf_counter() - t0
        spmd.exchange, spmd.all_max = plain
        out.append({"state": state, "launches": launches, "ms_step": ms_step,
                    "exchange": spent["exchange"] / total,
                    "all_reduce": spent["all_reduce"] / total})
    return out


def spawn_jobs(nprocs, jobs):
    """Run `jobs` on `nprocs` new ranks of this card; each rank's results."""
    from qgdsolver_tpu_torch.parallel import distributed

    return distributed.spawn(rank_jobs, nprocs, jobs, device="cuda",
                             timeout=600)


def numpy_state(s):
    from qgdsolver_tpu_torch import interop

    return interop.state_to_numpy(s)


def serial_kernel_state(solver, state, build, steps=10):
    """`steps` steps of the serial kernel path from a State; numpy State."""
    from qgdsolver_tpu_torch.solvers import common

    step, to_f, from_f = build(solver)
    out = from_f(common.run_steps(step, to_f(state), steps))
    torch.cuda.synchronize()
    return numpy_state(out)


def held(ref, got, bitwise, f_tol=None, split=False) -> str:
    """Check a gathered State against the serial one: bitwise (the sensor
    too); or dt equal
    and the JAX 2D-split bounds (rho, rhoE rtol 1e-6; rhoU rtol 1e-5 atol
    0.05); or dt equal and fields within f_tol of their max."""
    if bitwise:
        for f in ("rho", "rhoU", "rhoE", "sc", "t", "dt"):
            check(np.array_equal(getattr(ref, f), getattr(got, f)),
                  f"{f} not bitwise")
        return "bitwise"
    check(np.array_equal(ref.dt, got.dt), f"dt {got.dt} vs {ref.dt}")
    worst = {}
    for f in ("rho", "rhoU", "rhoE", "sc"):
        a, b = getattr(ref, f).astype(np.float64), getattr(got, f)
        worst[f] = float(np.abs(a - b).max() / np.abs(a).max())
        if split:
            tol = ((1e-5, 0.05) if f == "rhoU" else (1e-6, 0.0))
            check(np.allclose(b, a, rtol=tol[0], atol=tol[1]),
                  f"{f} outside the split bounds ({worst[f]:.2e})")
        else:
            check(worst[f] <= f_tol, f"{f} rel {worst[f]:.2e} > {f_tol}")
    same = all(np.array_equal(getattr(ref, f), getattr(got, f))
               for f in ("rho", "rhoU", "rhoE", "sc"))
    return "dt equal, " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) \
        + (" (bitwise)" if same else "")


def flagged_blocks_2d(solver, fs, grid, stats):
    """Phase 15's check of the flagged 2D kernels on every block of `grid`
    cut with its halo from the warm frames.  Against their flagged plain
    versions: qgd2d_dt_fold (each quad entry rel 1e-6 of itself),
    qgd2d_dt_apply on the kernel's quad (rel 1e-6), qgd2d_update (1e-5 of
    each field's max over the whole mesh, the bound phase 3 holds the
    serial kernel to; the qgdFlux side rows where physical) and
    qgd2d_ghosts (1e-6).  And qgd2d_update on the block must equal the
    serial kernel's result on the whole mesh in the block's window, bit for
    bit.  Returns a message and (kernel, plain) calls of one step's flagged
    kernels on rank 0's block, for timing."""
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.parallel import sharding, spmd

    worst, calls = {"dt": 0.0, "update": 0.0, "ghosts": 0.0}, None
    prm_g, _ = F.make_params(solver)
    frames = (fs.p, fs.T, fs.ux, fs.uy)
    whole, _ = F.update_reference(prm_g, *frames, None, fs.dt)
    whole_k, _ = F.qgd2d_update(prm_g, *frames, None, fs.dt)
    scale = [f[1:-1, 1:-1].abs().max() for f in whole]
    C = (slice(1, -1),) * 2
    for r in range(grid.size):
        ctx = sharding.block_context(solver.mesh, grid, r)
        prm, prof = F.block_params(solver, ctx)
        prof = solver.mesh.tensor(prof).contiguous()
        win = spmd.frame_window(ctx)
        blk = [f[win].contiguous() for f in frames]
        q_ref = F.dt_fold_reference(prm, *blk[1:])
        q_k = F.qgd2d_dt_fold(prm, *blk[1:])
        d_ref = F.dt_apply_reference(prm, q_ref, fs.dt)
        d_k = F.qgd2d_dt_apply(prm, q_k, fs.dt)
        err = max(entry_err(q_ref, q_k), rel_err(d_ref, d_k))
        check(err <= 1e-6, f"block {r}: qgd2d_dt_fold/apply rel {err:.2e}")
        worst["dt"] = max(worst["dt"], err)
        stats["err"] = max(stats["err"], float((q_ref - q_k).abs().max()),
                           float((d_ref - d_k).abs().max()))
        ref, side_ref = F.update_reference(prm, *blk, None, d_ref)
        new, side = F.qgd2d_update(prm, *blk, None, d_ref)
        same, _ = F.qgd2d_update(prm, *blk, None, fs.dt)
        torch.cuda.synchronize()
        for a, b, m in zip(ref, new, scale):
            e = float((a[C] - b[C]).abs().max() / m)
            check(e <= 1e-5, f"block {r}: qgd2d_update rel {e:.2e}")
            worst["update"] = max(worst["update"], e)
            stats["err"] = max(stats["err"], float((a[C] - b[C]).abs().max()))
        for k, (a, b) in enumerate(zip(whole_k, same)):
            check(torch.equal(a[win][C], b[C]), f"block {r}: qgd2d_update "
                  f"{F.FIELDS[k]} is not the serial kernel's window")
        for sd, phys in ((0, prm.edge_lo), (1, prm.edge_hi)):
            if phys and solver._flux_sides():
                e = rel_err(side_ref[sd, 1:-1], side[sd, 1:-1])
                check(e <= 1e-5, f"block {r}: qgdFlux side rel {e:.2e}")
        fa = [x.clone() for x in ref]
        fb = [x.clone() for x in ref]
        F.ghosts_reference(prm, fa, side_ref, prof)
        F.qgd2d_ghosts(prm, fb, side_ref, prof)
        torch.cuda.synchronize()
        for a, b in zip(fa, fb):
            e = rel_err(a, b)
            check(e <= 1e-6, f"block {r}: qgd2d_ghosts rel {e:.2e}")
            worst["ghosts"] = max(worst["ghosts"], e)
            stats["err"] = max(stats["err"], float((a - b).abs().max()))
        if r == 0:
            def kernels(prm=prm, blk=blk, prof=prof):
                q = F.qgd2d_dt_fold(prm, *blk[1:])
                d = F.qgd2d_dt_apply(prm, q, fs.dt)
                fr, sd = F.qgd2d_update(prm, *blk, None, d)
                F.qgd2d_ghosts(prm, list(fr), sd, prof)

            def plain(prm=prm, blk=blk, prof=prof):
                q = F.dt_fold_reference(prm, *blk[1:])
                d = F.dt_apply_reference(prm, q, fs.dt)
                fr, sd = F.update_reference(prm, *blk, None, d)
                F.ghosts_reference(prm, list(fr), sd, prof)

            calls = (kernels, plain, (prm.nx, prm.ny))
    return ("flagged kernels vs plain on every block: " + ", ".join(
        f"{k} rel {v:.2e}" for k, v in worst.items())
        + "; update on each block bitwise the serial kernel's window", calls)


def flagged_slabs_3d(solver, fs, grid, stats):
    """Phase 17's check of the flagged 3D kernels on every slab of an x-ring,
    as flagged_blocks_2d: against the flagged plain versions (the update to
    1e-5 of each field's max over the whole mesh, as phase 7; the sensor,
    rel 1e-6, on the fresh frames with the neighbours' planes in the halo),
    and the update and the sensor bit for bit the serial kernels' results
    on the whole mesh in the slab's window (the serial raw sensor from
    qgd3d_emit, which the serial step runs)."""
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
    from qgdsolver_tpu_torch.parallel import sharding, spmd

    prm_g, planes = F3.make_params(solver)
    planes = solver.mesh.tensor(planes).contiguous()
    sc = step_sensor(prm_g, fs) if prm_g.varsc else None
    frames = (fs.p, fs.T, fs.ux, fs.uy, fs.uz)
    fresh, _ = F3.update_reference_3d(prm_g, *frames, sc, fs.dt)
    whole_k, _ = F3.qgd3d_update(prm_g, *frames, sc, fs.dt)
    sensor_k = F3.qgd3d_emit(prm_g, fresh[0], fresh[1], sc, raw=True)[0] \
        if sc is not None else None
    worst, calls = {"dt": 0.0, "update": 0.0, "sensor": 0.0,
                    "ghosts": 0.0}, None
    C = (slice(1, -1),) * 3
    scale = [f[C].abs().max() for f in fresh]
    for r in range(grid.size):
        ctx = sharding.block_context(solver.mesh, grid, r)
        prm, _ = F3.block_params(solver, ctx)
        win = spmd.frame_window(ctx)
        blk = [f[win].contiguous() for f in frames]
        scb = sc[win].contiguous() if sc is not None else None
        q_ref = F3.dt_fold_reference_3d(prm, *blk[1:])
        q_k = F3.qgd3d_dt_fold(prm, *blk[1:])
        d_ref = F3.dt_apply_reference_3d(prm, q_ref, fs.dt)
        d_k = F3.qgd3d_dt_apply(prm, q_k, fs.dt)
        err = max(entry_err(q_ref, q_k), rel_err(d_ref, d_k))
        check(err <= 1e-6, f"slab {r}: qgd3d_dt_fold/apply rel {err:.2e}")
        worst["dt"] = max(worst["dt"], err)
        stats["err"] = max(stats["err"], float((q_ref - q_k).abs().max()),
                           float((d_ref - d_k).abs().max()))
        ref, side_ref = F3.update_reference_3d(prm, *blk, scb, d_ref)
        new, side = F3.qgd3d_update(prm, *blk, scb, d_ref)
        same, _ = F3.qgd3d_update(prm, *blk, scb, fs.dt)
        torch.cuda.synchronize()
        for a, b, m in zip(ref, new, scale):
            e = float((a[C] - b[C]).abs().max() / m)
            check(e <= 1e-5, f"slab {r}: qgd3d_update rel {e:.2e}")
            worst["update"] = max(worst["update"], e)
            stats["err"] = max(stats["err"], float((a[C] - b[C]).abs().max()))
        for k, (a, b) in enumerate(zip(whole_k, same)):
            check(torch.equal(a[win][C], b[C]), f"slab {r}: qgd3d_update "
                  f"{F3.FIELDS[k]} is not the serial kernel's window")
        if sc is not None:
            fp, fT = fresh[0][win].contiguous(), fresh[1][win].contiguous()
            s_ref = F3.sensor_reference_3d(prm, fp, fT, scb)
            s_k = F3.qgd3d_sensor(prm, fp, fT, scb)
            torch.cuda.synchronize()
            e = rel_err(s_ref, s_k)
            check(e <= 1e-6, f"slab {r}: qgd3d_sensor rel {e:.2e}")
            check(torch.equal(sensor_k[r * prm.nx:(r + 1) * prm.nx], s_k),
                  f"slab {r}: qgd3d_sensor is not the serial kernel's window")
            worst["sensor"] = max(worst["sensor"], e)
            stats["err"] = max(stats["err"], float((s_ref - s_k).abs().max()))
        fa = [x.clone() for x in ref]
        fb = [x.clone() for x in ref]
        F3.ghosts_reference_3d(prm, fa, side_ref, planes)
        F3.qgd3d_ghosts(prm, fb, side_ref, planes)
        torch.cuda.synchronize()
        for a, b in zip(fa, fb):
            e = rel_err(a, b)
            check(e <= 1e-6, f"slab {r}: qgd3d_ghosts rel {e:.2e}")
            worst["ghosts"] = max(worst["ghosts"], e)
            stats["err"] = max(stats["err"], float((a - b).abs().max()))
        if r == 0 and sc is None:
            def kernels(prm=prm, blk=blk):
                q = F3.qgd3d_dt_fold(prm, *blk[1:])
                d = F3.qgd3d_dt_apply(prm, q, fs.dt)
                fr, sd = F3.qgd3d_update(prm, *blk, None, d)
                F3.qgd3d_ghosts(prm, list(fr), sd, planes)

            def plain(prm=prm, blk=blk):
                q = F3.dt_fold_reference_3d(prm, *blk[1:])
                d = F3.dt_apply_reference_3d(prm, q, fs.dt)
                fr, sd = F3.update_reference_3d(prm, *blk, None, d)
                F3.ghosts_reference_3d(prm, list(fr), sd, planes)

            calls = (kernels, plain, (prm.nx, prm.ny, prm.nz))
    return ", ".join(f"{k} rel {v:.2e}" for k, v in worst.items()
                     if k != "sensor" or sc is not None), calls


def warm_global(name, shape, build, dev):
    """The case after 20 plain steps (warm_state), as a State; its solver
    and the warm fused carry."""
    solver, fs = warm_state(name, shape, build, dev)
    return solver, fs, build(solver)[2](fs)


def with_bump(solver, state):
    """A density jump across the x partition edge (the JAX sharded tests'),
    so the sensor and its cross-partition smoothing are active."""
    x = torch.as_tensor(np.asarray(solver.mesh.centers[0]),
                        device=state.rho.device)
    bump = 1.0 + 0.4 * (torch.abs(x - x[len(x) // 2]) < 0.1).float()
    bump = bump.reshape((-1,) + (1,) * (state.rho.ndim - 1))
    return state._replace(rho=state.rho * bump, rhoE=state.rhoE * bump)


def summed(results, key="launches"):
    """Launch counts summed over ranks and jobs."""
    total = {}
    for rank in results:
        for job in rank:
            for k, v in job[key].items():
                total[k] = total.get(k, 0) + v
    return total


def phases_sharded(dev, card, launches):
    """Phases 15-19.  Returns the kernels-line entries of K3 and K5: the
    flagged kernels of one step on rank 0's block (launches summed over the
    sharded runs' ranks; the CLI's ranks are not counted).  K5's varsc
    runs are the path of `qgd3d_sensor`: launches["qgd3d_sensor"] gets
    their launches."""
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
    from qgdsolver_tpu_torch.parallel import sharding

    steps = 10
    jet, jet_fs, jet_state = warm_global("supersonic_jet", SHAPE,
                                         F.build_fused_step, dev)
    varsc, _, varsc_state = warm_global("supersonic_jet_varsc", SHAPE,
                                        F.build_fused_step, dev)
    varsc_state = with_bump(varsc, varsc_state)
    warm3 = {n: warm_global(n, SHAPE3, F3.build_fused_step_3d, dev)
             for n in CASES3}
    ref = {"jet": serial_kernel_state(jet, jet_state, F.build_fused_step),
           "varsc": serial_kernel_state(varsc, varsc_state,
                                        F.build_fused_step)}
    for n, (solver, _, state) in warm3.items():
        ref[n] = serial_kernel_state(solver, state, F3.build_fused_step_3d)
    check(ref["varsc"].sc.max() > ref["varsc"].sc.min() + 0.01,
          "phase 16: the sensor must be active")
    jet_np, varsc_np = numpy_state(jet_state), numpy_state(varsc_state)
    jobs2 = [("k3", "supersonic_jet", SHAPE, (2, 1), steps, jet_np)] + [
        ("k5", n, SHAPE3, (2, 1), steps, numpy_state(warm3[n][2]))
        for n in CASES3]
    jobs4 = [("k3", "supersonic_jet", SHAPE, (2, 2), steps, jet_np),
             ("k3", "supersonic_jet_varsc", SHAPE, (2, 2), steps, varsc_np)]
    jobs1 = [("k3", "supersonic_jet", SHAPE, (1, 1), steps, jet_np)]
    t0 = time.perf_counter()
    world2 = spawn_jobs(2, jobs2)
    world4 = spawn_jobs(4, jobs4)
    world1 = spawn_jobs(1, jobs1)
    secs = time.perf_counter() - t0
    # every flagged kernel of the path, once per step on every rank
    for results, jobs in ((world2, jobs2), (world4, jobs4), (world1, jobs1)):
        for rank in results:
            for job, (kind, name, _, grid, n, _) in zip(rank, jobs):
                for k, v in job["launches"].items():
                    want = 0 if k == "qgd3d_sensor" and "varsc" not in name \
                        else n
                    check(v == want, f"{kind} {name} {grid}: {k} launched "
                          f"{v} times, expected {want}")

    k3_stats, k5_stats = {"err": 0.0}, {"err": 0.0}
    msg2x1 = held(ref["jet"], world2[0][0]["state"], bitwise=True)
    msg2x2 = held(ref["jet"], world4[0][0]["state"], bitwise=False,
                  split=True)
    blocks_msg, k3_calls = flagged_blocks_2d(jet, jet_fs,
                                             sharding.ProcessGrid(2, 2),
                                             k3_stats)
    print(f"phase 15 K3 on the jet {SHAPE}, {steps} steps from the warm "
          f"state: 2x1 {msg2x1}; 2x2 {msg2x2} (vs the serial kernel path) "
          f"| {blocks_msg} | launches per rank "
          f"{world4[0][0]['launches']} (2x2)", flush=True)
    msg16 = held(ref["varsc"], world4[0][1]["state"], bitwise=False,
                 f_tol=2e-5)
    print(f"phase 16 K3 on the varsc + qgdFlux jet {SHAPE} with a density "
          f"bump, 2x2: {msg16}; sensor range "
          f"{ref['varsc'].sc.min():.3f}-{ref['varsc'].sc.max():.3f}",
          flush=True)
    msgs17, k5_calls = [], None
    for i, n in enumerate(CASES3):
        got = world2[0][1 + i]["state"]
        # the varsc jet too: its rings divide exactly on both sides
        msg = held(ref[n], got, bitwise=True)
        solver, fs, _ = warm3[n]
        slab_msg, calls = flagged_slabs_3d(solver, fs,
                                           sharding.ProcessGrid(2, 1),
                                           k5_stats)
        k5_calls = k5_calls or calls
        msgs17.append(f"{n}: {msg} | flagged kernels vs plain: {slab_msg}")
    print(f"phase 17 K5 x-ring of 2 {SHAPE3}, {steps} steps: "
          + "; ".join(msgs17), flush=True)
    msg18 = held(ref["jet"], world1[0][0]["state"], bitwise=True)
    with tempfile.TemporaryDirectory() as root:
        cli_msg = phase_cli_devices(dev, root)
    print(f"phase 18 one-rank NCCL K3 on the jet {SHAPE}: {msg18} | {cli_msg}",
          flush=True)

    # phase 19: the times
    k_step, to_f, _ = F.build_fused_step(jet)
    box = [to_f(jet_state)]

    def advance():
        box[0] = k_step(box[0])

    serial_ms = cuda_ms(advance, 50)
    runs = [("K3 jet 2x1", world2[0][0]), ("K3 jet 2x2", world4[0][0]),
            ("K3 varsc jet 2x2", world4[0][1]),
            ("K5 duct 2x1", world2[0][1]), ("K5 varsc jet 2x1", world2[0][2]),
            ("K3 jet 1 rank NCCL", world1[0][0])]
    entries = []
    for label, kstats, calls, src, repl, kernels in (
            ("k3_sharded_step", k3_stats, k3_calls, CSRC + "qgd2d.cu",
             "qgdsolver_tpu/ops/fused_qgd2d.py:1166", F.SHARDED_KERNELS),
            ("k5_sharded_step", k5_stats, k5_calls, CSRC + "qgd3d.cu",
             "qgdsolver_tpu/ops/fused_qgd3d.py:930", F3.SHARDED_KERNELS)):
        # timed on the plain jet / duct: the step without a sensor
        kern, plain, shape = calls
        names = [k.__name__ for k in kernels]
        ops = count_ops(plain)
        b_ms, b_by = bound(sum(work_bytes(k, shape) for k in names
                               if k.endswith(("fold", "update", "ghosts"))),
                           ops)
        total = summed(world2 + world4 + world1)
        launches["qgd3d_sensor"] = total["qgd3d_sensor"]
        entries.append({
            "name": label, "route": "cuda", "source": src, "replaces": repl,
            "launches": sum(v for k, v in total.items() if k in names),
            "max_abs_err": kstats["err"],
            "ms": device_ms(kern, 20, match="qgd"),
            "plain_ms": device_ms(plain, 5), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "ops": ops,
            "kernels": names, "block": list(shape)})
    print("phase 19 time (" + SHARED + "): " + "; ".join(
        f"{label} {r['ms_step']:.4f} ms/step (exchange share "
        f"{r['exchange']:.3f}, MAX all-reduce share {r['all_reduce']:.3f})"
        for label, r in runs)
        + f" | serial kernel path {serial_ms:.4f} ms/step: the one-rank "
        f"NCCL wrapper costs {world1[0][0]['ms_step'] - serial_ms:+.4f} "
        f"ms/step | one step's flagged kernels on rank 0's block, device ms "
        + ", ".join(f"{e['name']} {e['ms']:.4f} vs plain {e['plain_ms']:.4f}"
                    f" (bound {e['bound_ms']:.4f}, {e['bound_by']})"
                    for e in entries)
        + f" | worlds spawned and run in {secs:.1f} s | card: {card}",
        flush=True)
    return entries


def phase_cli_devices(dev, root) -> str:
    """Phase 18's CLI part: `python -m qgdsolver_tpu_torch <case> --devices
    2x1 --device cuda --max-steps 50` on a 1024x512 jet case against a
    serial CLI run of the same case: the log names K3's builder and the
    gloo backend, one write, the written fields within 1e-5."""
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F

    serial, sharded = (write_case(root, n, SHAPE, varsc=False)
                       for n in ("serial", "2x1"))
    log, secs, _ = run_cli([serial, "--max-steps", "50", "--device", "cuda"],
                           F.KERNELS)
    check("fused kernel path engaged: build_fused_step" in log,
          f"serial CLI did not take K1:\n{log}")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "qgdsolver_tpu_torch",
                          sharded, "--devices", "2x1", "--device", "cuda",
                          "--max-steps", "50"], capture_output=True,
                         text=True, timeout=600)
    secs2 = time.perf_counter() - t0
    check(run.returncode == 0, f"CLI --devices 2x1 failed:\n{run.stdout}\n"
          f"{run.stderr[-4000:]}")
    out = run.stdout
    check("build_sharded_fused_step (2x1 ranks)" in out,
          f"the CLI did not take K3:\n{out}")
    check("backend gloo" in out, f"the CLI did not log gloo:\n{out}")
    writes = re.findall(r"writing fields to (\S+)", out)
    check(len(writes) == 1, f"{len(writes)} writes:\n{out}")
    a, b = latest_state(serial, dev)[1], latest_state(sharded, dev)[1]
    check(float(a.t) == float(b.t), f"times {float(a.t)} vs {float(b.t)}")
    worst = max(rel_err(getattr(a, f), getattr(b, f))
                for f in ("rho", "rhoU", "rhoE"))
    check(worst <= 1e-5, f"CLI --devices 2x1 fields rel {worst:.2e}")
    return (f"CLI --devices 2x1 (K3, gloo): 50 steps + one write in "
            f"{secs2:.1f} s (serial CLI {secs:.1f} s), written fields vs "
            f"the serial CLI's rel {worst:.2e} at t={float(b.t):.4e}")


# maxRatio of fvc::smooth beyond the cases' 1 + smoothCoeff that the
# division-free ring is held to
RATIOS = (1.01, 1.05, 1.2, 1.5, 2.0)


def phase_ring_check(dev, card):
    """Phase 20: the smoothing kernels' division-free ring against a
    correctly rounded division on every float of `smooth_ring_check`'s
    ranges, for each case's maxRatio and RATIOS: no mismatch."""
    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.ops import smoothing as S

    ratios = set()
    for name in CASES + CASES3:
        shape = (8, 6, 6) if name in CASES3 else (8, 6)
        tm = getattr(cases, name)(shape=shape, device=dev)[0].tau_model
        if hasattr(tm, "smoothCoeff"):
            ratios.add(1.0 + tm.smoothCoeff)
    for r in sorted(ratios) + list(RATIOS):
        bad = S.smooth_ring_check(r, dev)
        check(not any(bad.values()), f"the division-free ring is not exact "
              f"for maxRatio {r}: {bad}")
    print(f"phase 20 division-free ring vs __fdiv_rn on every float of "
          f"{'; '.join(S.RING_RANGES)}: 0 mismatches for the cases' maxRatio "
          f"{', '.join(f'{r:g}' for r in sorted(ratios))} and for "
          f"{', '.join(f'{r:g}' for r in RATIOS)} | card: {card}", flush=True)


def slice_run(label, build, n, card, cpu_steps=3, share=1e-3):
    """One run of phase 21: build(device) -> (solver, state) on the card
    and on the CPU (float32 both); the card's first cpu_steps steps held
    within `share` of each field's max against the CPU's, then n steps on
    the card, each timed by CUDA events, with the CG's iterations and the
    host reads a step; check_physical on the end state.  The share is the
    f32 bound the kernel paths are held to (fields within 1e-3 of their
    max): a flow starting from rest has momenta of a few steps' pressure
    differences, ~1e-3 of a pressure of 1e5, so an f32 rounding of p is
    ~1e-4 of the momentum's max."""
    from qgdsolver_tpu_torch.ops import linsolve
    from qgdsolver_tpu_torch.solvers import common

    solver, s0 = build(torch.device("cuda", 0))
    check(not solver.fused_supported(), f"{label}: a fused gate took it")
    csolver, c0 = build(torch.device("cpu"))
    step, cstep = solver.make_step(), csolver.make_step()
    s, c = s0, c0
    errs = {}
    for _ in range(cpu_steps):
        s, c = step(s), cstep(c)
    for f in ("rho", "rhoU", "rhoE", "dt"):
        errs[f] = rel_err(getattr(c, f), getattr(s, f).cpu())
        check(errs[f] <= share, f"{label}: {f} {errs[f]:.2e} of its max "
              f"from the CPU's after {cpu_steps} steps (> {share:g})")
    linsolve.reset_counts()
    box = [s]

    def one():
        box[0] = step(box[0])

    ms = cuda_ms(one, n, warmup=0)
    solves = linsolve.cg.solves
    iters = (int(linsolve.cg.iterations) / solves) if solves else 0.0
    reads = linsolve.cg.reads / n
    # the CG reads its stop test once a group of iterations, plus once
    if solves:
        check(linsolve.cg.reads <= int(linsolve.cg.iterations)
              / linsolve.CG_GROUP + 2 * solves,
              f"{label}: {linsolve.cg.reads} host reads for {solves} solves")
    phys = check_physical(label, solver, box[0])
    return (f"{label}: {ms:.3f} ms/step over {n} steps, "
            f"{iters:.2f} CG iterations/solve ({solves} solves), "
            f"{reads:.2f} host reads/step; first {cpu_steps} steps vs the "
            f"CPU " + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
            + f" (share {share:g}); {phys}")


def cg_group_ab(build, n):
    """{group: [ms/step, ...]} of build(card)'s step with the CG's groups
    of CG_GROUP and of 16 iterations, A B B A (cg's default group set for
    the other runs): an iteration run frozen past the stop against a host
    read a group."""
    from qgdsolver_tpu_torch.ops import linsolve

    solver, s = build(torch.device("cuda", 0))
    step = solver.make_step()
    box, out = [s], {}

    def one():
        box[0] = step(box[0])

    kw = linsolve.cg.__kwdefaults__
    try:
        for g in (linsolve.CG_GROUP, 16, 16, linsolve.CG_GROUP):
            kw["group"] = g
            out.setdefault(g, []).append(cuda_ms(one, n, warmup=1))
    finally:
        kw["group"] = linsolve.CG_GROUP
    return out


def phase_slice(dev, card, root):
    """Phase 21: QGDFoam beyond the fused kernels, at 1024x512 float32 on
    the composable path.  (a) the case CLI on tests/fixtures/jet_case with
    its `implicitDiffusion false;` line removed (the default, implicit
    diffusion, runs: two CG Helmholtz solves a step), 20 steps, no fused
    kernel launched; then the case through build_case as (a') below.
    (b) tests/fixtures/jet_coflow_case (a Segmented inlet side: jet and
    coflow patches, an inletOutlet top, slip bottom) with a
    waveTransmissive p outlet; (b') the same case with its outlet split
    into two patches, the lower a waveTransmissive segment of p and T (a
    Segmented outlet side whose segment carries its face values);
    (c) cases.wedge_blob.  Each of (a'), (b), (b') and (c): its first 3
    steps against the same run on the CPU, 20 timed steps,
    check_physical; and (a') timed with the CG's groups of CG_GROUP and
    of 16 iterations, A B B A."""
    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.io import foam_case
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3

    t0 = time.perf_counter()
    nx, ny = SHAPE
    jet = fixture_case(root, "jet_case", "jet_implicit", [
        ("system/blockMeshDict", r"\(64 32 1\)", "(%d %d 1)" % SHAPE),
        ("constant/thermophysicalProperties",
         r"\n\s*implicitDiffusion\s+false;", "")])
    check(foam_case.build_case(jet, device="cpu")[0].implicit_diffusion,
          "implicitDiffusion absent must read as true")
    log, secs, launches = run_cli([jet, "--max-steps", "20", "--device",
                                   "cuda"], F.KERNELS + F3.KERNELS)
    check("composable step engaged: make_step" in log,
          f"the CLI did not take the composable step:\n{log}")
    check(not any(launches.values()), f"CLI launched kernels {launches}")
    msgs = [f"(a) CLI 20 steps in {secs:.1f} s"]
    msgs.append(slice_run("(a') jet_case implicit",
                          lambda d: foam_case.build_case(jet, device=d),
                          20, card))
    ab = cg_group_ab(lambda d: foam_case.build_case(jet, device=d), 10)
    msgs.append("(a') CG groups A B B A, ms/step: " + "; ".join(
        f"of {g}: " + ", ".join(f"{t:.3f}" for t in ts)
        for g, ts in ab.items()))
    coflow = fixture_case(root, "jet_coflow_case", "coflow_wt", [
        ("system/blockMeshDict", r"\(64 16 1\)(.*?)\(64 16 1\)",
         "(%d %d 1)\\1(%d %d 1)" % (nx, ny // 2, nx, ny // 2)),
        ("0/p", r"outlet\s*\{[^}]*\}",
         "outlet { type waveTransmissive; fieldInf 101325; lInf 0.5; "
         "value uniform 101325; }")])

    def build_coflow(d):
        solver, state = foam_case.build_case(coflow, device=d)
        check(solver.mesh.shape == SHAPE and len(state.wt) == 1,
              "coflow case: shape or waveTransmissive carry")
        return solver, state

    msgs.append(slice_run("(b) jet_coflow_case Segmented + waveTransmissive",
                          build_coflow, 20, card))
    # (b') the outlet split into two patches, its lower one a
    # waveTransmissive segment of p and T carrying its face values
    split = fixture_case(root, "jet_coflow_case", "coflow_wt_split", [
        ("system/blockMeshDict", r"\(64 16 1\)(.*?)\(64 16 1\)",
         "(%d %d 1)\\1(%d %d 1)" % (nx, ny // 2, nx, ny // 2)),
        ("system/blockMeshDict",
         r"outlet\s*\{ type patch; faces \(\(1 2 6 5\) \(2 9 11 6\)\); \}",
         "outletLow { type patch; faces ((1 2 6 5)); }\n"
         "    outletHigh { type patch; faces ((2 9 11 6)); }"),
        ("0/p", r"outlet\s*\{[^}]*\}",
         "outletLow { type waveTransmissive; fieldInf 101325; lInf 0.5; "
         "value uniform 101325; }\n    outletHigh { type zeroGradient; }"),
        ("0/T", r"outlet\s*\{[^}]*\}",
         "outletLow { type waveTransmissive; fieldInf 300; "
         "value uniform 300; }\n    outletHigh { type zeroGradient; }")])

    def build_split(d):
        from qgdsolver_tpu_torch.core import bc as bcm

        solver, state = foam_case.build_case(split, device=d)
        segs = [w[4] for w in solver._wt_sides()]
        check(solver.mesh.shape == SHAPE and len(state.wt) == 2
              and isinstance(solver.bc_p[0, 1], bcm.Segmented)
              and None not in segs,
              "split coflow case: shape or waveTransmissive segments")
        return solver, state

    msgs.append(slice_run("(b') jet_coflow_case split outlet, "
                          "waveTransmissive segment", build_split, 20, card))
    msgs.append(slice_run(
        "(c) wedge_blob",
        lambda d: cases.wedge_blob(SHAPE, torch.float32, device=d), 20,
        card))
    print(f"phase 21 QGDFoam composable slice {SHAPE} f32: ok "
          + " | ".join(msgs)
          + f" | {time.perf_counter() - t0:.1f} s | card: {card}",
          flush=True)


@contextlib.contextmanager
def solve_log():
    """Record each Helmholtz solve of the step as (kind, iterations): p for
    the singular pressure solve, U for a vector solve, T (or e) for the
    rest.  The iteration counts stay on the device until read."""
    from qgdsolver_tpu_torch.ops import linsolve

    orig = linsolve.solve_helmholtz
    log = []

    def logged(**kw):
        res = orig(**kw)
        kind = ("p" if kw.get("singular") else
                "U" if kw.get("vector") else "T")
        log.append((kind, res.iters))
        return res

    linsolve.solve_helmholtz = logged
    try:
        yield log
    finally:
        linsolve.solve_helmholtz = orig


def iters_per_solve(log) -> dict:
    """{kind: mean CG iterations a solve} of a solve_log."""
    out = {}
    for kind in ("p", "U", "T"):
        its = [int(i) for k, i in log if k == kind]
        if its:
            out[kind] = sum(its) / len(its)
    return out


def state_gap(ref, got) -> dict:
    """{field: max |got - ref| over max |ref|} of two States' tensor
    fields (got on any device)."""
    return {f: rel_err(a.double(), b.cpu().double())
            for f, a, b in zip(ref._fields, ref, got)
            if torch.is_tensor(a)}


def qhd_checks(label, s) -> str:
    """Finite fields, and for the cavities T within its walls' bounds (the
    maximum principle); a summary."""
    for f, x in zip(s._fields, s):
        check(bool(torch.isfinite(x).all()), f"{label}: {f} not finite")
    if hasattr(s, "p"):
        tmax, tmin = float(s.T.max()), float(s.T.min())
        check(-1.0 - 1e-6 < tmin and tmax < 1.0 + 1e-6,
              f"{label}: T in [{tmin}, {tmax}] outside the walls' [-1, 1]")
        return (f"t={float(s.t):.4e} max|U| {float(s.U.abs().max()):.3e} "
                f"T in [{tmin:.4f}, {tmax:.4f}]")
    return f"t={float(s.t):.4e} T in [{float(s.T.min()):.4f}, " \
        f"{float(s.T.max()):.4f}]"


def family_run(label, build, n, cpu_steps=3, checks=None):
    """One run of phase 22 (and 23): build(device) -> (solver, state) on
    the card and on the CPU, in the build's dtype.  The card's first
    cpu_steps steps are held against the CPU's, each field within its
    bound of the field's max: float64 without a CG 1e-9, with one
    2*n*cg_tol (the solves stop at |r| <= cg_tol*|b|, their dots summed in
    another order), float32 1e-3 (the kernel paths' bound).  Then n steps
    on the card after one of warm-up, timed by CUDA events, with the CG
    iterations a solve by kind (p, U, T) and the host reads a step;
    checks(label, first state, last state) -> summary, when given, checks
    the end state (else the QGD or QHD cavity checks)."""
    from qgdsolver_tpu_torch.ops import linsolve

    solver, s = build(torch.device("cuda", 0))
    s_first = s
    check(not (hasattr(solver, "fused_supported")
               and solver.fused_supported()), f"{label}: a fused gate took it")
    csolver, c = build(torch.device("cpu"))
    step, cstep = solver.make_step(), csolver.make_step()
    f64 = solver.mesh.dtype == torch.float64
    with solve_log() as log:
        for _ in range(cpu_steps):
            s, c = step(s), cstep(c)
    uses_cg = bool(log)
    share = (2 * cpu_steps * solver.cg_tol if uses_cg else 1e-9) if f64 \
        else 1e-3
    gaps = state_gap(c, s)
    for f, g in gaps.items():
        check(g <= share, f"{label}: {f} {g:.2e} of its max from the CPU's "
              f"after {cpu_steps} steps (> {share:g})")
    box = [step(s)]

    def one():
        box[0] = step(box[0])

    linsolve.reset_counts()
    with solve_log() as log:
        ms = cuda_ms(one, n, warmup=0)
    its = iters_per_solve(log)
    reads = linsolve.cg.reads / n
    if log:
        check(linsolve.cg.reads <= sum(int(i) for _, i in log)
              / linsolve.CG_GROUP + 2 * len(log),
              f"{label}: {linsolve.cg.reads} host reads for {len(log)} "
              "solves")
    phys = (checks(label, s_first, box[0]) if checks is not None else
            check_physical(label, solver, box[0]) if hasattr(box[0], "rho")
            else qhd_checks(label, box[0]))
    cg = ", ".join(f"{k} {v:.1f}" for k, v in its.items()) or "none"
    return (f"{label}: {ms:.3f} ms/step over {n} steps, CG iterations/solve "
            f"{cg}, {reads:.2f} host reads/step; first {cpu_steps} steps vs "
            f"the CPU max " + f"{max(gaps.values()):.1e}"
            + f" (bound {share:g}); {phys}")


def jet_variant(kind, dev):
    """The supersonic jet's mesh and BCs (1024x512 f32) as rhoQGDFoam with
    a stiffened gas (p_inf 2e5: rho = (p + p_inf)/(R T)) or as zQGDFoam,
    from the jet's initial p, T and U."""
    import dataclasses

    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.physics import thermo as tm
    from qgdsolver_tpu_torch.solvers.rho_qgd import RhoQGDFoam
    from qgdsolver_tpu_torch.solvers.zqgd import ZQGDFoam

    jet, s = cases.supersonic_jet(SHAPE, torch.float32, device=dev)
    U, _, T, p = jet.primitives(s)
    kw = {f.name: getattr(jet, f.name) for f in dataclasses.fields(ZQGDFoam)}
    if kind == "rho":
        kw["thermo"] = tm.RhoThermo(eos=tm.StiffenedGasEoS(R=287.0,
                                                           p_inf=2e5),
                                    Cp=1004.5, R=287.0)
        solver = RhoQGDFoam(**kw)
    else:
        solver = ZQGDFoam(**kw)
    return solver, solver.init(p0=p, T0=T, U0=U)


def phase_family(card):
    """Phase 22: the static-mesh QHD family, scalar transport, rhoQGDFoam
    and zQGDFoam on the composable path (torch ops; the reference has no
    Pallas kernel for any of them): the buoyant cavity (QHDFoam, 128x128
    and 512x512 f64, BASELINE.json config 2), the cavity as SRFQHDFoam
    (omega (0, 0, 1)) and as mulesQHDFoam, the scalar box (64x64 f64,
    config 1), and the 1024x512 f32 jet as rhoQGDFoam with a stiffened gas
    (config 5) and as zQGDFoam, each through `family_run`; and the 128x128
    cavity timed with the CG's groups of CG_GROUP and of 16 iterations,
    A B B A (`cg_group_ab`)."""
    import dataclasses

    from qgdsolver_tpu_torch import cases

    t0 = time.perf_counter()

    def cavity(shape, **over):
        def build(d):
            solver, s = cases.buoyant_cavity(shape, device=d)
            return dataclasses.replace(solver, **over), s
        return build

    msgs = [
        family_run("QHDFoam cavity 128x128", cavity((128, 128)), 10),
        "QHDFoam cavity 128x128 CG groups A B B A, ms/step: " + "; ".join(
            f"of {g}: " + ", ".join(f"{t:.3f}" for t in ts)
            for g, ts in cg_group_ab(cavity((128, 128)), 5).items()),
        family_run("QHDFoam cavity 512x512", cavity((512, 512)), 3),
        family_run("SRFQHDFoam cavity 128x128 omega (0, 0, 1)",
                   cavity((128, 128), omega=(0.0, 0.0, 1.0)), 10),
        family_run("mulesQHDFoam cavity 128x128",
                   cavity((128, 128), t_equation="mules"), 10),
        family_run("scalarTransportQHDFoam box 64x64",
                   lambda d: cases.scalar_box((64, 64), device=d), 20),
        family_run(f"rhoQGDFoam stiffened-gas jet {SHAPE} f32",
                   lambda d: jet_variant("rho", d), 20),
        family_run(f"zQGDFoam jet {SHAPE} f32",
                   lambda d: jet_variant("z", d), 20),
    ]
    print("phase 22 QHD family, scalar transport, rhoQGDFoam, zQGDFoam "
          "(composable, torch ops): ok " + " | ".join(msgs)
          + f" | {time.perf_counter() - t0:.1f} s | card: {card}",
          flush=True)


def finite(label, s):
    for f, x in zip(s._fields, s):
        if torch.is_tensor(x):
            check(bool(torch.isfinite(x).all()), f"{label}: {f} not finite")


def bounded_alpha(label, s, first, rtol):
    """alpha1 within [0, 1] and its volume (sum of alpha*V) within rtol of
    the first state's; a summary."""
    finite(label, s)
    a, a0 = s.alpha1.double(), first.alpha1.double()
    lo, hi = float(a.min()), float(a.max())
    check(-1e-12 <= lo and hi <= 1.0 + 1e-12,
          f"{label}: alpha1 in [{lo}, {hi}] outside [0, 1]")
    vol = float(a.sum()) / float(a0.sum()) - 1.0
    check(abs(vol) <= rtol, f"{label}: alpha volume drift {vol:.2e} "
          f"(> {rtol:g})")
    return (f"t={float(s.t):.4e} alpha1 in [{lo:.3g}, {hi:.3g}], volume "
            f"drift {vol:.1e} (bound {rtol:g}), max|U| "
            f"{float(s.U.abs().max()):.3e}")


def piston(dev, n=(512, 128)):
    """tests/test_dym.py's piston channel at n cells, its face
    trajectories tensors on `dev` (general motion, `mesh_faces`): the left
    wall advances at 0.2 into a channel whose right end is open."""
    from qgdsolver_tpu_torch.core import bc
    from qgdsolver_tpu_torch.core.mesh import Mesh
    from qgdsolver_tpu_torch.physics.qgdcoeffs import ConstTau
    from qgdsolver_tpu_torch.physics.thermo import RhoConstThermo
    from qgdsolver_tpu_torch.solvers.common import TimeControls
    from qgdsolver_tpu_torch.solvers.qhd_dym import QHDDyMFoam

    f64 = torch.float64
    mesh = Mesh.uniform(n, lengths=(1.0, 0.25), dtype=f64, device=dev)
    x0 = torch.linspace(0.0, 1.0, n[0] + 1, dtype=f64, device=dev)
    y0 = torch.linspace(0.0, 0.25, n[1] + 1, dtype=f64, device=dev)
    v_p = 0.2

    def faces(t):
        left = v_p * t
        return left + (1.0 - left) * x0, y0

    zg, slip = bc.ZeroGradient(), bc.Symmetry()
    solver = QHDDyMFoam(
        mesh_faces=faces, mesh=mesh,
        thermo=RhoConstThermo(rho0=1.0, Cp=1000.0, mu0=1e-4, Pr=1.0),
        tau_model=ConstTau(tau0=2e-3),
        bc_U=bc.FieldBCs(((bc.FixedValue([v_p, 0.0]), zg), (slip, slip))),
        bc_T=bc.FieldBCs.uniform(zg, 2),
        bc_p=bc.FieldBCs(((zg, bc.FixedValue(0.0)), (zg, zg))),
        time=TimeControls(max_co=0.3, max_dt=2e-3, dt0=1e-4), cg_tol=1e-12)
    return solver, solver.init(torch.zeros((2,) + n, dtype=f64, device=dev),
                               torch.zeros(n, dtype=f64, device=dev))


def drop(dev, n=256):
    """tests/test_inter_qhd.py's drop (R 0.2 in the unit box, 1000:1
    densities, cg_tol 1e-9) at n x n, with surface tension 0.07 and no
    gravity: a static drop."""
    from qgdsolver_tpu_torch.core.mesh import Mesh
    from qgdsolver_tpu_torch.physics.twophase import TwoPhaseProperties
    from qgdsolver_tpu_torch.solvers.common import TimeControls
    from qgdsolver_tpu_torch.solvers.inter_qhd import InterQHDFoam

    mesh = Mesh.uniform((n, n), dtype=torch.float64, device=dev)
    solver = InterQHDFoam(
        mesh=mesh, props=TwoPhaseProperties(
            rho1=1000.0, rho2=1.0, nu1=1e-6, nu2=1.5e-5, tau1=2e-4,
            tau2=2e-4, sigma=0.07, c_alpha=1.0),
        g=(0.0, 0.0), time=TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-4),
        cg_tol=1e-9)
    x = mesh.centers[0][:, None] * np.ones(mesh.shape)
    y = mesh.centers[1][None, :] * np.ones(mesh.shape)
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
    return solver, solver.init(
        torch.zeros((2, n, n), dtype=torch.float64, device=dev),
        mesh.tensor((r < 0.2) * 1.0))


def gcl_run(label, motion, n=256, steps=50):
    """Uniform T and U on a moving n x n grid (zeroGradient sides) for
    `steps` steps on the card: the discrete GCL keeps them uniform; the
    largest drift of each relative to its value."""
    from qgdsolver_tpu_torch.core import bc
    from qgdsolver_tpu_torch.core.mesh import Mesh
    from qgdsolver_tpu_torch.physics.qgdcoeffs import ConstTau
    from qgdsolver_tpu_torch.physics.thermo import RhoConstThermo
    from qgdsolver_tpu_torch.solvers import common
    from qgdsolver_tpu_torch.solvers.qhd_dym import QHDDyMFoam

    dev, f64 = torch.device("cuda", 0), torch.float64
    x0 = torch.linspace(0.0, 1.0, n + 1, dtype=f64, device=dev)
    zg = bc.FieldBCs.uniform(bc.ZeroGradient(), 2)
    solver = QHDDyMFoam(
        mesh=Mesh.uniform((n, n), dtype=f64, device=dev),
        thermo=RhoConstThermo(rho0=1.0, Cp=1000.0, mu0=1e-3, Pr=1.0),
        tau_model=ConstTau(tau0=1e-4), bc_U=zg, bc_T=zg, bc_p=zg,
        time=common.TimeControls(adjust_time_step=False, dt0=5e-3),
        cg_tol=1e-12, **motion(x0))
    U0 = torch.stack([torch.full((n, n), 0.8, dtype=f64, device=dev),
                      torch.full((n, n), -0.3, dtype=f64, device=dev)])
    s = common.run_steps(solver.make_step(), solver.init(
        U0, torch.full((n, n), 3.7, dtype=f64, device=dev)), steps)
    dT = float((s.T - 3.7).abs().max()) / 3.7
    dU = max(float((s.U[0] - 0.8).abs().max()) / 0.8,
             float((s.U[1] + 0.3).abs().max()) / 0.3)
    check(dT <= 1e-9 and dU <= 1e-9, f"{label}: uniform fields drifted "
          f"(T {dT:.2e}, U {dU:.2e} of their values > 1e-9)")
    return (f"{label} GCL {n}x{n}, {steps} steps to t={float(s.t):.3f}: "
            f"uniform T drift {dT:.1e}, U {dU:.1e} (bound 1e-9)")


def cli_write_read(case, dev, steps, fields):
    """The case CLI for `steps` steps on the card (composable step, no
    kernel launched, one write at the end), the written fields read back
    through build_case against the same steps run directly; a summary."""
    from qgdsolver_tpu_torch.io import foam_case
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
    from qgdsolver_tpu_torch.solvers import common

    solver, s = foam_case.build_case(case, device=dev)
    ref = common.run_steps(solver.make_step(), s, steps)
    log, secs, launches = run_cli([case, "--max-steps", str(steps),
                                   "--device", "cuda"],
                                  F.KERNELS + F3.KERNELS)
    check("composable step engaged: make_step" in log,
          f"the CLI did not take the composable step:\n{log}")
    check(not any(launches.values()), f"CLI launched kernels {launches}")
    _, back = latest_state(case, dev)
    gaps = {f: rel_err(getattr(ref, f), getattr(back, f)) for f in fields}
    for f, g in gaps.items():
        # written with 12 significant digits
        check(g <= 1e-9, f"{case}: {f} read back {g:.2e} from the run")
    check(abs(float(back.t) - float(ref.t)) <= 1e-6 * float(ref.t),
          f"{case}: read back t {float(back.t)} against {float(ref.t)}")
    return (f"CLI {os.path.basename(case)} {steps} steps in {secs:.1f} s, "
            f"written and read back: " + ", ".join(
                f"{f} {g:.1e}" for f, g in gaps.items()))


def wedge_film_case(root) -> str:
    """tests/fixtures/wedge_case as an interQHDFoam case (water and air,
    sigma 0.07, an inflow of 0.05 m/s at x = 0, noSlip at the outer wall;
    tests/test_torch_inter_qhd.py's edit)."""
    case = fixture_case(root, "wedge_case", "wedge_film", [
        ("system/controlDict", r"application\s+QGDFoam;",
         "application     interQHDFoam;"),
        ("0/p", r"uniform 101325", "uniform 0")])
    os.remove(os.path.join(case, "0", "T"))
    files = {
        "constant/transportProperties":
            "FoamFile { version 2.0; format ascii; class dictionary; "
            "object transportProperties; }\nphases (water air);\n"
            "water { nu 1e-06; rho 1000; }\nair   { nu 1.48e-05; rho 1; }\n"
            "tauwater 1e-5;\ntauair 1e-5;\nsigma 0.07;\n",
        "0/alpha.water":
            "FoamFile { version 2.0; format ascii; class volScalarField; "
            "object alpha.water; }\ninternalField uniform 0;\n"
            "boundaryField { inlet { type zeroGradient; } "
            "outlet { type zeroGradient; } axis { type empty; } "
            "outer { type zeroGradient; } front { type wedge; } "
            "back { type wedge; } }\n",
        "0/U":
            "FoamFile { version 2.0; format ascii; class volVectorField; "
            "object U; }\ninternalField uniform (0 0 0);\n"
            "boundaryField { inlet { type fixedValue; "
            "value uniform (0.05 0 0); } outlet { type zeroGradient; } "
            "axis { type empty; } outer { type noSlip; } "
            "front { type wedge; } back { type wedge; } }\n"}
    for rel, text in files.items():
        with open(os.path.join(case, rel), "w") as f:
            f.write(text)
    return case


def wedge_film_run(root, cpu_steps=3, steps=30) -> str:
    """interQHDFoam's annular film on the wedge fixture, float64: the
    card's first cpu_steps steps with the CPU's CG counts and within 1e-9
    of each field's max from the CPU's, then the rest of `steps` free
    steps on the card, timed:
    finite, alpha in [0, 1], and every solve stopped by its test before
    cg_maxiter with its unweighted residual within 10*cg_tol (the CG on
    V*A; the JAX package's stalls at cg_maxiter here)."""
    from qgdsolver_tpu_torch.io import foam_case
    from qgdsolver_tpu_torch.ops import linsolve

    case = wedge_film_case(root)

    def build(d):
        solver, s = foam_case.build_case(case, device=d)
        check(solver.mesh.axisymmetric and solver.mesh.dtype == torch.float64,
              "wedge film: not a float64 wedge")
        r = solver.mesh.centers[1]
        dr = float(solver.mesh.dx[1][0])
        a0 = np.broadcast_to(0.5 * (1.0 + np.tanh((r[None, :] - 0.35)
                                                  / (2.0 * dr))),
                             solver.mesh.shape)
        return solver, s._replace(alpha1=solver.mesh.tensor(a0))

    solver, s = build(torch.device("cuda", 0))
    csolver, c = build(torch.device("cpu"))
    step, cstep = solver.make_step(), csolver.make_step()
    with linsolve.true_residuals() as card_log:
        for _ in range(cpu_steps):
            s = step(s)
    with linsolve.true_residuals() as cpu_log:
        for _ in range(cpu_steps):
            c = cstep(c)
    counts = [x[0] for x in card_log], [x[0] for x in cpu_log]
    check(counts[0] == counts[1], f"wedge film: CG counts {counts[0]} on "
          f"the card against {counts[1]} on the CPU")
    gaps = state_gap(c, s)
    for f, g in gaps.items():
        check(g <= 1e-9, f"wedge film: {f} {g:.2e} of its max from the "
              f"CPU's after {cpu_steps} steps (> 1e-9)")
    box = [s]

    def one():
        box[0] = step(box[0])

    with linsolve.true_residuals() as log:
        ms = cuda_ms(one, steps - cpu_steps, warmup=0)
    log = card_log + log
    # p's solves are of a cell field, U's of a vector field
    p_its = [x[0] for x in log if x[3] == solver.mesh.ndim]
    check(len(p_its) == steps, f"wedge film: {len(p_its)} p solves in "
          f"{steps} steps")
    for it, res, maxiter, _ in log:
        check(it < maxiter and res <= 10 * solver.cg_tol,
              f"wedge film: a solve took {it} iterations (cap {maxiter}) "
              f"to |b - A x|/|b| {res:.2e} (bound {10 * solver.cg_tol:g})")
    finite("wedge film", box[0])
    lo, hi = float(box[0].alpha1.min()), float(box[0].alpha1.max())
    check(-1e-8 <= lo and hi <= 1.0 + 1e-8,
          f"wedge film: alpha1 in [{lo}, {hi}] outside [0, 1]")
    return (f"interQHDFoam wedge film {solver.mesh.shape} f64: {steps} free "
            f"steps, {ms:.3f} ms/step over the last {steps - cpu_steps} "
            f"(with a residual check's read a solve), alpha1 in "
            f"[{lo:.3g}, {hi:.3g}], "
            f"p {sum(p_its) / len(p_its):.1f} CG iterations a solve (cap "
            f"{solver.cg_maxiter}), largest |b - A x|/|b| "
            f"{max(x[1] for x in log):.1e} (bound "
            f"{10 * solver.cg_tol:g}); first {cpu_steps} steps vs the CPU "
            + ", ".join(f"{k} {v:.1e}" for k, v in gaps.items()
                        if k not in ("t", "dt"))
            + " (bound 1e-9, CG counts equal)")


def phase_moving_twophase(card, root):
    """Phase 23: QHDDyMFoam and interQHDFoam on the composable path
    (torch ops; the reference has no Pallas kernel for either) in float64,
    each against the CPU over its first 3 steps (`family_run`), no kernel
    launched: tests/fixtures/dym_case at 256x256 (uniformDilation with
    checkMeshCourantNo), the piston channel at 512x128 (general face
    motion), tests/fixtures/inter_case at 256x256 with a water column, and
    a static drop with surface tension at 256x256 (alpha in [0, 1], its
    volume to 1e-6); the GCL on the card (uniform fields on a dilating and
    a sloshing 256x256 grid, 50 steps); the case CLI on both edited
    fixtures with a write and a read-back; and the annular film on the
    wedge fixture, 30 free float64 steps with every solve converged
    (`wedge_film_run`)."""
    from qgdsolver_tpu_torch.io import foam_case
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    edit = [("system/blockMeshDict", r"\(24 24 1\)", "(256 256 1)")]
    dym = fixture_case(root, "dym_case", "dym_256", edit)
    with open(os.path.join(dym, "0", "p"), "w") as f:
        f.write("FoamFile { version 2.0; format ascii; class volScalarField;"
                " object p; }\ndimensions [0 2 -2 0 0 0 0];\n"
                "internalField uniform 0;\nboundaryField { left { type "
                "zeroGradient; } right { type zeroGradient; } bottom { type "
                "zeroGradient; } top { type zeroGradient; } frontAndBack "
                "{ type empty; } }\n")
    inter = fixture_case(root, "inter_case", "inter_256", edit)

    def dym_build(d):
        solver, s = foam_case.build_case(dym, device=d)
        check(solver.mesh.shape == (256, 256) and solver.check_mesh_courant
              and solver.mesh_scale is not None, "dym_case: the motion")
        return solver, s

    def inter_build(d):
        solver, s = foam_case.build_case(inter, device=d)
        y = solver.mesh.centers[1][None, :] * np.ones(solver.mesh.shape)
        return solver, s._replace(alpha1=solver.mesh.tensor((y < 0.4) * 1.0))

    def dym_checks(label, first, s):
        # the maximum principle: T within its walls' 299 and 301
        finite(label, s)
        tmin, tmax = float(s.T.min()), float(s.T.max())
        check(299.0 - 1e-9 <= tmin and tmax <= 301.0 + 1e-9,
              f"{label}: T in [{tmin}, {tmax}] outside the walls' "
              "[299, 301]")
        return f"t={float(s.t):.4e} T in [{tmin:.4f}, {tmax:.4f}]"

    def piston_checks(label, first, s):
        finite(label, s)
        u_out = float(s.U[0, -1].mean())
        check(0.0 < u_out, f"{label}: outflow {u_out} not pushed out")
        return f"t={float(s.t):.4e} outlet u {u_out:.4f} (piston 0.2)"

    runs = [
        ("QHDDyMFoam dym_case 256x256 (uniformDilation, "
         "checkMeshCourantNo)", dym_build, 10, dym_checks),
        ("QHDDyMFoam piston 512x128 (mesh_faces)", piston, 10,
         piston_checks),
        ("interQHDFoam inter_case 256x256 water column", inter_build, 5,
         lambda label, first, s: bounded_alpha(label, s, first, 5e-3)),
        ("interQHDFoam static drop 256x256 sigma 0.07", drop, 5,
         lambda label, first, s: bounded_alpha(label, s, first, 1e-6)),
    ]
    kernels = F.KERNELS + F3.KERNELS
    msgs = []
    for label, build, n, checks in runs:
        for k in kernels:
            k.launches = 0
        msgs.append(family_run(label, build, n, checks=checks))
        launched = {k.__name__: k.launches for k in kernels if k.launches}
        check(not launched, f"{label}: kernels launched {launched}")
    msgs.append(gcl_run("dilating", lambda x0: dict(
        mesh_scale=lambda t: (1.0 + 0.15 * torch.sin(3.0 * t),
                              1.0 + 0.15 * torch.sin(5.1 * t + 0.5)))))
    msgs.append(gcl_run("sloshing", lambda x0: dict(mesh_faces=lambda t: (
        x0 + 0.08 * torch.sin(3.0 * t) * torch.sin(np.pi * x0),
        x0 + 0.05 * torch.sin(5.1 * t) * x0 * (1.0 - x0)))))
    msgs.append(cli_write_read(dym, dev, 5, ("U", "T", "p")))
    msgs.append(cli_write_read(inter, dev, 5, ("U", "p", "alpha1")))
    for k in kernels:
        k.launches = 0
    msgs.append(wedge_film_run(root))
    launched = {k.__name__: k.launches for k in kernels if k.launches}
    check(not launched, f"wedge film: kernels launched {launched}")
    print("phase 23 QHDDyMFoam and interQHDFoam (composable, torch ops, "
          "f64): ok " + " | ".join(msgs)
          + f" | {time.perf_counter() - t0:.1f} s | card: {card}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 24: the Lagrangian and reacting applications (torch ops)
# ---------------------------------------------------------------------------


def cloud_of(n, lo, hi, seed, dtype, device, u=0.0, T=350.0, d=5e-5):
    """n parcels from a numpy seed, uniform over the box [lo, hi], at
    velocity u, temperature T and diameter d: (x, u, Tp, dp) tensors."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(a, b, n) for a, b in zip(lo, hi)])

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    return (t(x), t(np.full_like(x, 0.0) + np.asarray(u).reshape(-1, 1)),
            t(np.full(n, T)), t(np.full(n, d)))


def pstate_gap(ref, got) -> dict:
    """{fluid field or c.<cloud array>: max |got - ref| over max |ref|} of
    two PStates (got on any device)."""
    gaps = {f: g for f, g in state_gap(ref.fluid, got.fluid).items()
            if f not in ("t", "dt")}
    for f in ("x", "u", "Tp", "dp", "active"):
        gaps["c." + f] = rel_err(getattr(ref.cloud, f).double(),
                                 getattr(got.cloud, f).cpu().double())
    return gaps


def host_reads():
    """The host reads the step makes: the CG's stop tests and DeviceISAT's
    all-hit test."""
    from qgdsolver_tpu_torch.ops import linsolve
    from qgdsolver_tpu_torch.physics import chemistry

    return linsolve.cg.reads + chemistry.DeviceISAT.reads


def cloud_run(label, build, n, share, checks, cpu_steps=3):
    """One run of phase 24: build(device) -> (solver, PState) on the card
    and on the CPU, cpu_steps steps of each, every fluid field and cloud
    array within `share` of its max; then n steps on the card after one of
    warm-up, timed by CUDA events, with the host reads a step;
    checks(label, solver, first, last) -> summary."""
    solver, s = build(torch.device("cuda", 0))
    first = s
    csolver, c = build(torch.device("cpu"))
    step, cstep = solver.make_step(), csolver.make_step()
    for _ in range(cpu_steps):
        s, c = step(s), cstep(c)
    gaps = pstate_gap(c, s)
    for f, g in gaps.items():
        check(g <= share, f"{label}: {f} {g:.2e} of its max from the CPU's "
              f"after {cpu_steps} steps (> {share:g})")
    box = [step(s)]

    def one():
        box[0] = step(box[0])

    reads = host_reads()
    ms = cuda_ms(one, n, warmup=0)
    reads = (host_reads() - reads) / n
    return (f"{label}: {ms:.3f} ms/step over {n} steps, {reads:.2f} host "
            f"reads/step; first {cpu_steps} steps vs the CPU max "
            f"{max(gaps.values()):.1e} (bound {share:g}: "
            + ", ".join(f"{k} {v:.1e}" for k, v in gaps.items()) + "); "
            + checks(label, solver, first, box[0]))


@contextlib.contextmanager
def deposits(keep=2):
    """{rows: [(values, cells, ncell, sums)]} of the first `keep` calls on
    the card of each row count (3: the jet's momentum and energy, 1: the
    evaporated mass) of the clouds' `deposit` in the context."""
    from qgdsolver_tpu_torch.solvers import particles

    seen = {}
    orig = particles.deposit

    def recorded(values, flat, ncell):
        out = orig(values, flat, ncell)
        got = seen.setdefault(values.shape[0], [])
        if values.is_cuda and len(got) < keep:
            got.append((values, flat, ncell, out))
        return out

    particles.deposit = recorded
    try:
        yield seen
    finally:
        particles.deposit = orig


def deposit_bitwise(seen) -> int:
    """Each recorded deposit's sums on the card against its plain version
    (`index_add_` on the CPU) on the same inputs, bit for bit; the number
    of calls checked."""
    from qgdsolver_tpu_torch.ops import deposit as D

    n = 0
    for rows, calls in seen.items():
        for values, flat, ncell, out in calls:
            check(values.is_cuda, "deposit: inputs not on the card")
            ref = D.deposit_reference(values.cpu(), flat.cpu(), ncell)
            ints = torch.int32 if ref.dtype == torch.float32 else torch.int64
            same = torch.equal(out.cpu().view(ints), ref.view(ints))
            check(same, f"deposit ({rows} rows, {values.shape[1]} parcels): "
                  f"the kernel's sums differ from index_add_ on the CPU by "
                  f"{float((out.cpu() - ref).abs().max()):.2e}")
            n += 1
    return n


def deposit_entry(values, flat, ncell, launches, per_step) -> dict:
    """The kernels-line entry of `deposit` on one call's inputs (the jet's
    momentum and energy rows): the kernel's device ms (profiler), all the
    wrapper's device work (the zero-term test, the stable sort, its
    gather, the zero fill and the kernel), the plain version's (`index_add_` a row, atomics on the
    card) and one `index_add_` of every row; the bound from the bytes the
    function must move: the values and cells read once, the (k, ncell)
    sums written once.  `skew` holds `deposit_skew`'s times."""
    from qgdsolver_tpu_torch.ops import deposit as D

    k, n = values.shape
    out = D.deposit(values, flat, ncell)
    err = float((out.cpu() - D.deposit_reference(
        values.cpu(), flat.cpu(), ncell)).abs().max())
    item = values.element_size()
    nbytes = item * k * n + flat.element_size() * n + item * k * ncell
    ops = k * n
    b_ms, b_by = bound(nbytes, ops)
    return {
        "name": "deposit", "route": "cuda",
        "source": "qgdsolver_tpu_torch/ops/csrc/deposit.cu",
        "replaces": "qgdsolver_tpu/solvers/particles.py:160",
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(lambda: D.deposit(values, flat, ncell), 20,
                        match="deposit_kernel"),
        "plain_ms": device_ms(
            lambda: D.deposit_reference(values, flat, ncell), 20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: torch.zeros(
            (k, ncell), dtype=values.dtype, device=values.device).index_add_(
                1, flat, values), 20),
        "wrapper_ms": device_ms(lambda: D.deposit(values, flat, ncell), 20),
        "ops": ops, "shape": [k, n, ncell],
        "launches_per_step": per_step,
        "skew": deposit_skew(values, flat, ncell),
        "note": ("replaces XLA scatter-adds (.at[flat].add, "
                 "qgdsolver_tpu/solvers/particles.py:160, :168, :372), not "
                 "Pallas")}


def skew_patterns(values, flat, ncell) -> dict:
    """{pattern: (values, cells)} of the deposition with piled-up cells,
    from one call's inputs: every parcel in one cell; half the parcels in
    8 outlet cells, the rest where they were; every other parcel inactive
    (its values zero) and clamped into one boundary cell, as escaped
    parcels are."""
    n = flat.shape[0]
    half = torch.arange(n, device=flat.device) % 2 == 1
    pile = flat.clone()
    pile[half] = ncell - 1 - (torch.arange(n, device=flat.device)[half] % 8)
    return {
        "one_cell": (values, torch.full_like(flat, ncell // 2)),
        "outlet_8_cells_half": (values, pile),
        "half_inactive_one_cell": (values * (~half).to(values.dtype),
                                   torch.where(half, ncell - 1, flat))}


def deposit_skew(values, flat, ncell) -> dict:
    """{pattern: {kernel_ms, wrapper_ms, library_ms, longest_run}} of the
    deposition on `skew_patterns` of the jet's values, each pattern's
    sums bitwise its plain version on the CPU.  The kernel sums a run in
    order, so its time grows with the longest run of nonzero terms
    (`longest_run`), one dependent add each; `index_add_` (one call for
    every row, atomics) is the library's time."""
    from qgdsolver_tpu_torch.ops import deposit as D

    out = {}
    for name, (v, f) in skew_patterns(values, flat, ncell).items():
        got = D.deposit(v, f, ncell)
        ref = D.deposit_reference(v.cpu(), f.cpu(), ncell)
        ints = torch.int32 if ref.dtype == torch.float32 else torch.int64
        check(torch.equal(got.cpu().view(ints), ref.view(ints)),
              f"deposit ({name}): the kernel's sums differ from index_add_ "
              f"on the CPU by {float((got.cpu() - ref).abs().max()):.2e}")
        live = f[(v != 0).any(dim=0)]
        out[name] = {
            "kernel_ms": device_ms(lambda v=v, f=f: D.deposit(v, f, ncell),
                                   10, match="deposit_kernel"),
            "wrapper_ms": device_ms(lambda v=v, f=f: D.deposit(v, f, ncell),
                                    10),
            "library_ms": device_ms(lambda v=v, f=f: torch.zeros(
                (v.shape[0], ncell), dtype=v.dtype,
                device=v.device).index_add_(1, f, v), 10),
            "longest_run": int(torch.bincount(live, minlength=ncell).max())}
    return out


def jet_twice(build, steps=3) -> str:
    """The two-way jet stepped `steps` times twice from one State on the
    card: every fluid field and cloud array equal bit for bit."""
    solver, s0 = build(torch.device("cuda", 0))
    runs = []
    for _ in range(2):
        step, s = solver.make_step(), s0
        for _ in range(steps):
            s = step(s)
        runs.append(s)
    a, b = runs
    for part in ("fluid", "cloud"):
        for f, x, y in zip(getattr(a, part)._fields, getattr(a, part),
                           getattr(b, part)):
            if torch.is_tensor(x):
                check(torch.equal(x, y), f"two-way jet run twice: "
                      f"{part}.{f} differs "
                      f"({rel_err(x.double(), y.double()):.1e})")
    return f"two runs of {steps} steps from one State bitwise equal"


def deposit_ab(build, n=10) -> str:
    """ms/step of the two-way jet with the deposition kernel and with the
    plain version on the card (`index_add_` a row, float atomics: the
    parent's deposition), A B B A twice, CUDA events."""
    from qgdsolver_tpu_torch.ops import deposit as D
    from qgdsolver_tpu_torch.solvers import particles

    solver, s = build(torch.device("cuda", 0))
    step = solver.make_step()
    box = [step(s)]

    def one():
        box[0] = step(box[0])

    times = {"kernel": [], "index_add_": []}
    try:
        for name in ("kernel", "index_add_", "index_add_", "kernel") * 2:
            particles.deposit = (D.deposit if name == "kernel"
                                 else D.deposit_reference)
            times[name].append(cuda_ms(one, n, warmup=1))
    finally:
        particles.deposit = D.deposit
    return ("jet ms/step A B B A twice, deposition kernel " + ", ".join(
        f"{t:.3f}" for t in times["kernel"]) + " against index_add_ "
        "(atomics) " + ", ".join(f"{t:.3f}" for t in times["index_add_"]))


def two_way_jet(device):
    """Phase 24's particlesQGDFoam jet: `cloud_jet` at SHAPE in float32
    with 262144 parcels from seed 18 over the domain, as (solver,
    PState)."""
    from qgdsolver_tpu_torch.solvers.particles import PState

    solver, fs = cloud_jet(SHAPE, torch.float32, device)
    cloud = solver.cloud.make(*cloud_of(1 << 18, (0.0, 0.0), (4.0, 2.0), 18,
                                        torch.float32, device))
    return solver, PState(fluid=fs, cloud=cloud)


def cloud_jet(shape, dtype, device):
    """particlesQGDFoam: cases.supersonic_jet's mesh and BCs with
    tests/fixtures/particles_case's cloud constants (rho 2500, Cp 900),
    two-way."""
    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.solvers.particles import (ParticlesQGDFoam,
                                                       ThermoCloud)

    fluid, fs = cases.supersonic_jet(shape=shape, dtype=dtype, device=device)
    return ParticlesQGDFoam(fluid=fluid, cloud=ThermoCloud(
        rho_p=2500.0, Cp_p=900.0, two_way=True)), fs


def momentum_exchange(solver, s) -> str:
    """One cloud evolve on the card's state: the gas's momentum source
    over the step, sum(rhoUSu V) dt, against the parcels' gain
    -sum(m du), within 32 float32 roundings of sum |m du| (a few roundings
    a parcel's term and the cell sums' additions)."""
    fluid = solver.fluid
    U, _, T, _ = fluid.primitives(s.fluid)
    dt = s.fluid.dt
    cloud, rhoUSu, _ = solver.cloud.evolve(s.cloud, fluid.mesh, dt,
                                           rho_g=s.fluid.rho, U_g=U, T_g=T)
    m = solver.cloud.mass(s.cloud).double()
    du = (cloud.u - s.cloud.u).double()
    gain = (m * du).sum(dim=1)
    src = (rhoUSu.double() * fluid.mesh.cell_volume.double()).sum(
        dim=(1, 2)) * float(dt)
    scale = (m * du.abs()).sum(dim=1)
    bound = 32 * float(torch.finfo(torch.float32).eps) * scale
    miss = (src + gain).abs()
    check(bool((miss <= bound).all()), f"momentum exchange: gas {src} "
          f"against the parcels' gain {gain} (bound {bound})")
    return (f"momentum exchange x over one step: the gas gains "
            f"{float(src[0]):.6e}, the parcels {float(gain[0]):.6e} "
            f"(|sum| {float(miss[0]):.1e}, bound {float(bound[0]):.1e})")


def cloud_rank(state_np, shape, grid, steps):
    """A rank of phase 24's decomposed cloud run: `steps` steps of the
    two-way jet (float32) on this rank's block, the lost parcels read, the
    gathered PState with numpy leaves."""
    from qgdsolver_tpu_torch import interop
    from qgdsolver_tpu_torch.parallel import distributed, sharding
    from qgdsolver_tpu_torch.solvers import particles

    dev = distributed.rank_device("cuda")
    solver, _ = cloud_jet(shape, torch.float32, dev)
    step, to_s, from_s = sharding.build_spmd_step(
        solver, sharding.ProcessGrid(*grid))
    s = to_s(interop.state_from_numpy(state_np, device=dev,
                                      dtype=torch.float32))
    for _ in range(steps):
        s = step(s)
    particles.raise_dropped(s)
    return interop.state_to_numpy(from_s(s))


def cloud_multiset(c):
    """The active parcels' (x, u, Tp, dp) rows, sorted (numpy)."""
    m = c.active > 0.5
    rows = np.concatenate([c.x[:, m], c.u[:, m], c.Tp[None, m],
                           c.dp[None, m]]).astype(np.float64)
    return rows[:, np.lexsort(rows)]


def decomposed_cloud(shape=(256, 128), steps=10):
    """particlesQGDFoam at `shape` f32 on 2x1 ranks sharing the card
    (gloo), with parcels planted across the partition face x = 2, against
    the serial card run: fields within 1e-5 of their max and the parcel
    multiset within 1e-5 of each row's max (float32 sums in another
    order: the atomics of the serial run and the slot order of the
    ranks)."""
    from qgdsolver_tpu_torch import interop
    from qgdsolver_tpu_torch.parallel import distributed
    from qgdsolver_tpu_torch.solvers import common
    from qgdsolver_tpu_torch.solvers.particles import PState

    dev = torch.device("cuda", 0)
    solver, fs = cloud_jet(shape, torch.float32, dev)
    x, u, Tp, dp = cloud_of(4096, (0.05, 0.05), (3.95, 1.95), 24,
                            torch.float64, "cpu")
    xs, us = x.numpy(), u.numpy()
    xs[:, :64] = np.stack([np.full(64, 2.0 - 2e-5),
                           np.linspace(0.2, 1.8, 64)])
    us[:, :64] = np.stack([np.full(64, 400.0), np.zeros(64)])
    xs[:, 64:128] = np.stack([np.full(64, 2.0 + 2e-5),
                              np.linspace(0.2, 1.8, 64)])
    us[:, 64:128] = np.stack([np.full(64, -400.0), np.zeros(64)])
    cloud = solver.cloud.make(xs, us, Tp, dp, device=dev,
                              dtype=torch.float32)
    s0 = PState(fluid=fs, cloud=cloud)
    t0 = time.perf_counter()
    ranks = distributed.spawn(cloud_rank, 2, interop.state_to_numpy(s0),
                              shape, (2, 1), steps, device="cuda",
                              timeout=600)
    secs = time.perf_counter() - t0
    ref = interop.state_to_numpy(common.run_steps(solver.make_step(), s0,
                                                  steps))
    crossed = int(((ref.cloud.x[0, :128] >= 2.0)
                   != (xs[0, :128] >= 2.0)).sum())
    check(crossed == 128, f"decomposed cloud: {crossed} of 128 planted "
          "parcels crossed the partition face")
    worst = 0.0
    for got in ranks:
        for f in ("rho", "rhoU", "rhoE"):
            a, b = getattr(ref.fluid, f), getattr(got.fluid, f)
            worst = max(worst, float(np.abs(a - b).max() / np.abs(a).max()))
        A, B = cloud_multiset(ref.cloud), cloud_multiset(got.cloud)
        check(A.shape == B.shape, f"decomposed cloud: {B.shape[1]} active "
              f"parcels against the serial {A.shape[1]}")
        worst = max(worst, float((np.abs(A - B) / np.maximum(
            np.abs(A).max(axis=1, keepdims=True), 1e-30)).max()))
    check(worst <= 1e-5, f"decomposed cloud: {worst:.2e} of the max from "
          "the serial card run (> 1e-5)")
    return (f"decomposed {shape} f32 2x1 ranks (gloo, sharing the card) "
            f"{steps} steps: 128 planted parcels crossed x = 2, fields and "
            f"parcel multiset {worst:.1e} of their max from the serial card "
            f"run (bound 1e-5); {secs:.1f} s")


def reacting_case(root, n_parcels=65536):
    """tests/fixtures/reacting_case at 1024x512 cells with its one parcel
    replaced by n_parcels evaporating parcels from a numpy seed, uniform
    over the unit square."""
    case = fixture_case(root, "reacting_case", "reacting_1024", [
        ("system/blockMeshDict", r"\(8 8 1\)", "(%d %d 1)" % SHAPE)])
    rng = np.random.default_rng(24)
    xy = rng.uniform(0.0, 1.0, (n_parcels, 2))
    path = os.path.join(case, "constant", "reactingCloud1Properties")
    with open(path) as f:
        text = f.read()
    pos = " ".join("(%.9g %.9g 0.05)" % (a, b) for a, b in xy)
    text, k = re.subn(r"positions\s*\(\(.*?\)\);", f"positions ({pos});",
                      text, flags=re.S)
    check(k == 1, "reacting_case: no parcel positions to replace")
    with open(path, "w") as f:
        f.write(text)
    return case


def reacting_run(root, card_steps=3, n=10):
    """reactingLagrangianQGDFoam at 1024x512 f64 (TDAC/EulerImplicit with
    the ISATDevice table of the fixture, tol 1e-3, capacity 2^15) through
    the CLI: 3 steps and a write on the card, every specie file written
    and read back against the CPU's 3 steps (1e-9 of each field's max, the
    table's hits, lookups and evictions equal); then n timed steps on the
    card with the counters and host reads a step."""
    from qgdsolver_tpu_torch.io import foam_case
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
    from qgdsolver_tpu_torch.physics import chemistry
    from qgdsolver_tpu_torch.solvers import common

    case = reacting_case(root)
    csolver, c = foam_case.build_case(case, device="cpu")
    check(c.cloud.x.shape == (2, 65536) and c.fluid.rho.dtype == torch.float64
          and c.fluid.tab["keys"].shape == (6, 1 << 15),
          "reacting_case: parcels, dtype or table")
    c = common.run_steps(csolver.make_step(), c, card_steps)
    log, secs, launches = run_cli([case, "--max-steps", str(card_steps),
                                   "--device", "cuda"],
                                  F.KERNELS + F3.KERNELS)
    check("composable step engaged: make_step" in log,
          f"the CLI did not take the composable step:\n{log}")
    check(not any(launches.values()), f"CLI launched kernels {launches}")
    tdirs = [d for d in os.listdir(case)
             if d not in ("0", "system", "constant")]
    check(len(tdirs) == 1, f"reacting CLI wrote {tdirs}")
    files = sorted(os.listdir(os.path.join(case, tdirs[0])))
    check(files == ["F", "N2", "O2", "T", "U", "p"],
          f"reacting CLI wrote {files}")
    _, back = latest_state(case, torch.device("cuda", 0))
    # the gas starts at rest: its momentum (the parcels' drag) is held
    # against a 1 kg/(m^2 s) scale
    gaps = {f: float((getattr(c.fluid, f).double()
                      - getattr(back.fluid, f).cpu().double()).abs().max())
            / max(float(getattr(c.fluid, f).abs().max()),
                  1.0 if f == "rhoU" else 1e-30)
            for f in ("rho", "rhoU", "rhoE", "Y", "T")}
    for f, g in gaps.items():
        check(g <= 1e-9, f"reacting CLI: {f} read back {g:.2e} from the "
              "CPU's run (> 1e-9)")

    # the table's counters, card against CPU, over the same 3 steps
    ctrl = os.path.join(case, "system", "controlDict")
    with open(ctrl) as f:
        text = f.read()
    with open(ctrl, "w") as f:
        f.write(text.replace("startFrom       latestTime;",
                             "startFrom       startTime;"))
    solver, s = foam_case.build_case(case, device=torch.device("cuda", 0))
    step = solver.make_step()
    s = common.run_steps(step, s, card_steps)
    names = ("hits", "lookups", "evictions")
    card = [chemistry.DeviceISAT.counter(s.fluid.tab, k) for k in names]
    cpu = [chemistry.DeviceISAT.counter(c.fluid.tab, k) for k in names]
    check(card == cpu, f"reacting: ISAT counters {card} on the card "
          f"against {cpu} on the CPU")
    box = [s]

    def one():
        box[0] = step(box[0])

    reads = host_reads()
    ms = cuda_ms(one, n, warmup=0)
    reads = (host_reads() - reads) / n
    now = [chemistry.DeviceISAT.counter(box[0].fluid.tab, k) for k in names]
    per = [(a - b) / n for a, b in zip(now, card)]
    finite("reacting fluid", box[0].fluid._replace(tab=None))
    return (f"reactingLagrangianQGDFoam {SHAPE} f64, 65536 evaporating "
            f"parcels, CLI {card_steps} steps + write in {secs:.1f} s (every "
            f"specie file, read back vs the CPU's run max "
            f"{max(gaps.values()):.1e}, bound 1e-9; ISAT hits/lookups/"
            f"evictions after {card_steps} steps {card}, the CPU's "
            f"{cpu}); {ms:.3f} ms/step over {n} steps, ISAT a step: hits "
            f"{per[0]:.0f}, lookups {per[1]:.0f}, evictions {per[2]:.0f}; "
            f"{reads:.2f} host reads/step")


def phase_lagrangian_reacting(card, root):
    """Phase 24: particlesQGDFoam, particlesQHDFoam and
    reactingLagrangianQGDFoam (with its DeviceISAT table) on the composable
    path (torch ops; the reference has no Pallas kernel for any), no kernel
    launched: the two-way jet at 1024x512 f32 with 262144 parcels (the
    gas's momentum source against the parcels' gain), the one-way cavity
    at 128x128 f64 with 65536 parcels, each against the CPU over 3 steps
    and timed; the reacting case through the CLI (`reacting_run`); and the
    two-way jet decomposed on 2x1 ranks sharing the card
    (`decomposed_cloud`)."""
    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.ops import deposit as D
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
    from qgdsolver_tpu_torch.solvers.particles import (ParticlesQHDFoam,
                                                       PState, ThermoCloud)

    t0 = time.perf_counter()

    def jet_checks(label, solver, first, s):
        finite(label, s.fluid)
        umean = float(s.cloud.u[0].mean())
        check(umean > 0.0, f"{label}: the parcels are not dragged ({umean})")
        return (f"mean parcel u {umean:.3e}, parcel T in "
                f"[{float(s.cloud.Tp.min()):.2f}, "
                f"{float(s.cloud.Tp.max()):.2f}]; "
                + momentum_exchange(solver, s))

    def cavity(d):
        fluid, fs = cases.buoyant_cavity((128, 128), device=d)
        solver = ParticlesQHDFoam(fluid=fluid, cloud=ThermoCloud(
            two_way=False, wall="rebound"))
        cloud = solver.cloud.make(*cloud_of(1 << 16, (0.0, 0.0), (1.0, 1.0),
                                            16, torch.float64, d,
                                            u=(0.01, -0.02), T=0.5, d=1e-4))
        return solver, PState(fluid=fs, cloud=cloud)

    def cavity_checks(label, solver, first, s):
        finite(label, s.fluid)
        x = s.cloud.x
        check(bool((x >= 0).all() and (x <= 1).all()
                   and (s.cloud.active == 1).all()),
              f"{label}: a parcel left the closed cavity")
        T = s.fluid.T
        return (f"{int(s.cloud.active.sum())} parcels inside, T in "
                f"[{float(T.min()):.4f}, {float(T.max()):.4f}]")

    kernels = F.KERNELS + F3.KERNELS
    for k in kernels:
        k.launches = 0
    # the main path's deposition launches: the jet's 24 steps (3 against
    # the CPU, 1 warm-up, 20 timed), one a step, and its momentum check's
    # evolve; the reacting case's 16
    # (3 through the CLI, 3 on the card, 10 timed), two a step (the
    # exchange and the evaporated mass)
    D.deposit.launches = 0
    with deposits() as seen:
        msgs = [cloud_run(f"particlesQGDFoam jet {SHAPE} f32, 262144 "
                          "parcels (two-way)", two_way_jet, 20, 1e-3, jet_checks)]
        jet_launches = D.deposit.launches
        msgs += [
            cloud_run("particlesQHDFoam cavity 128x128 f64, 65536 parcels "
                      "(one-way)", cavity, 5, 2 * 3 * 1e-8, cavity_checks),
            reacting_run(root)]
    launches = D.deposit.launches
    check(jet_launches == 25 and launches - jet_launches == 32,
          f"phase 24: deposit launched {jet_launches} times in the jet's 24 "
          "steps and momentum check (one each), and "
          f"{launches - jet_launches} in the reacting case's 16 steps (two "
          "a step)")
    checked = deposit_bitwise(seen)
    check(sorted(seen) == [1, 3], f"phase 24: deposits of {sorted(seen)} rows")
    values, flat, ncell, _ = seen[3][0]
    entry = deposit_entry(values, flat, ncell, launches, {
        "particlesQGDFoam": (jet_launches - 1) / 24,
        "reactingLagrangianQGDFoam": (launches - jet_launches) / 16})
    msgs.append(f"deposit: {launches} launches on the main path, {checked} "
                "calls (the jet's and the evaporated mass) bitwise their "
                "plain version on the CPU; piled-up cells bitwise, "
                "kernel/wrapper/index_add_ ms (longest run): " + ", ".join(
                    f"{k} {v['kernel_ms']:.4f}/{v['wrapper_ms']:.4f}/"
                    f"{v['library_ms']:.4f} ({v['longest_run']})"
                    for k, v in entry["skew"].items()))
    msgs.append(jet_twice(two_way_jet))
    msgs.append(deposit_ab(two_way_jet))
    msgs.append(decomposed_cloud())
    launched = {k.__name__: k.launches for k in kernels if k.launches}
    check(not launched, f"phase 24: kernels launched {launched}")
    print("phase 24 particlesQGDFoam, particlesQHDFoam, "
          "reactingLagrangianQGDFoam (composable, torch ops, the deposition "
          "kernel; no QGD kernel launched): ok " + " | ".join(msgs)
          + f" | {time.perf_counter() - t0:.1f} s | card: {card}",
          flush=True)
    return entry


# ---------------------------------------------------------------------------
# phase 25: the graft entry points and selectBadCells (no new kernel)
# ---------------------------------------------------------------------------


def entry_run(cpu_steps=3, n=20, share=1e-3) -> str:
    """`graft_entry.entry()` on the card: its first cpu_steps steps held
    within `share` of each field's max against entry(device="cpu") (phase
    21's bound for the composable path), then n steps timed by CUDA
    events, and check_physical on the end state."""
    from qgdsolver_tpu_torch import cases, graft_entry

    step, (s,) = graft_entry.entry()
    check(s.rho.is_cuda, "entry(): the State is not on the card")
    cstep, (c,) = graft_entry.entry(device="cpu")
    for _ in range(cpu_steps):
        s, c = step(s), cstep(c)
    errs = {}
    for f in ("rho", "rhoU", "rhoE", "dt"):
        errs[f] = rel_err(getattr(c, f), getattr(s, f).cpu())
        check(errs[f] <= share, f"entry(): {f} {errs[f]:.2e} of its max "
              f"from the CPU's after {cpu_steps} steps (> {share:g})")
    box = [s]

    def one():
        box[0] = step(box[0])

    ms = cuda_ms(one, n, warmup=0)
    solver, _ = cases.supersonic_jet(shape=tuple(s.rho.shape),
                                     device=s.rho.device)
    phys = check_physical("entry()", solver, box[0])
    return (f"entry() {tuple(s.rho.shape)} f32 composable: first "
            f"{cpu_steps} steps vs the CPU "
            + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
            + f" (share {share:g}); {ms:.3f} ms/step over {n} steps; {phys}")


def dryrun_run(n_ranks=4):
    """`graft_entry.dryrun_multichip(n_ranks)` on ranks sharing the card:
    each path within its bound of the port's serial step (the function
    raises otherwise), K3 and K5 bit for bit the serial kernel path, each
    flagged kernel of their paths launched once a step on every rank, and
    no kernel under the composable path.  (message, {path: launches})."""
    from qgdsolver_tpu_torch import graft_entry
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3

    steps = graft_entry.DRYRUN_STEPS
    t0 = time.perf_counter()
    rep = graft_entry.dryrun_multichip(n_ranks)
    secs = time.perf_counter() - t0
    check(rep["spmd"]["launches"] == {},
          f"dry run spmd: kernels launched {rep['spmd']['launches']}")
    totals = {}
    for path, kernels in (("k3", F.SHARDED_KERNELS),
                          ("k5", F3.SHARDED_KERNELS)):
        r = rep[path]
        check(r["bitwise"], f"dry run {path}: not bit for bit the serial "
              f"kernel path {r['max_rel']}")
        for k in kernels:
            got = r["launches"].get(k.__name__, 0)
            check(got == n_ranks * steps, f"dry run {path}: {k.__name__} "
                  f"launched {got} times, expected {n_ranks * steps}")
        totals[path] = sum(r["launches"].values())
    msg = "; ".join(
        f"{path} {r['shape']} on {r['grid'][0]}x{r['grid'][1]} "
        f"({r['bound']}): largest difference from serial "
        f"{max(r['max_rel'].values()):.1e}"
        + (" (bitwise)" if r["bitwise"] else "")
        + f", launches {r['launches']}" for path, r in rep.items())
    return (f"dryrun_multichip({n_ranks}), {steps} steps, {SHARED}: {msg}; "
            f"{secs:.1f} s"), totals


def badcells_run(dev, root) -> str:
    """`select_bad_cells` on the card against the CPU, on the 4096x2048
    CLI case's mesh (uniform: 0 bad), the graded jet at 1024x512, the
    wedge_case fixture's AxisymmetricMesh and a graded 256x126x126 mesh,
    each at the default thresholds and at thresholds midway between 1 and
    the mesh's maxima (which flag part of the cells): masks bit for bit,
    maxima and n_bad equal; ms a call by CUDA events (the three numbers'
    host read included)."""
    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.core.mesh import Mesh
    from qgdsolver_tpu_torch.io import foam_fields
    from qgdsolver_tpu_torch.utils import badcells

    def geom(n, length, ratio):
        w = ratio ** (np.arange(n) / max(n - 1, 1))
        return np.concatenate([[0.0], np.cumsum(w / w.sum() * length)])

    big = write_case(root, "badcells_big", BIG, varsc=True)
    here = os.path.dirname(os.path.abspath(__file__))
    wedge = os.path.join(here, "tests", "fixtures", "wedge_case")
    faces3 = (geom(SHAPE3[0], 4.0, 3.0), geom(SHAPE3[1], 1.0, 2.5),
              geom(SHAPE3[2], 1.0, 0.4))
    meshes = {
        f"CLI case {BIG[0]}x{BIG[1]}":
            lambda d: foam_fields.load_block_mesh(big, device=d)[0],
        f"jet_graded {SHAPE[0]}x{SHAPE[1]}":
            lambda d: cases.supersonic_jet_graded(shape=SHAPE,
                                                  device=d)[0].mesh,
        "wedge_case": lambda d: foam_fields.load_block_mesh(wedge,
                                                            device=d)[0],
        "graded {}x{}x{}".format(*SHAPE3):
            lambda d: Mesh(x_faces=faces3, device=d),
    }
    msgs = []
    for label, build in meshes.items():
        mesh, cmesh = build(dev), build(torch.device("cpu"))
        check(mesh.device.type == "cuda", f"{label}: mesh not on the card")
        top = badcells.select_bad_cells(mesh)
        mid = (0.5 * (1.0 + top.max_aspect_ratio),
               0.5 * (1.0 + top.max_expansion))
        counts = []
        for th in ((100.0, 3.0), mid):
            got = badcells.select_bad_cells(mesh, *th)
            ref = badcells.select_bad_cells(cmesh, *th)
            for m in ("high_aspect_ratio", "high_expansion"):
                check(getattr(got, m).is_cuda
                      and torch.equal(getattr(got, m).cpu(), getattr(ref, m)),
                      f"{label} {th}: {m} differs from the CPU's")
            for v in ("max_aspect_ratio", "max_expansion", "n_bad"):
                check(getattr(got, v) == getattr(ref, v),
                      f"{label} {th}: {v} {getattr(got, v)} vs the CPU's "
                      f"{getattr(ref, v)}")
            counts.append((got.n_bad, int(got.high_aspect_ratio.sum()),
                           int(got.high_expansion.sum())))
        if label.startswith("CLI"):
            check(counts[0][0] == 0, f"{label}: {counts[0][0]} bad cells")
        ms = cuda_ms(lambda: badcells.select_bad_cells(mesh), 5)
        msgs.append(f"{label} ({type(mesh).__name__}): n_bad {counts[0][0]} "
                    f"(defaults); midway ({mid[0]!r}, {mid[1]!r}) n_bad "
                    f"{counts[1][0]}, aspect {counts[1][1]}, expansion "
                    f"{counts[1][2]} of {mesh.shape}; max aspect "
                    f"{top.max_aspect_ratio!r}, max expansion "
                    f"{top.max_expansion!r}; {ms:.3f} ms/call")
    return "select_bad_cells vs the CPU (masks bitwise, maxima equal): " \
        + "; ".join(msgs)


def particles_fixture_run() -> str:
    """tests/fixtures/particles_case, the one fixture no other phase
    builds, through `foam_case.build_case` on the card against the CPU
    (`cloud_run` at phase 24's float32 bound), so every fixture's case
    ingestion runs on the card."""
    from qgdsolver_tpu_torch.io import foam_case

    here = os.path.dirname(os.path.abspath(__file__))
    case = os.path.join(here, "tests", "fixtures", "particles_case")

    def checks(label, solver, first, s):
        finite(label, s.fluid)
        return (f"{int(s.cloud.active.sum())} of "
                f"{int(first.cloud.active.sum())} parcels active")

    return cloud_run("particles_case (build_case) f32",
                     lambda d: foam_case.build_case(case, device=d), 20,
                     1e-3, checks)


def phase_graft_badcells(dev, card, root, sharded):
    """Phase 25: the port's graft entry points and selectBadCells on the
    card, and the particles_case fixture.  No kernel of its own: the dry run's launches of K3's and K5's
    kernels are printed and kept in their kernels-line entries as
    `dryrun_launches`."""
    t0 = time.perf_counter()
    msgs = [entry_run()]
    msg, totals = dryrun_run()
    msgs.append(msg)
    msgs.append(badcells_run(dev, root))
    msgs.append(particles_fixture_run())
    for e in sharded:
        e["dryrun_launches"] = totals[e["name"][:2]]
    print("phase 25 graft_entry and select_bad_cells: ok " + " | ".join(msgs)
          + f" | dry-run launches K3 {totals['k3']}, K5 {totals['k5']}"
          + f" | {time.perf_counter() - t0:.1f} s | card: {card}",
          flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--profiler-check"]:
        return profiler_check(int(sys.argv[2]))
    if sys.argv[1:2] == ["--fixed3"]:
        phase_fixed3(torch.device("cuda", 0), phase_env())
        return 0
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
    from qgdsolver_tpu_torch.ops import smoothing as S

    card = phase_env()
    dev = torch.device("cuda", 0)
    phase_build()
    stats = {k: {"err": 0.0} for k in KERNELS}
    tols = ((1e-6, 1e-3), (1e-5, 2e-3))  # (dt, fields): plain, varsc

    warm = {n: warm_state(n, SHAPE, F.build_fused_step, dev) for n in CASES}
    jobs = phase_kernels(warm, stats)
    phase_lockstep(4, warm, F.build_fused_step, dict(zip(CASES, tols)))
    del warm
    # the plain jet takes K1's builder, the varsc jet K2's
    launches = phase_main_path(5, dev, SHAPE, zip(CASES, (500, 100)),
                               F.KERNELS, {"qgd2d_dt": 500,
                                           "qgd2d_update": 600,
                                           "qgd2d_ghosts": 600,
                                           "qgd2d_emit": 101,
                                           "qgd2d_smooth": 101},
                               least=("qgd2d_smooth",))
    by_shape = {k: {SHAPE: v} for k, v in launches.items()}
    phase_time(dev, card, jobs, stats)

    warm = {n: warm_state(n, SHAPE3, F3.build_fused_step_3d, dev)
            for n in CASES3}
    jobs3 = phase_kernels3(warm, stats)
    phase_lockstep(8, warm, F3.build_fused_step_3d, dict(zip(CASES3, tols)))
    del warm
    # at rest the varsc jet's ring 1 is the fixed point: no qgd3d_smooth
    # launch, one host flag read a step
    reads = S.smooth_sensor.reads
    launches.update(phase_main_path(9, dev, SHAPE3, zip(CASES3, (100, 40)),
                                    F3.KERNELS, {"qgd3d_dt": 140,
                                                 "qgd3d_update": 140,
                                                 "qgd3d_emit": 40,
                                                 "qgd3d_ghosts": 140,
                                                 "qgd3d_smooth": 0}))
    reads = S.smooth_sensor.reads - reads
    check(reads == 40, f"the 3D main path at rest read {reads} smoothing "
          "flags in 40 varsc steps")
    # with a density bump the sensor goes on past ring 1: one more read a
    # step for the fixed point's call
    reads = S.smooth_sensor.reads
    bumped = phase_main_path(9, dev, SHAPE3, [(CASES3[1], 20, with_bump)],
                             F3.KERNELS, {"qgd3d_dt": 20, "qgd3d_update": 20,
                                          "qgd3d_emit": 20, "qgd3d_ghosts": 20,
                                          "qgd3d_smooth": 1},
                             least=("qgd3d_smooth",))
    reads = S.smooth_sensor.reads - reads
    fixed = bumped["qgd3d_smooth"] // F3.SMOOTH3_FIXED_LAUNCHES
    check(reads == 20 + fixed and bumped["qgd3d_smooth"]
          == F3.SMOOTH3_FIXED_LAUNCHES * fixed, f"the bumped 3D main path "
          f"read {reads} smoothing flags in 20 steps and "
          f"{bumped['qgd3d_smooth']} launches, expected one read a step and "
          f"one a fixed-point call of {F3.SMOOTH3_FIXED_LAUNCHES} launches")
    for k, v in bumped.items():
        launches[k] += v
    phase_time3(dev, card, jobs3, stats)
    # in an interpreter of its own: the benchmark's mesh holds ~3 GB, and
    # the profiler sessions of one process have lost events before (PERF.md)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--fixed3"], capture_output=True, text=True,
                          timeout=1200)
    print("\n".join(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("phase 10 ")), flush=True)
    check(proc.returncode == 0, "phase 10's fixed point (chip_smoke.py "
          f"--fixed3) failed:\n{proc.stderr[-3000:]}")

    solver, ts, emit_jobs = phase_emit(dev, stats)
    phase_lockstep_big(solver, ts)
    with tempfile.TemporaryDirectory() as root:
        cli_launches, solver, state = phase_cli(dev, root)
    for k, v in cli_launches.items():
        launches[k] += v
        by_shape[k][BIG] = v
    phase_time_big(solver, state, card, emit_jobs, stats)
    sharded = phases_sharded(dev, card, launches)
    phase_ring_check(dev, card)
    with tempfile.TemporaryDirectory() as root:
        phase_slice(dev, card, root)
    phase_family(card)
    with tempfile.TemporaryDirectory() as root:
        phase_moving_twophase(card, root)
    with tempfile.TemporaryDirectory() as root:
        deposit = phase_lagrangian_reacting(card, root)
    with tempfile.TemporaryDirectory() as root:
        phase_graft_badcells(dev, card, root, sharded)
    entries = []
    for k, v in stats.items():
        # each kernel's bound at the shape its time was taken; the 2D update
        # and emit at each shape the main path runs them (the update at
        # 4096x2048 on the varsc case, with its sensor frame)
        shape = BIG if k in ("qgd2d_emit", "qgd2d_smooth") else (
            SHAPE if k.startswith("qgd2d") else SHAPE3)
        top = v["by_shape"][shape]
        b_ms, b_by = bound(work_bytes(k, shape), top["ops"])
        entry = {
            "name": k, "route": "cuda", "source": KERNELS[k][0],
            "replaces": KERNELS[k][1], "launches": launches[k],
            "max_abs_err": v["err"], "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "ops": top["ops"], "shape": list(shape),
            "launches_per_call": top["launches_per_call"]}
        if len(v["by_shape"]) > 1:
            entry["by_shape"] = [
                {"shape": list(sh), "launches": by_shape[k].get(sh, 0),
                 "ms": x["ms"], "plain_ms": x["plain_ms"],
                 "bound_ms": bound(work_bytes(k, sh, varsc=(sh == BIG)),
                                   x["ops"])[0]}
                for sh, x in v["by_shape"].items()]
        if k == "qgd2d_smooth":
            entry["note"] = "replaces XLA (lax.while_loop), not Pallas"
            entry.update(v["extra"])
        if k == "qgd3d_smooth":
            entry["note"] = ("replaces XLA (fvc_smooth between K4's calls), "
                             "not Pallas")
            entry.update(v["extra"])
        entries.append(entry)
    # no single PyTorch call computes any of the QGD kernels' functions:
    # library_ms null; the deposition's is one index_add_
    print(json.dumps({"kernels": entries + sharded + [deposit]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
