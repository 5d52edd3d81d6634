"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of the fused 2D and 3D QGDFoam steps from the
sources in the checkout, and for each dimension checks each kernel against
its plain PyTorch version at the production size (1024x512 and 256x126x126
f32), runs the kernel path in lock-step with the plain path, drives the
library's main path (cases -> make_fused_step -> common.run_steps) for both
cases of that dimension, and times the kernel, plain and composable paths.
Then the 4096x2048 varScModel5 + qgdFlux jet (phases 11-14): `qgd2d_emit`
against its plain version, K2's path in lock-step with its plain path and
with K1's, the case CLI (`python -m qgdsolver_tpu_torch <case>`) on an
OpenFOAM case directory with a write and a resume, and the times of the
three 2D paths.  One line per phase; any failure exits non-zero.  The last
line is {"ok": true, "device": {...}}.  Without a CUDA device it fails
before printing any result.  It imports nothing of JAX.
"""
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
    **{k: (CSRC + "qgd3d.cu", "qgdsolver_tpu/ops/fused_qgd3d.py:349")
       for k in ("qgd3d_dt", "qgd3d_update", "qgd3d_sensor",
                 "qgd3d_ghosts")},
}


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


def device_ms(fn, n: int, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() over n calls: the summed durations
    of the CUDA kernels it launched, from the profiler (host gaps between
    launches excluded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    check(us > 0, "the profiler saw no device time")
    return us / n / 1e3


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))


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
    (name, kernel call, plain call) at the plain jet's inputs, for timing."""
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
        msgs = [f"dt rel {err / float(dt_ref):.2e}"]
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

        if name == "supersonic_jet":
            jobs = [("qgd2d_dt", lambda: F.qgd2d_dt(prm, *args),
                     lambda: F.dt_reference(prm, *args)),
                    ("qgd2d_update", lambda: F.qgd2d_update(prm, *upd),
                     lambda: F.update_reference(prm, *upd)),
                    ("qgd2d_ghosts",
                     lambda: F.qgd2d_ghosts(prm, fb, side_ref, prof),
                     lambda: F.ghosts_reference(prm, fa, side_ref, prof))]
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
    mach = float((U.norm(dim=0) / solver.thermo.c(T)).max())
    check(mach < 5.0, f"{name}: max Mach {mach}")
    return f"t={float(s.t):.4e} max Mach {mach:.3f}"


def phase_main_path(num, dev, shape, runs, kernels, want):
    """cases -> make_fused_step -> common.run_steps, as a user calls it, for
    each (case, steps) of `runs`.  The launch counts of `kernels` are set to
    0 just before and read just after; each must equal want[name] (the
    steps of the runs whose builder launches it, plus one per to_fused for
    qgd2d_emit)."""
    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.solvers import common

    built = []
    for name, n in runs:
        solver, state = getattr(cases, name)(shape=shape, device=dev)
        check(solver.fused_supported(), f"{name} not fused-supported")
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
        check(v == want[k], f"{k} launched {v} times, expected {want[k]}")
    msgs = [f"{name} ({solver.fused_builder().__name__}) {n} steps "
            + check_physical(name, solver, s) for name, n, solver, s in outs]
    print(f"phase {num} main path {shape}: ok " + "; ".join(msgs)
          + f" | launches {launches}", flush=True)
    return launches


def phase_time(dev, card, jobs, stats):
    """Grid points per second at SHAPE, plain jet: kernel path, plain frame
    path, composable make_step path (CUDA events); then, with the profiler,
    the device idle share of each path and each kernel's device time
    against its plain version's."""
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
    idle = {label: 1.0 - device_ms(advance, min(steps, 50)) / rates[label][1]
            for label, steps, advance in advances}
    for kname, kern, plain in jobs:
        stats[kname]["ms"] = device_ms(kern, 50)
        stats[kname]["plain_ms"] = device_ms(plain, 20)
    print("phase 6 time, supersonic_jet " + f"{SHAPE}: " + "; ".join(
        f"{k} {r:.4e} points/s ({ms:.4f} ms/step, device idle share "
        f"{idle[k]:.3f})" for k, (r, ms) in rates.items())
        + " | device ms/call kernel vs plain: " + ", ".join(
            f"{k} {stats[k]['ms']:.4f} vs {stats[k]['plain_ms']:.4f}"
            for k, _, _ in jobs) + f" | card: {card}", flush=True)

def phase_kernels3(warm, stats):
    """Each 3D kernel against its plain version on the same inputs.
    Returns (name, kernel call, plain call) at each case's inputs, for
    timing (the sensor's at the varsc jet's, the others' at the duct's)."""
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3

    C = (slice(1, -1),) * 3
    jobs = {}
    for name in CASES3:
        solver, fs = warm[name]
        prm, planes = F3.make_params(solver)
        planes = solver.mesh.tensor(planes).contiguous()
        sc = None
        if prm.varsc:
            sc = F3._edge_frame(F3.fvc_smooth(fs.sc_raw,
                                              solver.tau_model.smoothCoeff))
        dts = (fs.T, fs.ux, fs.uy, fs.uz, fs.dt)
        dt_ref = F3.dt_reference_3d(prm, *dts)
        dt_k = F3.qgd3d_dt(prm, *dts)
        err = abs(float(dt_k) - float(dt_ref))
        check(err <= 1e-6 * abs(float(dt_ref)),
              f"{name} qgd3d_dt {float(dt_k)!r} vs {float(dt_ref)!r}")
        msgs = [f"dt rel {err / float(dt_ref):.2e}"]
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
            s_ref = F3.sensor_reference_3d(prm, ref[0], ref[1], sc)
            s_k = F3.qgd3d_sensor(prm, ref[0], ref[1], sc)
            torch.cuda.synchronize()
            r = rel_err(s_ref, s_k)
            check(r <= 1e-6, f"{name} qgd3d_sensor rel {r:.2e}")
            stats["qgd3d_sensor"]["err"] = float((s_ref - s_k).abs().max())
            msgs.append(f"sensor rel {r:.2e}")
            jobs["qgd3d_sensor"] = (
                lambda: F3.qgd3d_sensor(prm, ref[0], ref[1], sc),
                lambda: F3.sensor_reference_3d(prm, ref[0], ref[1], sc))

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
            jobs["qgd3d_dt"] = (lambda: F3.qgd3d_dt(prm, *dts),
                                lambda: F3.dt_reference_3d(prm, *dts))
            jobs["qgd3d_update"] = (lambda: F3.qgd3d_update(prm, *upd),
                                    lambda: F3.update_reference_3d(prm, *upd))
            jobs["qgd3d_ghosts"] = (
                lambda: F3.qgd3d_ghosts(prm, fb, side_ref, planes),
                lambda: F3.ghosts_reference_3d(prm, fa, side_ref, planes))
        print(f"phase 7 3D kernels vs plain, {name} {SHAPE3}: ok "
              + ", ".join(msgs), flush=True)
    return [(k,) + jobs[k] for k in ("qgd3d_dt", "qgd3d_update",
                                     "qgd3d_sensor", "qgd3d_ghosts")]


def phase_time3(dev, card, jobs, stats):
    """Grid points per second at SHAPE3: the duct's kernel, plain frame and
    composable paths and the varsc jet's kernel path (CUDA events); then,
    with the profiler, each path's device idle share and each 3D kernel's
    device time against its plain version's."""
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
    rates, advances = {}, []
    for label, steps, step, s0 in paths:
        box = [s0]

        def advance(box=box, step=step):
            box[0] = step(box[0])

        ms = cuda_ms(advance, steps, warmup=2)
        rates[label] = (pts / (ms * 1e-3), ms)
        advances.append((label, steps, advance))
    idle = {label: 1.0 - device_ms(advance, min(steps, 20), warmup=1)
            / rates[label][1] for label, steps, advance in advances}
    for kname, kern, plain in jobs:
        stats[kname]["ms"] = device_ms(kern, 20, warmup=2)
        stats[kname]["plain_ms"] = device_ms(plain, 3, warmup=1)
    print(f"phase 10 time 3D {SHAPE3}: " + "; ".join(
        f"{k} {r:.4e} points/s ({ms:.4f} ms/step, device idle share "
        f"{idle[k]:.3f})" for k, (r, ms) in rates.items())
        + " | device ms/call kernel vs plain: " + ", ".join(
            f"{k} {stats[k]['ms']:.4f} vs {stats[k]['plain_ms']:.4f}"
            for k, _, _ in jobs) + f" | card: {card}", flush=True)


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


def write_big_case(root: str) -> str:
    """An OpenFOAM case directory: tests/fixtures/jet_case at 4096x2048
    cells with varScModel5 (the coefficients of cases.supersonic_jet_varsc)
    and its qgdFlux outflow."""
    case = os.path.join(root, "jet_varsc_4096x2048")
    here = os.path.dirname(os.path.abspath(__file__))
    shutil.copytree(os.path.join(here, "tests", "fixtures", "jet_case"), case)

    def edit(rel, old, new):
        path = os.path.join(case, rel)
        with open(path) as f:
            text = f.read()
        check(re.search(old, text, flags=re.S) is not None,
              f"{rel}: no {old!r}")
        with open(path, "w") as f:
            f.write(re.sub(old, new, text, count=1, flags=re.S))

    edit("system/blockMeshDict", r"\(64 32 1\)", "(%d %d 1)" % BIG)
    edit("constant/thermophysicalProperties", r"QGD\s*\{.*?\}",
         "QGD\n{\n    implicitDiffusion false;\n"
         "    QGDCoeffs       varScModel5;\n    aQGD 0.5;\n    PrQGD 1.0;\n"
         "    rC 0.5;\n    minSc 0.05;\n    maxSc 1.0;\n"
         "    smoothCoeff 0.1;\n}")
    return case


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
    qgd2d_ghosts once per step, qgd2d_dt never."""
    from qgdsolver_tpu_torch.io import foam_case
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F

    from qgdsolver_tpu_torch.physics import qgdcoeffs

    case = write_big_case(root)
    msgs, total = [], {}
    for n in (50, 10):
        rings = qgdcoeffs.fvc_smooth_continue.rings
        log, secs, launches = run_cli(
            [case, "--max-steps", str(n), "--device", "cuda"], F.KERNELS)
        check("fused kernel path engaged: build_tiled_fused_step" in log,
              f"the CLI did not take K2's builder:\n{log}")
        want = {"qgd2d_dt": 0, "qgd2d_update": n, "qgd2d_ghosts": n,
                "qgd2d_emit": n + 1}
        check(launches == want, f"CLI launches {launches}, expected {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        writes = re.findall(r"writing fields to (\S+)", log)
        check(len(writes) == 1, f"{len(writes)} writes in one run:\n{log}")
        ctrl = os.path.join(case, "system", "controlDict")
        with open(ctrl) as f:
            text = f.read()
        with open(ctrl, "w") as f:
            f.write(text.replace("startFrom       startTime;",
                                 "startFrom       latestTime;"))
        t0 = time.perf_counter()
        solver, state = foam_case.build_case(case, device=dev)
        read = time.perf_counter() - t0
        rings = (qgdcoeffs.fvc_smooth_continue.rings - rings) / n
        msgs.append(f"{n} steps in {secs:.1f} s, {rings:.2f} "
                    f"fvc_smooth_continue rings/step (wrote "
                    f"{os.path.basename(writes[0])}; read back in "
                    f"{read:.1f} s: "
                    + check_physical("written case", solver, state) + ")")
    print(f"phase 13 CLI on the case directory {BIG}: ok " + "; ".join(msgs)
          + f" | launches {total}", flush=True)
    return total, solver, state


def phase_time_big(solver, state, card, emit_jobs, stats):
    """Phase 14, on the CLI's case at the time it wrote last (an impulsive
    start, so the sensor is active): qgd2d_emit against emit_reference once
    more (the change flag set); grid points per second, ms/step and device
    idle share at 4096x2048 for K2's path, K1's path with the plain sensor
    pre-pass and K2's plain frame path; qgd2d_emit's device ms per call
    against emit_reference's (on phase 11's frames); the
    fvc_smooth_continue rings per step of the timed K2 steps, and the
    step's parts: qgd2d_update and qgd2d_ghosts (device ms) and the
    continuation from the emitted ring 1 (wall ms)."""
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.physics import qgdcoeffs

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
    checked = f"qgd2d_emit vs plain on the case ok, flag {float(ts[11]):.0f}"
    paths = [("K2", 30, k_step, ts), ("K1+pre-pass", 20, w_step, w_to(state)),
             ("plain", 3, p_step, p_to(state))]
    rates, advances = {}, []
    for label, steps, step, s0 in paths:
        box = [s0]

        def advance(box=box, step=step):
            box[0] = step(box[0])

        rings = qgdcoeffs.fvc_smooth_continue.rings
        ms = cuda_ms(advance, steps, warmup=2)
        if label == "K2":
            ring_rate = (qgdcoeffs.fvc_smooth_continue.rings - rings) \
                / (steps + 2)
        rates[label] = (pts / (ms * 1e-3), ms)
        advances.append((label, steps, advance))
    idle = {label: 1.0 - device_ms(advance, min(steps, 10), warmup=1)
            / rates[label][1] for label, steps, advance in advances}
    kern, plain = emit_jobs
    stats["qgd2d_emit"]["ms"] = device_ms(kern, 20)
    stats["qgd2d_emit"]["plain_ms"] = device_ms(plain, 5)
    # the step's parts at this size: the two shared K1 kernels (device
    # time) and the smoothing continuation from the emitted ring (wall)
    prof = solver.mesh.tensor(F.make_params(solver)[1]).contiguous()
    upd = (prm, ts.p, ts.T, ts.ux, ts.uy, ts.sc, ts.dt)
    new, side = F.qgd2d_update(*upd)
    parts = {"qgd2d_update": device_ms(lambda: F.qgd2d_update(*upd), 10),
             "qgd2d_ghosts": device_ms(
                 lambda: F.qgd2d_ghosts(prm, new, side, prof), 10),
             "fvc_smooth_continue (wall)": cuda_ms(
                 lambda: qgdcoeffs.fvc_smooth_continue(
                     ts.sc_s1, ts.sc_chg, solver.tau_model.smoothCoeff),
                 5, warmup=1)}
    print(f"phase 14 time, the CLI's case {BIG}: {checked} | "
          + "; ".join(
        f"{k} {r:.4e} points/s ({ms:.4f} ms/step, device idle share "
        f"{idle[k]:.3f})" for k, (r, ms) in rates.items())
        + f" | timed K2 rings/step {ring_rate:.2f} | ms per call: "
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + " | device ms/call qgd2d_emit vs emit_reference "
        f"{stats['qgd2d_emit']['ms']:.4f} vs "
        f"{stats['qgd2d_emit']['plain_ms']:.4f} | card: {card}", flush=True)


def main() -> int:
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3

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
                                           "qgd2d_emit": 101})
    phase_time(dev, card, jobs, stats)

    warm = {n: warm_state(n, SHAPE3, F3.build_fused_step_3d, dev)
            for n in CASES3}
    jobs3 = phase_kernels3(warm, stats)
    phase_lockstep(8, warm, F3.build_fused_step_3d, dict(zip(CASES3, tols)))
    del warm
    launches.update(phase_main_path(9, dev, SHAPE3, zip(CASES3, (100, 40)),
                                    F3.KERNELS, {"qgd3d_dt": 140,
                                                 "qgd3d_update": 140,
                                                 "qgd3d_sensor": 40,
                                                 "qgd3d_ghosts": 140}))
    phase_time3(dev, card, jobs3, stats)

    solver, ts, emit_jobs = phase_emit(dev, stats)
    phase_lockstep_big(solver, ts)
    with tempfile.TemporaryDirectory() as root:
        cli_launches, solver, state = phase_cli(dev, root)
    for k, v in cli_launches.items():
        launches[k] += v
    phase_time_big(solver, state, card, emit_jobs, stats)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": launches[k],
         "max_abs_err": v["err"], "ms": v["ms"], "plain_ms": v["plain_ms"]}
        for k, v in stats.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
