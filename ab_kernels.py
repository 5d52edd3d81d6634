"""Device times of the port's 2D kernels `qgd2d_update`, `qgd2d_emit`,
`qgd2d_smooth`, `qgd2d_dt`, `qgd2d_dt_fold` and `qgd2d_ghosts`, and of the
3D `qgd3d_emit` (or a build's `qgd3d_sensor` and ring 1), `qgd3d_sensor`,
`qgd3d_smooth`, `qgd3d_dt`, `qgd3d_dt_fold` and `qgd3d_ghosts`, and of
the clouds' `deposit_kernel`, from two or more builds of their source, on
the same inputs, in one process on one card.

    python3 ab_kernels.py NAME=PATH/qgd2d.cu [NAME=PATH/qgd3d.cu ...]
    python3 ab_kernels.py NAME=PATH/deposit.cu
    python3 ab_kernels.py --only update3 NAME=PATH/qgd3d.cu

`--only` keeps the timed inputs of the kernels it names (the names of
`fns` in `main`: `update3` is `qgd3d_update`).

Each PATH (another revision's source, unpacked with `git archive`, or a
variant of it, beside the headers it includes) is compiled alone with the
port's nvcc flags into `build/ab_kernels/`; the checkout's own kernels are
the build "this".  A `qgd2d.cu` build runs the 2D inputs, a `qgd3d.cu`
build the 3D ones, a `deposit.cu` build the deposition's (a kind with no
other build is not run).  The deposition's inputs are the first deposit
of `chip_smoke.py` phase 24's two-way f32 jet (3 rows of 262144 parcels
into 524288 cells) and `chip_smoke.skew_patterns` of it (every parcel in
one cell; half in 8 outlet cells; every other parcel inactive and clamped
into one cell), each through `ops.deposit.deposit` with every build's
kernel, held bitwise to this build's and timed A B B A; then the jet's
ms/step with each build's kernel, A B B A (CUDA events).  The other
inputs are those the port's steps hand the kernels, recorded in a step:

- the 1024x512 jet after 20 plain steps, on K1's path (`qgd2d_update`,
  `qgd2d_dt`, and `qgd2d_ghosts` on the frames the plain update makes
  from it);
- the 1024x512 varsc + qgdFlux jet after 20 plain steps, on K2's path
  (and `qgd2d_dt` on its frames);
- the 4096x2048 varsc + qgdFlux jet with a density bump (its sensor
  active), after 3 steps of K2's path;
- block 0 of a 2x2 split of the warm 1024x512 jet, flagged at its
  partition edges, as K3 hands it `qgd2d_update`, `qgd2d_dt_fold` and
  `qgd2d_ghosts` (on the frames the plain update makes from it);
- the 4096x2048 jet's frames after the plain update of that K2 step
  (`qgd2d_ghosts`);
- the first smoothing ring that K2's emit hands the next step on the
  4096x2048 jet with the bump (`qgd2d_smooth`: one launch of 8 and of 16
  rings, and K2's whole continuation to the fixed point at 8 and at 16
  rings a launch, `smoothing.smooth_sensor`);
- the fresh frames of a step of the 256x126x126 varsc jet after 20 plain
  steps (`qgd3d_emit`: the raw sensor, ring 1 and its flag in one launch,
  against a build without it, whose step ran `qgd3d_sensor` and a launch
  of `qgd3d_smooth` of ring 1; and `qgd3d_sensor`, the raw sensor alone);
- the first ring that the 3D step emits on that jet with a density bump
  (`qgd3d_smooth`: one launch of 1 and of 4 rings, and the step's
  continuation from it to the fixed point, 4 rings a launch);
- the first ring that the first step of the benchmark's
  jet3d_varsc.shocked cell emits at 640x318x318 (`qgd3d_smooth`: one
  launch of 4 rings, and the 3D step's smoothing from it as each build's
  step runs it: its fixed point in three line sweeps, or the ring loop in
  a build without it);
- the duct and the varsc jet after 20 plain steps at 256x126x126 (and
  the duct's K5 slab 0 of an x-ring of 2) and after 3 kernel-path steps
  at the benchmark's 640x318x318 (`qgd3d_update`, with its bound and each
  build's launch shape);
- the 256x126x126 duct and varsc jet after 20 plain steps (`qgd3d_dt`;
  `qgd3d_ghosts` on the frames the plain update makes from them), and
  slab 0 of the duct's x-ring of 2, flagged at its partition plane, as K5
  hands it `qgd3d_dt_fold` and `qgd3d_ghosts`.

For each input and kernel every build runs in the order given, then in the
reverse order (A B B A), timed by the profiler's device time of the port's
kernels (`chip_smoke.device_ms`), and each build's output is held against
"this" build's (the update's fields within 1e-5 of their max, as phase 3 of
`chip_smoke.py`; the emitted rates rel 1e-6, the sensor fields bitwise;
the 3D raw sensor and its ring 1 rel 1e-6, and the flag equal, since a
build may round the sensor otherwise; the smoothed frames and flags, the
2D and 3D dt, their quads and the ghost-filled frames bitwise).  Before the timed 2D inputs, each other
2D build's `qgd2d_dt`, `qgd2d_dt_fold` and `qgd2d_ghosts` are held to this
build's bit for bit on small random frames (`sweep_2d`: both jets, every
BC kind, all 16 edge-flag sets), where a few faces decide each max and
min.  It prints each build's
registers and spills of the kernels it times from ptxas, one line per
input and kernel, and the card's name and power limit.  It needs a card
and imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs

OUT_DIR = pathlib.Path(__file__).resolve().parent / "build" / "ab_kernels"
# the benchmark's 3D mesh (qgdbench/configs), where `qgd3d_update` and the
# 3D smoothing are timed beside chip_smoke's SHAPE3
BENCH3 = cs.BENCH3
# the kernels whose ptxas lines are printed, by source: a name, or the
# names one kernel has had (the first a build has is printed)
PTXAS = {"qgd2d": ("qgd2d_update_kernel", "qgd2d_smooth_kernel",
                   ("qgd2d_dt_kernel", "qgd2d_dt_partial_kernel"),
                   ("qgd2d_ghosts_kernel", "qgd2d_ghost_rows_kernel")),
         "qgd3d": ("qgd3d_update_kernel",
                   ("qgd3d_emit_kernel", "qgd3d_sensor_kernel"),
                   "qgd3d_smooth_kernel", "qgd3d_dt_", "qgd3d_ghost"),
         "deposit": ("deposit_kernel",)}


def build_other(name: str, src: pathlib.Path):
    """(library, ptxas report) of one qgd2d.cu, qgd3d.cu or deposit.cu
    built alone, with the entry points the timed wrappers call bound."""
    from qgdsolver_tpu_torch.ops import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / f"{name}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                           "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    p2 = ctypes.POINTER(_build.QGDParams)
    p3 = ctypes.POINTER(_build.QGD3DParams)
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    if src.name.startswith("deposit"):
        i64 = ctypes.c_longlong
        for fn in ("deposit_f32", "deposit_f64"):
            _build._bind(lib, fn, [ptr, i64, c_int, ptr, ptr, ptr, i64, ptr])
        return lib, proc.stderr
    if src.name.startswith("qgd3d"):
        _build._bind(lib, "qgd3d_smooth", [p3, ptr, ctypes.c_long,
                                           ctypes.c_long, c_int, ptr, ptr,
                                           ptr])
        _build._bind(lib, "qgd3d_dt_partials", [p3])
        _build._bind(lib, "qgd3d_dt", [p3] + [ptr] * 8)
        _build._bind(lib, "qgd3d_dt_fold", [p3] + [ptr] * 7)
        _build._bind(lib, "qgd3d_ghosts", [p3] + [ptr] * 8)
        _build._bind(lib, "qgd3d_sensor", [p3] + [ptr] * 5)
        _build._bind(lib, "qgd3d_update", [p3] + [ptr] * 14)
        _build._bind(lib, "qgd3d_update_launch", [p3, ctypes.POINTER(c_int)])
        if hasattr(lib, "qgd3d_emit"):
            _build._bind(lib, "qgd3d_emit", [p3] + [ptr] * 7)
        if hasattr(lib, "qgd3d_smooth_fixed"):
            _build._bind(lib, "qgd3d_smooth_fixed",
                         [p3, ptr, ctypes.c_long, ctypes.c_long, ptr, ptr,
                          ptr])
        return lib, proc.stderr
    _build._bind(lib, "qgd2d_error_string", [c_int], ctypes.c_char_p)
    _build._bind(lib, "qgd2d_dt_partials", [c_int, c_int])
    _build._bind(lib, "qgd2d_dt", [p2] + [ptr] * 7)
    _build._bind(lib, "qgd2d_dt_fold", [p2] + [ptr] * 6)
    _build._bind(lib, "qgd2d_ghosts", [p2] + [ptr] * 7)
    _build._bind(lib, "qgd2d_update", [p2] + [ptr] * 12)
    _build._bind(lib, "qgd2d_emit", [p2] + [ptr] * 11)
    _build._bind(lib, "qgd2d_smooth", [p2, ptr, c_int, c_int, ptr, ptr, ptr])
    if hasattr(lib, "qgd2d_emit_partials"):
        _build._bind(lib, "qgd2d_emit_partials", [c_int, c_int])
    else:
        # a build whose emit runs on qgd2d_dt's face grid
        lib.qgd2d_emit_partials = lib.qgd2d_dt_partials
    return lib, proc.stderr


def registers(report: str, kernel) -> str:
    """ptxas's spill and registers lines of `kernel` (its first instance;
    of a tuple of names, the first found) in a -v report."""
    lines = report.splitlines()
    for name in (kernel,) if isinstance(kernel, str) else kernel:
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and name in ln:
                got = [nxt.split(":", 1)[-1].strip()
                       for nxt in lines[i + 1:i + 4]
                       if "registers" in nxt or "spill" in nxt]
                if got:
                    return f"({name}) " + "; ".join(got)
    return "not reported"


# the printed names of the dt and ghost kernels
NAMES = {"dt3": "dt", "fold3": "dt_fold", "ghosts3": "ghosts",
         "sensor_ring1": "emit (or sensor + ring 1)",
         "fold": "dt_fold"}
# each build's dt workspaces: a build of another design lays the workspace
# out otherwise
WORKSPACES = {}
# the bound (ms, by) of an input, by its label (`update_inputs3`)
BOUNDS = {}


def on_library(lib, fn):
    """fn() with the wrappers launching lib's kernels."""
    from qgdsolver_tpu_torch.ops import _build, launch

    saved = _build.load, launch._DT_WORK
    _build.load = lambda: lib
    launch._DT_WORK = WORKSPACES.setdefault(id(lib), {})
    try:
        return fn()
    finally:
        _build.load, launch._DT_WORK = saved


def inputs(dev):
    """(label, kernel, args) of every timed 2D call."""
    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.parallel import sharding, spmd

    def ghost_args(prm, frames, prof, dt):
        """qgd2d_ghosts' inputs: the frames and side that the plain update
        makes from `frames`, and the profile table on the card."""
        fresh, side = F.update_reference(prm, *frames, None, dt)
        return (prm, fresh, side, torch.as_tensor(prof, device=dev))

    out = []
    small, big = ("x".join(map(str, sh)) for sh in (cs.SHAPE, cs.BIG))
    solver, fs = cs.warm_state("supersonic_jet", cs.SHAPE, F.build_fused_step,
                               dev)
    got = cs.recorded(F.build_fused_step, solver, fs, 1)
    out.append((f"jet {small}, K1", "update", got["update"]))
    prm, prof = F.make_params(solver)
    frames = (fs.p, fs.T, fs.ux, fs.uy)
    out.append((f"jet {small}, K1", "dt", (prm, fs.T, fs.ux, fs.uy, fs.dt)))
    out.append((f"jet {small}, the plain update's frames", "ghosts",
                ghost_args(prm, frames, prof, fs.dt)))
    grid = sharding.ProcessGrid(2, 2)
    ctx = sharding.block_context(solver.mesh, grid, 0)
    prm, prof = F.block_params(solver, ctx)
    win = spmd.frame_window(ctx)
    blk = [f[win].contiguous() for f in frames]
    label = f"jet block 0 of 2x2 ({prm.nx}x{prm.ny}), K3"
    out.append((label, "update", (prm, *blk, None, fs.dt)))
    out.append((label, "fold", (prm, *blk[1:])))
    out.append((label + ", the plain update's frames", "ghosts",
                ghost_args(prm, blk, prof, fs.dt)))
    solver, fs = cs.warm_state("supersonic_jet_varsc", cs.SHAPE,
                               F.build_tiled_fused_step, dev)
    got = cs.recorded(F.build_tiled_fused_step, solver, fs, 1)
    for k in ("update", "emit"):
        out.append((f"varsc jet {small}, K2", k, got[k]))
    out.append((f"varsc jet {small}", "dt",
                (got["update"][0], fs.T, fs.ux, fs.uy, fs.dt)))
    solver, state = cases.supersonic_jet_varsc(shape=cs.BIG, device=dev)
    fs = F.build_tiled_fused_step(solver)[1](cs.with_bump(solver, state))
    got = cs.recorded(F.build_tiled_fused_step, solver, fs, 3)
    for k in ("update", "emit"):
        out.append((f"varsc jet {big} with a bump, K2", k, got[k]))
    fresh, side = F.update_reference(*got["update"])
    out.append((f"varsc jet {big} with a bump, the plain update's frames",
                "ghosts", (got["update"][0], fresh, side, torch.as_tensor(
                    F.make_params(solver)[1], device=dev))))
    prm = got["emit"][0]
    _, _, _, s1, chg = F.qgd2d_emit(*got["emit"])
    cs.check(float(chg) == 1.0, "the bump's sensor must be active")
    for k in (8, 16):
        out.append((f"ring 1 of the varsc jet {big} with a bump, {k} rings",
                    "smooth", (prm, s1, k)))
    for k in (8, 16):
        out.append((f"K2's continuation from that ring 1, {k} rings a launch",
                    "continuation", (prm, s1, chg, k)))
    return out


def update_launch(lib, prm) -> tuple:
    """A build's `qgd3d_update` launch at prm's shape on the current
    device: (tile rows, tile lanes, chunk planes, shared bytes a block,
    blocks an SM)."""
    from qgdsolver_tpu_torch.ops import _build

    out = (ctypes.c_int * 5)()
    _build.check(lib, lib.qgd3d_update_launch(prm, out),
                 "qgd3d_update_launch")
    return tuple(out)


def update_inputs3(dev):
    """(label, "update3", args) of the timed `qgd3d_update` calls, each
    one's bound (ms, by) into BOUNDS: the duct and the varsc jet after 20
    plain steps at 256x126x126 (and slab 0 of the duct's x-ring of 2,
    flagged at its partition plane, as K5 hands it the kernel), and after 3
    kernel-path steps at the benchmark's 640x318x318.  The bound is the
    larger of `work_bytes` over the HBM rate and the plain version's
    `count_ops` over the float32 rate; the operations are counted at
    256x126x126 and scaled by the cells (the plain version's work is per
    cell and per face)."""
    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
    from qgdsolver_tpu_torch.parallel import sharding, spmd

    out, ops = [], {}
    for shape in (cs.SHAPE3, BENCH3):
        for name in cs.CASES3:
            if shape == cs.SHAPE3:
                solver, fs = cs.warm_state(name, shape,
                                           F3.build_fused_step_3d, dev)
            else:
                solver, state = getattr(cases, name)(shape=shape, device=dev)
                step, to_f, _ = F3.build_fused_step_3d(solver)
                fs = to_f(state)
                del state
                for _ in range(3):
                    fs = step(fs)
            prm, _ = F3.make_params(solver)
            sc = cs.step_sensor(prm, fs) if prm.varsc else None
            args = (prm, fs.p, fs.T, fs.ux, fs.uy, fs.uz, sc, fs.dt)
            if shape == cs.SHAPE3:
                ops[name] = cs.count_ops(
                    lambda args=args: F3.update_reference_3d(*args))
            n = ops[name] * np.prod(shape) / np.prod(cs.SHAPE3)
            label = f"{name} {'x'.join(map(str, shape))}"
            BOUNDS[label] = cs.bound(cs.work_bytes("qgd3d_update", shape,
                                                   bool(prm.varsc)), n)
            out.append((label, "update3", args))
            if shape == cs.SHAPE3 and name == cs.CASES3[0]:
                # slab 0 of the duct's x-ring of 2, as K5 hands it the kernel
                ctx = sharding.block_context(solver.mesh,
                                             sharding.ProcessGrid(2, 1), 0)
                blk, _ = F3.block_params(solver, ctx)
                win = spmd.frame_window(ctx)
                cut = [f[win].contiguous() for f in args[1:6]]
                slab = (blk.nx,) + shape[1:]
                label = (f"{name} slab 0 of an x-ring of 2 "
                         f"({'x'.join(map(str, slab))}), K5")
                BOUNDS[label] = cs.bound(cs.work_bytes("qgd3d_update", slab),
                                         n * slab[0] / shape[0])
                out.append((label, "update3", (blk, *cut, None, fs.dt)))
    return out


def inputs3(dev):
    """(label, kernel, args) of every timed 3D call."""
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
    from qgdsolver_tpu_torch.parallel import sharding, spmd

    shape = "x".join(map(str, cs.SHAPE3))
    solver, fs = cs.warm_state(cs.CASES3[1], cs.SHAPE3, F3.build_fused_step_3d,
                               dev)
    prm, _ = F3.make_params(solver)
    step, to_f, from_f = F3.build_fused_step_3d(solver)
    sc = step(fs).sc
    fresh, _ = F3.update_reference_3d(prm, fs.p, fs.T, fs.ux, fs.uy, fs.uz,
                                      sc, fs.dt)
    out = [(f"the varsc jet {shape}, a step's fresh frames", kind,
            (prm, fresh[0], fresh[1], sc))
           for kind in ("sensor_ring1", "sensor3")]
    bumped = step(to_f(cs.with_bump(solver, from_f(fs))))
    cs.check(float(bumped.sc_chg) == 1.0, "the bump's sensor must be active")
    out += [(f"the first ring the varsc jet {shape} with a bump emits, {k} "
             "rings", "smooth3", (prm, bumped.sc_s1, k))
            for k in (1, F3.SMOOTH3_RINGS)]
    out.append(("the 3D step's continuation from that ring, "
                f"{F3.SMOOTH3_RINGS} rings a launch", "continuation3",
                (prm, bumped.sc_s1, bumped.sc_chg)))
    big = "x".join(map(str, BENCH3))
    prm_b, shocked = cs.shocked_carry(dev)
    out += [(f"the ring 1 of the jet3d_varsc.shocked cell's first step "
             f"({big}), {F3.SMOOTH3_RINGS} rings", "smooth3",
             (prm_b, shocked.sc_s1, F3.SMOOTH3_RINGS)),
            (f"the 3D step's smoothing from that ring ({big}): the fixed "
             "point, or the ring loop in a build without it", "step_smooth3",
             (prm_b, shocked.sc_s1, shocked.sc_chg))]
    for name in cs.CASES3:
        solver, fs = cs.warm_state(name, cs.SHAPE3, F3.build_fused_step_3d,
                                   dev)
        prm, planes = F3.make_params(solver)
        planes = solver.mesh.tensor(planes).contiguous()
        frames = (fs.p, fs.T, fs.ux, fs.uy, fs.uz)
        sc = cs.step_sensor(prm, fs) if prm.varsc else None
        out.append((f"{name} {shape}", "dt3", (prm,) + frames[1:] + (fs.dt,)))
        fresh, side = F3.update_reference_3d(prm, *frames, sc, fs.dt)
        out.append((f"{name} {shape}, the plain update's frames", "ghosts3",
                    (prm, fresh, side, planes)))
        if name != cs.CASES3[0]:
            continue
        ctx = sharding.block_context(solver.mesh, sharding.ProcessGrid(2, 1), 0)
        prm, _ = F3.block_params(solver, ctx)
        win = spmd.frame_window(ctx)
        blk = [f[win].contiguous() for f in frames]
        label = f"{name} slab 0 of an x-ring of 2 ({prm.nx}x126x126), K5"
        out.append((label, "fold3", (prm,) + tuple(blk[1:])))
        fresh, side = F3.update_reference_3d(prm, *blk, None, fs.dt)
        out.append((label + ", the plain update's frames", "ghosts3",
                    (prm, fresh, side, planes)))
    return out


def ghosts(prm, frames, side, profiles):
    """qgd2d_ghosts on fresh copies of the frames (it fills them in place)."""
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F

    return F.qgd2d_ghosts(prm, [f.clone() for f in frames], side, profiles)


def sweep_2d(builds, dev) -> str:
    """Each other 2D build's qgd2d_dt, qgd2d_dt_fold and qgd2d_ghosts held
    to this build's bit for bit on small random frames: the jet and the
    varsc jet at (nx, ny) in 1, 2, 3 and 40 (extrapolation only where
    supported() takes it), with their own BCs and with each BC kind on
    every side, under all 16 edge-flag sets.  On a few cells each face is
    often the one whose value is the max or the min."""
    import dataclasses
    import itertools

    import numpy as np

    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.core import bc
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F

    def with_kind(solver, kind):
        make = {"zg": bc.ZeroGradient, "sym": bc.Symmetry,
                "extrap": bc.Extrapolated,
                "fixed": lambda: bc.FixedValue(301.0),
                "grad": lambda: bc.FixedGradient(-2.5),
                "io": lambda: bc.InletOutlet(299.0)}[kind]
        rows = tuple((make(), make()) for _ in range(2))
        return dataclasses.replace(solver, bc_T=bc.FieldBCs(rows),
                                   bc_p=bc.FieldBCs(rows))

    rng = np.random.default_rng(7)
    cases_run = 0
    for shape in itertools.product((1, 2, 3, 40), repeat=2):
        for name, kind in itertools.product(
                ("supersonic_jet", "supersonic_jet_varsc"),
                ("case", "zg", "sym", "extrap", "fixed", "grad", "io")):
            solver, _ = getattr(cases, name)(shape=shape, device=dev)
            if kind != "case":
                solver = with_kind(solver, kind)
            if not F.supported(solver):
                continue
            prm, prof = F.make_params(solver)
            prof = torch.as_tensor(prof, device=dev)
            fs = tuple(n + 2 for n in shape)
            lims = ((0.9e5, 1.1e5), (250.0, 350.0), (-60.0, 60.0),
                    (-60.0, 60.0))
            frames = [torch.as_tensor(rng.uniform(lo, hi, fs)
                                      .astype(np.float32), device=dev)
                      for lo, hi in lims]
            side = torch.as_tensor(rng.uniform(-5.0, 5.0, (2, fs[1]))
                                   .astype(np.float32), device=dev)
            dt = torch.tensor(1e-7, dtype=torch.float32, device=dev)
            for flags in itertools.product((1, 0), repeat=4):
                (prm.edge_lo, prm.edge_hi, prm.edge_lo_y,
                 prm.edge_hi_y) = flags

                def run():
                    return (F.qgd2d_dt(prm, *frames[1:], dt),
                            F.qgd2d_dt_fold(prm, *frames[1:]),
                            *ghosts(prm, frames, side, prof))

                ref = run()
                for bname, (lib, _) in builds.items():
                    got = on_library(lib, run)
                    cs.check(all(torch.equal(a, b) for a, b in zip(ref, got)),
                             f"sweep {shape} {name} {kind} {flags}: build "
                             f"{bname} differs from this build "
                             f"(dt {got[0].item()!r} vs {ref[0].item()!r}, "
                             f"quad {got[1].tolist()} vs {ref[1].tolist()})")
                cases_run += 1
    return (f"qgd2d sweep: {cases_run} small random cases, dt, quad and "
            "ghost-filled frames of every build bitwise this build's")


def ghosts3(prm, frames, side, planes):
    """qgd3d_ghosts on fresh copies of the frames (it fills them in place)."""
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3

    return F3.qgd3d_ghosts(prm, [f.clone() for f in frames], side, planes)


def continuation(prm, s1, chg, k):
    """K2's smoothing continuation to the fixed point, k rings a launch."""
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.ops import smoothing as S

    return S.smooth_sensor(prm, s1, chg, F.qgd2d_smooth, k)


def continuation3(prm, s1, chg):
    """The 3D step's smoothing loop from the emitted first ring."""
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
    from qgdsolver_tpu_torch.ops import smoothing as S

    return S.smooth_sensor(prm, s1, chg, F3.qgd3d_smooth, F3.SMOOTH3_RINGS)


def step_smooth3(prm, s1, chg):
    """The 3D step's smoothing from the emitted first ring as the build's
    step runs it: `qgd3d_smooth`'s fixed point where the build has one,
    else the ring loop."""
    from qgdsolver_tpu_torch.ops import _build
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
    from qgdsolver_tpu_torch.ops import smoothing as S

    return S.smooth_sensor(prm, s1, chg, F3.qgd3d_smooth, F3.SMOOTH3_RINGS,
                           cache={"fixed": hasattr(_build.load(),
                                                   "qgd3d_smooth_fixed")})


def sensor_ring1(prm, p, T, sc):
    """(ring 1 frame, flag) of the fresh frames: `qgd3d_emit`'s one launch,
    or, in a build without it, `qgd3d_sensor` and a `qgd3d_smooth` launch
    of one ring, as that build's step ran them."""
    from qgdsolver_tpu_torch.ops import _build
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3

    if hasattr(_build.load(), "qgd3d_emit"):
        return F3.qgd3d_emit(prm, p, T, sc)[1:]
    return F3.qgd3d_smooth(prm, F3.qgd3d_sensor(prm, p, T, sc), 1)


def deposit_inputs(dev):
    """(label, values, cells, ncell) of the timed deposits: the first
    deposit of phase 24's two-way jet and `chip_smoke.skew_patterns` of
    it."""
    from qgdsolver_tpu_torch.solvers import particles

    solver, s = cs.two_way_jet(dev)
    seen = []
    orig = particles.deposit

    def recorded(values, flat, ncell):
        seen.append((values, flat, ncell))
        return orig(values, flat, ncell)

    particles.deposit = recorded
    try:
        solver.make_step()(s)
    finally:
        particles.deposit = orig
    values, flat, ncell = seen[0]
    return [("jet", values, flat, ncell)] + [
        (name, v, f, ncell)
        for name, (v, f) in cs.skew_patterns(values, flat, ncell).items()]


def deposit_runs(builds, dev, card) -> None:
    """Print each deposit input's device ms through every build (held
    bitwise to this build's sums), A B B A, then the jet's ms/step."""
    from qgdsolver_tpu_torch.ops import deposit as D

    order = list(builds) + list(builds)[::-1]
    for label, v, f, ncell in deposit_inputs(dev):
        ref = D.deposit(v, f, ncell).view(torch.int32)
        for name, (lib, _) in builds.items():
            got = on_library(lib, lambda: D.deposit(v, f, ncell))
            cs.check(torch.equal(got.view(torch.int32), ref),
                     f"deposit ({label}): build {name} differs")
        times = [(name, on_library(builds[name][0], lambda: cs.device_ms(
            lambda: D.deposit(v, f, ncell), 10, match="deposit_kernel")))
            for name in order]
        print(f"deposit, {label}: held against this build (bitwise); "
              "device ms per call " + " | ".join(
                  f"{n} {ms:.4f}" for n, ms in times) + f" | card: {card}",
              flush=True)
    solver, s = cs.two_way_jet(dev)
    step = solver.make_step()
    box = [step(s)]

    def one():
        box[0] = step(box[0])

    times = [(name, on_library(builds[name][0],
                               lambda: cs.cuda_ms(one, 20, warmup=2)))
             for name in order]
    print("deposit, the two-way jet's step: ms/step " + " | ".join(
        f"{n} {ms:.3f}" for n, ms in times) + f" | card: {card}", flush=True)


def agree(kernel, ref, got) -> None:
    """Hold one build's output against "this" build's."""
    if kernel == "update3":
        C = (slice(1, -1),) * 3
        pairs = [(a[C], b[C]) for a, b in zip(ref[0], got[0])]
        for a, b in pairs + [(ref[1], got[1])]:
            cs.check(cs.rel_err(a, b) <= 1e-5,
                     f"qgd3d_update differs by {cs.rel_err(a, b):.2e}")
        return
    if kernel == "update":
        C = (slice(1, -1),) * 2
        for a, b in zip(ref[0], got[0]):
            cs.check(cs.rel_err(a[C], b[C]) <= 1e-5,
                     f"qgd2d_update differs by {cs.rel_err(a[C], b[C]):.2e}")
        return
    if kernel in ("dt", "fold", "dt3", "fold3"):
        cs.check(torch.equal(ref, got), f"{kernel}: {got.tolist()} against "
                 f"this build's {ref.tolist()}")
        return
    if kernel in ("sensor3", "sensor_ring1"):
        ref, got = (ref, got) if kernel == "sensor_ring1" else ((ref,), (got,))
        cs.check(cs.rel_err(ref[0], got[0]) <= 1e-6
                 and all(float(a) == float(b) for a, b in zip(ref[1:], got[1:])),
                 f"{kernel} differs by {cs.rel_err(ref[0], got[0]):.2e}")
        return
    if kernel != "emit":
        cs.check(all(torch.equal(a, b) for a, b in zip(ref, got)),
                 f"{kernel} differs")
        return
    for i, (a, b) in enumerate(zip(ref, got)):
        if a is None:
            continue
        ok = cs.rel_err(a, b) <= 1e-6 if i < 2 else torch.equal(a, b)
        cs.check(ok, f"qgd2d_emit output {i} differs")


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this comparison needs the card")
    from qgdsolver_tpu_torch.ops import _build
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.ops import fused_qgd3d as F3

    this = (_build.load(), _build.ptxas_report())
    builds = {"qgd2d": {"this": this}, "qgd3d": {"this": this},
              "deposit": {"this": this}}
    only = set()
    if argv[:1] == ["--only"]:
        only, argv = set(argv[1].split(",")), argv[2:]
    for arg in argv:
        name, _, path = arg.partition("=")
        kind = pathlib.Path(path).name
        kind = "deposit" if kind.startswith("deposit") else kind[:5]
        if not path or kind not in builds or name in builds[kind]:
            raise SystemExit("usage: ab_kernels.py [--only KERNEL,...] "
                             "NAME=PATH/qgd2d.cu|qgd3d.cu|deposit.cu ... "
                             f"({arg!r})")
        builds[kind][name] = build_other(name, pathlib.Path(path))
    card = cs.card_line()
    for kind, kernels in PTXAS.items():
        for kern in kernels:
            name = kern if isinstance(kern, str) else kern[0]
            print(f"{name}: " + " | ".join(
                f"{n} {registers(rep, kern)}"
                for n, (_, rep) in builds[kind].items()), flush=True)
    fns = {"update": F.qgd2d_update, "emit": F.qgd2d_emit,
           "smooth": F.qgd2d_smooth, "continuation": continuation,
           "dt": F.qgd2d_dt, "fold": F.qgd2d_dt_fold, "ghosts": ghosts,
           "smooth3": F3.qgd3d_smooth, "continuation3": continuation3,
           "step_smooth3": step_smooth3,
           "sensor_ring1": sensor_ring1, "sensor3": F3.qgd3d_sensor,
           "dt3": F3.qgd3d_dt, "fold3": F3.qgd3d_dt_fold,
           "ghosts3": ghosts3, "update3": F3.qgd3d_update}
    # the smoothing loops return one frame; their launches depend on the
    # data, so their device time is the sum of what they ran
    loops = ("continuation", "continuation3", "step_smooth3")
    runs = []
    if len(builds["qgd2d"]) > 1:
        others = {n: b for n, b in builds["qgd2d"].items() if n != "this"}
        print(sweep_2d(others, "cuda"), flush=True)
        runs += [("qgd2d", job) for job in inputs("cuda")]
    if len(builds["qgd3d"]) > 1:
        if not only or "update3" in only:
            runs += [("qgd3d", job) for job in update_inputs3("cuda")]
        if not only or only - {"update3"}:
            runs += [("qgd3d", job) for job in inputs3("cuda")]
    runs = [r for r in runs if not only or r[1][1] in only]
    if len(builds["deposit"]) > 1:
        deposit_runs(builds["deposit"], "cuda", card)
    for kind, (label, kernel, args) in runs:
        these = builds[kind]
        order = list(these) + list(these)[::-1]
        ref = fns[kernel](*args)
        if kernel in loops or kernel in ("dt", "fold", "dt3", "fold3",
                                         "sensor3"):
            ref = ref.clone()
        if kernel == "sensor_ring1":
            ref = tuple(x.clone() for x in ref)
        if kernel in loops:
            ref = (ref,)
        for name, (lib, _) in these.items():
            got = on_library(lib, lambda: fns[kernel](*args))
            agree(kernel, ref, (got,) if kernel in loops else got)
        extra = ""
        if kernel in loops:
            smooth = F.qgd2d_smooth if kind == "qgd2d" else F3.qgd3d_smooth
            rings, launches = smooth.rings, smooth.launches
            fns[kernel](*args)
            extra = (f" ({smooth.rings - rings} rings in "
                     f"{smooth.launches - launches} launches a call)")
        times = [(name, on_library(these[name][0], lambda: cs.device_ms(
            lambda: fns[kernel](*args), 20, match="qgd",
            same=kernel not in loops))) for name in order]
        name = NAMES.get(kernel, kernel.rstrip("3"))
        held = (" (bitwise)" if kernel not in ("update", "emit", "sensor3",
                                               "sensor_ring1", "update3")
                else " (rel 1e-6)" if kernel.startswith("sensor") else "")
        if label in BOUNDS:
            extra += " | bound {:.4f} ms by {}".format(*BOUNDS[label])
            extra += " | launch (tile, chunk, shared B, blocks/SM): " + \
                ", ".join(f"{n} {update_launch(lib, args[0])}"
                          for n, (lib, _) in these.items())
        print(f"{kind}_{name}, {label}: held against this build{held}; "
              "device ms per call "
              + " | ".join(f"{n} {ms:.4f}" for n, ms in times)
              + extra + f" | card: {card}", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
