"""Case-runner CLI (PyTorch port of `qgdsolver_tpu.cli`): the executable
surface of the reference solvers.

    python -m qgdsolver_tpu_torch <case_dir> [--device cuda|cpu]
        [--max-steps N] [--chunk K] [--no-fused] [--devices PXxPY]
    torchrun --nproc-per-node N -m qgdsolver_tpu_torch <case_dir>
        --devices PXxPY

Reads an OpenFOAM-layout case directory (`io.foam_case.build_case`: the
QGD solvers, the QHD family with QHDDyMFoam, scalar transport,
interQHDFoam, and the Lagrangian and reacting applications, whose t and dt
are their fluid State's), runs
chunks of K steps with `solvers.common.run_steps` (the adaptive dt stays on
the device; `t` is read back once per chunk), writes OpenFOAM-format time
directories via `io.foam_write` whenever the solution time crosses the next
write threshold (adjustableRunTime lands on it exactly; writeControl
timeStep counts steps), and prints the reference-style Time/deltaT lines.

On a CUDA device a config the fused kernels take runs on them
(`QGDFoam.fused_builder()`; the log names the builder); otherwise, and with
--no-fused, the composable step runs (the log says when the fused gates
refused the config: every application but QGDFoam).  `--device cuda` without a card is an
error: there is no fallback to the CPU.

--devices PXxPY decomposes the case over PX*PY ranks, the reference's
`decomposePar + mpirun <solver>`: outside a launched world the CLI starts
the ranks itself (`parallel.distributed.spawn`), under `torchrun` it joins
the launcher's world.  Every rank builds the case; on a CUDA device a config
the kernels take, on blocks that divide the mesh, runs K3
(`build_sharded_fused_step`, 2D) or K5 (`build_sharded_fused_step_3d`, 3D
x-ring), otherwise the decomposed composable step
(`parallel.sharding.build_spmd_step`; a Lagrangian cloud's parcels go to
the ranks whose blocks hold them, and a tabulated reacting case is
refused with `sharding.spmd_supported`'s reason); the log names which.
Rank 0 alone logs and writes, after the fields are gathered.  A decomposed
cloud's lost parcels are read with t once a chunk
(`particles.raise_dropped`), and raise.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time

import torch
import torch.distributed as dist


def run_case(case_dir: str, max_steps=None, chunk: int = 50,
             log=print, fused: str = "auto", device="cuda",
             devices=None) -> int:
    """Run the case to controlDict endTime; returns the step count.

    fused: "auto" takes the fused kernel path when `device` is a CUDA
    device and the config supports it (the carry stays in the kernels'
    frame layout between chunks and converts back only for writes);
    "never" forces the composable step; "always" takes the fused path of a
    supported config on any device (on the CPU its wrappers run their
    plain versions, which is how the tests drive this path).

    devices: "PXxPY" runs the case decomposed over PX*PY ranks (see the
    module docstring); rank 0's log lines reach `log`.
    """
    from .parallel import distributed, sharding

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA device is available")
    if devices is None:
        return _run(case_dir, max_steps, chunk, log, fused, device, None)
    grid = sharding.ProcessGrid.parse(devices)
    if distributed.initialize(device, log=log):
        quiet = dist.get_rank() != 0
        return _run(case_dir, max_steps, chunk,
                    (lambda *_: None) if quiet else log, fused, device, grid)
    if device.type == "cuda":
        from .ops import _build

        _build.load()  # once, here: the ranks only load the library
    n, lines = distributed.spawn(_rank_run, grid.size, case_dir, max_steps,
                                 chunk, fused, str(device), devices,
                                 device=device)[0]
    for line in lines:
        log(line)
    return n


def _rank_run(case_dir, max_steps, chunk, fused, device, devices):
    """One spawned rank of `run_case(..., devices=...)`: (steps, rank 0's
    log lines)."""
    from .parallel import sharding

    lines = []
    log = lines.append if dist.get_rank() == 0 else (lambda *_: None)
    n = _run(case_dir, max_steps, chunk, log, fused, torch.device(device),
             sharding.ProcessGrid.parse(devices))
    return n, lines


def _sharded_builder(solver, grid):
    """K3 or K5 for a config the kernels take on `grid`, else None."""
    from .ops import fused_qgd2d, fused_qgd3d

    if solver.mesh.ndim == 2 and fused_qgd2d.sharded_supported(solver, grid):
        return fused_qgd2d.build_sharded_fused_step
    if solver.mesh.ndim == 3 and fused_qgd3d.sharded_supported(solver, grid):
        return fused_qgd3d.build_sharded_fused_step_3d
    return None


def _run(case_dir, max_steps, chunk, log, fused, device, grid) -> int:
    """run_case on this process: the whole case (grid None) or this rank's
    block of it."""
    from .io import foam_case, foam_write, foamdict
    from .parallel import distributed, sharding
    from .solvers import common, particles

    writer = True
    if grid is not None:
        device = distributed.rank_device(device)
        writer = dist.get_rank() == 0
    solver, state = foam_case.build_case(case_dir, device=device)
    control = foamdict.parse_file(
        os.path.join(case_dir, "system", "controlDict"))
    end_time = float(control.get("endTime", math.inf))
    write_control = str(control.get("writeControl", "adjustableRunTime"))
    if isinstance(control.get("writeControl"), list):
        write_control = str(control["writeControl"][0])
    write_interval = float(control.get("writeInterval", 0.0) or 0.0)

    from_fused = None
    want_fused = fused == "always" or (fused == "auto"
                                       and device.type == "cuda")
    if grid is not None:
        where = f"({grid.px}x{grid.py} ranks)"
        builder = _sharded_builder(solver, grid) if want_fused else None
        if builder is not None:
            step, to_sharded, from_fused = builder(solver, grid)
            state = to_sharded(state)
            log(f"fused kernel path engaged: {builder.__name__} {where}")
        else:
            step, to_spmd, from_fused = sharding.build_spmd_step(solver, grid)
            state = to_spmd(state)
            log(f"composable step engaged: build_spmd_step {where}")
    elif (want_fused and hasattr(solver, "fused_supported")
          and solver.fused_supported()):  # only QGDFoam has fused steps
        builder = solver.fused_builder()
        step, to_fused, from_fused = builder(solver)
        state = to_fused(state)
        log(f"fused kernel path engaged: {builder.__name__}")
    else:
        step = solver.make_step()
        log("composable step engaged: make_step" + (
            f" (the fused gates refuse this {type(solver).__name__} config)"
            if want_fused else ""))

    def fluid(s):
        # the Lagrangian solvers' t and dt are their fluid State's
        return getattr(s, "fluid", s)

    def in_t(x):
        # a time as the carried t holds it: in f32 an instant between two
        # f32 values can never be landed on, and the landing step below
        # would trim dt to a remainder the f32 sum t + dt cannot add
        if not math.isfinite(x):
            return x
        return float(torch.tensor(x, dtype=fluid(state).t.dtype))

    def now(s):
        # the once-a-chunk host read: t, and a decomposed cloud's lost
        # parcels (raises)
        particles.raise_dropped(s)
        return float(fluid(s).t)

    end_time = in_t(end_time)
    t = float(fluid(state).t)
    n_steps = 0
    by_steps = write_control == "timeStep"
    next_write = None
    if write_interval > 0.0:
        next_write = (n_steps + write_interval if by_steps
                      else in_t(t + write_interval))

    def write():
        # decomposed: every rank joins the gather, rank 0 writes
        view = from_fused(state) if from_fused else state
        if not writer:
            return None
        tdir = foam_write.write_state(case_dir, solver, view)
        log("writing fields to %s" % tdir)
        return tdir

    adjustable = (not by_steps
                  and getattr(solver, "time", None) is not None
                  and solver.time.adjust_time_step)

    def _set_dt(s, dt_val):
        # carried-dt surgery between chunks: the controller's growth cap is
        # exactly 1.2x, so seeding dt = (target - t)/1.2 makes the next
        # step land ON the target when the CFL allows (Time::adjustDeltaT
        # parity, adjustableRunTime)
        f = fluid(s)
        f = f._replace(dt=torch.as_tensor(dt_val, dtype=f.dt.dtype,
                                          device=f.dt.device))
        return s._replace(fluid=f) if hasattr(s, "fluid") else f

    t_wall = time.perf_counter()
    while t < end_time and (max_steps is None or n_steps < max_steps):
        target = end_time
        if adjustable and next_write is not None:
            target = min(target, next_write)
        k = chunk if max_steps is None else min(chunk, max_steps - n_steps)
        dt_cur = max(float(fluid(state).dt), 1e-300)
        if math.isfinite(target):
            remaining = target - t
            if adjustable and remaining <= dt_cur * 1.2 * (1 + 1e-12):
                # landing step: trim dt to hit the write/end instant
                state = _set_dt(state, remaining / 1.2)
                state = common.run_steps(step, state, 1)
                n_steps += 1
                t = now(state)
                log("Time = %.8g  deltaT = %.8g  (%d steps, %.1f s)"
                    % (t, float(fluid(state).dt), n_steps,
                       time.perf_counter() - t_wall))
                if next_write is not None and t >= next_write * (1 - 1e-9):
                    write()
                    while next_write <= t * (1 + 1e-9):
                        next_write = in_t(next_write + write_interval)
                continue
            # bound the chunk so the run approaches the next stop without
            # overshooting it; dt may grow 1.2x per step COMPOUNDING, so
            # the k-step distance is at most dt*1.2*(1.2^k - 1)/0.2
            if adjustable:
                k_geo = int(math.log(remaining * (0.2 / 1.2) / dt_cur + 1.0)
                            / math.log(1.2))
                k = max(1, min(k, k_geo))
            else:
                k = max(1, min(k, int(remaining / dt_cur) + 1))
        state = common.run_steps(step, state, k)
        n_steps += k
        t = now(state)
        log("Time = %.8g  deltaT = %.8g  (%d steps, %.1f s)"
            % (t, float(fluid(state).dt), n_steps,
               time.perf_counter() - t_wall))
        if next_write is not None:
            due = (n_steps >= next_write) if by_steps else (t >= next_write)
            if due:
                write()
                while by_steps and next_write <= n_steps:
                    next_write += write_interval
                while not by_steps and next_write <= t:
                    next_write = in_t(next_write + write_interval)
    tdir = write()
    log("End.  Final fields in %s" % tdir)
    return n_steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m qgdsolver_tpu_torch",
        description="Run an OpenFOAM-layout case directory "
                    "(application from system/controlDict).")
    ap.add_argument("case", help="case directory")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
                         "the composable step)")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop after N steps even before endTime")
    ap.add_argument("--chunk", type=int, default=50,
                    help="steps between reads of the solution time "
                         "(default 50)")
    ap.add_argument("--no-fused", action="store_true",
                    help="force the composable step (skip the fused CUDA "
                         "kernel path)")
    ap.add_argument("--devices", default=None, metavar="PXxPY",
                    help="decompose the case over PX*PY ranks (started "
                         "here, or by torchrun)")
    args = ap.parse_args(argv)
    run_case(args.case, max_steps=args.max_steps, chunk=args.chunk,
             fused="never" if args.no_fused else "auto", device=args.device,
             devices=args.devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
