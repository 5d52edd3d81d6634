"""The fused 2D QGDFoam family (K2): how its configurations build the
program's step, and its plain reference, and what `correct` compares.

A configuration holds the 2D mesh one cell deep (`shape` [nx, ny, 1]), so
that the traffic generator makes its fields; the family drops the third
axis and uz.  The program is `qgdsolver_tpu_torch` through its public
entries: the configuration's case builder in `cases` at (nx, ny), the
solver's State from `solver.init`, and `solver.make_fused_step()`, which
sends a 2D varScModel5 solver to K2 (`ops/fused_qgd2d.build_tiled_fused_step`:
`qgd2d_update`, `qgd2d_ghosts`, `qgd2d_emit` and the smoothing continuation
on `qgd2d_smooth`); with plain=True, the same builder's plain torch path,
which runs on the CPU.  A segment is one call of
`solvers.common.run_steps`.

The numbers compared with the reference after one segment: `fields_gap`,
the largest gap of the p and T frames, each over its reference's largest
magnitude, and of the velocity frames over the reference's largest
velocity component (ghosts included, so the BCs); `dt_gap`, the relative
gap of dt and of t; and for varScModel5 `sensor_gap`, the gap of the
step's sensor frame and of the first smoothing ring of the last fields,
over the reference sensor's largest value.
"""
from __future__ import annotations

import math

import torch
from qgdsolver_tpu_torch import cases
from qgdsolver_tpu_torch.ops import fused_qgd2d, smoothing
from qgdsolver_tpu_torch.solvers import common

from qgdbench import roofline
from qgdbench.families.qgdfoam_fused3d import _rel, _worst
from qgdbench.reference import qgd2d as reference_step

# the wrappers K2 launches (K1's dt never runs in its window: the emit
# gives the next step's dt)
KERNELS = ("qgd2d_dt", "qgd2d_update", "qgd2d_ghosts", "qgd2d_emit",
           "qgd2d_smooth")


def cells(cfg) -> int:
    nx, ny, _ = cfg["shape"]
    return nx * ny


class Program:
    """The program's step for a configuration, on `device`."""

    def __init__(self, cfg, device, plain=False):
        solver, state = getattr(cases, cfg["case"])(
            shape=tuple(cfg["shape"][:2]), dtype=getattr(torch, cfg["dtype"]),
            mach=cfg["mach"], device=device)
        del state  # the traffic makes the initial fields
        if plain:
            self.step, self.to_fused, _ = \
                fused_qgd2d.build_tiled_fused_step(solver, plain=True)
        else:
            self.step, self.to_fused, _ = solver.make_fused_step()
        self.solver = solver

    def start(self, fields):
        """The step's carry of the primitive cell fields, through the
        solver's State."""
        p, T, U = reference_step.plane_fields(fields)
        sc = fields.get("sc")
        state = self.solver.init(p0=p, T0=T, U0=U,
                                 sc0=None if sc is None else sc[..., 0])
        return self.to_fused(state)

    def segment(self, carry, n):
        return common.run_steps(self.step, carry, n)

    @staticmethod
    def outputs(carry) -> dict:
        out = {k: getattr(carry, k) for k in reference_step.FIELDS}
        out.update(t=carry.t, dt=carry.dt)
        if carry.sc is not None:
            out.update(sc=carry.sc, s1=carry.sc_s1)
        return out

    @staticmethod
    def counters() -> dict:
        """The program's counters: each K2 wrapper's launches, the 2D
        smoothing kernel's rings and the host flag reads and rings of
        `smoothing.smooth_sensor`."""
        out = {f"fused_qgd2d.{k}.launches": getattr(fused_qgd2d, k).launches
               for k in KERNELS}
        out["fused_qgd2d.qgd2d_smooth.rings"] = fused_qgd2d.qgd2d_smooth.rings
        out["smoothing.smooth_sensor.reads"] = smoothing.smooth_sensor.reads
        out["smoothing.smooth_sensor.rings"] = smoothing.smooth_sensor.rings
        return out


def step_least(cfg):
    """(bytes, float operations) a whole step needs, however it is split
    into kernels: the carried frames read and the new ones written once
    (four each way, and the sensor frame for varScModel5), and the
    operations of the plain update and emit, which gives the next step's
    dt and the raw sensor's first ring (counted on the meta device at the
    configuration's shape)."""
    shape = cfg["shape"][:2]
    prm = reference_step.params(cfg, "meta")
    nbytes = 4 * 2 * (4 + prm.varsc) * math.prod(n + 2 for n in shape)
    frames = [roofline.meta_frame(shape) for _ in range(4)]
    sc = roofline.meta_frame(shape) if prm.varsc else None
    dt = torch.empty((), dtype=torch.float32, device="meta")

    def step():
        new, _ = reference_step.update(prm, *frames, sc, dt)
        reference_step.emit(prm, *new, sc)

    return nbytes, roofline.count_ops(step)


def reference(cfg, fields, steps, dtype=None) -> dict:
    """The plain reference's outputs after `steps` steps, in `dtype` (the
    configuration's by default)."""
    return reference_step.run(cfg, fields, steps, dtype)


def gaps(got, want) -> dict:
    """The numbers compared (see the module's docstring)."""
    vel = ("ux", "uy")
    out = {"fields_gap": _worst([_rel([got["p"]], [want["p"]]),
                                 _rel([got["T"]], [want["T"]]),
                                 _rel([got[k] for k in vel],
                                      [want[k] for k in vel])]),
           "dt_gap": _worst([_rel([got["dt"]], [want["dt"]]),
                             _rel([got["t"]], [want["t"]])])}
    if "sc" in want:
        out["sensor_gap"] = _worst([_rel([got["sc"]], [want["sc"]]),
                                    _rel([got["s1"]], [want["s1"]])])
    return out
