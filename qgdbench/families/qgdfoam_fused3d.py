"""The fused 3D QGDFoam family: how its configurations build the program's
step, and its plain reference, and what `correct` compares.

The program is `qgdsolver_tpu_torch` through its public entries: the
configuration's case builder in `cases`, the solver's State from
`solver.init`, and `solver.make_fused_step()`, the fused 3D step on the
CUDA kernels (`ops/fused_qgd3d.build_fused_step_3d`); with plain=True, the
same builder's plain torch path, which runs on the CPU.  A segment is one
call of `solvers.common.run_steps`.

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
from qgdsolver_tpu_torch.ops import fused_qgd3d, smoothing
from qgdsolver_tpu_torch.solvers import common

from qgdbench import roofline
from qgdbench.reference import qgd3d as reference_step

KERNELS = ("qgd3d_dt", "qgd3d_update", "qgd3d_emit", "qgd3d_ghosts",
           "qgd3d_smooth")


def cells(cfg) -> int:
    nx, ny, nz = cfg["shape"]
    return nx * ny * nz


class Program:
    """The program's step for a configuration, on `device`."""

    def __init__(self, cfg, device, plain=False):
        solver, state = getattr(cases, cfg["case"])(
            shape=tuple(cfg["shape"]), dtype=getattr(torch, cfg["dtype"]),
            mach=cfg["mach"], device=device)
        del state  # the traffic makes the initial fields
        if plain:
            self.step, self.to_fused, _ = fused_qgd3d.build_fused_step_3d(
                solver, plain=True)
        else:
            self.step, self.to_fused, _ = solver.make_fused_step()
        self.solver = solver

    def start(self, fields):
        """The step's carry of the primitive cell fields, through the
        solver's State."""
        state = self.solver.init(p0=fields["p"], T0=fields["T"],
                                 U0=fields["U"], sc0=fields.get("sc"))
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
        """The program's counters: each kernel's launches, the 3D smoothing
        kernel's rings and the host flag reads and rings of
        `smoothing.smooth_sensor`."""
        out = {f"fused_qgd3d.{k}.launches": getattr(fused_qgd3d, k).launches
               for k in KERNELS}
        out["fused_qgd3d.qgd3d_smooth.rings"] = fused_qgd3d.qgd3d_smooth.rings
        out["smoothing.smooth_sensor.reads"] = smoothing.smooth_sensor.reads
        out["smoothing.smooth_sensor.rings"] = smoothing.smooth_sensor.rings
        return out


def step_least(cfg):
    """(bytes, float operations) a whole step needs, however it is split
    into kernels: the carried frames read and the new ones written once
    (five each way, and the sensor frame for varScModel5), and the
    operations of the plain dt and update (counted on the meta device at
    the configuration's shape)."""
    shape = cfg["shape"]
    prm = reference_step.params(cfg)
    nbytes = 4 * 2 * (5 + prm.varsc) * math.prod(n + 2 for n in shape)
    frames = [roofline.meta_frame(shape) for _ in range(5)]
    sc = roofline.meta_frame(shape) if prm.varsc else None
    dt = torch.empty((), dtype=torch.float32, device="meta")

    def step():
        reference_step.update(prm, *frames, sc,
                              reference_step.new_dt(prm, *frames[1:], dt))

    return nbytes, roofline.count_ops(step)


def reference(cfg, fields, steps, dtype=None) -> dict:
    """The plain reference's outputs after `steps` steps, in `dtype` (the
    configuration's by default)."""
    return reference_step.run(cfg, fields, steps, dtype)


def _worst(xs) -> float:
    """The largest of xs, NaN if any is NaN (Python's max can drop one)."""
    xs = list(xs)
    return float("nan") if any(x != x for x in xs) else max(xs)


def _rel(got, want) -> float:
    """Largest |got - want| over the largest |want|, got and want lists of
    frames taken together."""
    gap = _worst(float((g.float() - w.float()).abs().max())
                 for g, w in zip(got, want))
    scale = max(float(w.float().abs().max()) for w in want)
    return gap / max(scale, 1e-30)


def gaps(got, want) -> dict:
    """The numbers compared (see the module's docstring)."""
    vel = ("ux", "uy", "uz")
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
