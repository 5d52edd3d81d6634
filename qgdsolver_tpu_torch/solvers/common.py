"""Shared solver building blocks: time-step control, Courant numbers, runner
(PyTorch port of `qgdsolver_tpu.solvers.common`).

The adaptive dt is a 0-dim tensor in the solver state, so a run never reads
it back to the host.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from ..core import bc as bcm
from ..core.mesh import Mesh
from ..parallel import spmd

SMALL = 1e-30


def e_bcs_from_T(bc_T: bcm.FieldBCs, e_of_T, Cv=None) -> bcm.FieldBCs:
    """Internal-energy BCs derived from the T BCs, e_wall = e(T_wall), for
    the implicit heat-diffusion solve (the reference's e patches derived
    from the T patches); the constant de/dT Cv converts a FixedGradient of
    T (grad_e = Cv*grad_T).  With a T-dependent cv (Cv None, the JANAF
    thermo) a FixedGradient T BC has no such conversion and raises.  Plain
    values become float64 numpy arrays (tensors stay tensors), cast to the
    field's dtype where the BC is applied."""

    def e_of(v):
        return e_of_T(v if torch.is_tensor(v) else np.asarray(v, np.float64))

    def lifted(fn, raw):
        if callable(raw):
            return lambda t_, c_: fn(raw(t_, c_))
        return fn(raw)

    def t2e(b):
        if isinstance(b, bcm.FixedValue):
            return bcm.FixedValue(lifted(e_of, b.value))
        if isinstance(b, bcm.InletOutlet):
            return bcm.InletOutlet(lifted(e_of, b.inlet_value))
        if isinstance(b, bcm.FixedGradient):
            if Cv is None:
                raise ValueError(
                    "FixedGradient T BC with a T-dependent cv: no static "
                    "grad_e conversion exists (use ZeroGradient or "
                    "FixedValue)")
            return bcm.FixedGradient(lifted(
                lambda g: Cv * (g if torch.is_tensor(g)
                                else np.asarray(g, np.float64)), b.grad))
        if isinstance(b, bcm.Mixed):
            return bcm.Mixed(lifted(e_of, b.value), b.fraction)
        return b

    return bc_T.map(t2e)


@dataclasses.dataclass(frozen=True)
class TimeControls:
    """controlDict equivalents."""

    adjust_time_step: bool = True
    max_co: float = 0.5
    max_dt: float = 1.0
    c_tau: float = 0.75
    dt0: float = 1e-6


def set_delta_t(dt, co_num, tau_f_min, tc: TimeControls):
    """setDeltaT-QGDQHD.H: immediate reduction, damped increase (at most
    x1.2 per step), capped by maxDeltaT and cTau*min(tau_f)."""
    if not tc.adjust_time_step:
        return dt
    max_fact = tc.max_co / (co_num + SMALL)
    fact = torch.clamp(torch.minimum(max_fact, 1.0 + 0.1 * max_fact), max=1.2)
    max_dt1 = torch.clamp(tc.c_tau * tau_f_min, max=tc.max_dt)
    return torch.minimum(fact * dt, max_dt1)


def courant_acoustic(Uf, cf, dt, mesh: Mesh):
    """QGD acoustic Courant: max over faces of max(|Un+c|,|Un-c|)*dt/h_f,
    global under an spmd context (the reference's gMax; a partition face is
    counted by both its blocks, which max does not mind)."""
    co = None
    for a in range(mesh.ndim):
        un = Uf[a][a]
        wave = torch.maximum(torch.abs(un + cf[a]), torch.abs(un - cf[a]))
        m = torch.max(wave * dt / mesh.h_face(a))
        co = m if co is None else torch.maximum(co, m)
    return spmd.all_max(co)


def courant_advective(Uf, dt, mesh: Mesh):
    """QHD advective Courant: max over faces of |Un|*dt/h_f, global under
    an spmd context."""
    co = None
    for a in range(mesh.ndim):
        m = torch.max(torch.abs(Uf[a][a]) * dt / mesh.h_face(a))
        co = m if co is None else torch.maximum(co, m)
    return spmd.all_max(co)


def courant_mag(Uf, dt, mesh: Mesh):
    """scalarTransportQHDFoam's Courant: max over faces of |Uf|*dt/h_f
    (the whole face velocity's magnitude), global under an spmd
    context."""
    co = None
    for a in range(mesh.ndim):
        mag = torch.sqrt(torch.sum(torch.square(Uf[a]), dim=0))
        m = torch.max(mag * dt / mesh.h_face(a))
        co = m if co is None else torch.maximum(co, m)
    return spmd.all_max(co)


def tau_f_min(tau_f):
    return spmd.all_min(torch.min(torch.stack([torch.min(tf)
                                               for tf in tau_f])))


class NonphysicalStateError(RuntimeError):
    """Raised by the checked runner when a prognostic field goes nonfinite
    or nonpositive (the reference aborts on negative e or rho, and writes
    the fields first); `dump_path` is the checkpoint of the bad state."""

    def __init__(self, message, dump_path=None):
        super().__init__(message)
        self.dump_path = dump_path


def run_steps(step_fn, state, n_steps: int, log_every: int = 0,
              log_fn: tp.Optional[tp.Callable] = None,
              check_every: int = 0,
              check_fields: tp.Tuple[str, ...] = ("rho", "rhoE"),
              dump_dir: tp.Optional[str] = None):
    """Run `n_steps` of `step_fn` in a Python loop.

    With check_every > 0 the named state fields are checked for finiteness
    and positivity at that cadence (a device sync each time); on failure
    the whole state is written by `utils.checkpoint.save` to `dump_dir`
    (default "nonphysical_dump") and NonphysicalStateError is raised with
    its path.  log_fn(done, state) runs every log_every steps.  With both 0
    the loop never syncs with the device.  While a `torch.profiler`
    session is open the call is a `qgd.run_steps` span and each step a
    `qgd.step` span, summarised in `utils.observability.segment_log()`.
    """
    from ..utils import checkpoint, observability

    seg = observability.segment()  # None while no profiler session is open
    try:
        for done in range(1, n_steps + 1):
            state = step_fn(state) if seg is None else seg.step(step_fn,
                                                                state)
            if check_every > 0 and done % check_every == 0:
                bad = observability.nonphysical_dump(state, check_fields,
                                                     out=lambda *_: None)
                if bad:
                    path = checkpoint.save(
                        state, dump_dir or "nonphysical_dump", done)
                    raise NonphysicalStateError(
                        f"nonphysical state at step {done}: {bad} "
                        f"(state dumped to {path})", dump_path=path)
            if log_fn is not None and log_every > 0 and done % log_every == 0:
                log_fn(done, state)
    finally:
        if seg is not None:
            seg.close()
    return state
