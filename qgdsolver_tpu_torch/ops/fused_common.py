"""What the fused 2D and 3D QGDFoam steps (`fused_qgd2d`, `fused_qgd3d`)
share: their gate, the BC kinds and pieces of the plain kernels, and the
conversion between the composable State and the ghost-padded frames.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import bc as bcm
from ..physics.qgdcoeffs import VarScModel5
from ..physics.thermo import ConstTransport, PerfectGasThermo
from ..solvers import common
from . import fvsc
from .pad import ghost_pad

# the ghost kinds of the kernels' BCEntry (csrc/*.cu)
KINDS = {"zg": 0, "fixed": 1, "grad": 2, "sym": 3, "extrap": 4, "io": 5,
         "qgdflux": 6}


def raw_value(b):
    """A BC's value (inletOutlet: its inlet value) or gradient spec; None
    for kinds without one."""
    if isinstance(b, bcm.FixedValue):
        return b.value
    if isinstance(b, bcm.FixedGradient):
        return b.grad
    if isinstance(b, bcm.InletOutlet):
        return b.inlet_value
    return None


def common_gate(solver, ndim: int) -> bool:
    """The conditions both fused steps (2D and 3D) share: an explicit
    QGDFoam on a uniform `ndim`-D f32 planar mesh without solid cells,
    perfect gas with constant transport, the `full` stencil, and qgdFlux p
    (unlimited, unrelaxed) only on x sides.  The BC kinds are each step's
    own test: neither takes Mixed, Segmented or waveTransmissive sides."""
    from ..solvers.qgd import QGDFoam

    if type(solver) is not QGDFoam:
        return False
    mesh = solver.mesh
    if mesh.ndim != ndim or mesh.dtype != torch.float32:
        return False
    if mesh.axisymmetric or mesh.solid is not None:
        return False  # hoop sources, stairstep walls: composable only
    if not all(np.allclose(d, d[0]) for d in mesh.dx):
        return False
    th = solver.thermo
    if not (isinstance(th, PerfectGasThermo)
            and isinstance(th.transport, ConstTransport)):
        return False
    if solver.implicit_diffusion:
        return False
    if solver.qgdflux_limit is not None or solver.qgdflux_relax != 1.0:
        return False
    for term in ("grad(U)", "grad(e)", "grad(rho)", "grad(p)"):
        if fvsc.scheme_for(solver.fvsc_scheme, term) != "full":
            return False
    return all(a == 0 for a, _ in solver._flux_sides())


def one_cell_extrapolation(solver, grid) -> bool:
    """True if the blocks of `grid` are one cell wide along a partitioned
    axis on whose sides some field's BC is extrapolated: at a physical side
    that ghost reads the second layer, the block's halo, which the exchange
    of a decomposed step fills only after the ghosts (K3, K5)."""
    return any(p > 1 and n // p == 1 and any(
        isinstance(bcs[a, side], bcm.Extrapolated)
        for bcs in solver._bcs() for side in (0, 1))
        for a, (n, p) in enumerate(zip(solver.mesh.shape,
                                       (grid.px, grid.py))))


# ---------------------------------------------------------------------------
# pieces of the plain versions of the kernels
# ---------------------------------------------------------------------------


def zg(f, edges=()):
    """Coefficient ghosts: zero-gradient copies of the edge cells (any
    number of axes).  edges[a] = (lo, hi) are the physical-boundary flags of
    axis a (axes past the tuple are physical on both sides); a partition
    side keeps its halo cell."""
    for a, n in enumerate(f.shape):
        lo, hi = edges[a] if a < len(edges) else (1, 1)
        idx = torch.arange(n, device=f.device).clamp(1 if lo else 0,
                                                     n - 2 if hi else n - 1)
        f = f.index_select(a, idx)
    return f


def time_controls(prm):
    """The setDeltaT controls held in a kernel's params."""
    return common.TimeControls(adjust_time_step=bool(prm.adjust_dt),
                               max_co=prm.max_co, max_dt=prm.max_dt,
                               c_tau=prm.c_tau)


def bc_ghost(entry, in1, in2, d, v, un, sd):
    """The ghost of a BCEntry from the first and second interior layers, the
    spacing d, the value v and the outward velocity un of the adjacent cell
    (inletOutlet) on side sd."""
    kind = entry.kind
    if kind == KINDS["sym"]:
        return entry.value * in1
    if kind == KINDS["extrap"]:
        return 2.0 * in1 - in2
    if kind == KINDS["fixed"]:
        return 2.0 * v - in1
    if kind == KINDS["io"]:
        outflow = (un < 0) if sd == 0 else (un > 0)
        return torch.where(outflow, in1, 2.0 * v - in1)
    if kind == KINDS["grad"]:
        return in1 + v * d
    return in1  # zero gradient


def x_ghosts(prm, frames, side, table, dx):
    """The x phase of the plain ghost kernels, in place on the fresh
    frames' interior lanes: at each physical x end, each field's ghost from
    its interior (qgdFlux p: interior +- side*dx), `side` the (2, ...)
    ws/tau_f and `table` the profile rows (2D) or planes (3D), both over the
    interior lanes.  inletOutlet switches on the fresh ux of the adjacent
    cell."""
    nx = frames[0].shape[0] - 2
    lanes = (slice(1, -1),) * (frames[0].ndim - 1)
    ux = frames[2]
    for f, fld in enumerate(frames):
        for sd, physical in enumerate((prm.edge_lo, prm.edge_hi)):
            if not physical:
                continue
            e = prm.bc[f][0][sd]
            r1, r2, rg = (1, 2, 0) if sd == 0 else (nx, nx - 1, nx + 1)
            in1 = fld[(r1,) + lanes]
            if e.kind == KINDS["qgdflux"]:
                q = side[sd] * dx
                g = in1 + q if sd == 0 else in1 - q
            else:
                v = table[e.prof] if e.prof >= 0 else e.value
                g = bc_ghost(e, in1, fld[(r2,) + lanes], dx, v,
                             ux[(r1,) + lanes], sd)
            fld[(rg,) + lanes] = g


# ---------------------------------------------------------------------------
# the composable State <-> the ghost-padded frames
# ---------------------------------------------------------------------------


def state_frames(solver, carry, frame_sc):
    """(to_frames, from_frames) between the composable State and the
    ghost-padded primitive frames of a 2D or 3D fused step.

    to_frames(s) is `carry` (the step's carry type) of the frames p, T, ux,
    uy[, uz], each contiguous with the composable padding's ghosts
    (inletOutlet resolved on s's velocity, a qgdFlux side a fixed gradient
    of s.pbc), s's t and dt, and for varScModel5 the sensor cells framed by
    `frame_sc`; the carry's other fields are left at their defaults.
    from_frames(fs) is the State of any carry with those fields: rho, rhoU
    and rhoE rebuilt from the interior, and the lagged qgdFlux gradients
    recovered from the p ghosts (ghost = interior + g*dx on both sides)."""
    from ..solvers.qgd import State

    mesh = solver.mesh
    th = solver.thermo
    tm = solver.tau_model
    nd = mesh.ndim
    varsc = isinstance(tm, VarScModel5)
    flux_sides = solver._flux_sides()
    bc_U, bc_p, bc_T = solver._bcs()
    dx = float(mesh.dx[0][0])
    C = (slice(1, -1),) * nd
    vel = ("ux", "uy", "uz")[:nd]

    def to_frames(s):
        bc_pp = bc_p
        for i, (a, side) in enumerate(flux_sides):
            bc_pp = bc_pp.replace(a, side, bcm.FixedGradient(s.pbc[i]))
        U, e, T, p = solver.primitives(s)
        bc_Ur = bcm.resolve_inlet_outlet(bc_U, U, nd)
        bc_pp = bcm.resolve_inlet_outlet(bc_pp, U, nd)
        bc_Tr = bcm.resolve_inlet_outlet(bc_T, U, nd)
        Upad = ghost_pad(U, bc_Ur, mesh, t=s.t, vector=True)
        pf = ghost_pad(p, bc_pp, mesh, t=s.t).contiguous()
        Tf = ghost_pad(T, bc_Tr, mesh, t=s.t).contiguous()
        return carry(pf, Tf, *(u.contiguous() for u in Upad), s.t, s.dt,
                     frame_sc(s.sc) if varsc else None)

    def from_frames(fs):
        p = fs.p[C]
        T = fs.T[C]
        U = torch.stack([getattr(fs, k)[C] for k in vel])
        rho = th.rho_from_p_T(p, T)
        e = th.e_from_T(T)
        pbc = []
        for _, side in flux_sides:
            ghost, inner = ((slice(0, 1), slice(1, 2)) if side == 0
                            else (slice(-1, None), slice(-2, -1)))
            pbc.append((fs.p[(ghost,) + C[1:]] - fs.p[(inner,) + C[1:]])
                       * (1.0 / dx))
        sc = fs.sc[C] if varsc else torch.full_like(rho, tm.Sc)
        return State(rho=rho, rhoU=rho[None] * U,
                     rhoE=rho * e + 0.5 * rho * torch.sum(U * U, dim=0),
                     sc=sc, t=fs.t, dt=fs.dt, pbc=tuple(pbc))

    return to_frames, from_frames
