"""Fused explicit 3D QGDFoam step on hand-written CUDA kernels (PyTorch port
of `qgdsolver_tpu.ops.fused_qgd3d.build_fused_step_3d`, the x-slab Pallas
kernel K4, together with its dt pre-pass).

State carried across steps: the ghost-padded primitive frames p, T, ux, uy,
uz, each a contiguous (nx+2, ny+2, nz+2) float32 tensor with z the fast
axis; index [r, s, t] holds cell (r-1, s-1, t-1) and index 0 / n+1 of each
axis is a ghost.  varScModel5 configs also carry the smoothed sensor `sc`
(a frame, edge-replicated ghosts) and, from the fresh fields, the first
fvc::smooth ring of their raw sensor `sc_s1` (a frame too) and its change
flag `sc_chg` (0-dim, 1.0 if the ring raised a cell).

One step:
  1. `qgd3d_dt`: acoustic Courant number and min tau_f over the exact live
     face sets, then setDeltaT - a one-element tensor on the device, in one
     launch;
  2. varScModel5 only: this step's sensor frame, fvc::smooth of the raw
     sensor (XLA's `fvc_smooth` between the kernel's calls in the
     reference): `smoothing.smooth_sensor` reads the carried flag on the
     host; at 0, ring 1 is the fixed point and `sc_s1` is the frame, with
     no launch; else `qgd3d_smooth` writes the fixed point of `sc_s1` in
     three line sweeps (k = SMOOTH_FIXED) and the host reads that call's
     flag, which is 0 unless a cell is NaN, infinite or negative; there
     `qgd3d_smooth` carries ring 1 on, SMOOTH3_RINGS rings a launch, one
     host flag read a launch;
  3. `qgd3d_update`: the six face fluxes of each cell and the explicit
     update into new frames, plus ws/tau_f on the two x-boundary faces;
  4. varScModel5 only: `qgd3d_emit`, the raw sensor over the fresh frames,
     its first ring as a new frame and the ring's change flag, in one
     launch;
  5. `qgd3d_ghosts`: BC ghost planes along x, then y over every x, then z,
     in one launch that computes each ghost from interior cells.

Each kernel call is a wrapper: for CPU tensors it runs the plain torch
version beside it (`dt_reference_3d`, `smooth_reference_3d`,
`update_reference_3d`, `emit_reference_3d`, `sensor_reference_3d`,
`ghosts_reference_3d`); for CUDA tensors it launches the kernel from
csrc/qgd3d.cu through `launch.launch`, which counts the launches in the
wrapper's `launches` (`qgd3d_smooth.rings` counts its rings too, `.fixed`
its fixed-point calls and `.fallbacks` those whose flag sent the step to
the rings).

`build_sharded_fused_step_3d` (K5) runs the same kernels on each rank's
x-slab of an x-ring decomposition: the slab's frame carries the
neighbours' planes as its x halo, the flags edge_lo / edge_hi of
QGD3DParams mark the physical x ends, dt is `qgd3d_dt_fold` per slab, one
MAX all-reduce and `qgd3d_dt_apply`, and the fresh edge planes are
exchanged after `qgd3d_ghosts`, before `qgd3d_sensor` (the emit's mode that
writes the raw sensor alone) reads them.  It carries the raw sensor
`sc_raw` ((nxl, ny, nz) cells) instead of ring 1, whose neighbours cross
the partition: its rings stay the plain `fvc_smooth` under the spmd
context (a launch of k rings would need a k-plane halo exchange).

Restrictions (`supported()`): 3D uniform f32 mesh, PerfectGasThermo with
constant transport, the constScPrModel1 family or varScModel5 (scalar cqSc),
explicit diffusion, the `full` stencil for every gradient, qgdFlux p only on
x sides, y/z BCs of scalar value, and x BCs whose values are scalars or
static (ny, nz) planes.
"""
from __future__ import annotations

import ctypes
import typing as tp

import numpy as np
import torch

from ..core import bc as bcm
from ..physics.qgdcoeffs import ConstScPrModel1, VarScModel5, fvc_smooth
from ..parallel import sharding, spmd
from ..solvers import common
from . import _build
from .fused_common import (KINDS, bc_ghost, common_gate,
                           one_cell_extrapolation, raw_value, state_frames,
                           time_controls, x_ghosts, zg)
from .fvsc import _hi, _lo
from .launch import check_dt, check_tensors, dt_work, launch, launch_shape
from .pad import _sl, ghost_pad
from .smoothing import (SMOOTH_FIXED, _edge_frame, _smooth_plain,
                        require_exact_ring, smooth_args, smooth_reference,
                        smooth_sensor)

FIELDS = ("p", "T", "ux", "uy", "uz")
_CONST_SC_PR = ("ConstScPrModel1", "ConstScPrModel1n", "ConstScPrModel2")


class Fused3DState(tp.NamedTuple):
    """Carry of the fused 3D step: ghost-padded primitive frames + time,
    and for varScModel5 the smoothed sensor frame and what the next step
    smooths: the first ring of the raw sensor (a frame) and its change flag
    on the serial step, the raw sensor itself on K5's slabs."""

    p: torch.Tensor
    T: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    sc: tp.Optional[torch.Tensor] = None
    sc_raw: tp.Optional[torch.Tensor] = None
    sc_s1: tp.Optional[torch.Tensor] = None
    sc_chg: tp.Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# BC compilation and the capability check
# ---------------------------------------------------------------------------


def _to_numpy(v) -> np.ndarray:
    return torch.as_tensor(v).detach().cpu().numpy().astype(np.float64)


def _kind(b) -> str:
    return ("fixed" if isinstance(b, bcm.FixedValue)
            else "grad" if isinstance(b, bcm.FixedGradient) else "io")


def _scalar_bc(b, axis, comp=None):
    """(kind, value) of a BC the ghost formula takes with a scalar value;
    None if it is not one (array/callable values, flux BCs, ...)."""
    if isinstance(b, bcm.ZeroGradient):
        return ("zg", 0.0)
    if isinstance(b, bcm.Symmetry):
        return ("sym", -1.0 if comp == axis else 1.0)
    if isinstance(b, bcm.Extrapolated):
        return ("extrap", 0.0)
    if not isinstance(b, (bcm.FixedValue, bcm.FixedGradient,
                          bcm.InletOutlet)):
        return None
    raw = raw_value(b)
    if callable(raw):
        return None
    v = _to_numpy(raw)
    if comp is not None and v.ndim >= 1 and v.shape[0] >= comp + 1:
        v = v[comp]
    if v.size != 1:
        return None
    return (_kind(b), float(v.reshape(())))


def _plane_value(b, mesh, side, comp=None):
    """An x-side BC's value or gradient as a static (ny, nz) float64 plane,
    or None.  A callable is evaluated on the ghost layer's coordinates at
    t=0 and t=1 and must give the same plane there."""
    raw = raw_value(b)
    ny, nz = mesh.shape[1], mesh.shape[2]
    if callable(raw):
        coords = (mesh.tensor(mesh.x_faces[0][0 if side == 0 else -1]
                              ).reshape(1, 1, 1),
                  mesh.tensor(mesh.centers[1]).reshape(1, ny, 1),
                  mesh.tensor(mesh.centers[2]).reshape(1, 1, nz))
        try:
            v0 = _to_numpy(raw(0.0, coords))
            v1 = _to_numpy(raw(1.0, coords))
        except Exception:  # noqa: BLE001 - a callable that is not static
            return None
        if not np.array_equal(v0, v1):
            return None
        v = v0
        if comp is not None and v.ndim >= 3 and v.shape[0] >= comp + 1:
            v = v[comp]
    else:
        v = _to_numpy(raw)
        if comp is not None and v.ndim >= 1 and v.shape[0] >= comp + 1:
            v = v[comp]
    # drop the leading axes of one (a squeeze would also drop ny or nz = 1)
    while v.ndim > 2 and v.shape[0] == 1:
        v = v[0]
    try:
        return np.broadcast_to(v, (ny, nz)).astype(np.float64)
    except ValueError:
        return None


def _x_bc_spec(b, side, comp, mesh, planes):
    """(kind, value, plane index) for an x side: scalar kinds as
    `_scalar_bc` (plane -1), array or static-callable values as a plane
    appended to `planes`; None if not representable."""
    sc = _scalar_bc(b, 0, comp)
    if sc is not None:
        return sc + (-1,)
    if isinstance(b, bcm.QGDFluxP):
        return ("qgdflux", 0.0, -1)
    if not isinstance(b, (bcm.FixedValue, bcm.FixedGradient,
                          bcm.InletOutlet)):
        return None
    v = _plane_value(b, mesh, side, comp)
    if v is None:
        return None
    planes.append(v)
    return (_kind(b), 0.0, len(planes) - 1)


def _field_bcs(solver):
    bc_U, bc_p, bc_T = solver._bcs()
    return ((bc_p, None), (bc_T, None), (bc_U, 0), (bc_U, 1), (bc_U, 2))


def _bc_specs(solver):
    """specs[field][axis][side] = (kind, value, plane) or None, and the
    (ny, nz) planes of the array-valued x-side BCs."""
    mesh = solver.mesh
    planes = []
    specs = []
    for bcs, comp in _field_bcs(solver):
        rows = []
        for a in range(3):
            row = []
            for side in (0, 1):
                if a == 0:
                    row.append(_x_bc_spec(bcs[a, side], side, comp, mesh,
                                          planes))
                else:
                    s = _scalar_bc(bcs[a, side], a, comp)
                    row.append(None if s is None else s + (-1,))
            rows.append(row)
        specs.append(rows)
    return specs, planes


def supported(solver) -> bool:
    """True if this solver config runs on the fused 3D step."""
    if not common_gate(solver, 3):
        return False
    tm = solver.tau_model
    if isinstance(tm, VarScModel5):
        # per-cell cqSc floors / const-Sc cellSets: composable only
        if np.ndim(tm.cqSc) != 0 \
                or tm.const_sc_mask is not None:
            return False
    elif not isinstance(tm, ConstScPrModel1) \
            or type(tm).__name__ not in _CONST_SC_PR:
        return False
    # an extrapolated ghost reads the second interior layer; along an axis
    # of one cell that is the other end's ghost, which qgd3d_ghosts writes
    # in the same launch (the composable padding has no such layer either).
    # A K5 slab of one plane would read its halo plane there, before the
    # exchange fills it: sharded_supported refuses it.
    specs, _ = _bc_specs(solver)
    n = solver.mesh.shape
    return all(e is not None and not (e[0] == "extrap" and n[a] < 2)
               for rows in specs for a, row in enumerate(rows) for e in row)


def make_params(solver) -> tuple:
    """(QGD3DParams, plane table (n_planes, ny, nz) float32) for a
    supported solver."""
    mesh = solver.mesh
    th = solver.thermo
    tm = solver.tau_model
    tc = solver.time
    nx, ny, nz = mesh.shape
    d = [float(mesh.dx[a][0]) for a in range(3)]
    vol = d[0] * d[1] * d[2]
    h_cell = float(mesh._h_cell_np.reshape(-1)[0])
    varsc = isinstance(tm, VarScModel5)
    f3 = ctypes.c_float * 3
    prm = _build.QGD3DParams(
        nx=nx, ny=ny, nz=nz, varsc=int(varsc), edge_lo=1, edge_hi=1,
        mu_const0=int(th.transport.mu0 == 0.0),
        adjust_dt=int(tc.adjust_time_step),
        d=f3(*d), inv_d=f3(*(1.0 / x for x in d)),
        inv_2d=f3(*(1.0 / (2.0 * x) for x in d)),
        area=f3(*(vol / x for x in d)), inv_vol=1.0 / vol,
        R=th.R, Cv=th.Cv, inv_Cv=1.0 / th.Cv, CvR=th.Cv + th.R,
        gammaR=th.gamma * th.R, gamma=th.gamma, alpha=tm.alpha,
        k_mu=0.0 if varsc else tm.Sc * tm.alpha * h_cell,
        k_muv=tm.alpha * h_cell, inv_Pr_tau=1.0 / tm.Pr,
        mu0=th.transport.mu0, mu0_Pr_th=th.transport.mu0 * (1.0 / th.Pr),
        max_co=tc.max_co, max_dt=tc.max_dt, c_tau=tc.c_tau,
        rC=tm.rC if varsc else 0.0, one_m_rC=1.0 - tm.rC if varsc else 0.0,
        minSc=tm.minSc if varsc else 0.0, maxSc=tm.maxSc if varsc else 1.0,
        cqSc=float(tm.cqSc) if varsc else 0.0, h_cell=h_cell,
        smooth_ratio=1.0 + tm.smoothCoeff if varsc else 0.0,
    )
    specs, planes = _bc_specs(solver)
    for f, rows in enumerate(specs):
        for a in range(3):
            for side in (0, 1):
                kind, value, plane = rows[a][side]
                e = prm.bc[f][a][side]
                e.kind, e.value, e.prof = KINDS[kind], value, plane
    if not planes:
        planes.append(np.zeros((ny, nz)))
    return prm, np.stack(planes).astype(np.float32)


# ---------------------------------------------------------------------------
# plain torch versions of the four kernels (same frame layout)
# ---------------------------------------------------------------------------


def _aint(x, a):
    """Face values along axis a of a frame (n_a+1 faces, other axes full)."""
    return 0.5 * (_lo(x, a) + _hi(x, a))


def _trim(x, a):
    """Keep the interior along every axis except a."""
    for b in range(3):
        if b != a:
            x = _sl(x, b, slice(1, -1))
    return x


def _tan(xf, a, b, prm):
    """Central d/dx_b of the a-face values xf, at the interior faces."""
    g = (_sl(xf, b, slice(2, None)) - _sl(xf, b, slice(None, -2))) \
        * prm.inv_2d[b]
    c = 3 - a - b
    return _sl(g, c, slice(1, -1))


def _edges(prm):
    """The physical-boundary flags of a 3D slab: the two x ends."""
    return ((prm.edge_lo, prm.edge_hi),)


def dt_fold_reference_3d(prm, T, ux, uy, uz):
    """Plain version of `qgd3d_dt_fold`: the quad (max acoustic wave speed
    along x, y, z, -min tau_f) over the slab's live faces (faces against
    the ghost layers included; coefficient ghosts zero-gradient at physical
    boundaries, the halo plane across a partition plane)."""
    gRT = prm.gammaR * T
    c = gRT * torch.rsqrt(gRT)
    coef = zg(c if prm.varsc else prm.alpha / c, _edges(prm))
    waves = []
    tau_min = torch.full((), float("inf"), dtype=T.dtype, device=T.device)
    for a, u in enumerate((ux, uy, uz)):
        wave = torch.abs(_trim(_aint(u, a), a)) + _trim(_aint(c, a), a)
        waves.append(torch.max(wave))
        cf = _trim(_aint(coef, a), a)
        tauf = (prm.alpha / cf) * prm.d[a] if prm.varsc else cf * prm.d[a]
        tau_min = torch.minimum(tau_min, torch.min(tauf))
    return torch.stack(waves + [-tau_min])


def dt_apply_reference_3d(prm, quad, dt):
    """Plain version of `qgd3d_dt_apply`: setDeltaT from a (reduced) quad
    of `dt_fold_reference_3d`."""
    co = torch.zeros((), dtype=quad.dtype, device=quad.device)
    for a in range(3):
        co = torch.maximum(co, quad[a] * dt / prm.d[a])
    return common.set_delta_t(dt, co, -quad[3], time_controls(prm))


def dt_reference_3d(prm, T, ux, uy, uz, dt):
    """Plain version of `qgd3d_dt`: setDeltaT from the max acoustic wave
    speed per axis and the min tau_f over the live faces."""
    return dt_apply_reference_3d(
        prm, dt_fold_reference_3d(prm, T, ux, uy, uz), dt)


def _axis_fluxes(prm, a, cell, coef):
    """The five face fluxes (area included) at the a-faces of every interior
    line, and ws, tau_f there - the reference kernel's per-axis body."""
    p, rho, e, H, u3, ru = cell
    mu_eff, alphau, tcoef = coef
    tang = [b for b in range(3) if b != a]
    d = prm.d[a]

    def face(x):
        return _trim(_aint(x, a), a)

    def sn(x):
        return _trim((_hi(x, a) - _lo(x, a)) * prm.inv_d[a], a)

    pf_a, rf_a, ef_a = _aint(p, a), _aint(rho, a), _aint(e, a)
    uf_a = [_aint(u, a) for u in u3]
    pf, rf = _trim(pf_a, a), _trim(rf_a, a)
    Hf = face(H)
    uf = [_trim(x, a) for x in uf_a]
    ruf = [face(x) for x in ru]
    muf = face(mu_eff)
    af = muf * prm.inv_Pr_tau if alphau is None else face(alphau)
    if prm.varsc:
        tauf = (prm.alpha / face(tcoef)) * d
    else:
        tauf = face(tcoef) * d
    urr = [face(u3[a] * ru[k]) for k in range(3)]

    gU = [[None] * 3 for _ in range(3)]  # gU[i][j] = dU_j/dx_i
    gR, gP, ge = [None] * 3, [None] * 3, [None] * 3
    for j in range(3):
        gU[a][j] = sn(u3[j])
    gR[a], gP[a], ge[a] = sn(rho), sn(p), sn(e)
    for b in tang:
        for j in range(3):
            gU[b][j] = _tan(uf_a[j], a, b, prm)
        gR[b] = _tan(rf_a, a, b, prm)
        gP[b] = _tan(pf_a, a, b, prm)
        ge[b] = _tan(ef_a, a, b, prm)

    divU = gU[0][0] + gU[1][1] + gU[2][2]
    u_gradrho = uf[0] * gR[0] + uf[1] * gR[1] + uf[2] * gR[2]
    rg = ruf[0] * gU[0][a] + ruf[1] * gU[1][a] + ruf[2] * gU[2][a]
    ws = tauf * (u_gradrho * uf[a] + ruf[a] * divU + rg)
    jm = ruf[a] - (ws + tauf * gP[a])
    u_gradp = uf[0] * gP[0] + uf[1] * gP[1] + uf[2] * gP[2]
    iso = u_gradp + prm.gamma * pf * divU
    pi = []
    for j in range(3):
        t1 = urr[0] * gU[0][j] + urr[1] * gU[1][j] + urr[2] * gU[2][j] \
            + uf[a] * gP[j]
        if j == a:
            pij = tauf * (t1 + iso) \
                + muf * (gU[a][j] + gU[j][a] - (2.0 / 3.0) * divU)
        else:
            pij = tauf * t1 + muf * (gU[a][j] + gU[j][a])
        pi.append(pij)
    prr = pf / (rf * rf)
    de = [ge[k] - prr * gR[k] for k in range(3)]
    q = -tauf * (urr[0] * de[0] + urr[1] * de[1] + urr[2] * de[2]) \
        - af * ge[a]
    area = prm.area[a]
    phiJm = jm * area
    fl = [phiJm]
    for j in range(3):
        fl.append(phiJm * uf[j] + area * ((pf if j == a else 0.0) - pi[j]))
    fl.append(phiJm * Hf
              + area * (q - (pi[0] * uf[0] + pi[1] * uf[1] + pi[2] * uf[2])))
    return fl, ws, tauf


def update_reference_3d(prm, p, T, ux, uy, uz, sc, dt):
    """Plain version of `qgd3d_update`: the QGD fluxes and the explicit
    update.  Returns (new frames p, T, ux, uy, uz with the interior filled
    and zero ghosts, side) where side[0 / 1] = ws/tau_f on the x-low /
    x-high boundary faces, shape (2, ny, nz)."""
    u3 = (ux, uy, uz)
    rho = p / (prm.R * T)
    e = prm.Cv * T
    gRT = prm.gammaR * T
    rcs = torch.rsqrt(gRT)
    ru = tuple(rho * u for u in u3)
    ke = ux * ux + uy * uy + uz * uz
    H = prm.CvR * T + 0.5 * ke
    # coefficient fields with zero-gradient ghosts at physical boundaries
    edges = _edges(prm)
    if prm.varsc:
        mu_qgd = ((prm.k_muv * sc) * p) * rcs
        tcoef = zg(gRT * rcs, edges)
    else:
        mu_qgd = (prm.k_mu * p) * rcs
        tcoef = zg(prm.alpha * rcs, edges)
    if prm.mu_const0:
        mu_eff, alphau = zg(mu_qgd, edges), None
    else:
        mu_eff = zg(mu_qgd + prm.mu0, edges)
        alphau = zg(mu_qgd * prm.inv_Pr_tau + prm.mu0_Pr_th, edges)
    cell = (p, rho, e, H, u3, ru)
    acc = None
    for a in range(3):
        fl, ws, tauf = _axis_fluxes(prm, a, cell, (mu_eff, alphau, tcoef))
        if a == 0:
            side = torch.stack([ws[0] / tauf[0], ws[-1] / tauf[-1]])
        dfl = [_hi(f, a) - _lo(f, a) for f in fl]
        acc = dfl if acc is None else [x + y for x, y in zip(acc, dfl)]

    C = (slice(1, -1),) * 3
    sdt = dt * prm.inv_vol
    rho_c = rho[C]
    rhon = rho_c - sdt * acc[0]
    run = [ru[j][C] - sdt * acc[1 + j] for j in range(3)]
    rhoE = rho_c * (e[C] + 0.5 * ke[C])
    rhoEn = rhoE - sdt * acc[4]
    inv_rhon = 1.0 / rhon
    un = [r * inv_rhon for r in run]
    en = rhoEn * inv_rhon - 0.5 * (un[0] * un[0] + un[1] * un[1]
                                   + un[2] * un[2])
    Tn = en * prm.inv_Cv
    pn = rhon * prm.R * Tn
    out = []
    for interior in (pn, Tn, un[0], un[1], un[2]):
        f = torch.zeros_like(p)
        f[C] = interior
        out.append(f)
    return tuple(out), side.contiguous()


def sensor_reference_3d(prm, p, T, sc):
    """Plain version of `qgd3d_sensor`: the raw varScModel5 sensor of the
    fresh frames (rho from the stored p, T; zero-gradient ghosts at
    physical boundaries, the exchanged halo plane across a partition
    plane), relaxed against the current smoothed sensor `sc`.  Returns
    (nx, ny, nz)."""
    C = (slice(1, -1),) * 3
    rg = zg(p * (1.0 / (prm.R * T)), _edges(prm))
    r = rg[C]
    g = [(_sl(rg, a, slice(2, None)) - _sl(rg, a, slice(None, -2)))
         * prm.inv_2d[a] for a in range(3)]
    g = [_trim(x, a) for a, x in enumerate(g)]
    mag = torch.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2])
    s = prm.rC * (mag * prm.h_cell / r) + prm.one_m_rC * sc[C]
    s = torch.clamp(s, prm.minSc, prm.maxSc)
    return torch.clamp(s, min=prm.cqSc)


def emit_reference_3d(prm, p, T, sc):
    """Plain version of `qgd3d_emit`: (raw, s1, chg) - the raw sensor of the
    fresh frames (`sensor_reference_3d`), its first fvc::smooth ring as a
    frame with edge-replicated ghosts, and the ring's change flag (0-dim,
    1.0 if it raised a cell)."""
    raw = sensor_reference_3d(prm, p, T, sc)
    s1, chg = smooth_reference(prm, raw, 1)
    return raw, _edge_frame(s1), chg


# plain version of `qgd3d_smooth`'s rings: the rings of any number of axes
smooth_reference_3d = smooth_reference


def ghosts_reference_3d(prm, frames, side, planes):
    """Plain version of `qgd3d_ghosts`, in place on the fresh frames: the
    x-ghost planes from the interior (qgdFlux p: interior +- side*dx), then
    the y-ghost rows over every x, then the z-ghost lanes over every x and
    y, so edges and corners see the earlier axes.  inletOutlet switches on
    the fresh adjacent-cell outward velocity (on ghost layers of earlier
    axes, the nearest interior cell's).  A partition x end is left as it
    is: the plane exchange fills it."""
    nx, ny, nz = prm.nx, prm.ny, prm.nz
    ux, uy, uz = frames[2], frames[3], frames[4]
    I = slice(1, -1)
    x_ghosts(prm, frames, side, planes, prm.d[0])
    rows = torch.arange(nx + 2, device=ux.device).clamp(1, nx)
    lanes = torch.arange(ny + 2, device=ux.device).clamp(1, ny)
    for f, fld in enumerate(frames):
        for sd in (0, 1):
            e = prm.bc[f][1][sd]
            l1, l2, lg = (1, 2, 0) if sd == 0 else (ny, ny - 1, ny + 1)
            fld[:, lg, I] = bc_ghost(e, fld[:, l1, I], fld[:, l2, I],
                                     prm.d[1], e.value, uy[rows, l1, I], sd)
    for f, fld in enumerate(frames):
        for sd in (0, 1):
            e = prm.bc[f][2][sd]
            l1, l2, lg = (1, 2, 0) if sd == 0 else (nz, nz - 1, nz + 1)
            un = uz[rows][:, lanes, l1]
            fld[:, :, lg] = bc_ghost(e, fld[:, :, l1], fld[:, :, l2],
                                     prm.d[2], e.value, un, sd)
    return frames


# ---------------------------------------------------------------------------
# the wrappers: plain version for CPU tensors, the CUDA kernel otherwise
# ---------------------------------------------------------------------------


def _check(prm, name, *tensors):
    return check_tensors(name, (prm.nx + 2, prm.ny + 2, prm.nz + 2), *tensors)


def _tiled(out, *keys) -> dict:
    """A 3D shape query's five ints as a dict: the (y, z) tile, then keys."""
    return {"tile": out[:2], **dict(zip(keys, out[2:]))}


# floats of a qgd3d_dt block's partial: three max waves, three tau
# coefficient extremes
_DT_NQ = 6


def qgd3d_dt(prm, T, ux, uy, uz, dt):
    """New dt (0-dim tensor) from the current frames and the previous dt.
    One launch: the blocks' partials and, in the last block, the fold and
    setDeltaT."""
    on_card = _check(prm, "qgd3d_dt", T, ux, uy, uz)
    check_dt("qgd3d_dt", dt, T)
    if not on_card:
        return dt_reference_3d(prm, T, ux, uy, uz, dt)
    work = dt_work(_DT_NQ, T, "qgd3d_dt_partials", prm)
    out = torch.empty((), dtype=T.dtype, device=T.device)
    launch(qgd3d_dt, "qgd3d_dt", prm, T, ux, uy, uz, dt, work, out, like=T)
    return out


def qgd3d_dt_fold(prm, T, ux, uy, uz):
    """This slab's dt quad (4,) on T's device - see
    `dt_fold_reference_3d`.  One launch, as `qgd3d_dt`."""
    on_card = _check(prm, "qgd3d_dt_fold", T, ux, uy, uz)
    if not on_card:
        return dt_fold_reference_3d(prm, T, ux, uy, uz)
    work = dt_work(_DT_NQ, T, "qgd3d_dt_partials", prm)
    quad = torch.empty(4, dtype=T.dtype, device=T.device)
    launch(qgd3d_dt_fold, "qgd3d_dt_fold", prm, T, ux, uy, uz, work, quad,
           like=T)
    return quad


def dt_launch_shape(prm, device) -> dict:
    """`qgd3d_dt`'s launch at prm's shape on a card: its (y, z) tile, the
    x-planes a block marches, its blocks and the blocks resident on one
    SM."""
    return _tiled(launch_shape("qgd3d_dt_shape", prm, device=device),
                  "chunk", "blocks", "blocks_per_sm")


def qgd3d_dt_apply(prm, quad, dt):
    """New dt (0-dim tensor) from a reduced quad of `qgd3d_dt_fold` - see
    `dt_apply_reference_3d`."""
    on_card = check_tensors("qgd3d_dt_apply", (4,), quad)
    check_dt("qgd3d_dt_apply", dt, quad)
    if not on_card:
        return dt_apply_reference_3d(prm, quad, dt)
    out = torch.empty((), dtype=quad.dtype, device=quad.device)
    launch(qgd3d_dt_apply, "qgd3d_dt_apply", prm, quad, dt, out, like=quad)
    return out


def qgd3d_update(prm, p, T, ux, uy, uz, sc, dt):
    """(new frames, side) - see `update_reference_3d`.  The kernel leaves
    the new frames' ghosts unset; `qgd3d_ghosts` fills them."""
    fr = (p, T, ux, uy, uz) + ((sc,) if prm.varsc else ())
    on_card = _check(prm, "qgd3d_update", *fr)
    check_dt("qgd3d_update", dt, p)
    if not on_card:
        return update_reference_3d(prm, p, T, ux, uy, uz, sc, dt)
    new = tuple(torch.empty_like(p) for _ in range(5))
    side = torch.empty((2, prm.ny, prm.nz), dtype=p.dtype, device=p.device)
    launch(qgd3d_update, "qgd3d_update", prm, p, T, ux, uy, uz,
           sc if prm.varsc else None, dt, *new, side, like=p)
    return new, side


def update_launch_shape(prm, device) -> dict:
    """`qgd3d_update`'s launch at prm's shape on `device`: its (y, z) tile,
    the x-planes one block marches (the chunk, from the grid), the dynamic
    shared memory of a block and the blocks resident on one SM."""
    return _tiled(launch_shape("qgd3d_update_launch", prm, device=device),
                  "chunk", "smem_bytes", "blocks_per_sm")


def qgd3d_sensor(prm, p, T, sc):
    """The raw varScModel5 sensor of the fresh frames, (nx, ny, nz) - see
    `sensor_reference_3d`: `qgd3d_emit`'s kernel in the mode that writes
    the raw sensor alone (the same bits), for K5's slabs.  Reads only
    interior cells of p and T (and the halo planes at partition ends)."""
    if not prm.varsc:
        raise ValueError("qgd3d_sensor: the config has no varScModel5 sensor")
    on_card = _check(prm, "qgd3d_sensor", p, T, sc)
    if not on_card:
        return sensor_reference_3d(prm, p, T, sc)
    out = torch.empty((prm.nx, prm.ny, prm.nz), dtype=p.dtype,
                      device=p.device)
    launch(qgd3d_sensor, "qgd3d_sensor", prm, p, T, sc, out, like=p)
    return out


def qgd3d_emit(prm, p, T, sc, raw=False):
    """(raw, s1, chg) of the fresh frames - see `emit_reference_3d`: the
    first fvc::smooth ring of their raw sensor as a new frame and its
    change flag (0-dim, on the device), in one launch; raw, the raw sensor
    (nx, ny, nz), only when asked for, else None.  Ring 1 reads the cells
    beside each cell, so both x ends must be physical (K5's slabs take
    `qgd3d_sensor`).  Reads only interior cells of p and T."""
    if not prm.varsc:
        raise ValueError("qgd3d_emit: the config has no varScModel5 sensor")
    on_card = _check(prm, "qgd3d_emit", p, T, sc)
    if not (prm.edge_lo and prm.edge_hi):
        raise ValueError("qgd3d_emit: ring 1 needs both x ends physical")
    if not on_card:
        got, s1, chg = emit_reference_3d(prm, p, T, sc)
        return (got if raw else None), s1, chg
    s1 = torch.empty_like(p)
    chg = torch.empty((), dtype=p.dtype, device=p.device)
    got = torch.empty((prm.nx, prm.ny, prm.nz), dtype=p.dtype,
                      device=p.device) if raw else None
    launch(qgd3d_emit, "qgd3d_emit", prm, p, T, sc, got, s1, chg, like=p)
    return got, s1, chg


def emit_launch_shape(prm, device) -> dict:
    """`qgd3d_emit`'s launch at prm's shape on a card: its (y, z) tile, the
    x-planes a block writes, its blocks and the blocks resident on one
    SM."""
    return _tiled(launch_shape("qgd3d_emit_shape", prm, device=device),
                  "chunk", "blocks", "blocks_per_sm")


def qgd3d_ghosts(prm, frames, side, planes):
    """Fill the ghosts of the fresh frames in place - see
    `ghosts_reference_3d`.  One launch: each ghost from interior cells."""
    on_card = _check(prm, "qgd3d_ghosts", *frames)
    check_tensors("qgd3d_ghosts", (2, prm.ny, prm.nz), side)
    check_tensors("qgd3d_ghosts", (planes.shape[0], prm.ny, prm.nz), planes)
    if side.device != frames[0].device or planes.device != side.device:
        raise ValueError("qgd3d_ghosts: side and planes must lie beside the "
                         "frames")
    if not on_card:
        return ghosts_reference_3d(prm, frames, side, planes)
    launch(qgd3d_ghosts, "qgd3d_ghosts", prm, planes, side, *frames,
           like=side)
    return frames


# rings one qgd3d_smooth launch may run (its x-march keeps one register
# level per ring), and the rings per launch after the emitted first ring
SMOOTH3_KMAX = 4
SMOOTH3_RINGS = 4
# the fixed point's launches a call (its z, y and x passes) and the most
# cells along an axis it takes (the z pass: 32 lanes of 32 cells)
SMOOTH3_FIXED_LAUNCHES = 3
SMOOTH3_FIXED_MAXN = 1024


def fixed_supported(prm) -> bool:
    """Whether `qgd3d_smooth` takes k = SMOOTH_FIXED at prm: every axis at
    most SMOOTH3_FIXED_MAXN cells and maxRatio (as float32) at least 1,
    where h(v) <= v makes the sweeps the rings' fixed point."""
    return (max(prm.nx, prm.ny, prm.nz) <= SMOOTH3_FIXED_MAXN
            and float(np.float32(prm.smooth_ratio)) >= 1.0)


def qgd3d_smooth(prm, f, k, out=None, flag=None):
    """(out, flag): k fvc::smooth rings (0 <= k <= SMOOTH3_KMAX) of the
    sensor cells f - an (nx, ny, nz) tensor, or the interior of a frame -
    into the frame `out` (new if None) with edge-replicated ghosts, and a
    0-dim flag (new if None), 1.0 if the last ring raised any cell, else
    0.0 - see `smooth_reference_3d`.  Each launch adds one to `launches`
    and k to `rings`.

    k = SMOOTH_FIXED (where `fixed_supported`): the rings' fixed point
    itself, in line sweeps, and a flag 1.0 if a cell of f is not finite or
    has its sign bit set (the result is then not the rings'), else 0.0 -
    see `smoothing.smooth_fixed_reference`.  A call adds one to `fixed`
    and, on a card, SMOOTH3_FIXED_LAUNCHES to `launches` and none to
    `rings`.  `fallbacks` counts the calls whose flag sent
    `smoothing.smooth_sensor` to the rings."""
    fixed = k == SMOOTH_FIXED
    if fixed and not fixed_supported(prm):
        raise ValueError("qgd3d_smooth: no fixed point at this shape or "
                         "maxRatio")
    on_card, out, flag, base, pitches = smooth_args(
        "qgd3d_smooth", (prm.nx, prm.ny, prm.nz), SMOOTH3_KMAX, f,
        0 if fixed else k, out, flag)
    qgd3d_smooth.fixed += fixed
    if not on_card:
        return _smooth_plain(prm, f, k, out, flag)
    if fixed:
        launch(qgd3d_smooth, "qgd3d_smooth_fixed", prm, base, *pitches, out,
               flag, like=f, count=SMOOTH3_FIXED_LAUNCHES)
    else:
        launch(qgd3d_smooth, "qgd3d_smooth", prm, base, *pitches, k, out,
               flag, like=f)
        qgd3d_smooth.rings += k
    return out, flag


def smooth_launch_shape(prm, k, device) -> dict:
    """`qgd3d_smooth`'s launch of k rings at prm's shape on a card: its
    (y, z) tile, the x-planes a block writes, the dynamic shared memory of
    a block and the blocks resident on one SM."""
    return _tiled(launch_shape("qgd3d_smooth_shape", prm, k, device=device),
                  "chunk", "smem_bytes", "blocks_per_sm")


def fixed_launch_shape(prm, device) -> dict:
    """The fixed point's launches at prm's shape: the cells a lane of the z
    pass holds, and the cells a thread holds and the threads of a block of
    the y and of the x pass."""
    return dict(zip(("z_cells", "y_cells", "y_threads", "x_cells",
                     "x_threads"),
                    launch_shape("qgd3d_smooth_fixed_shape", prm,
                                 device=device)))


qgd3d_dt.launches = 0
qgd3d_dt_fold.launches = 0
qgd3d_dt_apply.launches = 0
qgd3d_update.launches = 0
qgd3d_sensor.launches = 0
qgd3d_emit.launches = 0
qgd3d_ghosts.launches = 0
qgd3d_smooth.launches = 0
qgd3d_smooth.rings = 0
qgd3d_smooth.fixed = 0
qgd3d_smooth.fallbacks = 0
# the kernels of the serial step
KERNELS = (qgd3d_dt, qgd3d_update, qgd3d_emit, qgd3d_ghosts, qgd3d_smooth)
# the flagged kernels of the decomposed step (K5)
SHARDED_KERNELS = (qgd3d_dt_fold, qgd3d_dt_apply, qgd3d_update, qgd3d_sensor,
                   qgd3d_ghosts)


# ---------------------------------------------------------------------------
# the step and its State conversions
# ---------------------------------------------------------------------------


def build_fused_step_3d(solver, plain: bool = False):
    """(step, to_fused, from_fused) for a supported 3D QGDFoam solver.

    step: Fused3DState -> Fused3DState.  With plain=True the step calls the
    plain torch versions directly on any device (the comparison path for
    the kernels on the card); the default goes through the kernel wrappers.
    The varScModel5 sensor frame is `smooth_sensor` on `qgd3d_smooth` (or
    its plain version) from the carried first ring and flag, which
    `qgd3d_emit` makes from the fresh frames (a new frame each step, so
    the carry's `sc` is never written): the fixed point in one call where
    `fixed_supported`, the rings where its flag says the sweeps do not
    hold, or at any other shape; on a card the builder first
    requires the division-free ring exact for the case's maxRatio.
    to_fused makes the first ring and flag of the State's raw sensor with
    the plain ring.
    """
    if not supported(solver):
        raise ValueError("solver config not supported by the fused 3D step")
    mesh = solver.mesh
    tm = solver.tau_model
    varsc = isinstance(tm, VarScModel5)
    prm, planes_np = make_params(solver)
    planes = mesh.tensor(planes_np).contiguous()
    if plain:
        k_dt, k_update, k_emit, k_ghosts, k_smooth = (
            dt_reference_3d, update_reference_3d, emit_reference_3d,
            ghosts_reference_3d, _smooth_plain)
    else:
        k_dt, k_update, k_emit, k_ghosts, k_smooth = KERNELS
        if varsc and mesh.device.type == "cuda":
            require_exact_ring(prm, mesh.device)
    # the cache of smooth_sensor, and whether it takes the fixed point
    scratch = {"fixed": varsc and fixed_supported(prm)}

    def step(fs: Fused3DState) -> Fused3DState:
        dt_new = k_dt(prm, fs.T, fs.ux, fs.uy, fs.uz, fs.dt)
        sc = s1 = chg = None
        if varsc:
            sc = smooth_sensor(prm, fs.sc_s1, fs.sc_chg, k_smooth,
                               SMOOTH3_RINGS, cache=scratch)
        frames, side = k_update(prm, fs.p, fs.T, fs.ux, fs.uy, fs.uz, sc,
                                dt_new)
        if varsc:
            _, s1, chg = k_emit(prm, frames[0], frames[1], sc)
        p, T, ux, uy, uz = k_ghosts(prm, frames, side, planes)
        return Fused3DState(p=p, T=T, ux=ux, uy=uy, uz=uz, t=fs.t + dt_new,
                            dt=dt_new, sc=sc, sc_s1=s1, sc_chg=chg)

    to_frames, from_fused = state_frames(solver, Fused3DState, _edge_frame)

    def to_fused(s) -> Fused3DState:
        fs = to_frames(s)
        if not varsc:
            return fs
        s1, chg = smooth_reference(prm, raw_sensor(solver, fs.p, fs.T, s.sc),
                                   1)
        return fs._replace(sc_s1=_edge_frame(s1), sc_chg=chg)

    return step, to_fused, from_fused


# ---------------------------------------------------------------------------
# K5: the step over an x-ring of ranks
# ---------------------------------------------------------------------------


def raw_sensor(solver, pf, Tf, sc):
    """The raw varScModel5 sensor of a State's frames pf, Tf and its sensor
    cells sc, as the composable step computes it (`sc_raw_update`), for
    to_fused: (nx, ny, nz) cells."""
    rho = solver.thermo.rho_from_p_T(pf[(slice(1, -1),) * 3],
                                     Tf[(slice(1, -1),) * 3])
    return solver.tau_model.sc_raw_update(solver.mesh, rho, sc).contiguous()


def sharded_supported(solver, grid) -> bool:
    """True if `build_sharded_fused_step_3d` takes this config on `grid`:
    the fused gate, an x-ring (py == 1), slabs that divide nx, and no slab
    of one plane with an extrapolated x side (`one_cell_extrapolation`:
    its ghost reads the halo plane before the exchange fills it)."""
    return (supported(solver) and grid.py == 1
            and solver.mesh.shape[0] % grid.px == 0
            and not one_cell_extrapolation(solver, grid))


def block_params(solver, ctx):
    """(QGD3DParams, plane table) of this rank's x-slab: the global step
    constants with the slab's nx and x-end flags.  The x-side planes span
    (ny, nz), which an x-ring does not split."""
    prm_g, planes = make_params(solver)
    prm = _build.QGD3DParams.from_buffer_copy(prm_g)
    prm.nx = solver.mesh.shape[0] // ctx.grid.px
    prm.edge_lo, prm.edge_hi = int(ctx.is_lo(0)), int(ctx.is_hi(0))
    return prm, planes


def build_sharded_fused_step_3d(solver, grid):
    """(step, to_sharded, from_sharded): the 3D kernels on this rank's
    x-slab of an x-ring decomposition (grid.py must be 1), inside a
    launched world of grid.px ranks (the port of the reference's K5).

    Each rank holds an (nxl+2, ny+2, nz+2) frame whose x halo planes are
    the neighbours' edge planes.  A step: the slab's dt quad
    (`qgd3d_dt_fold`), one MAX all-reduce, setDeltaT (`qgd3d_dt_apply`);
    for varScModel5 `fvc_smooth` of the carried raw sensor under the spmd
    context (its rings and termination test cross the slabs), padded with
    the neighbours' planes; `qgd3d_update`; `qgd3d_ghosts` at the physical
    x ends; the exchange of the fresh planes 1 and nxl; then, for
    varScModel5, `qgd3d_sensor` on the exchanged frames, so its x-gradient
    at a partition plane reads the neighbour's true plane and no strip fix
    is needed.  The result is the serial 3D step's: the serial step's
    sensor frame is fvc_smooth of the same raw sensor.  to_sharded /
    from_sharded as in `fused_qgd2d.build_sharded_fused_step`.
    """
    if not supported(solver):
        raise ValueError("solver config not supported by the fused 3D step")
    if grid.py != 1:
        raise NotImplementedError("the decomposed fused 3D step is an "
                                  "x-ring only (py must be 1)")
    if one_cell_extrapolation(solver, grid):
        raise ValueError("solver config not supported by the fused 3D step "
                         "on slabs of one plane")
    mesh = solver.mesh
    tm = solver.tau_model
    varsc = isinstance(tm, VarScModel5)
    ctx = sharding.block_context(mesh, grid)
    local_mesh = sharding.block_mesh(ctx)
    prm, planes_np = block_params(solver, ctx)
    nxl = prm.nx
    planes = mesh.tensor(planes_np).contiguous()
    zg3 = bcm.FieldBCs.uniform(bcm.ZeroGradient(), 3)

    def local_step(fs: Fused3DState) -> Fused3DState:
        quad = spmd.all_max(qgd3d_dt_fold(prm, fs.T, fs.ux, fs.uy, fs.uz))
        dt_new = qgd3d_dt_apply(prm, quad, fs.dt)
        sc = sc_raw = None
        if varsc:
            sc = ghost_pad(fvc_smooth(fs.sc_raw, tm.smoothCoeff), zg3,
                           local_mesh).contiguous()
        frames, side = qgd3d_update(prm, fs.p, fs.T, fs.ux, fs.uy, fs.uz, sc,
                                    dt_new)
        p, T, ux, uy, uz = spmd.exchange_frames(
            qgd3d_ghosts(prm, list(frames), side, planes))
        if varsc:
            sc_raw = qgd3d_sensor(prm, p, T, sc)
        return Fused3DState(p=p, T=T, ux=ux, uy=uy, uz=uz, t=fs.t + dt_new,
                            dt=dt_new, sc=sc, sc_raw=sc_raw)

    def step(fs: Fused3DState) -> Fused3DState:
        with spmd.active(ctx):
            return local_step(fs)

    to_frames, from_fused = state_frames(solver, Fused3DState, _edge_frame)
    framed = FIELDS + (("sc",) if varsc else ())
    win, xs = spmd.frame_window(ctx), ctx.start(0)

    def to_sharded(s) -> Fused3DState:
        fs = to_frames(s)
        cut = {k: getattr(fs, k)[win].contiguous() for k in framed}
        if varsc:  # the raw sensor has no halo
            cut["sc_raw"] = raw_sensor(solver, fs.p, fs.T,
                                       s.sc)[xs:xs + nxl].contiguous()
        return fs._replace(**cut)

    def from_sharded(fs):
        full = {k: spmd.join_frames(getattr(fs, k), ctx) for k in framed}
        return from_fused(fs._replace(**full))

    return step, to_sharded, from_sharded
