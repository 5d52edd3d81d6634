"""Fused explicit 2D QGDFoam steps on hand-written CUDA kernels (PyTorch port
of `qgdsolver_tpu.ops.fused_qgd2d`: the whole-frame Pallas kernel K1,
`build_fused_step`, and the x-slab kernel K2, `build_tiled_fused_step`).

State carried across steps: the ghost-padded primitive frames p, T, ux, uy
(and the varScModel5 sensor), each a contiguous (nx+2, ny+2) float32 tensor
with y the fast axis.  Row r, lane s hold cell (r-1, s-1); row 0 / nx+1 and
lane 0 / ny+1 are ghosts.

One step of `build_fused_step` (K1):
  1. varScModel5 only: the sensor pre-pass (`VarScModel5.sc_update`, plain
     torch; it is XLA in the reference too);
  2. `qgd2d_dt`: acoustic Courant number and min tau_f over the exact live
     face sets, then setDeltaT — a one-element tensor on the device, one
     launch;
  3. `qgd2d_update`: the fluxes and the explicit update into new frames;
  4. `qgd2d_ghosts`: BC ghost rows and ghost lanes of every row, one
     launch.

`build_sharded_fused_step` (K3) runs K1's kernels on each rank's block of
a domain-decomposed run: the frame of a block carries a one-cell halo, and
the edge flags of QGDParams say which frame edges are partition edges (the
halo holds the neighbour's cells) and which are physical boundaries.  dt
is `qgd2d_dt_fold` per block, one MAX all-reduce, `qgd2d_dt_apply`; after
`qgd2d_ghosts` (physical sides only) the halo rows, then the halo lanes,
are exchanged with the neighbour ranks.

`build_tiled_fused_step` (K2) shares 3-4 and ends each step with
`qgd2d_emit`, which reads from the fresh frames what the next step needs:
its Courant/tau rates (so setDeltaT reads no frame) and, for varScModel5,
the raw sensor, its first smoothing ring and a change flag.  The next step
carries ring 1 to the fvc::smooth fixed point on the card
(`smoothing.smooth_sensor`: `qgd2d_smooth` launches of k rings each, the
host reading one flag per launch), straight into the sensor frame.  An
active sensor (the flagship 4096x2048 case: ~20 rings a step) costs a few
launches; an inactive one a single launch that frames ring 1.  The frames
are whole, so none of the reference's slab strip fixes exist here; K2's
VMEM slab sizing is TPU-only and is not ported.

Each kernel call is a wrapper: for CPU tensors it runs the plain torch
version beside it (`dt_reference`, `dt_fold_reference`,
`dt_apply_reference`, `update_reference`, `ghosts_reference`,
`emit_reference`, `smoothing.smooth_reference`); for CUDA tensors it
launches the kernel from csrc/qgd2d.cu through `launch.launch`, which
counts the launch in the wrapper's `launches` (`qgd2d_smooth.rings` counts
its rings too).  The plain versions composed are the reference's
`frame_fn`.

Restrictions (`supported()`): 2D uniform f32 mesh, PerfectGasThermo with
constant transport, constScPrModel1 or varScModel5,
explicit diffusion, the `full` stencil for every gradient, qgdFlux p only on
x sides, and BCs {FixedValue, ZeroGradient, FixedGradient, Symmetry,
Extrapolated, InletOutlet} whose values do not depend on time.  K2 also
needs a scalar cqSc (`tiled_supported()`).
"""
from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..core import bc as bcm
from ..physics.qgdcoeffs import ConstScPrModel1, VarScModel5
from ..parallel import sharding, spmd
from ..solvers import common
from . import _build
from .fused_common import (KINDS, bc_ghost, common_gate,
                           one_cell_extrapolation, raw_value, state_frames,
                           time_controls, x_ghosts, zg)
from .launch import (check_dt, check_tensors, dt_work, launch, launch_shape,
                     query)
from .pad import ghost_pad
from .smoothing import (_edge_frame, _smooth_plain, require_exact_ring,
                        smooth_args, smooth_reference, smooth_sensor)

FIELDS = ("p", "T", "ux", "uy")


class FusedState(tp.NamedTuple):
    """Carry of the fused step: ghost-padded primitive frames + time."""

    p: torch.Tensor
    T: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    sc: tp.Optional[torch.Tensor] = None  # varScModel5 sensor frame


# ---------------------------------------------------------------------------
# capability check
# ---------------------------------------------------------------------------

_SIMPLE_BCS = (bcm.FixedValue, bcm.ZeroGradient, bcm.FixedGradient,
               bcm.Symmetry, bcm.Extrapolated, bcm.InletOutlet)


def supported(solver) -> bool:
    """True if this solver config runs on the fused step."""
    if not common_gate(solver, 2):
        return False
    tm = solver.tau_model
    if not isinstance(tm, (ConstScPrModel1, VarScModel5)):
        return False
    if isinstance(tm, VarScModel5) and tm.const_sc_mask is not None:
        return False  # const-Sc cellSet: composable only
    mesh = solver.mesh
    for bcs in solver._bcs():
        for a in range(2):
            for side in (0, 1):
                b = bcs[a, side]
                if isinstance(b, bcm.QGDFluxP):
                    continue
                if not isinstance(b, _SIMPLE_BCS):
                    return False
                # an extrapolated ghost reads the second interior layer;
                # along an axis of one cell that is the other side's ghost,
                # which qgd2d_ghosts writes in the same launch (the
                # composable padding has no such layer either).  A K3 block
                # of one row or one lane would read its halo there, before
                # the exchange fills it: sharded_supported refuses it.
                if isinstance(b, bcm.Extrapolated) and mesh.shape[a] < 2:
                    return False
                raw = raw_value(b)
                if raw is not None and not _value_is_static(raw, mesh, a,
                                                            side):
                    return False  # time-dependent BC: composable only
    return True


# ---------------------------------------------------------------------------
# BC spec compilation (evaluated once, at build time)
# ---------------------------------------------------------------------------


def _eval_static_value(v, mesh, a, side, vector_comp=None, t=0.0):
    """A BC value/gradient spec as a float32 numpy array over the ghost
    layer (callables see cell-centre coordinates on the tangential axis)."""
    if callable(v):
        coords = []
        for b in range(2):
            if b == a:
                c = mesh.tensor(mesh.x_faces[a][0 if side == 0 else -1]
                                ).reshape(1, 1)
            else:
                shape = [1, 1]
                shape[b] = mesh.shape[b]
                c = mesh.tensor(mesh.centers[b]).reshape(shape)
            coords.append(c)
        out = torch.as_tensor(v(t, tuple(coords))).cpu().numpy()
        if vector_comp is not None:
            out = out[vector_comp]
        return out.astype(np.float32)
    v = np.asarray(torch.as_tensor(v).cpu(), dtype=np.float32)
    if vector_comp is not None and v.ndim >= 1 and v.shape[0] == 2:
        v = v[vector_comp]
    return v


def _value_is_static(v, mesh, a, side) -> bool:
    """True if a BC spec does not depend on time: plain values always;
    callables when three pairwise-incommensurate sample times agree (the
    fused step bakes BC values at build time)."""
    if not callable(v):
        return True
    vals = [_eval_static_value(v, mesh, a, side, t=t)
            for t in (0.0, 0.3183098861837907, 1.4142135623730951)]
    return all(np.array_equal(vals[0], x) for x in vals[1:])


def _compile_bcs(solver, params: _build.QGDParams) -> np.ndarray:
    """Fill params.bc[field][axis][side] and return the profile table
    (n_prof, prof_len) of array-valued BCs: x-side profiles run over the
    ny+2 lanes, y-side profiles over the nx+2 rows, edge-padded into the
    ghost positions."""
    mesh = solver.mesh
    nx, ny = mesh.shape
    prof_len = max(nx, ny) + 2
    bc_U, bc_p, bc_T = solver._bcs()
    profiles = []

    def fill(entry, bc, a, side, comp):
        entry.prof = -1
        entry.value = 0.0
        if isinstance(bc, bcm.QGDFluxP):
            entry.kind = KINDS["qgdflux"]
            return
        if isinstance(bc, bcm.ZeroGradient):
            entry.kind = KINDS["zg"]
            return
        if isinstance(bc, bcm.Symmetry):
            entry.kind = KINDS["sym"]
            entry.value = -1.0 if comp == a else 1.0
            return
        if isinstance(bc, bcm.Extrapolated):
            entry.kind = KINDS["extrap"]
            return
        kind = ("fixed" if isinstance(bc, bcm.FixedValue)
                else "grad" if isinstance(bc, bcm.FixedGradient) else "io")
        entry.kind = KINDS[kind]
        v = _eval_static_value(raw_value(bc), mesh, a, side,
                               vector_comp=comp)
        if v.size == 1:
            entry.value = float(v.reshape(()))
            return
        n = mesh.shape[1 - a]
        row = np.zeros(prof_len, dtype=np.float32)
        row[1:n + 1] = np.broadcast_to(v.reshape(-1), (n,))
        row[0] = row[1]
        row[n + 1] = row[n]
        profiles.append(row)
        entry.prof = len(profiles) - 1

    for f, (bcs, comp) in enumerate(((bc_p, None), (bc_T, None),
                                     (bc_U, 0), (bc_U, 1))):
        for a in range(2):
            for side in (0, 1):
                fill(params.bc[f][a][side], bcs[a, side], a, side, comp)
    params.prof_len = prof_len
    if not profiles:
        profiles.append(np.zeros(prof_len, dtype=np.float32))
    return np.stack(profiles)


def make_params(solver) -> tuple:
    """(QGDParams, profile table) for a supported solver."""
    mesh = solver.mesh
    th = solver.thermo
    tm = solver.tau_model
    tc = solver.time
    nx, ny = mesh.shape
    dx, dy = float(mesh.dx[0][0]), float(mesh.dx[1][0])
    h_cell = float(mesh._h_cell_np.reshape(-1)[0])
    varsc = isinstance(tm, VarScModel5)
    prm = _build.QGDParams(
        nx=nx, ny=ny, varsc=int(varsc),
        edge_lo=1, edge_hi=1, edge_lo_y=1, edge_hi_y=1,
        mu_const0=int(th.transport.mu0 == 0.0),
        adjust_dt=int(tc.adjust_time_step),
        dx=dx, dy=dy, inv_dx=1.0 / dx, inv_dy=1.0 / dy,
        inv_2dx=1.0 / (2.0 * dx), inv_2dy=1.0 / (2.0 * dy),
        hfx=dx, hfy=dy, inv_vol=1.0 / (dx * dy),
        R=th.R, Cv=th.Cv, inv_Cv=1.0 / th.Cv, CvR=th.Cv + th.R,
        gammaR=th.gamma * th.R, gamma=th.gamma, alpha=tm.alpha,
        k_mu=0.0 if varsc else tm.Sc * tm.alpha * h_cell,
        k_muv=tm.alpha * h_cell,
        Pr_tau=tm.Pr, inv_Pr_tau=1.0 / tm.Pr, Pr_th=th.Pr,
        mu0=th.transport.mu0,
        max_co=tc.max_co, max_dt=tc.max_dt, c_tau=tc.c_tau,
        inv_hfx=1.0 / dx, inv_hfy=1.0 / dy, h_cell=h_cell,
    )
    if varsc and getattr(tm.cqSc, "ndim", 0) == 0:
        # the sensor constants of qgd2d_emit (a per-cell cqSc floor keeps
        # the plain pre-pass: see folds_sensor)
        prm.rC = tm.rC
        prm.one_m_rC = 1.0 - tm.rC
        prm.minSc = tm.minSc
        prm.maxSc = tm.maxSc
        prm.cqSc = float(tm.cqSc)
        prm.smooth_ratio = 1.0 + tm.smoothCoeff
    profiles = _compile_bcs(solver, prm)
    return prm, profiles


# ---------------------------------------------------------------------------
# plain torch versions of the three kernels (same frame layout)
# ---------------------------------------------------------------------------


def _edges(prm):
    """The physical-boundary flags of a 2D block, per axis."""
    return ((prm.edge_lo, prm.edge_hi), (prm.edge_lo_y, prm.edge_hi_y))


def _xi(a, b):
    return 0.5 * (a + b)


def _face_tau(prm, coef):
    """tau_f at x-faces (rows 0..nx, lanes 1..ny) and y-faces (rows 1..nx,
    lanes 0..ny) from a zero-gradient coefficient frame."""
    cx = _xi(coef[:-1, 1:-1], coef[1:, 1:-1])
    cy = _xi(coef[1:-1, :-1], coef[1:-1, 1:])
    if prm.varsc:
        return (prm.alpha / cx) * prm.hfx, (prm.alpha / cy) * prm.hfy
    return cx * prm.hfx, cy * prm.hfy


def dt_fold_reference(prm, T, ux, uy):
    """Plain version of `qgd2d_dt_fold`: the quad (max acoustic wave speed
    along x, along y, -min tau_f, 0) over the block's live faces; the
    partition faces of a block count on both ranks, which max and min do
    not mind."""
    gRT = prm.gammaR * T
    rcs = torch.rsqrt(gRT)
    c = gRT * rcs
    wave_x = torch.abs(_xi(ux[:-1, 1:-1], ux[1:, 1:-1])) \
        + _xi(c[:-1, 1:-1], c[1:, 1:-1])
    wave_y = torch.abs(_xi(uy[1:-1, :-1], uy[1:-1, 1:])) \
        + _xi(c[1:-1, :-1], c[1:-1, 1:])
    taux, tauy = _face_tau(prm, zg(c if prm.varsc else prm.alpha * rcs,
                                   _edges(prm)))
    tau_min = torch.minimum(torch.min(taux), torch.min(tauy))
    return torch.stack([torch.max(wave_x), torch.max(wave_y), -tau_min,
                        torch.zeros_like(tau_min)])


def dt_apply_reference(prm, quad, dt):
    """Plain version of `qgd2d_dt_apply`: setDeltaT from a (reduced) quad of
    `dt_fold_reference`."""
    co = torch.maximum(quad[0] * dt / prm.hfx, quad[1] * dt / prm.hfy)
    return common.set_delta_t(dt, co, -quad[2], time_controls(prm))


def dt_reference(prm, T, ux, uy, dt):
    """Plain version of `qgd2d_dt`: setDeltaT from the max acoustic wave
    speed per axis and min tau_f over the live faces."""
    return dt_apply_reference(prm, dt_fold_reference(prm, T, ux, uy), dt)


def update_reference(prm, p, T, ux, uy, sc, dt):
    """Plain version of `qgd2d_update`: the QGD fluxes and the explicit
    update.  Returns (new frames p, T, ux, uy with the interior filled and
    zero ghosts, side) where side[0 / 1, 1:ny+1] = ws0/tau_f on the x-low /
    x-high boundary faces (read only where that side is physical)."""
    rho = p / (prm.R * T)
    e = prm.Cv * T
    gRT = prm.gammaR * T
    rcs = torch.rsqrt(gRT)
    c = gRT * rcs
    rux = rho * ux
    ruy = rho * uy
    ke = ux * ux + uy * uy
    H = prm.CvR * T + 0.5 * ke
    # coefficient fields with zero-gradient ghosts at physical edges
    edges = _edges(prm)
    if prm.varsc:
        mu_eff = sc * ((prm.k_muv * p) * rcs)
    else:
        mu_eff = (prm.k_mu * p) * rcs
    alphau = None
    if not prm.mu_const0:
        alphau = zg(mu_eff / prm.Pr_tau + prm.mu0 / prm.Pr_th, edges)
        mu_eff = mu_eff + prm.mu0
    mu_eff = zg(mu_eff, edges)
    taufx, taufy = _face_tau(prm, zg(c if prm.varsc else prm.alpha * rcs,
                                     edges))
    C = slice(1, -1)

    # x-faces: face r+1/2 at row r (rows 0..nx), lanes 1..ny
    def xint(f):
        return _xi(f[:-1], f[1:])

    def xsn(f):
        return ((f[1:] - f[:-1]) * prm.inv_dx)[:, C]

    def ytan(fx):
        return (fx[:, 2:] - fx[:, :-2]) * prm.inv_2dy

    pfx_a, rfx_a, uxfx_a, uyfx_a, efx_a = (xint(f) for f in (p, rho, ux, uy,
                                                             e))
    pfx, rfx, uxfx, uyfx = (f[:, C] for f in (pfx_a, rfx_a, uxfx_a, uyfx_a))
    ruxf = xint(rux)[:, C]
    ruyf = xint(ruy)[:, C]
    Hfx = xint(H)[:, C]
    mufx = xint(mu_eff)[:, C]
    afx = mufx * prm.inv_Pr_tau if alphau is None else xint(alphau)[:, C]
    urr0x = xint(ux * rux)[:, C]
    urr1x = xint(ux * ruy)[:, C]
    gU00, gU01 = xsn(ux), xsn(uy)
    gU10, gU11 = ytan(uxfx_a), ytan(uyfx_a)
    gRx, gRy = xsn(rho), ytan(rfx_a)
    gPx, gPy = xsn(p), ytan(pfx_a)
    gex, gey = xsn(e), ytan(efx_a)

    divU = gU00 + gU11
    u_gradrho = uxfx * gRx + uyfx * gRy
    rg0 = ruxf * gU00 + ruyf * gU10
    ws0 = taufx * (u_gradrho * uxfx + ruxf * divU + rg0)
    jmx = ruxf - (ws0 + taufx * gPx)
    phiJm_x = jmx * prm.dy
    u_gradp = uxfx * gPx + uyfx * gPy
    iso = u_gradp + prm.gamma * pfx * divU
    pi0 = taufx * (urr0x * gU00 + urr1x * gU10 + uxfx * gPx + iso) \
        + mufx * (2.0 * gU00 - (2.0 / 3.0) * divU)
    pi1 = taufx * (urr0x * gU01 + urr1x * gU11 + uxfx * gPy) \
        + mufx * (gU01 + gU10)
    de0 = gex - (pfx / (rfx * rfx)) * gRx
    de1 = gey - (pfx / (rfx * rfx)) * gRy
    qx = -taufx * (urr0x * de0 + urr1x * de1) - afx * gex
    fx_rho = phiJm_x
    fx_m0 = phiJm_x * uxfx + prm.dy * (pfx - pi0)
    fx_m1 = phiJm_x * uyfx - prm.dy * pi1
    fx_E = phiJm_x * Hfx + prm.dy * (qx - (pi0 * uxfx + pi1 * uyfx))

    # y-faces: face s+1/2 at lane s (lanes 0..ny), rows 1..nx
    def yint(f):
        return _xi(f[:, :-1], f[:, 1:])

    def ysn(f):
        return ((f[:, 1:] - f[:, :-1]) * prm.inv_dy)[C]

    def xtan(fy):
        return (fy[2:] - fy[:-2]) * prm.inv_2dx

    pfy_a, rfy_a, uxfy_a, uyfy_a, efy_a = (yint(f) for f in (p, rho, ux, uy,
                                                             e))
    pfy, rfy, uxfy, uyfy = (f[C] for f in (pfy_a, rfy_a, uxfy_a, uyfy_a))
    ruxfy = yint(rux)[C]
    ruyfy = yint(ruy)[C]
    Hfy = yint(H)[C]
    mufy = yint(mu_eff)[C]
    afy = mufy * prm.inv_Pr_tau if alphau is None else yint(alphau)[C]
    urr0y = yint(uy * rux)[C]
    urr1y = yint(uy * ruy)[C]
    hU10, hU11 = ysn(ux), ysn(uy)
    hU00, hU01 = xtan(uxfy_a), xtan(uyfy_a)
    hRx, hRy = xtan(rfy_a), ysn(rho)
    hPx, hPy = xtan(pfy_a), ysn(p)
    hex_, hey = xtan(efy_a), ysn(e)

    divUy = hU00 + hU11
    u_gradrho_y = uxfy * hRx + uyfy * hRy
    rg1y = ruxfy * hU01 + ruyfy * hU11
    ws1y = taufy * (u_gradrho_y * uyfy + ruyfy * divUy + rg1y)
    jmy = ruyfy - (ws1y + taufy * hPy)
    phiJm_y = jmy * prm.dx
    u_gradp_y = uxfy * hPx + uyfy * hPy
    isoy = u_gradp_y + prm.gamma * pfy * divUy
    qi0 = taufy * (urr0y * hU00 + urr1y * hU10 + uyfy * hPx) \
        + mufy * (hU00 + hU10)
    qi1 = taufy * (urr0y * hU01 + urr1y * hU11 + uyfy * hPy + isoy) \
        + mufy * (2.0 * hU11 - (2.0 / 3.0) * divUy)
    he0 = hex_ - (pfy / (rfy * rfy)) * hRx
    he1 = hey - (pfy / (rfy * rfy)) * hRy
    qy = -taufy * (urr0y * he0 + urr1y * he1) - afy * hey
    fy_rho = phiJm_y
    fy_m0 = phiJm_y * uxfy - prm.dx * qi0
    fy_m1 = phiJm_y * uyfy + prm.dx * (pfy - qi1)
    fy_E = phiJm_y * Hfy + prm.dx * (qy - (qi0 * uxfy + qi1 * uyfy))

    # explicit update of the interior cells
    sdt = dt * prm.inv_vol

    def div(fx, fy):
        return (fx[1:] - fx[:-1]) + (fy[:, 1:] - fy[:, :-1])

    rho_c, rux_c, ruy_c = rho[C, C], rux[C, C], ruy[C, C]
    rhoE = rho_c * (e[C, C] + 0.5 * ke[C, C])
    rhon = rho_c - sdt * div(fx_rho, fy_rho)
    rux_n = rux_c - sdt * div(fx_m0, fy_m0)
    ruy_n = ruy_c - sdt * div(fx_m1, fy_m1)
    rhoEn = rhoE - sdt * div(fx_E, fy_E)
    inv_rhon = 1.0 / rhon
    uxn = rux_n * inv_rhon
    uyn = ruy_n * inv_rhon
    en = rhoEn * inv_rhon - 0.5 * (uxn * uxn + uyn * uyn)
    Tn = en * prm.inv_Cv
    pn = rhon * prm.R * Tn

    out = []
    for interior in (pn, Tn, uxn, uyn):
        f = torch.zeros_like(p)
        f[C, C] = interior
        out.append(f)
    side = torch.zeros((2, p.shape[1]), dtype=p.dtype, device=p.device)
    side[0, C] = ws0[0] / taufx[0]
    side[1, C] = ws0[-1] / taufx[-1]
    return tuple(out), side


def ghosts_reference(prm, frames, side, profiles):
    """Plain version of `qgd2d_ghosts`, in place on the fresh frames: the
    x-ghost rows from the interior rows (qgdFlux p: interior +- side*dx),
    then the y-ghost lanes of every row, corners included.  inletOutlet
    switches on the fresh adjacent-cell outward velocity; on the ghost rows
    it takes the edge interior row's.  Partition sides are left as they
    are: the halo exchange fills them."""
    nr, w = frames[0].shape
    nx, ny = nr - 2, w - 2
    uy = frames[3]
    x_ghosts(prm, frames, side[:, 1:-1], profiles[:, 1:ny + 1], prm.dx)
    y_lo, y_hi = _edges(prm)[1]
    rows = torch.arange(nr, device=uy.device).clamp(1, nx)
    for f, fld in enumerate(frames):
        for sd in (0, 1):
            if not (y_lo if sd == 0 else y_hi):
                continue
            e = prm.bc[f][1][sd]
            l1, l2, lg = (1, 2, 0) if sd == 0 else (ny, ny - 1, ny + 1)
            v = profiles[e.prof, :nr] if e.prof >= 0 else e.value
            fld[:, lg] = bc_ghost(e, fld[:, l1], fld[:, l2], prm.dy, v,
                                  uy[rows, l1], sd)
    return frames


def emit_reference(prm, p, T, ux, uy, sc):
    """Plain version of `qgd2d_emit`: what the next step needs, read from
    the fresh frames after `ghosts_reference` (and the sensor frame `sc`
    this step used).  Returns (co_rate, tau_rate, sc_raw, sc_s1, sc_chg):

      co_rate  max over the live x- and y-faces (the physical boundary
               faces against the fresh ghosts included) of (|u_f| + c_f)/h,
               a rate: setDeltaT takes co = co_rate*dt;
      tau_rate min tau_f with zero-gradient coefficient ghosts:
               alpha/max(c_f)*h (varScModel5), min(alpha/c)_f*h otherwise;
      sc_raw   varScModel5: the raw sensor clip(rC*|grad rho|*h/rho
               + (1-rC)*sc, minSc, maxSc), floored at cqSc, over the
               interior (nx, ny); rho = p*(1/(R*T)) with zero-gradient
               ghosts;
      sc_s1    the first fvc::smooth ring max(raw, nbr_max(raw)/maxRatio),
               edge-replicated neighbours at the boundary;
      sc_chg   1.0 if any(sc_s1 > sc_raw), else 0.0.

    The sensor outputs are None unless varScModel5.  The arithmetic is the
    reference's slab kernel's (`emit_dt`/`emit_sc`)."""
    C = slice(1, -1)
    gRT = prm.gammaR * T
    rcs = torch.rsqrt(gRT)
    c = gRT * rcs
    wave_x = torch.abs(_xi(ux[:-1, C], ux[1:, C])) + _xi(c[:-1, C], c[1:, C])
    wave_y = torch.abs(_xi(uy[C, :-1], uy[C, 1:])) + _xi(c[C, :-1], c[C, 1:])
    co_rate = torch.maximum(torch.max(wave_x) * prm.inv_hfx,
                            torch.max(wave_y) * prm.inv_hfy)
    coef = zg(c if prm.varsc else prm.alpha * rcs)
    cx = _xi(coef[:-1, C], coef[1:, C])
    cy = _xi(coef[C, :-1], coef[C, 1:])
    if prm.varsc:
        tau_rate = torch.minimum((prm.alpha / torch.max(cx)) * prm.hfx,
                                 (prm.alpha / torch.max(cy)) * prm.hfy)
    else:
        tau_rate = torch.minimum(torch.min(cx) * prm.hfx,
                                 torch.min(cy) * prm.hfy)
    if not prm.varsc:
        return co_rate, tau_rate, None, None, None
    rho = zg(p * (1.0 / (prm.R * T)))
    fa = 0.5 * rho[:-1] + 0.5 * rho[1:]
    gx = ((fa[1:] - fa[:-1]) / prm.dx)[:, C]
    fb = 0.5 * rho[:, :-1] + 0.5 * rho[:, 1:]
    gy = ((fb[:, 1:] - fb[:, :-1]) / prm.dy)[C]
    mag = torch.sqrt(gx * gx + gy * gy)
    raw = prm.rC * (mag * prm.h_cell / rho[C, C]) + prm.one_m_rC * sc[C, C]
    raw = torch.clamp(raw, prm.minSc, prm.maxSc)
    raw = torch.clamp(raw, min=prm.cqSc).contiguous()
    s1, chg = smooth_reference(prm, raw, 1)
    return co_rate, tau_rate, raw, s1, chg


# ---------------------------------------------------------------------------
# the wrappers: plain version for CPU tensors, the CUDA kernel otherwise
# ---------------------------------------------------------------------------


def _check(prm, name, *tensors):
    return check_tensors(name, (prm.nx + 2, prm.ny + 2), *tensors)


# floats of a qgd2d_dt block's partial: two max waves, two tau coefficient
# extremes
_DT_NQ = 4


def qgd2d_dt(prm, T, ux, uy, dt):
    """New dt (0-dim tensor) from the current frames and the previous dt.
    One launch: the blocks' partials and, in the last block, the fold and
    setDeltaT."""
    on_card = _check(prm, "qgd2d_dt", T, ux, uy)
    check_dt("qgd2d_dt", dt, T)
    if not on_card:
        return dt_reference(prm, T, ux, uy, dt)
    work = dt_work(_DT_NQ, T, "qgd2d_dt_partials", prm.nx, prm.ny)
    out = torch.empty((), dtype=T.dtype, device=T.device)
    launch(qgd2d_dt, "qgd2d_dt", prm, T, ux, uy, dt, work, out, like=T)
    return out


def qgd2d_dt_fold(prm, T, ux, uy):
    """This block's dt quad (4,) on T's device - see `dt_fold_reference`.
    One launch, as `qgd2d_dt`."""
    on_card = _check(prm, "qgd2d_dt_fold", T, ux, uy)
    if not on_card:
        return dt_fold_reference(prm, T, ux, uy)
    work = dt_work(_DT_NQ, T, "qgd2d_dt_partials", prm.nx, prm.ny)
    quad = torch.empty(4, dtype=T.dtype, device=T.device)
    launch(qgd2d_dt_fold, "qgd2d_dt_fold", prm, T, ux, uy, work, quad, like=T)
    return quad


def qgd2d_dt_apply(prm, quad, dt):
    """New dt (0-dim tensor) from a reduced quad of `qgd2d_dt_fold` and the
    previous dt - see `dt_apply_reference`."""
    on_card = check_tensors("qgd2d_dt_apply", (4,), quad)
    check_dt("qgd2d_dt_apply", dt, quad)
    if not on_card:
        return dt_apply_reference(prm, quad, dt)
    out = torch.empty((), dtype=quad.dtype, device=quad.device)
    launch(qgd2d_dt_apply, "qgd2d_dt_apply", prm, quad, dt, out, like=quad)
    return out


def qgd2d_update(prm, p, T, ux, uy, sc, dt):
    """(new frames, side) — see `update_reference`.  The kernel leaves the
    new frames' ghosts unset; `qgd2d_ghosts` fills them."""
    fr = (p, T, ux, uy) + ((sc,) if prm.varsc else ())
    on_card = _check(prm, "qgd2d_update", *fr)
    check_dt("qgd2d_update", dt, p)
    if not on_card:
        return update_reference(prm, p, T, ux, uy, sc, dt)
    new = tuple(torch.empty_like(p) for _ in range(4))
    # lanes 0 and ny+1 of side stay unset: no ghost reads them
    side = torch.empty((2, prm.ny + 2), dtype=p.dtype, device=p.device)
    launch(qgd2d_update, "qgd2d_update", prm, p, T, ux, uy,
           sc if prm.varsc else None, dt, *new, side, like=p)
    return new, side


def qgd2d_ghosts(prm, frames, side, profiles):
    """Fill the ghosts of the fresh frames in place — see
    `ghosts_reference`.  One launch: each ghost cell from interior cells,
    a corner from the x-ghosts beside it."""
    on_card = _check(prm, "qgd2d_ghosts", *frames)
    check_tensors("qgd2d_ghosts", (2, prm.ny + 2), side)
    check_tensors("qgd2d_ghosts", (len(profiles), prm.prof_len), profiles)
    if side.device != frames[0].device or profiles.device != side.device:
        raise ValueError("qgd2d_ghosts: side and profiles must lie beside "
                         "the frames")
    if not on_card:
        return ghosts_reference(prm, frames, side, profiles)
    launch(qgd2d_ghosts, "qgd2d_ghosts", prm, profiles, side, *frames,
           like=side)
    return frames


def qgd2d_emit(prm, p, T, ux, uy, sc):
    """(co_rate, tau_rate, sc_raw, sc_s1, sc_chg) of the fresh frames — see
    `emit_reference`.  Launch it after `qgd2d_ghosts`: the rates read the
    fresh ghost rows and lanes.  On the card the two rates and the flag are
    one-element device tensors (two passes: per-block partials, then one
    block), never read back here."""
    fr = (p, T, ux, uy) + ((sc,) if prm.varsc else ())
    on_card = _check(prm, "qgd2d_emit", *fr)
    if not on_card:
        return emit_reference(prm, p, T, ux, uy, sc)
    dev = p.device
    n = query("qgd2d_emit_partials", prm.nx, prm.ny, device=dev)
    partials = torch.empty((n, 8), dtype=p.dtype, device=dev)
    rates = torch.empty(2, dtype=p.dtype, device=dev)
    raw = s1 = chg = None
    if prm.varsc:
        raw = torch.empty((prm.nx, prm.ny), dtype=p.dtype, device=dev)
        s1 = torch.empty_like(raw)
        chg = torch.empty((), dtype=p.dtype, device=dev)
    launch(qgd2d_emit, "qgd2d_emit", prm, p, T, ux, uy,
           sc if prm.varsc else None, partials, rates, raw, s1, chg, like=p)
    return rates[0], rates[1], raw, s1, chg


# rings one qgd2d_smooth launch may run (the kernel's halo), and the rings
# per launch on K2's path
SMOOTH_KMAX = 16
SMOOTH_RINGS = 16


def qgd2d_smooth(prm, f, k, out=None, flag=None):
    """(out, flag): k fvc::smooth rings (0 <= k <= SMOOTH_KMAX) of the
    sensor cells f - an (nx, ny) tensor, or the interior of an
    (nx+2, ny+2) frame - into the frame `out` (new if None) with
    edge-replicated ghosts, and a 0-dim flag (new if None), 1.0 if the last
    ring raised any cell, else 0.0 - see `smooth_reference`.  k = 0 only
    frames the cells.  Each launch adds one to `launches` and k to
    `rings`."""
    on_card, out, flag, base, pitches = smooth_args(
        "qgd2d_smooth", (prm.nx, prm.ny), SMOOTH_KMAX, f, k, out, flag)
    if not on_card:
        return _smooth_plain(prm, f, k, out, flag)
    launch(qgd2d_smooth, "qgd2d_smooth", prm, base, *pitches, k, out, flag,
           like=f)
    qgd2d_smooth.rings += k
    return out, flag


def update_launch_shape(prm, device) -> dict:
    """`qgd2d_update`'s launch at prm's shape on a card: strip lanes, chunk
    rows, static shared bytes per block, resident blocks per SM and blocks
    of the grid."""
    return dict(zip(("strip", "chunk", "smem_bytes", "blocks_per_sm",
                     "blocks"), launch_shape("qgd2d_update_shape", prm.nx,
                                             prm.ny, device=device)))


def dt_launch_shape(prm, device) -> dict:
    """`qgd2d_dt`'s launch at prm's shape on a card: the frame lanes a warp
    owns (it loads one more), warps a block, chunk rows, blocks of the grid
    and resident blocks per SM."""
    return dict(zip(("lanes", "warps", "chunk", "blocks", "blocks_per_sm"),
                    launch_shape("qgd2d_dt_shape", prm.nx, prm.ny,
                                 device=device)))


qgd2d_dt.launches = 0
qgd2d_dt_fold.launches = 0
qgd2d_dt_apply.launches = 0
qgd2d_update.launches = 0
qgd2d_ghosts.launches = 0
qgd2d_emit.launches = 0
qgd2d_smooth.launches = 0
qgd2d_smooth.rings = 0
KERNELS = (qgd2d_dt, qgd2d_update, qgd2d_ghosts, qgd2d_emit, qgd2d_smooth)
# the flagged kernels of the decomposed step (K3)
SHARDED_KERNELS = (qgd2d_dt_fold, qgd2d_dt_apply, qgd2d_update, qgd2d_ghosts)


# ---------------------------------------------------------------------------
# the step and its State conversions
# ---------------------------------------------------------------------------


def build_fused_step(solver, plain: bool = False):
    """(step, to_fused, from_fused) for a supported QGDFoam solver: K1's
    step, with the varScModel5 sensor as a plain pre-pass.

    step: FusedState -> FusedState.  With plain=True the step calls the plain
    torch versions directly on any device (the comparison path for the
    kernels on the card); the default goes through the kernel wrappers.
    """
    if not supported(solver):
        raise ValueError("solver config not supported by the fused step")
    mesh = solver.mesh
    th = solver.thermo
    tm = solver.tau_model
    varsc = isinstance(tm, VarScModel5)
    prm, profiles_np = make_params(solver)
    profiles = mesh.tensor(profiles_np).contiguous()
    if plain:
        k_dt, k_update, k_ghosts = dt_reference, update_reference, \
            ghosts_reference
    else:
        k_dt, k_update, k_ghosts = qgd2d_dt, qgd2d_update, qgd2d_ghosts

    def step(fs: FusedState) -> FusedState:
        sc_new = None
        if varsc:
            # sensor pre-pass: VarScModel5.sc_update (fvc::smooth included)
            rho_int = th.rho_from_p_T(fs.p[1:-1, 1:-1], fs.T[1:-1, 1:-1])
            sc_new = _edge_frame(tm.sc_update(mesh, rho_int,
                                              fs.sc[1:-1, 1:-1]))
        dt_new = k_dt(prm, fs.T, fs.ux, fs.uy, fs.dt)
        frames, side = k_update(prm, fs.p, fs.T, fs.ux, fs.uy, sc_new, dt_new)
        p, T, ux, uy = k_ghosts(prm, frames, side, profiles)
        return FusedState(p=p, T=T, ux=ux, uy=uy, t=fs.t + dt_new, dt=dt_new,
                          sc=sc_new)

    return (step, *state_frames(solver, FusedState, _edge_frame))


# ---------------------------------------------------------------------------
# K3: K1 on each block of a domain-decomposed run
# ---------------------------------------------------------------------------


def sharded_supported(solver, grid) -> bool:
    """True if `build_sharded_fused_step` takes this config on `grid`: the
    fused gate, blocks that divide both axes, and no block of one cell
    along a partitioned axis with an extrapolated side there
    (`one_cell_extrapolation`)."""
    nx, ny = solver.mesh.shape[:2]
    return (supported(solver) and nx % grid.px == 0 and ny % grid.py == 0
            and not one_cell_extrapolation(solver, grid))


def block_params(solver, ctx):
    """(QGDParams, profile table) of this rank's block: the global step
    constants with the block's shape and edge flags, and each array-valued
    BC profile windowed to the block's range plus its two ghosts (the
    serial table's entries there, not edge copies of the block's own)."""
    prm_g, prof_g = make_params(solver)
    prm = _build.QGDParams.from_buffer_copy(prm_g)
    nxl, nyl = (ax.n_local if ax is not None else n
                for ax, n in zip(ctx.axes, solver.mesh.shape))
    prm.nx, prm.ny = nxl, nyl
    prm.prof_len = max(nxl, nyl) + 2
    prm.edge_lo, prm.edge_hi = int(ctx.is_lo(0)), int(ctx.is_hi(0))
    prm.edge_lo_y, prm.edge_hi_y = int(ctx.is_lo(1)), int(ctx.is_hi(1))
    prof = np.zeros((prof_g.shape[0], prm.prof_len), dtype=np.float32)
    for f in range(4):
        for a in range(2):
            for side in (0, 1):
                k = prm.bc[f][a][side].prof
                if k >= 0:  # x sides run over lanes, y sides over rows
                    start, n = ((ctx.start(1), nyl) if a == 0
                                else (ctx.start(0), nxl))
                    prof[k, :n + 2] = prof_g[k, start:start + n + 2]
    return prm, prof


def build_sharded_fused_step(solver, grid):
    """(step, to_sharded, from_sharded): K1's kernels on this rank's block
    of a `grid` decomposition, inside a launched world of grid.size ranks
    (the port of the reference's shard_map step K3).

    Each rank carries its block with a one-cell halo frame, contiguous
    (nxl+2, nyl+2) float32.  A step: the block's dt quad
    (`qgd2d_dt_fold`), one MAX all-reduce, setDeltaT (`qgd2d_dt_apply`);
    for varScModel5 the sensor pre-pass `VarScModel5.sc_update` under the
    spmd context (its gradient ghosts and fvc::smooth rings cross the
    partitions); `qgd2d_update`; `qgd2d_ghosts` on the physical sides; then
    the halo exchange in two phases: rows over X at full width, then lanes
    over Y including the fresh halo rows, so the corners come from the
    diagonal neighbour in two hops.  The result is the serial K1 step's,
    bit for bit on an x-ring.

    to_sharded cuts this rank's overlapped block out of the frames of a
    global State; from_sharded gathers the blocks (a collective: every rank
    calls it) and returns the global State on every rank.  Raises
    ValueError for a config the kernels do not take or a grid that does not
    divide the mesh.
    """
    if not supported(solver) or one_cell_extrapolation(solver, grid):
        raise ValueError("solver config not supported by the fused step")
    mesh = solver.mesh
    th = solver.thermo
    tm = solver.tau_model
    varsc = isinstance(tm, VarScModel5)
    ctx = sharding.block_context(mesh, grid)
    local_mesh = sharding.block_mesh(ctx)
    prm, prof_np = block_params(solver, ctx)
    profiles = mesh.tensor(prof_np).contiguous()
    zg2 = bcm.FieldBCs.uniform(bcm.ZeroGradient(), 2)

    def local_step(fs: FusedState) -> FusedState:
        quad = spmd.all_max(qgd2d_dt_fold(prm, fs.T, fs.ux, fs.uy))
        dt_new = qgd2d_dt_apply(prm, quad, fs.dt)
        sc = None
        if varsc:
            rho_int = th.rho_from_p_T(fs.p[1:-1, 1:-1], fs.T[1:-1, 1:-1])
            sc = ghost_pad(tm.sc_update(local_mesh, rho_int,
                                        fs.sc[1:-1, 1:-1]),
                           zg2, local_mesh).contiguous()
        frames, side = qgd2d_update(prm, fs.p, fs.T, fs.ux, fs.uy, sc, dt_new)
        p, T, ux, uy = spmd.exchange_frames(
            qgd2d_ghosts(prm, list(frames), side, profiles))
        return FusedState(p=p, T=T, ux=ux, uy=uy, t=fs.t + dt_new, dt=dt_new,
                          sc=sc)

    def step(fs: FusedState) -> FusedState:
        with spmd.active(ctx):
            return local_step(fs)

    to_frames, from_fused = state_frames(solver, FusedState, _edge_frame)
    win = spmd.frame_window(ctx)

    def to_sharded(s) -> FusedState:
        fs = to_frames(s)
        return fs._replace(**{k: getattr(fs, k)[win].contiguous()
                              for k in FIELDS},
                           sc=fs.sc[win].contiguous() if varsc else None)

    def from_sharded(fs):
        return from_fused(fs._replace(
            **{k: spmd.join_frames(getattr(fs, k), ctx) for k in FIELDS},
            sc=spmd.join_frames(fs.sc, ctx) if varsc else None))

    return step, to_sharded, from_sharded


# ---------------------------------------------------------------------------
# K2: the step that carries what its last kernel emitted
# ---------------------------------------------------------------------------


class TiledState(tp.NamedTuple):
    """Carry of `build_tiled_fused_step`: FusedState's frames and time, plus
    what `qgd2d_emit` read from them for the next step (the reference's
    TiledState carry, without its slab ghost tiles): the Courant and tau
    rates (0-dim tensors) and, for varScModel5, the raw sensor, its first
    smoothing ring ((nx, ny) cells) and the change flag (0-dim, 1.0/0.0)."""

    p: torch.Tensor
    T: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    sc: tp.Optional[torch.Tensor] = None
    co_rate: tp.Optional[torch.Tensor] = None
    tau_rate: tp.Optional[torch.Tensor] = None
    sc_raw: tp.Optional[torch.Tensor] = None
    sc_s1: tp.Optional[torch.Tensor] = None
    sc_chg: tp.Optional[torch.Tensor] = None


def tiled_supported(solver) -> bool:
    """True if the config runs on `build_tiled_fused_step`: the fused gate,
    and for varScModel5 a scalar cqSc floor (the kernel takes it as a
    constant; `supported` refuses a const-Sc cellSet).  The reference's
    VMEM and slab tests are TPU-only."""
    if not supported(solver):
        return False
    tm = solver.tau_model
    return not isinstance(tm, VarScModel5) or getattr(tm.cqSc, "ndim", 0) == 0


def folds_sensor(solver) -> bool:
    """True for the configs `make_fused_step` sends to
    `build_tiled_fused_step`: 2D varScModel5 with a scalar cqSc, whose raw
    sensor and first smoothing ring `qgd2d_emit` folds into the step (the
    reference's `fold_sc` configs).  Every other 2D config keeps
    `build_fused_step` and its plain sensor pre-pass."""
    return tiled_supported(solver) and isinstance(solver.tau_model,
                                                  VarScModel5)


def build_tiled_fused_step(solver, plain: bool = False):
    """(step, to_fused, from_fused): the port of the reference's x-slab
    kernel K2 for a `tiled_supported` solver.

    K2 runs K1's physics and, over the fresh fields, emits what the next
    step needs; here the K1 kernels are shared and `qgd2d_emit` does the
    emitting, launched after `qgd2d_ghosts` so the rates read fresh ghosts.
    The frames are whole (no slabs), so there are no stale halos and no
    strip fixes.  step: TiledState -> TiledState does

      1. setDeltaT from the carried rates (dt = co_rate*dt-controlled, with
         cTau*tau_rate and maxDeltaT caps), no frame read;
      2. varScModel5: the sensor frame from the carried ring 1 and flag,
         `smooth_sensor` on `qgd2d_smooth` (one launch of no ring when the
         flag is 0, else SMOOTH_RINGS rings a launch to the fixed point; one
         host flag read per launch; its scratch frame and flag allocated
         once per builder and device; on a card the builder first requires
         the kernels' division-free ring exact for the case's maxRatio,
         `require_exact_ring`);
      3. `qgd2d_update`;  4. `qgd2d_ghosts`;  5. `qgd2d_emit`.

    to_fused converts a State (the sensor framed by `qgd2d_smooth` with no
    ring) and calls `qgd2d_emit` once on its frames, so the first dt is the
    K1 path's.  With plain=True every kernel is its plain torch version, on
    any device.
    """
    if not tiled_supported(solver):
        raise ValueError("solver config not supported by the tiled fused "
                         "step")
    mesh = solver.mesh
    tm = solver.tau_model
    tc = solver.time
    varsc = isinstance(tm, VarScModel5)
    prm, profiles_np = make_params(solver)
    profiles = mesh.tensor(profiles_np).contiguous()
    if varsc and not plain and mesh.device.type == "cuda":
        require_exact_ring(prm, mesh.device)
    if plain:
        k_update, k_ghosts, k_emit, k_smooth = update_reference, \
            ghosts_reference, emit_reference, _smooth_plain
    else:
        k_update, k_ghosts, k_emit, k_smooth = qgd2d_update, qgd2d_ghosts, \
            qgd2d_emit, qgd2d_smooth
    scratch = {}  # the cache of smooth_sensor

    def sensor(ts):
        return smooth_sensor(prm, ts.sc_s1, ts.sc_chg, k_smooth, SMOOTH_RINGS,
                             cache=scratch)

    def step(ts: TiledState) -> TiledState:
        dt_new = common.set_delta_t(ts.dt, ts.co_rate * ts.dt, ts.tau_rate,
                                    tc)
        sc = sensor(ts) if varsc else None
        frames, side = k_update(prm, ts.p, ts.T, ts.ux, ts.uy, sc, dt_new)
        p, T, ux, uy = k_ghosts(prm, frames, side, profiles)
        return TiledState(p, T, ux, uy, ts.t + dt_new, dt_new, sc,
                          *k_emit(prm, p, T, ux, uy, sc))

    def frame_sc(cells):
        out = torch.empty((prm.nx + 2, prm.ny + 2), dtype=cells.dtype,
                          device=cells.device)
        flag = torch.empty((), dtype=cells.dtype, device=cells.device)
        return k_smooth(prm, cells.contiguous(), 0, out, flag)[0]

    to_frames, from_fused = state_frames(solver, FusedState, frame_sc)

    def to_fused(s) -> TiledState:
        fs = to_frames(s)
        return TiledState(*fs, *k_emit(prm, fs.p, fs.T, fs.ux, fs.uy, fs.sc))

    return step, to_fused, from_fused
