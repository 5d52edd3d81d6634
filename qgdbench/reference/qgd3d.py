"""Plain PyTorch reference of the explicit 3D QGDFoam step on a uniform mesh.

A frozen copy of the plain 3D step of `qgdsolver_tpu_torch.ops.fused_qgd3d`
at commit f5c3372 (`dt_reference_3d`, `update_reference_3d`,
`sensor_reference_3d` and `emit_reference_3d`, `ghosts_reference_3d`, the
plain fvc::smooth ring loop, and `make_params`' constants), written against
a configuration's file instead of the program's solver objects.  It imports
nothing of the program.

State: ghost-padded primitive frames p, T, ux, uy, uz, each (nx+2, ny+2,
nz+2) with z the fast axis; index 0 and n+1 of each axis are ghosts.  For
varScModel5 the raw sensor of the current frames is carried, and each step
smooths it to the fvc::smooth fixed point before the update.

One step: dt by setDeltaT from the acoustic Courant number and min tau_f;
the smoothed sensor (varsc); the QGD face fluxes and the explicit update;
the raw sensor of the new fields (varsc); the BC ghosts, x, then y over
every x, then z over every x and y.

Every constant is rounded to float32 once, as the program's parameter
block is, so both sides compute with the same rounded values.
"""
from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch

FIELDS = ("p", "T", "ux", "uy", "uz")
SMALL = 1e-30
MAX_RINGS = 10_000


def _f32(x) -> float:
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# the configuration's constants
# ---------------------------------------------------------------------------


def face_coords(cfg, a) -> np.ndarray:
    """Face coordinates of axis a of the configuration's uniform mesh."""
    n, length = cfg["shape"][a], cfg["lengths"][a]
    return np.linspace(0.0, length, n + 1, dtype=np.float64)


def centres(cfg, a) -> np.ndarray:
    xf = face_coords(cfg, a)
    return 0.5 * (xf[:-1] + xf[1:])


def spacing(cfg, a) -> np.ndarray:
    return np.diff(face_coords(cfg, a))


def gas(cfg) -> dict:
    """Perfect-gas constants: R, Cp, Cv, gamma."""
    R, Cp = cfg["thermo"]["R"], cfg["thermo"]["Cp"]
    Cv = Cp - R
    return {"R": R, "Cp": Cp, "Cv": Cv, "gamma": Cp / Cv}


def values(cfg) -> dict:
    """The named values a configuration's BCs and initial fields use: the
    far-field p_inf and T_inf, and u_in, Mach times the far-field speed of
    sound."""
    g = gas(cfg)
    T_inf = cfg["far_field"]["T"]
    return {"p_inf": cfg["far_field"]["p"], "T_inf": T_inf,
            "u_in": cfg["mach"] * math.sqrt(g["gamma"] * g["R"] * T_inf)}


def inlet_profile(cfg) -> np.ndarray:
    """The round inlet slot over the x-low plane, (ny, nz) float64: a tanh
    edge over `edge_cells` cells at `radius` about `centre`."""
    inlet = cfg["inlet"]
    yc, zc = centres(cfg, 1), centres(cfg, 2)
    rr = np.sqrt((yc[:, None] - inlet["centre"][0]) ** 2
                 + (zc[None, :] - inlet["centre"][1]) ** 2)
    delta = inlet["edge_cells"] * float(spacing(cfg, 1)[0])
    return 0.5 * (np.tanh((inlet["radius"] - rr) / delta) + 1.0)


@dataclasses.dataclass(frozen=True)
class BC:
    """One side's ghost rule: kind `zg`, `fixed` or `qgdflux`; a fixed
    value is a number or an (ny, nz) plane."""

    kind: str
    value: tp.Any = 0.0


@dataclasses.dataclass(frozen=True)
class Params:
    """The step's constants, each rounded to float32."""

    nx: int
    ny: int
    nz: int
    varsc: bool
    mu_const0: bool
    adjust_dt: bool
    d: tuple
    inv_d: tuple
    inv_2d: tuple
    area: tuple
    inv_vol: float
    R: float
    Cv: float
    inv_Cv: float
    CvR: float
    gammaR: float
    gamma: float
    alpha: float
    k_mu: float
    k_muv: float
    inv_Pr_tau: float
    mu0: float
    mu0_Pr_th: float
    max_co: float
    max_dt: float
    c_tau: float
    rC: float
    one_m_rC: float
    minSc: float
    maxSc: float
    cqSc: float
    h_cell: float
    smooth_ratio: float
    bc: tuple  # bc[field][axis][side] -> BC, fields in FIELDS order


def _h_cell(cfg) -> float:
    """The QGD cell length of cell (0, 0, 0): the area-weighted mean of its
    face lengths, a boundary face taking the edge cell's width."""
    d = [spacing(cfg, a) for a in range(3)]
    num = den = 0.0
    for a in range(3):
        h_lo, h_hi = d[a][0], min(d[a][0], d[a][1])
        area = 1.0
        for b in range(3):
            if b != a:
                area = area * d[b][0]
        num = num + area * (h_lo + h_hi)
        den = den + 2.0 * area
    return float(num / den)


def _bc_value(v, cfg, named):
    if isinstance(v, str):
        if v == "inlet":
            return named["u_in"] * inlet_profile(cfg)
        return named[v]
    return v


def params(cfg, device="cpu", dtype=torch.float32) -> Params:
    """The step constants and BC table of a configuration.  Planes of the
    BCs are tensors on `device` in `dtype`, rounded to float32 first."""
    g = gas(cfg)
    th = cfg["thermo"]
    tm = cfg["tau_model"]
    tc = cfg["time"]
    varsc = tm["name"] == "varScModel5"
    d = [float(spacing(cfg, a)[0]) for a in range(3)]
    vol = d[0] * d[1] * d[2]
    h = _h_cell(cfg)
    named = values(cfg)
    bc = []
    for f in FIELDS:
        rows = []
        for a in range(3):
            row = []
            for side in (0, 1):
                spec = cfg["bcs"][f][a][side]
                kind = spec[0]
                if kind not in ("zg", "fixed", "qgdflux"):
                    raise ValueError(f"BC kind {kind!r} is not in the reference")
                v = _bc_value(spec[1], cfg, named) if kind == "fixed" else 0.0
                if isinstance(v, np.ndarray):
                    v = torch.as_tensor(v.astype(np.float32), device=device
                                        ).to(dtype)
                else:
                    v = _f32(v)
                row.append(BC(kind, v))
            rows.append(tuple(row))
        bc.append(tuple(rows))
    f3 = lambda xs: tuple(_f32(x) for x in xs)  # noqa: E731
    return Params(
        nx=cfg["shape"][0], ny=cfg["shape"][1], nz=cfg["shape"][2],
        varsc=varsc, mu_const0=th["mu0"] == 0.0,
        adjust_dt=tc["adjust_time_step"],
        d=f3(d), inv_d=f3(1.0 / x for x in d),
        inv_2d=f3(1.0 / (2.0 * x) for x in d),
        area=f3(vol / x for x in d), inv_vol=_f32(1.0 / vol),
        R=_f32(g["R"]), Cv=_f32(g["Cv"]), inv_Cv=_f32(1.0 / g["Cv"]),
        CvR=_f32(g["Cv"] + g["R"]), gammaR=_f32(g["gamma"] * g["R"]),
        gamma=_f32(g["gamma"]), alpha=_f32(tm["alpha"]),
        k_mu=0.0 if varsc else _f32(tm["Sc"] * tm["alpha"] * h),
        k_muv=_f32(tm["alpha"] * h), inv_Pr_tau=_f32(1.0 / tm["Pr"]),
        mu0=_f32(th["mu0"]), mu0_Pr_th=_f32(th["mu0"] * (1.0 / th["Pr"])),
        max_co=_f32(tc["max_co"]), max_dt=_f32(tc["max_dt"]),
        c_tau=_f32(tc["c_tau"]),
        rC=_f32(tm["rC"]) if varsc else 0.0,
        one_m_rC=_f32(1.0 - tm["rC"]) if varsc else 0.0,
        minSc=_f32(tm["minSc"]) if varsc else 0.0,
        maxSc=_f32(tm["maxSc"]) if varsc else 1.0,
        cqSc=_f32(tm["cqSc"]) if varsc else 0.0, h_cell=_f32(h),
        smooth_ratio=_f32(1.0 + tm["smoothCoeff"]) if varsc else 0.0,
        bc=tuple(bc))


# ---------------------------------------------------------------------------
# frame helpers
# ---------------------------------------------------------------------------


def _sl(x, axis, s):
    idx = [slice(None)] * x.ndim
    idx[axis] = s
    return x[tuple(idx)]


def _lo(x, a):
    return _sl(x, a, slice(0, x.shape[a] - 1))


def _hi(x, a):
    return _sl(x, a, slice(1, None))


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


def _zg(f):
    """Coefficient ghosts: zero-gradient copies of the edge cells."""
    for a, n in enumerate(f.shape):
        idx = torch.arange(n, device=f.device).clamp(1, n - 2)
        f = f.index_select(a, idx)
    return f


def edge_frame(cells):
    """Cells -> frame with edge-replicated ghosts."""
    f = cells
    for a, n in enumerate(cells.shape):
        idx = (torch.arange(n + 2, device=f.device) - 1).clamp(0, n - 1)
        f = f.index_select(a, idx)
    return f.contiguous()


C = (slice(1, -1),) * 3


# ---------------------------------------------------------------------------
# the step's parts
# ---------------------------------------------------------------------------


def set_delta_t(prm, dt, co, tau_min):
    """setDeltaT: immediate reduction, damped increase (at most x1.2 a
    step), capped by maxDeltaT and cTau*min(tau_f)."""
    if not prm.adjust_dt:
        return dt
    max_fact = prm.max_co / (co + SMALL)
    fact = torch.clamp(torch.minimum(max_fact, 1.0 + 0.1 * max_fact), max=1.2)
    max_dt1 = torch.clamp(prm.c_tau * tau_min, max=prm.max_dt)
    return torch.minimum(fact * dt, max_dt1)


def new_dt(prm, T, ux, uy, uz, dt):
    """The step's dt from the max acoustic wave speed per axis and the min
    tau_f over every face, those against the ghost layers included."""
    gRT = prm.gammaR * T
    c = gRT * torch.rsqrt(gRT)
    coef = _zg(c if prm.varsc else prm.alpha / c)
    waves = []
    tau_min = torch.full((), float("inf"), dtype=T.dtype, device=T.device)
    for a, u in enumerate((ux, uy, uz)):
        wave = torch.abs(_trim(_aint(u, a), a)) + _trim(_aint(c, a), a)
        waves.append(torch.max(wave))
        cf = _trim(_aint(coef, a), a)
        tauf = (prm.alpha / cf) * prm.d[a] if prm.varsc else cf * prm.d[a]
        tau_min = torch.minimum(tau_min, torch.min(tauf))
    co = torch.zeros((), dtype=T.dtype, device=T.device)
    for a in range(3):
        co = torch.maximum(co, waves[a] * dt / prm.d[a])
    return set_delta_t(prm, dt, co, tau_min)


def _axis_fluxes(prm, a, cell, coef):
    """The five face fluxes (area included) at the a-faces of every interior
    line, and ws, tau_f there."""
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


def update(prm, p, T, ux, uy, uz, sc, dt):
    """The QGD fluxes and the explicit update.  Returns (new frames p, T,
    ux, uy, uz with the interior filled and zero ghosts, side), side[0 / 1]
    = ws/tau_f on the x-low / x-high boundary faces, shape (2, ny, nz)."""
    u3 = (ux, uy, uz)
    rho = p / (prm.R * T)
    e = prm.Cv * T
    gRT = prm.gammaR * T
    rcs = torch.rsqrt(gRT)
    ru = tuple(rho * u for u in u3)
    ke = ux * ux + uy * uy + uz * uz
    H = prm.CvR * T + 0.5 * ke
    if prm.varsc:
        mu_qgd = ((prm.k_muv * sc) * p) * rcs
        tcoef = _zg(gRT * rcs)
    else:
        mu_qgd = (prm.k_mu * p) * rcs
        tcoef = _zg(prm.alpha * rcs)
    if prm.mu_const0:
        mu_eff, alphau = _zg(mu_qgd), None
    else:
        mu_eff = _zg(mu_qgd + prm.mu0)
        alphau = _zg(mu_qgd * prm.inv_Pr_tau + prm.mu0_Pr_th)
    cell = (p, rho, e, H, u3, ru)
    acc = None
    for a in range(3):
        fl, ws, tauf = _axis_fluxes(prm, a, cell, (mu_eff, alphau, tcoef))
        if a == 0:
            side = torch.stack([ws[0] / tauf[0], ws[-1] / tauf[-1]])
        dfl = [_hi(f, a) - _lo(f, a) for f in fl]
        acc = dfl if acc is None else [x + y for x, y in zip(acc, dfl)]
        del fl, ws, tauf, dfl

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
    return out, side.contiguous()


def raw_sensor(prm, p, T, sc):
    """The raw varScModel5 sensor of the frames' cells, relaxed against the
    sensor frame sc: rC*|grad rho|*h/rho + (1-rC)*sc, clamped to [minSc,
    maxSc], floored at cqSc; rho from p and T, with zero-gradient ghosts.
    Returns (nx, ny, nz)."""
    rg = _zg(p * (1.0 / (prm.R * T)))
    r = rg[C]
    g = [(_sl(rg, a, slice(2, None)) - _sl(rg, a, slice(None, -2)))
         * prm.inv_2d[a] for a in range(3)]
    g = [_trim(x, a) for a, x in enumerate(g)]
    mag = torch.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2])
    s = prm.rC * (mag * prm.h_cell / r) + prm.one_m_rC * sc[C]
    s = torch.clamp(s, prm.minSc, prm.maxSc)
    return torch.clamp(s, min=prm.cqSc)


def _neighbour_max(f):
    """Max over the face neighbours of each cell, edge-replicated."""
    nb = f
    for a in range(f.ndim):
        n = f.shape[a]
        lo = torch.cat([f.narrow(a, 0, 1), f.narrow(a, 0, n - 1)], dim=a)
        hi = torch.cat([f.narrow(a, 1, n - 1), f.narrow(a, n - 1, 1)], dim=a)
        nb = torch.maximum(nb, torch.maximum(lo, hi))
    return nb


def ring(prm, f):
    """One fvc::smooth ring: (max(f, nbr_max(f)/maxRatio), 0-dim flag, 1.0
    if it raised a cell).  maxRatio divides as a tensor, a correctly
    rounded division."""
    ratio = torch.full((), prm.smooth_ratio, dtype=f.dtype, device=f.device)
    fn = torch.maximum(f, _neighbour_max(f) / ratio)
    return fn, torch.any(fn > f).to(f.dtype)


def smooth(prm, f):
    """fvc::smooth: rings until one raises no cell (at most MAX_RINGS).
    Returns (cells, rings run)."""
    for k in range(1, MAX_RINGS + 1):
        f, flag = ring(prm, f)
        if not bool(flag):
            break
    return f, k


def _bc_ghost(bc, in1, v_side=None, sd=0, dx=0.0):
    if bc.kind == "fixed":
        return 2.0 * bc.value - in1
    if bc.kind == "qgdflux":
        q = v_side * dx
        return in1 + q if sd == 0 else in1 - q
    return in1  # zero gradient


def ghosts(prm, frames, side):
    """The BC ghosts, in place on the frames: the x-ghost planes from the
    interior (qgdFlux p: interior +- side*dx), then the y-ghost rows over
    every x, then the z-ghost lanes over every x and y, so edges and
    corners see the earlier axes."""
    nx, ny, nz = prm.nx, prm.ny, prm.nz
    I = slice(1, -1)
    for f, fld in enumerate(frames):
        for sd in (0, 1):
            r1, rg = (1, 0) if sd == 0 else (nx, nx + 1)
            fld[rg, I, I] = _bc_ghost(prm.bc[f][0][sd], fld[r1, I, I],
                                      side[sd], sd, prm.d[0])
    for f, fld in enumerate(frames):
        for sd in (0, 1):
            l1, lg = (1, 0) if sd == 0 else (ny, ny + 1)
            fld[:, lg, I] = _bc_ghost(prm.bc[f][1][sd], fld[:, l1, I])
    for f, fld in enumerate(frames):
        for sd in (0, 1):
            l1, lg = (1, 0) if sd == 0 else (nz, nz + 1)
            fld[:, :, lg] = _bc_ghost(prm.bc[f][2][sd], fld[:, :, l1])
    return frames


# ---------------------------------------------------------------------------
# the initial frames and the run
# ---------------------------------------------------------------------------


def frames_of(prm, p, T, U):
    """Ghost-padded frames of primitive cell fields after the conservative
    round trip the solver state makes (rho, rhoU, rhoE and back): p, T and
    the velocity components, their ghosts by the BCs (a qgdFlux side starts
    with a zero gradient)."""
    rho = p * (1.0 / (prm.R * T))
    e = prm.Cv * T
    rhoU = rho[None] * U
    rhoE = rho * e + 0.5 * rho * torch.sum(U * U, dim=0)
    U = rhoU / rho[None]
    e = rhoE / rho - 0.5 * torch.sum(U * U, dim=0)
    T = e / prm.Cv
    p = rho * prm.R * T
    out = []
    for x in (p, T, U[0], U[1], U[2]):
        f = torch.zeros(tuple(n + 2 for n in x.shape), dtype=x.dtype,
                        device=x.device)
        f[C] = x
        out.append(f)
    zero = torch.zeros((2, prm.ny, prm.nz), dtype=p.dtype, device=p.device)
    return ghosts(prm, out, zero)


def run(cfg, fields, steps, dtype=None) -> dict:
    """`steps` steps from the primitive cell fields `fields` (p, T, U and,
    for varScModel5, sc), in `dtype` (the configuration's by default).
    Returns the frames p, T, ux, uy, uz, t and dt after the last step, and
    for varScModel5 `sc`, the sensor frame that step used, and `s1`, the
    first fvc::smooth ring of the raw sensor of the last frames, framed;
    and `rings`, the rings of each step's smoothing."""
    dtype = dtype or getattr(torch, cfg["dtype"])
    dev = fields["p"].device
    prm = params(cfg, dev, dtype)
    p, T, U = (fields[k].to(dtype) for k in ("p", "T", "U"))
    frames = frames_of(prm, p, T, U)
    del p, T, U
    dt = torch.full((), _f32(cfg["time"]["dt0"]), dtype=dtype, device=dev)
    t = torch.zeros((), dtype=dtype, device=dev)
    raw = sc = None
    if prm.varsc:
        sc = edge_frame(fields["sc"].to(dtype))
        raw = raw_sensor(prm, frames[0], frames[1], sc)
    rings = []
    for _ in range(steps):
        dt = new_dt(prm, *frames[1:], dt)
        if prm.varsc:
            cells, k = smooth(prm, raw)
            sc = edge_frame(cells)
            rings.append(k)
            del cells
        new, side = update(prm, *frames, sc, dt)
        frames = None
        if prm.varsc:
            raw = raw_sensor(prm, new[0], new[1], sc)
        frames = ghosts(prm, new, side)
        t = t + dt
    out = dict(zip(FIELDS, frames), t=t, dt=dt, rings=rings)
    if prm.varsc:
        out["sc"] = sc
        out["s1"] = edge_frame(ring(prm, raw)[0])
    return out
