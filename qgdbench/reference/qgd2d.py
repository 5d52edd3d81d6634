"""Plain PyTorch reference of the explicit 2D QGDFoam step of K2 on a uniform
mesh.

A frozen copy of the plain 2D K2 step of `qgdsolver_tpu_torch.ops.fused_qgd2d`
at commit c89fb21 (`build_tiled_fused_step(plain=True)`: `update_reference`,
`ghosts_reference`, `emit_reference`, `smoothing.smooth_reference` carried
to its fixed point, setDeltaT from the emitted rates, `make_params`'
constants, and the State round trip of `to_fused`), written against a
configuration's file instead of the program's solver objects.  It imports
nothing of the program; the helpers that do not depend on the number of
axes (the configuration's geometry and named values, the fvc::smooth ring)
are `reference.qgd3d`'s.

The configuration holds the 2D mesh one cell deep: `shape` [nx, ny, 1],
`lengths` [Lx, Ly, Lz]; the third axis, its BCs and uz are not read.

State: ghost-padded primitive frames p, T, ux, uy, each (nx+2, ny+2) with y
the fast axis; row 0 / nx+1 and lane 0 / ny+1 are ghosts.  Carried from
one step to the next, as K2 carries them: the Courant and tau rates of the
current frames, and for varScModel5 the raw sensor's first fvc::smooth
ring and its change flag.

One step: dt by setDeltaT from the carried rates; the sensor frame, ring 1
carried to the fvc::smooth fixed point and edge-framed (varsc); the QGD
face fluxes and the explicit update; the BC ghosts, x rows from the
interior, then y lanes over every row; the rates, the raw sensor (relaxed
against the sensor frame the step used) and its first ring, of the fresh
frames.

Where it departs from QGDFoam (the program departs alike):
- uniform planar mesh: every face length h_f is the cell width, h_cell the
  area-weighted mean of a cell's face lengths, one number;
- explicit diffusion only (QGDFoam's `implicitDiffusion false`);
- the sensor's gradient is the central difference of face averages, with
  zero-gradient ghosts, and fvc::smooth a cell beyond a physical edge is
  the cell itself;
- qgdFlux p: the new ghost is interior +- (W_s/tau)*dx of the update's
  boundary faces, the flux of the step that made the frames;
- every constant of the step is rounded to float32 once, as the program's
  parameter block is; setDeltaT reads the time controls unrounded, as the
  program's TimeControls hold them.
"""
from __future__ import annotations

import dataclasses

import torch

from .qgd3d import (BC, SMALL, _bc_ghost, _f32, _zg, centres, edge_frame, gas,
                    ring, smooth, spacing, values)

FIELDS = ("p", "T", "ux", "uy")
C = (slice(1, -1),) * 2


@dataclasses.dataclass(frozen=True)
class Params:
    """The step's constants, each rounded to float32 (the names are those
    of the program's parameter block)."""

    nx: int
    ny: int
    varsc: bool
    mu_const0: bool
    adjust_dt: bool
    dx: float
    dy: float
    inv_dx: float
    inv_dy: float
    inv_2dx: float
    inv_2dy: float
    hfx: float
    hfy: float
    inv_hfx: float
    inv_hfy: float
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
    Pr_tau: float
    inv_Pr_tau: float
    Pr_th: float
    mu0: float
    max_co: float
    max_dt: float
    c_tau: float
    h_cell: float
    rC: float
    one_m_rC: float
    minSc: float
    maxSc: float
    cqSc: float
    smooth_ratio: float
    bc: tuple  # bc[field][axis][side] -> BC, fields in FIELDS order


def _h_cell(d) -> float:
    """The QGD cell length of cell (0, 0): the area-weighted mean of its
    face lengths, a boundary face taking the edge cell's width."""
    num = den = 0.0
    for a in range(2):
        h_lo, h_hi = d[a][0], min(d[a][0], d[a][1])
        area = 1.0 * d[1 - a][0]
        num = num + area * (h_lo + h_hi)
        den = den + 2.0 * area
    return float(num / den)


def slot(cfg, device="cpu") -> torch.Tensor:
    """The inlet slot over the x-low side, (ny,) float32: u_in * 0.5 *
    (tanh((radius - |y - centre|) / (edge_cells*dy)) + 1), evaluated in
    float32 on float32 cell centres, as the case builder's BC callable is."""
    inlet = cfg["inlet"]
    y = torch.as_tensor(centres(cfg, 1), dtype=torch.float32, device=device)
    delta = inlet["edge_cells"] * float(spacing(cfg, 1)[0])
    prof = 0.5 * (torch.tanh((inlet["radius"]
                              - torch.abs(y - inlet["centre"][0])) / delta)
                  + 1.0)
    return values(cfg)["u_in"] * prof


def params(cfg, device="cpu", dtype=torch.float32) -> Params:
    """The step constants and BC table of a configuration.  A plane of the
    BCs is a tensor on `device` in `dtype`, computed in float32 first."""
    g = gas(cfg)
    th = cfg["thermo"]
    tm = cfg["tau_model"]
    tc = cfg["time"]
    varsc = tm["name"] == "varScModel5"
    d = [spacing(cfg, a) for a in range(2)]
    dx, dy = float(d[0][0]), float(d[1][0])
    h = _h_cell(d)
    named = values(cfg)
    bc = []
    for f in FIELDS:
        rows = []
        for a in range(2):
            row = []
            for side in (0, 1):
                spec = cfg["bcs"][f][a][side]
                kind = spec[0]
                if kind not in ("zg", "fixed", "qgdflux"):
                    raise ValueError(f"BC kind {kind!r} is not in the "
                                     "reference")
                if kind != "fixed":
                    v = 0.0
                elif spec[1] == "inlet":
                    v = slot(cfg, device).to(dtype)
                else:
                    v = _f32(named[spec[1]] if isinstance(spec[1], str)
                             else spec[1])
                row.append(BC(kind, v))
            rows.append(tuple(row))
        bc.append(tuple(rows))
    return Params(
        nx=cfg["shape"][0], ny=cfg["shape"][1], varsc=varsc,
        mu_const0=th["mu0"] == 0.0, adjust_dt=tc["adjust_time_step"],
        dx=_f32(dx), dy=_f32(dy), inv_dx=_f32(1.0 / dx),
        inv_dy=_f32(1.0 / dy), inv_2dx=_f32(1.0 / (2.0 * dx)),
        inv_2dy=_f32(1.0 / (2.0 * dy)), hfx=_f32(dx), hfy=_f32(dy),
        inv_hfx=_f32(1.0 / dx), inv_hfy=_f32(1.0 / dy),
        inv_vol=_f32(1.0 / (dx * dy)), R=_f32(g["R"]), Cv=_f32(g["Cv"]),
        inv_Cv=_f32(1.0 / g["Cv"]), CvR=_f32(g["Cv"] + g["R"]),
        gammaR=_f32(g["gamma"] * g["R"]), gamma=_f32(g["gamma"]),
        alpha=_f32(tm["alpha"]),
        k_mu=0.0 if varsc else _f32(tm["Sc"] * tm["alpha"] * h),
        k_muv=_f32(tm["alpha"] * h), Pr_tau=_f32(tm["Pr"]),
        inv_Pr_tau=_f32(1.0 / tm["Pr"]), Pr_th=_f32(th["Pr"]),
        mu0=_f32(th["mu0"]), max_co=_f32(tc["max_co"]),
        max_dt=_f32(tc["max_dt"]), c_tau=_f32(tc["c_tau"]), h_cell=_f32(h),
        rC=_f32(tm["rC"]) if varsc else 0.0,
        one_m_rC=_f32(1.0 - tm["rC"]) if varsc else 0.0,
        minSc=_f32(tm["minSc"]) if varsc else 0.0,
        maxSc=_f32(tm["maxSc"]) if varsc else 0.0,
        cqSc=_f32(tm["cqSc"]) if varsc else 0.0,
        smooth_ratio=_f32(1.0 + tm["smoothCoeff"]) if varsc else 0.0,
        bc=tuple(bc))


# ---------------------------------------------------------------------------
# the step's parts
# ---------------------------------------------------------------------------


def _xi(a, b):
    return 0.5 * (a + b)


def set_delta_t(tc, dt, co, tau_min):
    """setDeltaT: immediate reduction, damped increase (at most x1.2 a
    step), capped by maxDeltaT and cTau*min(tau_f); `tc` the
    configuration's time controls."""
    if not tc["adjust_time_step"]:
        return dt
    max_fact = tc["max_co"] / (co + SMALL)
    fact = torch.clamp(torch.minimum(max_fact, 1.0 + 0.1 * max_fact), max=1.2)
    max_dt1 = torch.clamp(tc["c_tau"] * tau_min, max=tc["max_dt"])
    return torch.minimum(fact * dt, max_dt1)


def update(prm, p, T, ux, uy, sc, dt):
    """The QGD fluxes and the explicit update.  Returns (new frames p, T,
    ux, uy with the interior filled and zero ghosts, side), side[0 / 1] =
    ws/tau_f on the x-low / x-high boundary faces, shape (2, ny)."""
    rho = p / (prm.R * T)
    e = prm.Cv * T
    gRT = prm.gammaR * T
    rcs = torch.rsqrt(gRT)
    c = gRT * rcs
    rux = rho * ux
    ruy = rho * uy
    ke = ux * ux + uy * uy
    H = prm.CvR * T + 0.5 * ke
    if prm.varsc:
        mu_eff = sc * ((prm.k_muv * p) * rcs)
    else:
        mu_eff = (prm.k_mu * p) * rcs
    alphau = None
    if not prm.mu_const0:
        alphau = _zg(mu_eff / prm.Pr_tau + prm.mu0 / prm.Pr_th)
        mu_eff = mu_eff + prm.mu0
    mu_eff = _zg(mu_eff)
    coef = _zg(c if prm.varsc else prm.alpha * rcs)
    cx = _xi(coef[:-1, 1:-1], coef[1:, 1:-1])
    cy = _xi(coef[1:-1, :-1], coef[1:-1, 1:])
    if prm.varsc:
        taufx, taufy = (prm.alpha / cx) * prm.hfx, (prm.alpha / cy) * prm.hfy
    else:
        taufx, taufy = cx * prm.hfx, cy * prm.hfy
    I = slice(1, -1)

    # x-faces: face r+1/2 at row r (rows 0..nx), lanes 1..ny
    def xint(f):
        return _xi(f[:-1], f[1:])

    def xsn(f):
        return ((f[1:] - f[:-1]) * prm.inv_dx)[:, I]

    def ytan(fx):
        return (fx[:, 2:] - fx[:, :-2]) * prm.inv_2dy

    pfx_a, rfx_a, uxfx_a, uyfx_a, efx_a = (xint(f) for f in (p, rho, ux, uy,
                                                             e))
    pfx, rfx, uxfx, uyfx = (f[:, I] for f in (pfx_a, rfx_a, uxfx_a, uyfx_a))
    ruxf = xint(rux)[:, I]
    ruyf = xint(ruy)[:, I]
    Hfx = xint(H)[:, I]
    mufx = xint(mu_eff)[:, I]
    afx = mufx * prm.inv_Pr_tau if alphau is None else xint(alphau)[:, I]
    urr0x = xint(ux * rux)[:, I]
    urr1x = xint(ux * ruy)[:, I]
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
        return ((f[:, 1:] - f[:, :-1]) * prm.inv_dy)[I]

    def xtan(fy):
        return (fy[2:] - fy[:-2]) * prm.inv_2dx

    pfy_a, rfy_a, uxfy_a, uyfy_a, efy_a = (yint(f) for f in (p, rho, ux, uy,
                                                             e))
    pfy, rfy, uxfy, uyfy = (f[I] for f in (pfy_a, rfy_a, uxfy_a, uyfy_a))
    ruxfy = yint(rux)[I]
    ruyfy = yint(ruy)[I]
    Hfy = yint(H)[I]
    mufy = yint(mu_eff)[I]
    afy = mufy * prm.inv_Pr_tau if alphau is None else yint(alphau)[I]
    urr0y = yint(uy * rux)[I]
    urr1y = yint(uy * ruy)[I]
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

    # the explicit update of the interior cells
    sdt = dt * prm.inv_vol

    def div(fx, fy):
        return (fx[1:] - fx[:-1]) + (fy[:, 1:] - fy[:, :-1])

    rho_c, rux_c, ruy_c = rho[C], rux[C], ruy[C]
    rhoE = rho_c * (e[C] + 0.5 * ke[C])
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
        f[C] = interior
        out.append(f)
    side = torch.stack([ws0[0] / taufx[0], ws0[-1] / taufx[-1]])
    return out, side


def ghosts(prm, frames, side):
    """The BC ghosts, in place on the frames: the x-ghost rows from the
    interior rows (qgdFlux p: interior +- side*dx), then the y-ghost lanes
    of every row, corners included."""
    nx, ny = prm.nx, prm.ny
    I = slice(1, -1)
    for f, fld in enumerate(frames):
        for sd in (0, 1):
            r1, rg = (1, 0) if sd == 0 else (nx, nx + 1)
            fld[rg, I] = _bc_ghost(prm.bc[f][0][sd], fld[r1, I], side[sd],
                                   sd, prm.dx)
    for f, fld in enumerate(frames):
        for sd in (0, 1):
            l1, lg = (1, 0) if sd == 0 else (ny, ny + 1)
            fld[:, lg] = _bc_ghost(prm.bc[f][1][sd], fld[:, l1])
    return frames


def emit(prm, p, T, ux, uy, sc):
    """What the next step needs, read from the fresh frames (ghosts
    included) and the sensor frame sc this step used: (co_rate, tau_rate,
    raw, s1, chg).  co_rate is the largest (|u_f| + c_f)/h over the x- and
    y-faces, so that the Courant number is co_rate*dt; tau_rate min tau_f
    (alpha/max(c_f)*h for varScModel5).  For varScModel5: raw, the sensor
    clip(rC*|grad rho|*h/rho + (1-rC)*sc, minSc, maxSc) floored at cqSc
    over the (nx, ny) cells; s1 its first fvc::smooth ring; chg 1.0 if that
    ring raised a cell, else 0.0 (None otherwise)."""
    gRT = prm.gammaR * T
    rcs = torch.rsqrt(gRT)
    c = gRT * rcs
    I = slice(1, -1)
    wave_x = torch.abs(_xi(ux[:-1, I], ux[1:, I])) + _xi(c[:-1, I], c[1:, I])
    wave_y = torch.abs(_xi(uy[I, :-1], uy[I, 1:])) + _xi(c[I, :-1], c[I, 1:])
    co_rate = torch.maximum(torch.max(wave_x) * prm.inv_hfx,
                            torch.max(wave_y) * prm.inv_hfy)
    coef = _zg(c if prm.varsc else prm.alpha * rcs)
    cx = _xi(coef[:-1, I], coef[1:, I])
    cy = _xi(coef[I, :-1], coef[I, 1:])
    if prm.varsc:
        tau_rate = torch.minimum((prm.alpha / torch.max(cx)) * prm.hfx,
                                 (prm.alpha / torch.max(cy)) * prm.hfy)
    else:
        tau_rate = torch.minimum(torch.min(cx) * prm.hfx,
                                 torch.min(cy) * prm.hfy)
    if not prm.varsc:
        return co_rate, tau_rate, None, None, None
    rho = _zg(p * (1.0 / (prm.R * T)))
    fa = 0.5 * rho[:-1] + 0.5 * rho[1:]
    gx = ((fa[1:] - fa[:-1]) / prm.dx)[:, I]
    fb = 0.5 * rho[:, :-1] + 0.5 * rho[:, 1:]
    gy = ((fb[:, 1:] - fb[:, :-1]) / prm.dy)[I]
    mag = torch.sqrt(gx * gx + gy * gy)
    raw = prm.rC * (mag * prm.h_cell / rho[C]) + prm.one_m_rC * sc[C]
    raw = torch.clamp(raw, prm.minSc, prm.maxSc)
    raw = torch.clamp(raw, min=prm.cqSc).contiguous()
    s1, chg = ring(prm, raw)
    return co_rate, tau_rate, raw, s1, chg


# ---------------------------------------------------------------------------
# the initial frames and the run
# ---------------------------------------------------------------------------


def frames_of(prm, p, T, U):
    """Ghost-padded frames of primitive cell fields after the conservative
    round trip the solver state makes (rho, rhoU, rhoE and back): p, T, ux
    and uy, their ghosts by the BCs (a qgdFlux side starts with a zero
    gradient)."""
    rho = p * (1.0 / (prm.R * T))
    e = prm.Cv * T
    rhoU = rho[None] * U
    rhoE = rho * e + 0.5 * rho * torch.sum(U * U, dim=0)
    U = rhoU / rho[None]
    e = rhoE / rho - 0.5 * torch.sum(U * U, dim=0)
    T = e / prm.Cv
    p = rho * prm.R * T
    out = []
    for x in (p, T, U[0], U[1]):
        f = torch.zeros(tuple(n + 2 for n in x.shape), dtype=x.dtype,
                        device=x.device)
        f[C] = x
        out.append(f)
    zero = torch.zeros((2, prm.ny), dtype=p.dtype, device=p.device)
    return ghosts(prm, out, zero)


def plane_fields(fields) -> tuple:
    """p, T and U (2, nx, ny) of the generator's one-cell-deep fields (p, T
    (nx, ny, 1), U (3, nx, ny, 1)): the third axis and uz dropped."""
    return (fields["p"][..., 0], fields["T"][..., 0],
            fields["U"][:2, ..., 0])


def run(cfg, fields, steps, dtype=None) -> dict:
    """`steps` steps from the generator's one-cell-deep fields `fields` (p,
    T, U and, for varScModel5, sc), in `dtype` (the configuration's by
    default).  Returns the frames p, T, ux, uy, t and dt after the last
    step, and for varScModel5 `sc`, the sensor frame that step used, and
    `s1`, the first fvc::smooth ring of the raw sensor of the last frames
    ((nx, ny) cells); and `rings`, the rings of each step's smoothing."""
    dtype = dtype or getattr(torch, cfg["dtype"])
    dev = fields["p"].device
    prm = params(cfg, dev, dtype)
    p, T, U = (x.to(dtype) for x in plane_fields(fields))
    frames = frames_of(prm, p, T, U)
    del p, T, U
    tc = cfg["time"]
    dt = torch.full((), _f32(tc["dt0"]), dtype=dtype, device=dev)
    t = torch.zeros((), dtype=dtype, device=dev)
    sc = None
    if prm.varsc:
        sc = edge_frame(fields["sc"][..., 0].to(dtype))
    co_rate, tau_rate, raw, s1, _ = emit(prm, *frames, sc)
    rings = []
    for _ in range(steps):
        dt = set_delta_t(tc, dt, co_rate * dt, tau_rate)
        if prm.varsc:
            cells, k = smooth(prm, s1)
            sc = edge_frame(cells)
            rings.append(k)
            del cells
        new, side = update(prm, *frames, sc, dt)
        frames = ghosts(prm, new, side)
        del new
        t = t + dt
        co_rate, tau_rate, raw, s1, _ = emit(prm, *frames, sc)
    out = dict(zip(FIELDS, frames), t=t, dt=dt, rings=rings)
    if prm.varsc:
        out.update(sc=sc, s1=s1)
    return out
