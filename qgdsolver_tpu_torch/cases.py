"""Canonical case configurations (PyTorch port of `qgdsolver_tpu.cases`:
the 2D supersonic jets (uniform and graded), the wedge blob, the QHDFoam
buoyant cavity, the scalar-transport box, the 3D duct and the 3D varsc
jet).  Each builder
returns (solver, initial_state), with every tensor in `dtype` on `device`:
the card by default (a RuntimeError where there is none; pass device="cpu"
to run on the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import bc as bcm
from .core.mesh import AxisymmetricMesh, Mesh, checked_device
from .physics.qgdcoeffs import (ConstScPrModel1, H2bynuQHD, HbyUQHD,
                                VarScModel5)
from .physics.thermo import PerfectGasThermo, RhoConstThermo
from .solvers import common
from .solvers.qgd import QGDFoam
from .solvers.qhd import QHDFoam
from .solvers.scalar_transport import ScalarTransportQHD


def _np_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def supersonic_jet(shape=(512, 256), dtype=torch.float32, mach=2.0,
                   implicit_diffusion=False, fvsc_scheme="full",
                   x_faces=None, device="cuda"):
    """QGDFoam supersonic jet: a Mach-`mach` air jet entering a quiescent
    (4.0, 2.0) box through a slot in the left boundary.

    x_faces: optional explicit face coordinates (graded-mesh variants).
    """
    device = checked_device(device)
    if x_faces is not None:
        mesh = Mesh(x_faces=tuple(x_faces), dtype=dtype, device=device)
    else:
        mesh = Mesh.uniform(shape, lengths=(4.0, 2.0), dtype=dtype,
                            device=device)
    th = PerfectGasThermo(R=287.0, Cp=1004.5)
    p_inf, T_inf = 1.0e5, 300.0
    u_jet = mach * float(th.c(torch.tensor(T_inf, dtype=torch.float64)))

    # tanh-smoothed slot profile (|y-1| < 0.15, edges over ~3 cells): a step
    # profile seeds an odd-even decoupling at the inlet shear
    y = np.asarray(mesh.centers[1])
    delta = 3.0 * float(mesh.dx[1][0])

    def _profile(yy, xp):
        return 0.5 * (xp.tanh((0.15 - xp.abs(yy - 1.0)) / delta) + 1.0)

    jet_mask = _profile(y, np).astype(_np_dtype(dtype))

    def inlet_u(t, coords):
        yy = coords[1]
        ux = u_jet * _profile(yy, torch) * torch.ones_like(yy)
        return torch.stack(torch.broadcast_tensors(ux, torch.zeros_like(ux)),
                           dim=0)

    bc_U = bcm.FieldBCs((
        (bcm.FixedValue(inlet_u), bcm.ZeroGradient()),
        (bcm.ZeroGradient(), bcm.ZeroGradient()),
    ))
    bc_p = bcm.FieldBCs((
        (bcm.ZeroGradient(), bcm.FixedValue(p_inf)),
        (bcm.FixedValue(p_inf), bcm.FixedValue(p_inf)),
    ))
    bc_T = bcm.FieldBCs((
        (bcm.FixedValue(T_inf), bcm.ZeroGradient()),
        (bcm.ZeroGradient(), bcm.ZeroGradient()),
    ))
    solver = QGDFoam(
        mesh=mesh, thermo=th,
        tau_model=ConstScPrModel1(alpha=0.5, Sc=1.0, Pr=1.0),
        bc_U=bc_U, bc_p=bc_p, bc_T=bc_T,
        # explicit QGD stability: the tau-diffusion terms bind before the
        # acoustic CFL at jet Mach 2 (the reference tutorials run maxCo 0.2)
        time=common.TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-7),
        implicit_diffusion=implicit_diffusion, fvsc_scheme=fvsc_scheme,
    )
    p0 = torch.full(mesh.shape, p_inf, dtype=dtype, device=mesh.device)
    T0 = torch.full(mesh.shape, T_inf, dtype=dtype, device=mesh.device)
    ux0 = mesh.tensor(u_jet * jet_mask[None, :]
                      * np.exp(-np.asarray(mesh.centers[0]))[:, None])
    U0 = torch.stack([ux0, torch.zeros_like(ux0)])
    return solver, solver.init(p0=p0, T0=T0, U0=U0)


def _geom_faces(n, L, ratio, origin=0.0):
    """simpleGrading-style geometric face coordinates (total expansion
    `ratio` across the block)."""
    r = ratio ** (1.0 / max(n - 1, 1))
    w = r ** np.arange(n)
    w = w / w.sum() * L
    return origin + np.concatenate([[0.0], np.cumsum(w)])


def supersonic_jet_graded(shape=(512, 256), dtype=torch.float32, mach=2.0,
                          device="cuda"):
    """The supersonic jet on a graded mesh: x expands 3:1 away from the
    inlet, y contracts toward the centreline and expands again."""
    nx, ny = shape
    yh = _geom_faces(ny // 2, 1.0, 2.5, origin=1.0)
    yl = 2.0 - yh[::-1]
    yf = np.concatenate([yl[:-1], yh])
    return supersonic_jet(shape=shape, dtype=dtype, mach=mach,
                          x_faces=(_geom_faces(nx, 4.0, 3.0), yf),
                          device=device)


def wedge_blob(shape=(128, 64), dtype=torch.float64, device="cuda"):
    """QGDFoam on an axisymmetric wedge duct (x in [0, 2], r in [0, 0.5])
    with an off-axis pressure blob at rest: the r-weighted metrics and the
    hoop sources."""
    nx, nr = shape
    mesh = AxisymmetricMesh(
        x_faces=(np.linspace(0.0, 2.0, nx + 1), np.linspace(0.0, 0.5, nr + 1)),
        dtype=dtype, device=checked_device(device))
    th = PerfectGasThermo(R=287.0, Cp=1004.5)
    solver = QGDFoam(
        mesh=mesh, thermo=th,
        tau_model=ConstScPrModel1(alpha=0.5, Sc=1.0, Pr=1.0),
        bc_U=bcm.FieldBCs(((bcm.ZeroGradient(), bcm.ZeroGradient()),
                           (bcm.Symmetry(), bcm.FixedValue([0.0, 0.0])))),
        bc_p=bcm.FieldBCs.uniform(bcm.ZeroGradient(), 2),
        bc_T=bcm.FieldBCs.uniform(bcm.ZeroGradient(), 2),
        time=common.TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-7),
    )
    x = np.asarray(mesh.centers[0])[:, None] * np.ones(mesh.shape)
    r = np.asarray(mesh.centers[1])[None, :] * np.ones(mesh.shape)
    p0 = 1e5 * (1.0 + 0.2 * np.exp(-((x - 0.6) ** 2 + (r - 0.12) ** 2)
                                   / 0.02))
    return solver, solver.init(
        p0=mesh.tensor(p0),
        T0=torch.full(mesh.shape, 300.0, dtype=dtype, device=mesh.device),
        U0=torch.zeros((2,) + mesh.shape, dtype=dtype, device=mesh.device))


def buoyant_cavity(shape=(128, 128), dtype=torch.float64, beta=-3e-3,
                   device="cuda"):
    """QHDFoam differentially heated cavity (BASELINE.json config 2): hot
    x-low and cold x-high walls (T = +-1), adiabatic y walls, no slip,
    gravity along -y, at rest."""
    mesh = Mesh.uniform(shape, lengths=(1.0, 1.0), dtype=dtype,
                        device=checked_device(device))
    thermo = RhoConstThermo(rho0=1.0, Cp=1000.0, mu0=1e-2, Pr=0.71, beta=beta)
    solver = QHDFoam(
        mesh=mesh, thermo=thermo, tau_model=H2bynuQHD(alpha=0.3),
        g=(0.0, -9.81),
        bc_U=bcm.FieldBCs.uniform(bcm.FixedValue([0.0, 0.0]), 2),
        bc_T=bcm.FieldBCs(((bcm.FixedValue(1.0), bcm.FixedValue(-1.0)),
                           (bcm.ZeroGradient(), bcm.ZeroGradient()))),
        bc_p=bcm.FieldBCs.uniform(bcm.ZeroGradient(), 2),
        time=common.TimeControls(max_co=0.3, max_dt=0.05, dt0=1e-3),
    )
    return solver, solver.init(
        torch.zeros((2,) + mesh.shape, dtype=dtype, device=mesh.device),
        torch.zeros(mesh.shape, dtype=dtype, device=mesh.device))


def scalar_box(shape=(64, 64), dtype=torch.float64, device="cuda"):
    """scalarTransportQHDFoam on a periodic unit box (BASELINE.json config
    1): a Gaussian blob of T carried along x at unit speed."""
    mesh = Mesh.uniform(shape, lengths=(1.0, 1.0), dtype=dtype,
                        device=checked_device(device))
    thermo = RhoConstThermo(rho0=1.0, Cp=1000.0, mu0=1e-3, Pr=1.0)
    per = bcm.FieldBCs.uniform(bcm.Periodic(), 2)
    solver = ScalarTransportQHD(
        mesh=mesh, thermo=thermo, tau_model=HbyUQHD(alpha=0.2, U0=1.0),
        bc_T=per, bc_U=per,
        time=common.TimeControls(max_co=0.4, max_dt=0.01, dt0=1e-4),
    )
    x = np.asarray(mesh.centers[0])[:, None] * np.ones(mesh.shape)
    y = np.asarray(mesh.centers[1])[None, :] * np.ones(mesh.shape)
    T0 = mesh.tensor(np.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.01))
    U0 = torch.stack([torch.ones(mesh.shape, dtype=dtype, device=mesh.device),
                      torch.zeros(mesh.shape, dtype=dtype,
                                  device=mesh.device)])
    return solver, solver.init(T0, U0)


def supersonic_jet_varsc(shape=(512, 256), dtype=torch.float32, mach=2.0,
                         device="cuda"):
    """The shock-capturing flagship: the supersonic jet with the varScModel5
    density-gradient sensor and the qgdFlux outflow pressure BC."""
    solver, state = supersonic_jet(shape=shape, dtype=dtype, mach=mach,
                                   device=device)
    bc_p = bcm.FieldBCs((
        (bcm.ZeroGradient(), bcm.QGDFluxP()),
        (bcm.FixedValue(1.0e5), bcm.FixedValue(1.0e5)),
    ))
    solver = dataclasses.replace(
        solver,
        tau_model=VarScModel5(alpha=0.5, Pr=1.0, rC=0.5,
                              minSc=0.05, maxSc=1.0, smoothCoeff=0.1),
        bc_p=bc_p,
    )
    full = dict(dtype=dtype, device=solver.mesh.device)
    state = solver.init(
        p0=torch.full(solver.mesh.shape, 1.0e5, **full),
        T0=torch.full(solver.mesh.shape, 300.0, **full),
        U0=state.rhoU / state.rho[None],
        sc0=torch.full(solver.mesh.shape, 0.05, **full),
    )
    return solver, state


def supersonic_duct_3d(shape=(256, 126, 126), dtype=torch.float32, mach=2.0,
                       device="cuda"):
    """3D QGDFoam duct: a Mach-`mach` flow through a (4.0, 2.0, 2.0) box
    with a hot low-density spherical disturbance advecting through it.  All
    BCs are scalar-valued (uniform inflow, zero-gradient outflow and walls,
    fixed far-field pressure on the y/z sides)."""
    mesh = Mesh.uniform(shape, lengths=(4.0, 2.0, 2.0), dtype=dtype,
                        device=checked_device(device))
    th = PerfectGasThermo(R=287.0, Cp=1004.5)
    p_inf, T_inf = 1.0e5, 300.0
    u_in = mach * float(th.c(torch.tensor(T_inf, dtype=torch.float64)))
    zg = bcm.ZeroGradient()
    bc_U = bcm.FieldBCs((
        (bcm.FixedValue(mesh.tensor([u_in, 0.0, 0.0])), zg),
        (zg, zg), (zg, zg)))
    bc_p = bcm.FieldBCs(((zg, bcm.FixedValue(p_inf)),
                         (bcm.FixedValue(p_inf), bcm.FixedValue(p_inf)),
                         (bcm.FixedValue(p_inf), bcm.FixedValue(p_inf))))
    bc_T = bcm.FieldBCs(((bcm.FixedValue(T_inf), zg),
                         (zg, zg), (zg, zg)))
    solver = QGDFoam(
        mesh=mesh, thermo=th,
        tau_model=ConstScPrModel1(alpha=0.5, Sc=1.0, Pr=1.0),
        bc_U=bc_U, bc_p=bc_p, bc_T=bc_T,
        time=common.TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-7),
    )
    xc = [np.asarray(c) for c in mesh.centers]
    r2 = ((xc[0][:, None, None] - 1.0) ** 2
          + (xc[1][None, :, None] - 1.0) ** 2
          + (xc[2][None, None, :] - 1.0) ** 2)
    hot = 1.0 + 0.2 * np.exp(-r2 / 0.08)
    p0 = torch.full(mesh.shape, p_inf, dtype=dtype, device=mesh.device)
    T0 = mesh.tensor(T_inf * hot)
    U0 = torch.stack([torch.full_like(p0, u_in), torch.zeros_like(p0),
                      torch.zeros_like(p0)])
    return solver, solver.init(p0=p0, T0=T0, U0=U0)


def supersonic_jet_3d_varsc(shape=(256, 126, 126), dtype=torch.float32,
                            mach=2.0, device="cuda"):
    """The 3D shock-capturing jet: a round Mach-`mach` jet entering a
    quiescent (4.0, 2.0, 2.0) box through a tanh-profiled slot in the x-low
    plane (an array-valued (3, 1, ny, nz) inlet velocity), the varScModel5
    sensor, and the qgdFlux pressure BC on the outflow."""
    mesh = Mesh.uniform(shape, lengths=(4.0, 2.0, 2.0), dtype=dtype,
                        device=checked_device(device))
    th = PerfectGasThermo(R=287.0, Cp=1004.5)
    p_inf, T_inf = 1.0e5, 300.0
    u_jet = mach * float(th.c(torch.tensor(T_inf, dtype=torch.float64)))
    yc = np.asarray(mesh.centers[1])
    zc = np.asarray(mesh.centers[2])
    rr = np.sqrt((yc[:, None] - 1.0) ** 2 + (zc[None, :] - 1.0) ** 2)
    delta = 3.0 * float(mesh.dx[1][0])
    prof = 0.5 * (np.tanh((0.3 - rr) / delta) + 1.0)  # (ny, nz) slot
    zg = bcm.ZeroGradient()
    # value array (3, 1, ny, nz): the normal-axis dim kept as 1
    inlet = np.stack([u_jet * prof, np.zeros_like(prof),
                      np.zeros_like(prof)])[:, None]
    bc_U = bcm.FieldBCs((
        (bcm.FixedValue(mesh.tensor(inlet)), zg),
        (zg, zg), (zg, zg)))
    bc_p = bcm.FieldBCs(((zg, bcm.QGDFluxP()),
                         (bcm.FixedValue(p_inf), bcm.FixedValue(p_inf)),
                         (bcm.FixedValue(p_inf), bcm.FixedValue(p_inf))))
    bc_T = bcm.FieldBCs(((bcm.FixedValue(T_inf), zg),
                         (zg, zg), (zg, zg)))
    solver = QGDFoam(
        mesh=mesh, thermo=th,
        tau_model=VarScModel5(alpha=0.5, Pr=1.0, rC=0.5, minSc=0.05,
                              maxSc=1.0, smoothCoeff=0.1),
        bc_U=bc_U, bc_p=bc_p, bc_T=bc_T,
        time=common.TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-7),
    )
    p0 = torch.full(mesh.shape, p_inf, dtype=dtype, device=mesh.device)
    T0 = torch.full_like(p0, T_inf)
    decay = np.exp(-np.asarray(mesh.centers[0]))[:, None, None]
    U0 = torch.stack([mesh.tensor(u_jet * prof[None] * decay),
                      torch.zeros_like(p0), torch.zeros_like(p0)])
    return solver, solver.init(p0=p0, T0=T0, U0=U0,
                               sc0=torch.full_like(p0, 0.05))
