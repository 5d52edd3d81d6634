"""The port's interQHDFoam (two-phase VoF with surface tension) and its
two-phase machinery against the JAX package, and its oracles on the port.
Mirrors tests/test_inter_qhd.py (the circle's curvature, reconstruct, the
static drop, the falling drop, the mQhdFlux hydrostatic column),
tests/test_solver_variants.py's alpha smoothing flags,
tests/test_axisymmetric.py's wedge cases (the annulus' Laplace pressure,
the wedge case directory, the axis-centred drop) and
tests/test_foam_case_e2e.py's interQHDFoam case directories (ingestion,
the non-water alpha write and resume, mQhdFlux walls).

Both packages build each config from one description (the JAX solver,
carried across by `interop.solver_from`) and start from one float64 State;
the JAX package runs n steps, the port n one-step windows from its States
(`_torch_parity.run_both`), each held within 2*cg_tol of each field's max
with equal CG iteration counts.  `physics.twophase` is held to the JAX
package's to round-off.  On a wedge the cell volumes vary with r, and the
port's pressure CG runs on the symmetric V*A (`ops.linsolve`), where the
JAX package's stalls at cg_maxiter: there the JAX package's solves are
made exact (`_torch_parity.exact_jax_solves`) and the counts are not
compared, and the port's runs are held to their own oracles as well
(each solve's unweighted residual within 10*cg_tol before cg_maxiter,
`ops.linsolve.true_residuals`; the Laplace jumps; the film's r-weighted
volume balance).
"""
import dataclasses
import math
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.core.mesh import AxisymmetricMesh as JAxiMesh
from qgdsolver_tpu.core.mesh import Mesh as JMesh
from qgdsolver_tpu.io import foam_case as jfoam_case
from qgdsolver_tpu.physics import twophase as jtwophase
from qgdsolver_tpu.solvers import common as jcommon
from qgdsolver_tpu.solvers.inter_qhd import InterQHDFoam as JInterQHDFoam
from qgdsolver_tpu_torch import cli, interop
from qgdsolver_tpu_torch.core import bc
from qgdsolver_tpu_torch.core.mesh import AxisymmetricMesh, Mesh
from qgdsolver_tpu_torch.io import foam_case, foam_write
from qgdsolver_tpu_torch.ops import linsolve
from qgdsolver_tpu_torch.physics import twophase
from qgdsolver_tpu_torch.solvers import common
from qgdsolver_tpu_torch.solvers.inter_qhd import InterQHDFoam

from _torch_parity import (F64, ROUND_OFF, _rel, assert_solves_converged,
                           exact_jax_solves, run_both)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
X64 = np.float64
PROPS = dict(rho1=1000.0, rho2=1.0, nu1=1e-6, nu2=1.5e-5, tau1=2e-4,
             tau2=2e-4, c_alpha=1.0)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _jdrop(n=16, sigma=0.0, g=(0.0, 0.0), **over):
    """tests/test_inter_qhd.py's drop case (JAX solver, State)."""
    mesh = JMesh.uniform((n, n), dtype=X64)
    js = JInterQHDFoam(
        mesh=mesh, props=jtwophase.TwoPhaseProperties(sigma=sigma, **PROPS),
        g=g, time=jcommon.TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-4),
        cg_tol=1e-9, **over)
    x = np.asarray(mesh.cell_coords(0)) * np.ones(mesh.shape)
    y = np.asarray(mesh.cell_coords(1)) * np.ones(mesh.shape)
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
    return js, js.init(jnp.zeros((2,) + mesh.shape),
                       jnp.asarray((r < 0.2).astype(X64)))


def _port(js):
    return interop.solver_from(js, dtype=F64)


def _tstate(jst):
    return interop.state_from_numpy(
        type(jst)(*(np.asarray(x) for x in jst)), dtype=F64)


# ---------------------------------------------------------------------------
# physics.twophase against the JAX package
# ---------------------------------------------------------------------------


def _circle(mesh_cls, faces):
    mesh = mesh_cls(x_faces=faces, dtype=X64 if mesh_cls in (
        JMesh, JAxiMesh) else F64)
    x = np.asarray(mesh.centers[0])[:, None] * np.ones(mesh.shape)
    y = np.asarray(mesh.centers[1])[None, :] * np.ones(mesh.shape)
    r = np.sqrt((x - 0.5) ** 2 + y ** 2 if mesh.axisymmetric
                else (x - 0.5) ** 2 + (y - 0.5) ** 2)
    return mesh, 0.5 * (1.0 - np.tanh((r - 0.25) / 0.03))


@pytest.mark.parametrize("kind", ["uniform", "graded", "wedge"])
def test_twophase_matches_jax(kind):
    """The mixture closures, deltaN, nHatf (with a static and a dynamic
    contact angle on two walls), the curvature, the surface-tension force
    and reconstruct of the port against the JAX package's on a circular
    interface, to round-off: a uniform, a graded and a wedge mesh."""
    if kind == "graded":
        faces = (np.concatenate([[0.0], np.cumsum(np.geomspace(1, 3, 20))]),
                 np.linspace(0.0, 1.0, 17))
        faces = (faces[0] / faces[0][-1], faces[1])
    else:
        faces = (np.linspace(0.0, 1.0, 21), np.linspace(0.0, 1.0, 17))
    jcls, tcls = ((JAxiMesh, AxisymmetricMesh) if kind == "wedge"
                  else (JMesh, Mesh))
    jmesh, a = _circle(jcls, faces)
    tmesh, _ = _circle(tcls, faces)
    jprops = jtwophase.TwoPhaseProperties(sigma=0.07, **PROPS)
    tprops = twophase.TwoPhaseProperties(sigma=0.07, **PROPS)
    ta = torch.as_tensor(a)
    for f in ("rho", "mu", "tau"):
        assert _rel(getattr(jprops, f)(a), getattr(tprops, f)(ta)) <= 1e-15
    assert twophase.delta_n(tmesh) == pytest.approx(
        jtwophase.delta_n(jmesh), rel=1e-15)
    angles = {(1, 0): (math.radians(60.0),),
              (0, 1): (1.0, 0.1, 1.2, 0.8)}
    jbca = jbc.FieldBCs.uniform(jbc.ZeroGradient(), 2)
    tbca = bc.FieldBCs.uniform(bc.ZeroGradient(), 2)
    ji = jtwophase.interface_properties(
        jnp.asarray(a), jbca, jmesh, 0.07,
        contact_angles={k: jtwophase.ContactAngle(*v)
                        for k, v in angles.items()}, u_wall=0.05)
    ti = twophase.interface_properties(
        ta, tbca, tmesh, 0.07,
        contact_angles={k: twophase.ContactAngle(*v)
                        for k, v in angles.items()}, u_wall=0.05)
    for name in ("n_hat_f", "stf"):
        for x, y in zip(getattr(ji, name), getattr(ti, name)):
            assert _rel(x, y) <= ROUND_OFF, name
    assert _rel(ji.K, ti.K) <= ROUND_OFF
    assert _rel(jtwophase.reconstruct(ji.stf, jmesh),
                twophase.reconstruct(ti.stf, tmesh)) <= ROUND_OFF


def test_interface_properties_circle():
    """The curvature of a circular interface is ~1/R in its band."""
    mesh = Mesh.uniform((64, 64), dtype=F64)
    x = mesh.centers[0][:, None] * np.ones(mesh.shape)
    y = mesh.centers[1][None, :] * np.ones(mesh.shape)
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
    alpha = torch.as_tensor(0.5 * (1.0 - np.tanh((r - 0.25) / 0.02)))
    iface = twophase.interface_properties(
        alpha, bc.FieldBCs.uniform(bc.ZeroGradient(), 2), mesh, sigma=0.07)
    K_band = np.abs(iface.K.numpy()[np.abs(r - 0.25) < 0.03])
    assert abs(np.median(K_band) - 4.0) < 1.0


def test_reconstruct_linear():
    mesh = Mesh.uniform((16, 12), dtype=F64)
    flux = tuple((3.0 if a == 0 else -2.0)
                 * torch.ones(mesh.face_shape(a), dtype=F64)
                 * mesh.face_area(a) for a in range(2))
    v = twophase.reconstruct(flux, mesh).numpy()
    np.testing.assert_allclose(v[0], 3.0, rtol=1e-12)
    np.testing.assert_allclose(v[1], -2.0, rtol=1e-12)


# ---------------------------------------------------------------------------
# the step against the JAX package
# ---------------------------------------------------------------------------


def _wedge_annulus(nx=8, nr=40):
    """tests/test_axisymmetric.py's liquid annulus on an (x, r) wedge."""
    mesh = JAxiMesh(x_faces=(np.linspace(0.0, 0.2, nx + 1),
                             np.linspace(0.2, 1.0, nr + 1)), dtype=X64)
    props = jtwophase.TwoPhaseProperties(rho1=1000.0, rho2=1.0, nu1=1e-5,
                                         nu2=1e-5, tau1=1e-5, tau2=1e-5,
                                         sigma=0.07, c_alpha=0.0)
    zg = jbc.ZeroGradient()
    js = JInterQHDFoam(
        mesh=mesh, props=props, g=(0.0, 0.0),
        bc_U=jbc.FieldBCs(((zg, zg), (jbc.FixedValue(jnp.zeros(2)),) * 2)),
        bc_alpha=jbc.FieldBCs.uniform(zg, 2),
        bc_p=jbc.FieldBCs(((zg, zg), (zg, jbc.FixedValue(0.0)))),
        time=jcommon.TimeControls(max_co=0.1, max_dt=2e-6, dt0=1e-6),
        smooth_alpha=True, n_smooth_iters=2)
    r = np.asarray(mesh.centers[1])
    a0 = 0.5 * (1.0 - np.tanh((r[None, :] - 0.6) / (2.0 * 0.8 / nr)))
    return js, js.init(U0=jnp.zeros((2,) + mesh.shape),
                       alpha0=jnp.asarray(np.broadcast_to(a0, mesh.shape)))


def _axis_drop(nx=48, nr=24, c_alpha=1.0):
    """tests/test_axisymmetric.py's drop centred on the wedge axis."""
    mesh = JAxiMesh(x_faces=(np.linspace(0, 1, nx + 1),
                             np.linspace(0, 0.5, nr + 1)), dtype=X64)
    props = jtwophase.TwoPhaseProperties(rho1=1000.0, rho2=1.0, nu1=1e-5,
                                         nu2=1e-5, tau1=1e-5, tau2=1e-5,
                                         sigma=0.07, c_alpha=c_alpha)
    zg = jbc.ZeroGradient()
    js = JInterQHDFoam(
        mesh=mesh, props=props, g=(0.0, 0.0),
        bc_U=jbc.FieldBCs(((zg, zg), (jbc.FixedValue(jnp.zeros(2)),) * 2)),
        bc_alpha=jbc.FieldBCs.uniform(zg, 2),
        bc_p=jbc.FieldBCs(((zg, zg), (zg, jbc.FixedValue(0.0)))),
        time=jcommon.TimeControls(max_co=0.1, max_dt=2e-6, dt0=1e-6))
    x = np.asarray(mesh.centers[0])[:, None] * np.ones(mesh.shape)
    r = np.asarray(mesh.centers[1])[None, :] * np.ones(mesh.shape)
    d = np.sqrt((x - 0.5) ** 2 + r ** 2)
    a0 = 0.5 * (1.0 - np.tanh((d - 0.25) / (0.5 / nr)))
    return js, js.init(U0=jnp.zeros((2,) + mesh.shape),
                       alpha0=jnp.asarray(a0)), d


def _mqhd_column(nx=16, ny=32):
    """tests/test_inter_qhd.py's stratified column with mQhdFlux walls."""
    mesh = JMesh.uniform((nx, ny), lengths=(0.5, 1.0), dtype=X64)
    js = JInterQHDFoam(
        mesh=mesh, props=jtwophase.TwoPhaseProperties(sigma=0.0, **PROPS),
        g=(0.0, -9.81), bc_p=jbc.FieldBCs.uniform(jbc.QHDFluxP(), 2),
        time=jcommon.TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-4),
        cg_tol=1e-11)
    y = np.asarray(mesh.cell_coords(1)) * np.ones(mesh.shape)
    return js, js.init(jnp.zeros((2,) + mesh.shape),
                       jnp.asarray((y < 0.5).astype(X64))), y


def _parity_case(name):
    """(JAX solver, JAX State, steps) of a parity case."""
    if name == "drop_gravity_tension":
        return _jdrop(sigma=0.07, g=(0.0, -9.81)) + (4,)
    if name == "smoothing":
        return _jdrop(sigma=0.07, smooth_alpha=True, n_smooth_iters=2,
                      smooth_coeff=0.4) + (3,)
    if name == "explicit_diffusion":
        return _jdrop(sigma=0.07, implicit_diffusion=False) + (3,)
    if name == "contact_angles_mqhd":
        zg = jbc.ZeroGradient()
        js, jst = _jdrop(
            sigma=0.07, g=(0.0, -9.81),
            bc_p=jbc.FieldBCs(((jbc.QHDFluxP(), jbc.QHDFluxP()),
                               (jbc.QHDFluxP(), jbc.FixedValue(0.0)))),
            bc_U=jbc.FieldBCs(((jbc.FixedValue(jnp.zeros(2)),) * 2,
                               (jbc.FixedValue(jnp.zeros(2)), zg))),
            contact_angles={
                (1, 0): jtwophase.ContactAngle(math.radians(60.0)),
                (0, 1): jtwophase.ContactAngle(1.0, 0.1, 1.2, 0.8)})
        # the drop sits on the floor: its interface meets the wall
        y = np.asarray(js.mesh.cell_coords(1)) * np.ones(js.mesh.shape)
        x = np.asarray(js.mesh.cell_coords(0)) * np.ones(js.mesh.shape)
        a0 = ((x - 0.5) ** 2 + y ** 2 < 0.09).astype(X64)
        return js, jst._replace(alpha1=jnp.asarray(a0)), 3
    if name == "mqhd_column":
        return _mqhd_column()[:2] + (3,)
    if name == "wedge_annulus":
        return _wedge_annulus() + (3,)
    if name == "wedge_axis_drop":
        return _axis_drop(24, 12)[:2] + (3,)
    raise KeyError(name)


def _alpha_balance(monkeypatch):
    """[dt * the net alpha flux out through the boundary faces] of every
    MULES solve in the context: the r-weighted volume of phase 1 changes
    by minus their sum, to round-off."""
    from qgdsolver_tpu_torch.ops import mules

    out = []
    orig = mules.explicit_solve

    def recorded(T, phi, phiH, dt, mesh, *args, **kw):
        new, flux = orig(T, phi, phiH, dt, mesh, *args, **kw)
        out.append(float(dt) * sum(
            float(f.narrow(a, f.shape[a] - 1, 1).sum()
                  - f.narrow(a, 0, 1).sum()) for a, f in enumerate(flux)))
        return new, flux

    monkeypatch.setattr(mules, "explicit_solve", recorded)
    return out


WEDGE = ("wedge_annulus", "wedge_axis_drop")


@pytest.mark.parametrize("name", [
    "drop_gravity_tension", "smoothing", "explicit_diffusion",
    "contact_angles_mqhd", "mqhd_column", "wedge_annulus",
    "wedge_axis_drop"])
def test_inter_qhd_matches_jax(name, monkeypatch):
    """interQHDFoam's step against the JAX package, window by window: a
    drop with surface tension under gravity, with the alpha smoothing
    flags, with explicit diffusion, on the floor with a static and a
    dynamic contact angle and mQhdFlux walls; the mQhdFlux column.  The
    wedge annulus (smoothing on r-weighted areas) and the axis-centred
    wedge drop.  On the wedges the JAX package's pressure CG stalls at
    cg_maxiter, so its solves are made exact there
    (`_torch_parity.exact_jax_solves`, counts not compared), and a free
    run of the port is held to its oracles as well: every solve's
    unweighted residual within 10*cg_tol before cg_maxiter, phase 1
    bounded, its r-weighted volume conserved to 1e-12."""
    js, jst, n = _parity_case(name)
    if name in WEDGE:
        exact_jax_solves(monkeypatch)
        states, _, log = run_both(js, jst, n, 2 * js.cg_tol, monkeypatch,
                                  floors={"U": 1e-3, "p": 1e-3},
                                  counts=False)
        assert [k == "U" for k, _ in log] == [False, True] * n  # p, U
        solver = _port(js)
        flux = _alpha_balance(monkeypatch)
        with linsolve.true_residuals() as solves:
            s = common.run_steps(solver.make_step(), _tstate(jst), n)
        assert_solves_converged(solves, js.cg_tol)
        assert len(solves) == 2 * n  # p and U each step
        a, a0 = s.alpha1.numpy(), np.asarray(jst.alpha1)
        V = solver.mesh.cell_volume.numpy()
        assert a.min() >= -1e-10 and a.max() <= 1.0 + 1e-10
        vol0 = (a0 * V).sum()
        assert abs((a * V).sum() - vol0 + sum(flux)) <= 1e-12 * vol0
        return
    states, _, log = run_both(js, jst, n, 2 * js.cg_tol, monkeypatch,
                              floors={"U": 1e-3, "p": 1e-3})
    assert sum(k != "U" for k, _ in log) == n
    a = np.asarray(states[-1].alpha1)
    assert a.min() >= -1e-10 and a.max() <= 1.0 + 1e-10


# ---------------------------------------------------------------------------
# oracles on the port
# ---------------------------------------------------------------------------


def _run_port(js, jst, n):
    solver = _port(js)
    return solver, common.run_steps(solver.make_step(), _tstate(jst), n)


def test_static_drop_boundedness_and_mass():
    """No gravity, no surface tension: a static drop stays in [0, 1], keeps
    its volume and stays at rest."""
    js, jst = _jdrop(n=32)
    _, s = _run_port(js, jst, 20)
    a = s.alpha1
    assert bool(torch.isfinite(s.U).all())
    assert float(a.max()) <= 1.0 + 1e-12 and float(a.min()) >= -1e-12
    np.testing.assert_allclose(float(a.sum()), float(np.sum(jst.alpha1)),
                               rtol=1e-6)
    assert float(s.U.abs().max()) < 1e-6


def test_rising_dynamics_with_gravity():
    """A heavy drop under gravity starts moving down, bounded."""
    js, jst = _jdrop(n=32, g=(0.0, -9.81))
    _, s = _run_port(js, jst, 30)
    assert bool(torch.isfinite(s.U).all())
    assert float(s.alpha1.max()) <= 1.0 + 1e-12
    assert float((s.U[1] * s.alpha1).sum() / s.alpha1.sum()) < 0.0


def test_mqhdflux_hydrostatic_pressure_bc():
    """mQhdFlux walls hold a stable stratification at rest and its
    hydrostatic pressure gradient in each phase."""
    js, jst, y = _mqhd_column()
    _, s = _run_port(js, jst, 10)
    a, U, p = s.alpha1.numpy(), s.U.numpy(), s.p.numpy()
    assert np.isfinite(U).all()
    assert a.min() >= -1e-10 and a.max() <= 1.0 + 1e-10
    assert np.abs(U).max() < 1e-2
    off = np.broadcast_to(~(np.abs(y - 0.5) < 0.3), U.shape[1:])
    assert np.abs(U[:, off]).max() < 1e-10
    dpdy = (p[:, 1:] - p[:, :-1]) * 32
    ymid = 0.5 * (y[:, 1:] + y[:, :-1])
    pure2 = (a[:, 1:] < 1e-8) & (a[:, :-1] < 1e-8) & (ymid > 0.8)
    pure1 = (a[:, 1:] > 1 - 1e-8) & (a[:, :-1] > 1 - 1e-8) & (ymid < 0.2)
    assert pure1.any() and pure2.any()
    np.testing.assert_allclose(dpdy[pure2], -9.81, rtol=2e-2)
    np.testing.assert_allclose(dpdy[pure1], -9.81 * 1000.0, rtol=2e-2)


def test_inter_qhd_alpha_smoothing_flags():
    """smoothAlpha/nSmoothIters/smoothCoeff: the smoothed interface has a
    smaller max gradient and stays in [0, 1]."""
    js, jst = _jdrop(n=32)
    solver = _port(js)
    a = solver.make_step()(_tstate(jst)).alpha1.numpy()
    b = dataclasses.replace(solver, smooth_alpha=True, n_smooth_iters=2,
                            smooth_coeff=0.5).make_step()(
        _tstate(jst)).alpha1.numpy()
    assert np.abs(np.diff(b, axis=0)).max() < np.abs(np.diff(a, axis=0)).max()
    assert b.min() >= 0.0 and b.max() <= 1.0


def test_inter_qhd_wedge_cylindrical_laplace_pressure(monkeypatch):
    """A static liquid annulus on a wedge, its whole curvature the hoop
    term: the Laplace jump sigma/R develops and it stays static, every
    solve converged (unweighted residual within 10*cg_tol)."""
    js, jst = _wedge_annulus()
    with linsolve.true_residuals() as solves:
        solver, s = _run_port(js, jst, 120)
    assert_solves_converged(solves, js.cg_tol)
    p = s.p.numpy()
    r = solver.mesh.centers[1]
    assert np.isfinite(p).all()
    dp = p[:, r < 0.45].mean() - p[:, r > 0.8].mean()
    np.testing.assert_allclose(dp, 0.07 / 0.6, rtol=0.05)
    assert float(s.U.abs().max()) < 1e-9


def test_inter_qhd_axis_centered_drop_laplace(monkeypatch):
    """A spherical drop centred on the wedge axis: the spherical jump
    2*sigma/R, bounded spurious currents on the first axis rings too,
    every solve converged (unweighted residual within 10*cg_tol)."""
    js, jst, d = _axis_drop()
    with linsolve.true_residuals() as solves:
        _, s = _run_port(js, jst, 200)
    assert_solves_converged(solves, js.cg_tol)
    p, a = s.p.numpy(), s.alpha1.numpy()
    assert np.isfinite(p).all()
    assert a.min() >= -1e-10 and a.max() <= 1.0 + 1e-10
    dr = 0.5 / 24
    dp = p[d < 0.25 - 3 * dr].mean() - p[d > 0.25 + 4 * dr].mean()
    np.testing.assert_allclose(dp, 2 * 0.07 / 0.25, rtol=0.1)
    assert float(s.U.abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# case directories and the CLI
# ---------------------------------------------------------------------------


def _water_column(solver, state, height=0.4):
    y = solver.mesh.centers[1][None, :] * np.ones(solver.mesh.shape)
    return state._replace(alpha1=solver.mesh.tensor((y < height) * 1.0))


def test_build_case_inter_qhd_matches_jax(monkeypatch):
    """tests/fixtures/inter_case: the phases, per-phase tau/nu/rho, sigma,
    cAlpha, gravity and the floor's contact angle as the JAX package reads
    them; a water column runs 5 steps held to it, bounded and
    conserving."""
    solver, state = foam_case.build_case(os.path.join(FIX, "inter_case"),
                                         device="cpu")
    js, jst = jfoam_case.build_case(os.path.join(FIX, "inter_case"))
    # the JAX package reads the mesh in float32: compare in float64
    js = dataclasses.replace(js, mesh=JMesh(x_faces=js.mesh.x_faces,
                                            dtype=X64))
    assert isinstance(solver, InterQHDFoam)
    assert solver.mesh.dtype == torch.float64
    assert dataclasses.asdict(solver.props) == dataclasses.asdict(js.props)
    assert solver.g == (0.0, -9.81) and solver.alpha_field == "alpha.water"
    assert solver.contact_angles[(1, 0)].theta0 == pytest.approx(
        math.radians(60.0))
    assert interop.solver_from(js, dtype=F64).contact_angles == \
        solver.contact_angles
    state = _water_column(solver, state)
    jst = jst._replace(alpha1=jnp.asarray(_np(state.alpha1)))
    states, _, _ = run_both(js, jst, 5, 2 * js.cg_tol, monkeypatch,
                            floors={"U": 1e-3, "p": 1e-3})
    s = common.run_steps(solver.make_step(), state, 5)
    a = s.alpha1.numpy()
    assert a.min() >= -1e-8 and a.max() <= 1.0 + 1e-8
    np.testing.assert_allclose(a.sum(), float(state.alpha1.sum()),
                               rtol=5e-3)
    np.testing.assert_allclose(a, np.asarray(states[-1].alpha1),
                               rtol=0, atol=5 * 2 * js.cg_tol)


def _inter_copy(tmp_path, name="inter"):
    case = tmp_path / name
    shutil.copytree(os.path.join(FIX, "inter_case"), case)
    return case


def test_inter_qhd_nonwater_alpha_write_resume(tmp_path):
    """A phase pair (oil air) with an `alphat` decoy: the phase fraction
    writes to alpha.oil and a resume reads it back."""
    case = _inter_copy(tmp_path, "inter_oil")
    tp = (case / "constant" / "transportProperties").read_text()
    (case / "constant" / "transportProperties").write_text(
        tp.replace("water", "oil"))
    alpha = (case / "0" / "alpha.water").read_text()
    (case / "0" / "alpha.water").unlink()
    (case / "0" / "alpha.oil").write_text(
        alpha.replace("alpha.water", "alpha.oil"))
    (case / "0" / "alphat").write_text(
        "FoamFile { version 2.0; format ascii; class volScalarField; "
        "object alphat; }\ninternalField uniform 0;\n"
        "boundaryField { left { type zeroGradient; } "
        "right { type zeroGradient; } bottom { type zeroGradient; } "
        "top { type zeroGradient; } frontAndBack { type empty; } }\n")
    solver, state = foam_case.build_case(str(case), device="cpu")
    assert solver.alpha_field == "alpha.oil"
    s = common.run_steps(solver.make_step(), _water_column(solver, state), 3)
    tdir = foam_write.write_state(str(case), solver, s)
    assert os.path.exists(os.path.join(tdir, "alpha.oil"))
    assert not os.path.exists(os.path.join(tdir, "alpha.water"))
    ctrl = (case / "system" / "controlDict").read_text()
    (case / "system" / "controlDict").write_text(
        ctrl.replace("startFrom       startTime;",
                     "startFrom       latestTime;"))
    _, state2 = foam_case.build_case(str(case), device="cpu")
    np.testing.assert_allclose(state2.alpha1.numpy(), s.alpha1.numpy(),
                               rtol=1e-5, atol=1e-7)


def test_build_case_inter_mqhdflux(tmp_path):
    """mQhdFlux p walls on the case: the word builds the QHDFluxP marker,
    and a dam break runs bounded, conserving, spreading to the right."""
    case = _inter_copy(tmp_path)
    (case / "0" / "p").write_text(
        "FoamFile { version 2.0; format ascii; class volScalarField;"
        " object p; }\ndimensions [1 -1 -2 0 0 0 0];\n"
        "internalField uniform 0;\nboundaryField\n{\n"
        "    left   { type mQhdFlux; value uniform 0; }\n"
        "    right  { type mQhdFlux; value uniform 0; }\n"
        "    bottom { type mQhdFlux; value uniform 0; }\n"
        "    top    { type fixedValue; value uniform 0; }\n"
        "    frontAndBack { type empty; }\n}\n")
    solver, state = foam_case.build_case(str(case), device="cpu")
    assert isinstance(solver.bc_p[0, 0], bc.QHDFluxP)
    assert isinstance(solver.bc_p[1, 0], bc.QHDFluxP)
    x = solver.mesh.centers[0][:, None] * np.ones(solver.mesh.shape)
    y = solver.mesh.centers[1][None, :] * np.ones(solver.mesh.shape)
    a0 = ((x < 0.3) & (y < 0.6)) * 1.0
    s = common.run_steps(solver.make_step(), state._replace(
        alpha1=solver.mesh.tensor(a0)), 8)
    a = s.alpha1.numpy()
    assert np.isfinite(s.U.numpy()).all() and np.isfinite(s.p.numpy()).all()
    assert a.min() >= -1e-8 and a.max() <= 1.0 + 1e-8
    np.testing.assert_allclose(a.sum(), a0.sum(), rtol=5e-3)
    assert (a * x).sum() / a.sum() > (a0 * x).sum() / a0.sum()


def test_wedge_inter_qhd_case_ingests_and_runs(tmp_path, monkeypatch):
    """A wedge two-phase case builds through ingestion as the JAX package
    builds it (BC types, phase properties); 10 windows of an annular film
    held to the JAX package with its solves made exact
    (`_torch_parity.exact_jax_solves`); and the film runs 30
    free float64 steps on the port: finite, bounded, every solve
    converged (unweighted residual within 10*cg_tol before cg_maxiter),
    and the film's r-weighted volume changed by what its boundary faces
    carried, to 1e-8 of it (the inlet feeds the film).  The JAX package's
    pressure CG stalls at cg_maxiter on this case, and the port's free
    run turned nonfinite at step 9 while it copied that CG."""
    case = tmp_path / "wedge2p"
    shutil.copytree(os.path.join(FIX, "wedge_case"), case)
    (case / "system" / "controlDict").write_text(
        (case / "system" / "controlDict").read_text().replace(
            "application     QGDFoam;", "application     interQHDFoam;"))
    (case / "constant" / "transportProperties").write_text(
        "FoamFile { version 2.0; format ascii; class dictionary; "
        "object transportProperties; }\nphases (water air);\n"
        "water { nu 1e-06; rho 1000; }\nair   { nu 1.48e-05; rho 1; }\n"
        "tauwater 1e-5;\ntauair 1e-5;\nsigma 0.07;\n")
    (case / "0" / "T").unlink()
    (case / "0" / "p").write_text((case / "0" / "p").read_text().replace(
        "uniform 101325", "uniform 0"))
    (case / "0" / "alpha.water").write_text(
        "FoamFile { version 2.0; format ascii; class volScalarField; "
        "object alpha.water; }\ninternalField uniform 0;\n"
        "boundaryField { inlet { type zeroGradient; } "
        "outlet { type zeroGradient; } axis { type empty; } "
        "outer { type zeroGradient; } front { type wedge; } "
        "back { type wedge; } }\n")
    (case / "0" / "U").write_text(
        "FoamFile { version 2.0; format ascii; class volVectorField; "
        "object U; }\ninternalField uniform (0 0 0);\n"
        "boundaryField { inlet { type fixedValue; "
        "value uniform (0.05 0 0); } outlet { type zeroGradient; } "
        "axis { type empty; } outer { type noSlip; } "
        "front { type wedge; } back { type wedge; } }\n")
    solver, state = foam_case.build_case(str(case), device="cpu")
    assert isinstance(solver, InterQHDFoam) and solver.mesh.axisymmetric
    js, jst = jfoam_case.build_case(str(case))
    js = dataclasses.replace(js, mesh=JAxiMesh(x_faces=js.mesh.x_faces,
                                               dtype=X64))
    port = interop.solver_from(js, dtype=F64)
    for f in ("bc_U", "bc_p", "bc_alpha"):
        assert [[type(b) for b in row] for row in getattr(port, f).bcs] == \
            [[type(b) for b in row] for row in getattr(solver, f).bcs], f
    assert dataclasses.asdict(solver.props) == dataclasses.asdict(js.props)
    r = solver.mesh.centers[1]
    dr = float(solver.mesh.dx[1][0])
    a0 = np.broadcast_to(0.5 * (1.0 + np.tanh((r[None, :] - 0.35)
                                              / (2.0 * dr))),
                         solver.mesh.shape)
    with monkeypatch.context() as mp:
        exact_jax_solves(mp)
        run_both(js, jst._replace(alpha1=jnp.asarray(a0)), 10,
                 2 * js.cg_tol, mp, floors={"U": 1e-3, "p": 1e-3},
                 counts=False)
    flux = _alpha_balance(monkeypatch)
    with linsolve.true_residuals() as solves:
        s = common.run_steps(solver.make_step(), state._replace(
            alpha1=solver.mesh.tensor(a0)), 30)
    assert_solves_converged(solves, solver.cg_tol)
    assert len(flux) == 30
    a = s.alpha1.numpy()
    assert np.isfinite(s.p.numpy()).all() and np.isfinite(s.U.numpy()).all()
    assert a.min() >= -1e-8 and a.max() <= 1.0 + 1e-8
    V = solver.mesh.cell_volume.numpy()
    vol0 = (a0 * V).sum()
    assert abs((a * V).sum() - vol0 + sum(flux)) <= 1e-8 * vol0


def test_cli_runs_writes_and_resumes_inter_case(tmp_path):
    """The CLI runs the interQHDFoam case, writes U, p and alpha.water,
    and resumes from the written time to the same fields as an unbroken
    run."""
    case = _inter_copy(tmp_path)
    logs = []
    assert cli.run_case(str(case), max_steps=4, device="cpu",
                        log=logs.append) == 4
    assert any("composable step engaged: make_step" in ln for ln in logs)
    tdir = [ln for ln in logs if ln.startswith("End.")][0].split()[-1]
    assert sorted(os.listdir(tdir)) == ["U", "alpha.water", "p"]
    solver, s4 = foam_case.build_case(str(case), device="cpu")
    s4 = common.run_steps(solver.make_step(), s4, 4)
    ctrl = (case / "system" / "controlDict").read_text()
    (case / "system" / "controlDict").write_text(ctrl.replace(
        "startFrom       startTime;", "startFrom       latestTime;"))
    _, back = foam_case.build_case(str(case), device="cpu")
    np.testing.assert_allclose(float(back.t), float(s4.t), rtol=1e-6)
    for f in ("U", "p", "alpha1"):
        x, y = getattr(s4, f).numpy(), getattr(back, f).numpy()
        assert np.abs(x - y).max() <= 1e-6 * max(np.abs(x).max(), 1e-12), f
