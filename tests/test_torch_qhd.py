"""The port's QHD family (QHDFoam, SRFQHDFoam, mulesQHDFoam) and its tau
models against the JAX package, and its oracles on the port: the buoyant
cavity and its divergence-free projection, the SRF Coriolis deflection,
MULES boundedness and the limiter's high-order limit, the qhdFlux p BC, a
wedge and a masked cavity.  Mirrors tests/test_qhd.py,
tests/test_solver_variants.py and tests/test_qhd_solid.py; the oracles of
tests/test_validation.py and the body-fitted comparison are in
tests/test_torch_qhd_oracles.py.

Both packages build each config from one description (the JAX solver,
carried across by `interop.solver_from`) and start from one State, in
float64.  The JAX package runs n steps; the port runs n one-step windows
from its States (`_torch_parity.run_both`): every QHD step solves p, and U
and T when the diffusion is implicit, so each window's fields are held
within 2*cg_tol of their max (n windows: 2*n*cg_tol), with equal CG
iteration counts for every solve (`_torch_parity.same_iterations`); without a CG the bound is 1e-9 (the
same formulas in the same order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgdsolver_tpu import cases as jcases
from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.core.mesh import AxisymmetricMesh as JAxiMesh
from qgdsolver_tpu.core.mesh import Mesh as JMesh
from qgdsolver_tpu.ops import mules as jmules
from qgdsolver_tpu.physics import qgdcoeffs as jcoeffs
from qgdsolver_tpu.physics.thermo import RhoConstThermo as JRhoConst
from qgdsolver_tpu.solvers import common as jcommon
from qgdsolver_tpu.solvers.mules_qhd import MulesQHDFoam as JMulesQHDFoam
from qgdsolver_tpu.solvers.qhd import QHDFoam as JQHDFoam
from qgdsolver_tpu_torch import interop
from qgdsolver_tpu_torch.core import bc
from qgdsolver_tpu_torch.core.mesh import Mesh
from qgdsolver_tpu_torch.ops import fvsc, linsolve, mules
from qgdsolver_tpu_torch.physics import qgdcoeffs
from qgdsolver_tpu_torch.physics.thermo import RhoConstThermo
from qgdsolver_tpu_torch.solvers import common
from qgdsolver_tpu_torch.solvers.mules_qhd import MulesQHDFoam
from qgdsolver_tpu_torch.solvers.qhd import QHDFoam
from qgdsolver_tpu_torch.solvers.srf_qhd import SRFQHDFoam

from _torch_parity import (F64, assert_solves_converged, exact_jax_solves,
                           run_both)


def _cg(jsolver, n=1):
    """2*n*cg_tol: n steps whose solves each stop at |r| <= cg_tol*|b|."""
    return 2.0 * n * jsolver.cg_tol


def _jcavity(n=16, **over):
    """tests/test_qhd.py's cavity: cases.buoyant_cavity with cg_tol
    1e-10."""
    js, jst = jcases.buoyant_cavity(shape=(n, n))
    return dataclasses.replace(js, cg_tol=1e-10, **over), jst


def _port(js):
    return interop.state_from_numpy(jax.tree.map(np.asarray, js), dtype=F64)


@pytest.mark.parametrize("variant", ["standard", "explicit", "srf",
                                     "mules", "mules_explicit", "p_ref"])
def test_cavity_matches_jax(variant, monkeypatch):
    """30 steps of the 16x16 cavity from rest (30 p solves; with implicit
    diffusion 30 U and 30 T solves): the convection roll rises at the hot
    wall, T keeps the walls' bounds; the variants: explicit diffusion,
    a rotating frame (SRFQHDFoam, omega_z = 1), the MULES T equation
    (implicit and explicit diffusion), and a pRef value of 5."""
    over = {"explicit": dict(implicit_diffusion=False),
            "srf": dict(omega=(0.0, 0.0, 1.0)),
            "mules": dict(t_equation="mules"),
            "mules_explicit": dict(t_equation="mules",
                                   implicit_diffusion=False),
            "p_ref": dict(p_ref_value=5.0)}.get(variant, {})
    js, jst = _jcavity(**over)
    n = 30
    _, ts, log = run_both(js, jst, n, _cg(js), monkeypatch)
    kinds = [k for k, _ in log]
    assert kinds.count("p") == n and sum(it for _, it in log) > n
    assert kinds.count("U") == kinds.count("T") == (
        n if js.implicit_diffusion else 0)
    assert np.isfinite(ts.U).all() and np.isfinite(ts.T).all()
    assert np.abs(ts.U).max() > 1e-6
    assert ts.T.max() < 1.0 + 1e-6 and ts.T.min() > -1.0 - 1e-6
    assert ts.U[1][1, 8] > 0 and ts.U[1][-2, 8] < 0
    if variant == "p_ref":
        assert ts.p[0, 0] == pytest.approx(5.0, abs=1e-12)


def test_projection_divergence_free():
    """After the pressure solve div(phi) vanishes to the CG tolerance
    (phi = phiu - phiwo + pEqn.flux()), on the port: phi rebuilt from the
    state before a step and the p after it (tests/test_qhd.py)."""
    js, jst = _jcavity()
    solver = interop.solver_from(js, dtype=F64)
    mesh, nd = solver.mesh, 2
    step = solver.make_step()
    s = common.run_steps(step, _port(jst), 3)
    s2 = step(s)
    bc_U, bc_T, bc_p = solver._bcs()
    th = solver.thermo
    U, T, p = s.U, s.T, s2.p
    rho, mu = th.rho(p, T), th.mu(p, T)
    zg = bc.FieldBCs.uniform(bc.ZeroGradient(), nd)
    gradUf = fvsc.grad(U, bc_U, mesh, vector=True)
    rhof = fvsc.interpolate(rho, zg, mesh)
    Uf = fvsc.interpolate(U, bc_U, mesh, vector=True)
    g = torch.tensor(solver.g, dtype=F64).reshape(nd, 1, 1)
    BdFrcf = fvsc.interpolate(th.beta * T[None] * g, zg, mesh, vector=True)
    tau_f = solver.tau_model.correct(mesh, p=p, T=T, ref=T, mu=mu,
                                     rho=rho).tau_f
    area = [mesh.face_area(a) for a in range(nd)]
    udg = [torch.einsum("i...,ij...->j...", Uf[a], gradUf[a])
           for a in range(nd)]
    phiu = [Uf[a][a] * area[a] for a in range(nd)]
    phiwo = [(tau_f[a] * (udg[a] - BdFrcf[a]))[a] * area[a]
             for a in range(nd)]
    snp = fvsc.sn_grad(p, bc_p, mesh)
    phi = [phiu[a] - phiwo[a] - tau_f[a] / rhof[a] * area[a] * snp[a]
           for a in range(nd)]
    scale = max(float(fvsc.div_flux(phiu, mesh).abs().max()), 1e-30)
    assert float(fvsc.div_flux(phi, mesh).abs().max()) < 1e-5 * scale + 1e-9


@pytest.mark.parametrize("model", ["ConstTau", "HbyUQHD", "H2bynuQHD",
                                   "T0byGr"])
def test_tau_models_match_jax(model):
    """The QHD tau models (and constTau) on a graded mesh from one random
    state: tau and every face tau within 1e-14 of their max."""
    kw = {"ConstTau": dict(tau0=3e-3), "HbyUQHD": dict(alpha=0.3, U0=2.0),
          "H2bynuQHD": dict(alpha=0.3), "T0byGr": dict(T0=2.0, Gr=7.0)}
    xf = (np.cumsum(np.r_[0.0, 1.0 + np.arange(12) / 10.0]),
          np.linspace(0.0, 1.0, 9))
    jmesh = JMesh(x_faces=xf, dtype=np.float64)
    mesh = interop.mesh_from(jmesh, dtype=F64)
    rng = np.random.default_rng(0)
    T = 300.0 + rng.random(mesh.shape)
    mu = 1e-3 * (1.0 + rng.random(mesh.shape))
    rho = 1.0 + rng.random(mesh.shape)
    jm = getattr(jcoeffs, model)(**kw[model])
    tm = interop._same(qgdcoeffs, jm)
    jc = jm.correct(jmesh, p=T, T=T, ref=T, mu=mu, rho=rho)
    tc = tm.correct(mesh, p=torch.tensor(T), T=torch.tensor(T),
                    ref=torch.tensor(T), mu=torch.tensor(mu),
                    rho=torch.tensor(rho))
    for a, b in [(jc.tau, tc.tau)] + list(zip(jc.tau_f, tc.tau_f)):
        a = np.broadcast_to(np.asarray(a), b.shape)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-14, atol=0.0)
    for a in (tc.mu_qgd, tc.alphau_qgd, tc.sc):
        assert not a.any()


def test_srf_coriolis_deflects_flow():
    """SRFQHDFoam on the port (tests/test_solver_variants.py): an x-stream
    in a frame rotating at omega_z = 2 gains a negative mean y velocity
    (-2 Omega x U) in 20 steps on a periodic box.  (Its pressure is
    round-off of zero, a system of noise whose CG counts mean nothing:
    the SRF step's parity runs on the cavity, test_cavity_matches_jax.)"""
    mesh = Mesh.uniform((24, 24), lengths=(1.0, 1.0), dtype=F64)
    per = bc.FieldBCs.uniform(bc.Periodic(), 2)
    solver = SRFQHDFoam(
        omega=[0.0, 0.0, 2.0], mesh=mesh,
        thermo=RhoConstThermo(rho0=1.0, Cp=1000.0, mu0=1e-3, Pr=1.0),
        tau_model=qgdcoeffs.H2bynuQHD(alpha=0.3), g=(0.0, 0.0), bc_U=per,
        bc_T=per, bc_p=per,
        time=common.TimeControls(max_co=0.3, max_dt=5e-3, dt0=1e-3))
    assert isinstance(solver, QHDFoam) and solver.omega == (0.0, 0.0, 2.0)
    U0 = torch.stack([torch.full(mesh.shape, 0.5, dtype=F64),
                      torch.zeros(mesh.shape, dtype=F64)])
    s = common.run_steps(solver.make_step(),
                         solver.init(U0, torch.zeros(mesh.shape,
                                                     dtype=F64)), 20)
    assert float(s.U[1].mean()) < -1e-3 and bool(s.U.isfinite().all())


def _mules_box():
    mesh = JMesh.uniform((64, 8), lengths=(1.0, 1.0), dtype=np.float64)
    per = jbc.FieldBCs.uniform(jbc.Periodic(), 2)
    js = JMulesQHDFoam(
        mesh=mesh, thermo=JRhoConst(rho0=1.0, Cp=1000.0, mu0=1e-6, Pr=1.0,
                                    beta=0.0),
        tau_model=jcoeffs.HbyUQHD(alpha=0.2, U0=1.0), g=(0.0, 0.0),
        bc_U=per, bc_T=per, bc_p=per, implicit_diffusion=False,
        time=jcommon.TimeControls(max_co=0.3, max_dt=2e-3, dt0=5e-4))
    x = np.asarray(mesh.centers[0])[:, None] * np.ones(mesh.shape)
    T0 = (np.abs(x - 0.3) < 0.1).astype(np.float64)  # a top hat
    U0 = np.stack([np.ones(mesh.shape), np.zeros(mesh.shape)])
    return js, js.init(U0, T0)


def test_mules_boundedness(monkeypatch):
    """mulesQHDFoam advects a top hat 100 steps (on the port; its first
    10 held to the JAX package): T stays within its initial [0, 1] and
    its sum is conserved."""
    js, jst = _mules_box()
    T0 = np.asarray(jst.T)
    run_both(js, jst, 10, _cg(js), monkeypatch)
    solver = interop.solver_from(js, dtype=F64)
    assert solver.t_equation == "mules" == MulesQHDFoam(
        mesh=solver.mesh, thermo=solver.thermo).t_equation
    s = common.run_steps(solver.make_step(), _port(jst), 100)
    T = s.T.numpy()
    assert T.max() <= 1.0 + 1e-9 and T.min() >= -1e-9
    np.testing.assert_allclose(T.sum(), T0.sum(), rtol=1e-10)
    assert np.argmax(T.mean(axis=1)) != np.argmax(T0.mean(axis=1))


def _monotone(mesh_mod, xp, dtype):
    mesh = mesh_mod.uniform((64, 4), lengths=(1.0, 1.0), dtype=dtype)
    x = np.asarray(mesh.centers[0])[:, None] * np.ones(mesh.shape)
    T = 1.0 + 0.1 * x
    phi = [np.ones(mesh.face_shape(a)) * np.asarray(mesh.face_area(a))
           for a in range(2)]
    phiH = []
    for a in range(2):
        Te = np.concatenate([np.take(T, [0], axis=a), T,
                             np.take(T, [-1], axis=a)], axis=a)
        n = Te.shape[a]
        Tf = 0.5 * (np.take(Te, np.arange(n - 1), axis=a)
                    + np.take(Te, np.arange(1, n), axis=a))
        phiH.append(phi[a] * Tf)
    return mesh, xp(T), tuple(xp(f) for f in phi), tuple(xp(f)
                                                         for f in phiH)


def test_mules_limit_reduces_to_high_order_and_matches_jax():
    """On a monotone profile with a small dt the limiter keeps the
    high-order flux (lambda = 1) away from the domain ends; on a random
    field the limited fluxes equal the JAX limiter's within 1e-14 of
    their max."""
    mesh, T, phi, phiH = _monotone(Mesh, torch.tensor, F64)
    flux = mules.limit(T, phi, phiH, 1e-4, mesh, T.max(), T.min())
    np.testing.assert_allclose(flux[0][2:-2].numpy(), phiH[0][2:-2].numpy(),
                               rtol=1e-12)
    rng = np.random.default_rng(0)
    jmesh = JMesh.uniform((16, 12), lengths=(1.0, 2.0), dtype=np.float64)
    mesh = interop.mesh_from(jmesh, dtype=F64)
    T = rng.random(mesh.shape)
    phi = [rng.standard_normal(mesh.face_shape(a)) for a in range(2)]
    phiH = [rng.standard_normal(mesh.face_shape(a)) for a in range(2)]
    jf = jmules.limit(jnp.asarray(T), phi, phiH, 1e-2, jmesh, 1.0, 0.0)
    tf = mules.limit(torch.tensor(T), [torch.tensor(f) for f in phi],
                     [torch.tensor(f) for f in phiH], 1e-2, mesh, 1.0, 0.0)
    for a, b in zip(jf, tf):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-14 * np.abs(a).max()


def test_qhd_flux_p_bc_matches_jax(monkeypatch):
    """A channel with a fixed inflow, a zero-pressure outlet and the
    qhdFlux p BC on the inlet and the walls (dp/dn from the step's own
    regularizer flux), 10 steps."""
    mesh = JMesh.uniform((20, 12), lengths=(2.0, 1.0), dtype=np.float64)
    zg, fv = jbc.ZeroGradient(), jbc.FixedValue
    js = JQHDFoam(
        mesh=mesh, thermo=JRhoConst(rho0=1.0, Cp=1000.0, mu0=1e-2, Pr=0.71,
                                    beta=-3e-3),
        tau_model=jcoeffs.H2bynuQHD(alpha=0.3), g=(0.0, -9.81),
        bc_U=jbc.FieldBCs(((fv(np.array([0.2, 0.0])), zg),
                           (fv(np.zeros(2)), fv(np.zeros(2))))),
        bc_T=jbc.FieldBCs(((fv(1.0), zg), (zg, zg))),
        bc_p=jbc.FieldBCs(((jbc.QHDFluxP(), fv(0.0)),
                           (jbc.QHDFluxP(), jbc.QHDFluxP()))),
        time=jcommon.TimeControls(max_co=0.3, max_dt=0.05, dt0=1e-3),
        cg_tol=1e-10)
    n = 10
    _, ts, log = run_both(js, js.init(np.zeros((2,) + mesh.shape),
                                      np.zeros(mesh.shape)),
                          n, _cg(js), monkeypatch)
    assert "p" not in [k for k, _ in log]  # a FixedValue side: not singular
    assert ts.U[0].max() > 0.01


def test_axisymmetric_qhd_matches_jax(monkeypatch):
    """QHDFoam on a wedge (the hoop term of the radial momentum, the
    r-weighted metrics): a closed pipe, hot at x = 0 and cold at x = 2,
    with gravity along r, 5 windows from the JAX package's States, each
    within 2*cg_tol of each field's max.  The cell volumes vary with r:
    the JAX package's pressure CG on V^-1 A stalls at cg_maxiter there
    (|r|/|b| ~ 5 at 1000 iterations), so its solves are made exact
    (`_torch_parity.exact_jax_solves`) and the counts are not compared;
    the port's CG on V*A is held to its own oracle as well, every solve
    (p, U, T) with its unweighted residual within 10*cg_tol before
    cg_maxiter.  T stays within its wall values and the buoyant flow
    starts."""
    mesh = JAxiMesh(x_faces=(np.linspace(0.0, 2.0, 17),
                             np.linspace(0.0, 0.5, 9)), dtype=np.float64)
    zg, fv = jbc.ZeroGradient(), jbc.FixedValue
    js = JQHDFoam(
        mesh=mesh, thermo=JRhoConst(rho0=1.0, Cp=1000.0, mu0=1e-2, Pr=0.71,
                                    beta=-3e-3),
        tau_model=jcoeffs.H2bynuQHD(alpha=0.3), g=(0.0, -9.81),
        bc_U=jbc.FieldBCs(((fv(np.zeros(2)), fv(np.zeros(2))),
                           (jbc.Symmetry(), fv(np.zeros(2))))),
        bc_T=jbc.FieldBCs(((fv(1.0), fv(0.0)), (zg, zg))),
        time=jcommon.TimeControls(max_co=0.3, max_dt=0.05, dt0=1e-3),
        cg_tol=1e-10)
    n = 5
    exact_jax_solves(monkeypatch)
    with linsolve.true_residuals() as solves:
        _, ts, log = run_both(js, js.init(np.zeros((2,) + mesh.shape),
                                          np.zeros(mesh.shape)),
                              n, _cg(js), monkeypatch, counts=False)
    assert_solves_converged(solves, js.cg_tol)
    assert [k for k, _ in log] == ["p", "U", "T"] * n
    assert np.isfinite(ts.U).all() and np.isfinite(ts.p).all()
    assert ts.T.min() >= -1e-12 and ts.T.max() <= 1.0 + 1e-12
    assert np.abs(ts.U).max() > 0


def test_masked_cavity_matches_jax(monkeypatch):
    """The cavity with a solid band (y < 0.25) on a 24x24 mesh: the mirror
    fill, the masked operators, the first fluid cell as pRef cell; 10
    windows after 10 JAX steps from rest.  (The first steps' pressure
    systems are round-off of zero, whose CG counts mean nothing.)"""
    n = 24
    solid = np.zeros((n, n), dtype=bool)
    solid[:, :n // 4] = True
    js, _ = _jcavity(n)
    js = dataclasses.replace(js, mesh=JMesh(
        x_faces=(np.linspace(0, 1, n + 1),) * 2, solid=solid,
        dtype=np.float64))
    step = js.make_step()
    j10 = jax.jit(lambda s: jcommon.run_steps(step, s, 10))(
        js.init(np.zeros((2, n, n)), np.zeros((n, n))))
    _, ts, _ = run_both(js, j10, 10, _cg(js), monkeypatch)
    assert np.abs(ts.U[:, :, :n // 4]).max() == 0.0
    assert np.abs(ts.U).max() > 1e-8
