"""The port's zQGDFoam and rhoQGDFoam against the JAX package: `logmean` on
both of its branches in float64 and float32, the freestream, Sod against
the exact Riemann solution, and the step on a perturbed field (explicit
and with implicit diffusion), for zQGDFoam, for QGDFoam with a stiffened
gas (rhoQGDFoam) and with a JANAF gas.  Mirrors tests/test_zqgd.py and
tests/test_solver_variants.py's rhoQGDFoam freestream.

Bounds: composable steps in float64 without a CG solve within 1e-9 of
each field's max (round-off: the same formulas in the same order); with
implicit diffusion 2*n*cg_tol (each solve stops at |r| <= cg_tol*|b| in
both packages, its dots summed in another order) and equal CG iteration
counts.  `logmean` within 4 ulps of its dtype (the series and the guarded
logarithm are the same expressions).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.core.mesh import Mesh as JMesh
from qgdsolver_tpu.physics import thermo as jtm
from qgdsolver_tpu.physics.qgdcoeffs import ConstScPrModel1 as JModel1
from qgdsolver_tpu.solvers import common as jcommon
from qgdsolver_tpu.solvers.qgd import QGDFoam as JQGDFoam
from qgdsolver_tpu.solvers.rho_qgd import RhoQGDFoam as JRhoQGDFoam
from qgdsolver_tpu.solvers.zqgd import ZQGDFoam as JZQGDFoam
from qgdsolver_tpu.solvers.zqgd import logmean as jlogmean
from qgdsolver_tpu_torch import interop
from qgdsolver_tpu_torch.ops import fused_qgd2d
from qgdsolver_tpu_torch.solvers import common
from qgdsolver_tpu_torch.solvers.qgd import QGDFoam
from qgdsolver_tpu_torch.solvers.rho_qgd import RhoQGDFoam
from qgdsolver_tpu_torch.solvers.zqgd import ZQGDFoam, logmean
from tests.test_qgd import _sod_exact

from _torch_parity import F64, ROUND_OFF, run_both



@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_logmean_both_branches_match_jax(dtype):
    """The series branch (u < 1e-4: equal and near-equal states, where the
    |f| < 1e-30 guard decides the logarithm branch's divisor), the
    logarithm branch, and the values of tests/test_zqgd.py::test_logmean."""
    rng = np.random.default_rng(0)
    a = np.concatenate([[1.0, 2.0, 5.0, 3.0], 1.0 + rng.random(64),
                        1.0 + 10.0 * rng.random(64)])
    b = np.concatenate([[1.0, 2.0 + 1e-14, 1.0, 3.0 * (1 + 1e-3)],
                        a[4:68] * (1.0 + 1e-5 * rng.standard_normal(64)),
                        1.0 + 10.0 * rng.random(64)])
    a, b = a.astype(dtype), b.astype(dtype)
    zeta = a / b
    u = ((zeta - 1) / (zeta + 1)) ** 2
    assert (u < 1e-4).sum() > 60 and (u >= 1e-4).sum() > 60
    got = logmean(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    ref = np.asarray(jlogmean(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == dtype
    np.testing.assert_allclose(got, ref, rtol=4 * np.finfo(dtype).eps)
    if dtype == np.float64:
        np.testing.assert_allclose(got[0], 1.0, rtol=1e-12)
        np.testing.assert_allclose(got[1], 2.0, rtol=1e-10)
        np.testing.assert_allclose(got[2], 4.0 / np.log(5.0), rtol=1e-10)


def _periodic(cls, **kw):
    mesh = JMesh.uniform((12, 10), lengths=(1.0, 1.0), dtype=np.float64)
    per = jbc.FieldBCs.uniform(jbc.Periodic(), 2)
    return cls(mesh=mesh, tau_model=JModel1(alpha=0.5), bc_U=per, bc_p=per,
               bc_T=per,
               time=jcommon.TimeControls(max_co=0.3, max_dt=1e-3, dt0=1e-6),
               **kw)


@pytest.mark.parametrize("kind", ["zqgd", "rho"])
def test_freestream_preserved_and_matches_jax(kind, monkeypatch):
    """A uniform stream stays uniform (15 steps, rho to 1e-12, U to
    1e-10): zQGDFoam with a perfect gas and rhoQGDFoam with a stiffened
    gas (p_inf 2e5)."""
    if kind == "zqgd":
        jsolver = _periodic(JZQGDFoam, thermo=jtm.PerfectGasThermo(
            R=287.0, Cp=1004.5))
        u = (200.0, -50.0)
    else:
        jsolver = _periodic(lambda **kw: JRhoQGDFoam(**kw), thermo=(
            jtm.RhoThermo(eos=jtm.StiffenedGasEoS(R=287.0, p_inf=2e5),
                          R=287.0, Cp=1004.5)))
        u = (50.0, 0.0)
    shape = jsolver.mesh.shape
    js = jsolver.init(p0=np.full(shape, 1e5), T0=np.full(shape, 300.0),
                      U0=np.stack([np.full(shape, u[0]),
                                   np.full(shape, u[1])]))
    _, ts, _ = run_both(jsolver, js, 15, ROUND_OFF, monkeypatch)
    np.testing.assert_allclose(ts.rho, ts.rho[0, 0], rtol=1e-12)
    np.testing.assert_allclose(ts.rhoU[0] / ts.rho, u[0], rtol=1e-10)
    solver = interop.solver_from(jsolver, dtype=F64)
    assert isinstance(solver, ZQGDFoam if kind == "zqgd" else QGDFoam)
    assert not fused_qgd2d.supported(solver)


def _perturbed(cls, implicit, thermo):
    """A 24x16 box with an inlet, an outlet and walls, from a random
    perturbed state (seed 0)."""
    mesh = JMesh.uniform((24, 16), lengths=(1.0, 1.0), dtype=np.float64)
    zg = jbc.ZeroGradient()
    solver = cls(
        mesh=mesh, thermo=thermo, tau_model=JModel1(alpha=0.5),
        bc_U=jbc.FieldBCs(((jbc.FixedValue(np.array([300.0, 0.0])), zg),
                           (jbc.FixedValue(np.zeros(2)), zg))),
        bc_p=jbc.FieldBCs(((zg, jbc.FixedValue(1e5)), (zg, zg))),
        bc_T=jbc.FieldBCs(((jbc.FixedValue(300.0), zg),
                           (jbc.FixedValue(320.0), zg))),
        implicit_diffusion=implicit,
        time=jcommon.TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-7))
    rng = np.random.default_rng(0)
    return solver, solver.init(
        p0=1e5 * (1.0 + 0.2 * rng.random(mesh.shape)),
        T0=300.0 * (1.0 + 0.1 * rng.random(mesh.shape)),
        U0=100.0 * rng.standard_normal((2,) + mesh.shape))


THERMOS = {
    "perfect": lambda: jtm.PerfectGasThermo(
        R=287.0, Cp=1004.5, transport=jtm.ConstTransport(1e-3)),
    "stiffened": lambda: jtm.RhoThermo(
        eos=jtm.StiffenedGasEoS(R=287.0, p_inf=2e5), R=287.0, Cp=1004.5,
        transport=jtm.ConstTransport(1e-3)),
    "janaf": lambda: jtm.JanafPerfectGasThermo(
        janaf=jtm.JanafThermo(
            R=296.8,
            low=(3.298677, 1.4082404e-3, -3.963222e-6, 5.641515e-9,
                 -2.444854e-12, -1020.8999, 3.950372),
            high=(2.92664, 1.4879768e-3, -5.68476e-7, 1.0097038e-10,
                  -6.753351e-15, -922.7977, 5.980528)),
        transport=jtm.SutherlandTransport(As=1.4792e-6, Ts=116.0)),
}


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("solver,thermo", [
    ("zqgd", "perfect"), ("qgd", "stiffened"), ("qgd", "janaf")])
def test_perturbed_steps_match_jax(solver, thermo, implicit, monkeypatch):
    """5 steps from a perturbed field with FixedValue, ZeroGradient and
    wall sides: zQGDFoam (its log-mean fluxes, upwind face values, split
    regularizer and phih2), rhoQGDFoam with a stiffened gas and QGDFoam
    with a JANAF gas (no constant gamma or Cv: gamma(T) interpolated to
    the faces), explicit and with implicit diffusion."""
    cls = JZQGDFoam if solver == "zqgd" else JQGDFoam
    jsolver, js = _perturbed(cls, implicit, THERMOS[thermo]())
    n = 5
    tol = 2 * n * jsolver.cg_tol if implicit else ROUND_OFF
    _, _, log = run_both(jsolver, js, n, tol, monkeypatch)
    assert (len(log) == 2 * n) == implicit
    assert all(it > 0 for _, it in log)


def test_sod_shock_tube():
    """zQGDFoam on Sod (400 cells to t = 0.2 on the port): rho within
    L1 0.03 of the exact Riemann solution, as tests/test_zqgd.py."""
    from qgdsolver_tpu_torch.core import bc
    from qgdsolver_tpu_torch.core.mesh import Mesh
    from qgdsolver_tpu_torch.physics.qgdcoeffs import ConstScPrModel1
    from qgdsolver_tpu_torch.physics.thermo import PerfectGasThermo

    n, R, gamma = 400, 1.0, 1.4
    mesh = Mesh.uniform((n,), lengths=(1.0,), dtype=F64)
    zg = bc.FieldBCs.uniform(bc.ZeroGradient(), 1)
    solver = ZQGDFoam(
        mesh=mesh, thermo=PerfectGasThermo(R=R, Cp=gamma * R / (gamma - 1)),
        tau_model=ConstScPrModel1(alpha=0.5), bc_U=zg, bc_p=zg, bc_T=zg,
        time=common.TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-6))
    x = np.asarray(mesh.centers[0])
    p0 = np.where(x < 0.5, 1.0, 0.1)
    rho0 = np.where(x < 0.5, 1.0, 0.125)
    s = solver.init(p0=p0, T0=p0 / (R * rho0), U0=np.zeros((1, n)))
    step = solver.make_step()
    for _ in range(20000):
        s = step(s)
        if float(s.t) >= 0.2:
            break
    rho_ex, _, _ = _sod_exact(x, float(s.t))
    rho = s.rho.numpy()
    assert np.all(np.isfinite(rho))
    assert np.mean(np.abs(rho - rho_ex)) < 0.03


def test_rho_qgd_takes_only_rho_thermo():
    from qgdsolver_tpu_torch.core.mesh import Mesh
    from qgdsolver_tpu_torch.physics import thermo as tm

    with pytest.raises(TypeError, match="RhoThermo"):
        RhoQGDFoam(thermo=tm.PerfectGasThermo(287.0, 1004.5),
                   mesh=Mesh.uniform((4, 4)))
