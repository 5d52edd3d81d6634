"""The 2D analytic oracles of tests/test_qgd.py and the flagship Sod tube of
tests/test_validation.py, on the port.

Each oracle runs on the port's composable step (float64, its config carried
from the reference test's JAX solver by `interop.solver_from`, and within
1e-9 of each field's max of the JAX run at the end) and on the fused 2D
steps' plain versions on the CPU: K1 (`build_fused_step`) and, for
varScModel5, K2 (`build_tiled_fused_step`), float32, held to the reference
test's own physical bounds.  The fused gates refuse periodic sides
(`fused_qgd2d.supported`), so where the reference oracle is periodic the
fused runs take the nearest config the kernels run (noted per test), and
the 1D Sod tube runs on them as a quasi-1D 400x4 tube.  `_sod_exact` comes
from tests/test_qgd.py, as tests/test_torch_fused_qgd3d.py takes it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_qgd import _sod_exact
from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.core.mesh import Mesh as JMesh
from qgdsolver_tpu.physics import qgdcoeffs as jcoeffs
from qgdsolver_tpu.physics.thermo import PerfectGasThermo
from qgdsolver_tpu.solvers import common as jcommon
from qgdsolver_tpu.solvers.qgd import QGDFoam as JQGDFoam
from qgdsolver_tpu_torch import interop
from qgdsolver_tpu_torch.core import bc as tbc
from qgdsolver_tpu_torch.ops import fused_qgd2d as F
from qgdsolver_tpu_torch.solvers import common

F64 = torch.float64
PATHS = ["composable", "K1", "K2"]


def _rel(a, b):
    a = np.asarray(a)
    return np.max(np.abs(a - np.asarray(b))) / max(np.max(np.abs(a)), 1e-300)


class _Run:
    """One oracle config on one path: `advance(n)` steps the port, `state`
    is its composable State (numpy leaves)."""

    def __init__(self, jsolver, js, path):
        self.path = path
        if path == "composable":
            self.solver = interop.solver_from(jsolver, dtype=F64)
            self.fs = interop.state_from_numpy(
                jax.tree.map(np.asarray, js), dtype=F64)
            self.step, self.from_f = self.solver.make_step(), (lambda s: s)
            self.jax = (jsolver, js)
        else:
            self.solver = interop.solver_from(jsolver, dtype=torch.float32)
            build = (F.build_fused_step if path == "K1"
                     else F.build_tiled_fused_step)
            assert F.supported(self.solver)
            assert path == "K1" or F.folds_sensor(self.solver)
            self.step, to_f, self.from_f = build(self.solver)
            self.fs = to_f(interop.state_from_numpy(
                jax.tree.map(np.asarray, js), dtype=torch.float32))
            self.jax = None

    def advance(self, n):
        for _ in range(n):
            self.fs = self.step(self.fs)

    def run_to(self, t_end, max_steps=10000):
        for _ in range(max_steps):
            self.fs = self.step(self.fs)
            if float(self.fs.t) >= t_end:
                return
        raise AssertionError(f"t did not reach {t_end}")

    @property
    def state(self):
        return interop.state_to_numpy(self.from_f(self.fs))

    def primitives(self):
        U, e, T, p = self.solver.primitives(self.from_f(self.fs))
        return U.numpy(), T.numpy(), p.numpy()

    def check_jax(self, n_steps):
        """The composable run against the JAX package's n_steps."""
        if self.jax is None:
            return
        jsolver, js = self.jax
        step = jsolver.make_step()
        js = jax.jit(lambda s: jcommon.run_steps(step, s, n_steps))(js)
        out = self.state
        for f in ("rho", "rhoU", "rhoE", "sc", "t", "dt"):
            assert _rel(getattr(js, f), getattr(out, f)) <= 1e-9, f


def _gas(R=287.0, Cp=1004.5):
    return PerfectGasThermo(R=R, Cp=Cp)


@pytest.mark.parametrize("path", PATHS)
def test_freestream_preservation_2d(path):
    """Uniform flow must stay uniform, 20 steps.  The reference box is
    periodic (the composable path); the fused paths run the same stream
    with zero-gradient sides, which preserve it as well (K2 with the
    varScModel5 sensor at rest)."""
    mesh = JMesh.uniform((16, 12), lengths=(1.0, 1.0),
                         dtype=np.float64 if path == "composable"
                         else np.float32)
    sides = (jbc.FieldBCs.uniform(jbc.Periodic(), 2) if path == "composable"
             else jbc.FieldBCs.uniform(jbc.ZeroGradient(), 2))
    tau = (jcoeffs.VarScModel5(alpha=0.5) if path == "K2"
           else jcoeffs.ConstScPrModel1(alpha=0.5))
    solver = JQGDFoam(
        mesh=mesh, thermo=_gas(), tau_model=tau, bc_U=sides, bc_p=sides,
        bc_T=sides,
        time=jcommon.TimeControls(max_co=0.3, max_dt=1e-3, dt0=1e-6))
    U0 = jnp.stack([jnp.full(mesh.shape, 100.0), jnp.full(mesh.shape, 30.0)])
    js = solver.init(p0=jnp.full(mesh.shape, 1e5),
                     T0=jnp.full(mesh.shape, 300.0), U0=U0,
                     sc0=jnp.full(mesh.shape, 0.05))
    run = _Run(solver, js, path)
    run.advance(20)
    run.check_jax(20)
    s = run.state
    rtol = (1e-12, 1e-10) if path == "composable" else (1e-6, 1e-5)
    np.testing.assert_allclose(s.rho, s.rho[0, 0], rtol=rtol[0])
    np.testing.assert_allclose(s.rhoU[0] / s.rho, 100.0, rtol=rtol[1])
    np.testing.assert_allclose(s.rhoU[1] / s.rho, 30.0, rtol=rtol[1])


@pytest.mark.parametrize("path", ["composable", "K1"])
def test_sod_shock_tube(path):
    """Sod to t = 0.2 against the exact Riemann solution: density L1 <
    0.02, velocity L1 < 0.04 (the reference's bounds).  The composable
    path runs the reference's 1D 400-cell tube; K1 a quasi-1D 400x4 one
    (zero-gradient sides)."""
    n = 400
    shape = (n,) if path == "composable" else (n, 4)
    dtype = np.float64 if path == "composable" else np.float32
    mesh = JMesh.uniform(shape, lengths=(1.0,) if len(shape) == 1
                         else (1.0, 0.01), dtype=dtype)
    R, gamma = 1.0, 1.4
    zg = jbc.FieldBCs.uniform(jbc.ZeroGradient(), len(shape))
    solver = JQGDFoam(
        mesh=mesh, thermo=_gas(R, gamma * R / (gamma - 1)),
        tau_model=jcoeffs.ConstScPrModel1(alpha=0.5, Sc=1.0, Pr=1.0),
        bc_U=zg, bc_p=zg, bc_T=zg,
        time=jcommon.TimeControls(max_co=0.3, max_dt=1e-3, dt0=1e-6))
    x = np.asarray(mesh.centers[0])
    line = (slice(None),) + (None,) * (len(shape) - 1)
    p0 = np.where(x < 0.5, 1.0, 0.1)[line] * np.ones(shape)
    rho0 = np.where(x < 0.5, 1.0, 0.125)[line] * np.ones(shape)
    js = solver.init(p0=jnp.asarray(p0), T0=jnp.asarray(p0 / (R * rho0)),
                     U0=jnp.zeros((len(shape),) + shape))
    run = _Run(solver, js, path)
    run.run_to(0.2)
    s = run.state
    rho = s.rho if len(shape) == 1 else s.rho[:, 2]
    u = (s.rhoU[0] / s.rho) if len(shape) == 1 else (s.rhoU[0] / s.rho)[:, 2]
    rho_ex, u_ex, _ = _sod_exact(x, float(s.t))
    assert np.mean(np.abs(rho - rho_ex)) < 0.02
    assert np.mean(np.abs(u - u_ex)) < 0.04
    if path == "K1":
        assert np.max(np.std(s.rho, axis=1)) < 1e-4  # stays quasi-1D


def test_entropy_wave_2d_stability():
    """A temperature wave advected through a periodic 48x8 box, 300
    steps: finite, y-uniform, and carried downstream.  Periodic on every
    side, so the composable path only; within round-off of the JAX run."""
    mesh = JMesh.uniform((48, 8), lengths=(1.0, 0.2), dtype=np.float64)
    per = jbc.FieldBCs.uniform(jbc.Periodic(), 2)
    solver = JQGDFoam(
        mesh=mesh, thermo=_gas(), tau_model=jcoeffs.ConstScPrModel1(alpha=0.5),
        bc_U=per, bc_p=per, bc_T=per,
        time=jcommon.TimeControls(max_co=0.3, max_dt=1e-3, dt0=1e-6))
    x = np.asarray(mesh.cell_coords(0)) * np.ones(mesh.shape)
    T0 = jnp.asarray(400.0 * (1 + 0.2 * np.exp(-((x - 0.3) / 0.08) ** 2)))
    U0 = jnp.zeros((2,) + mesh.shape).at[0].set(50.0)
    js = solver.init(p0=jnp.full(mesh.shape, 1e5), T0=T0, U0=U0)
    run = _Run(solver, js, "composable")
    run.advance(300)
    run.check_jax(300)
    s = run.state
    assert np.isfinite(s.rho).all()
    assert np.max(np.abs(s.rho - s.rho[:, :1])) < 1e-8
    _, T, _ = run.primitives()
    assert np.asarray(mesh.centers[0])[int(np.argmax(T[:, 4]))] > 0.32


@pytest.mark.parametrize("path", ["composable", "K1"])
def test_qgd_flux_pressure_bc_outflow(path):
    """A uniform supersonic stream passes a qgdFlux outlet unchanged (p and
    Ux within 2% after 100 steps).  The reference box is periodic in y
    (the composable path); K1 runs it between slip walls."""
    dtype = np.float64 if path == "composable" else np.float32
    mesh = JMesh.uniform((32, 8), lengths=(1.0, 0.25), dtype=dtype)
    u_in = 500.0
    y = ((jbc.Periodic(), jbc.Periodic()) if path == "composable"
         else (jbc.Symmetry(), jbc.Symmetry()))
    solver = JQGDFoam(
        mesh=mesh, thermo=_gas(), tau_model=jcoeffs.ConstScPrModel1(alpha=0.5),
        bc_U=jbc.FieldBCs(((jbc.FixedValue(jnp.asarray([u_in, 0.0])),
                            jbc.ZeroGradient()), y)),
        bc_p=jbc.FieldBCs(((jbc.ZeroGradient(), jbc.QGDFluxP()), y)),
        bc_T=jbc.FieldBCs(((jbc.FixedValue(300.0), jbc.ZeroGradient()), y)),
        time=jcommon.TimeControls(max_co=0.3, max_dt=1e-4, dt0=1e-7))
    js = solver.init(p0=jnp.full(mesh.shape, 1e5),
                     T0=jnp.full(mesh.shape, 300.0),
                     U0=jnp.zeros((2,) + mesh.shape).at[0].set(u_in))
    run = _Run(solver, js, path)
    assert run.solver._flux_sides() == ((0, 1),)
    run.advance(100)
    run.check_jax(100)
    U, _, p = run.primitives()
    assert np.isfinite(p).all()
    np.testing.assert_allclose(p, 1e5, rtol=2e-2)
    np.testing.assert_allclose(U[0], u_in, rtol=2e-2)


@pytest.mark.parametrize("path", PATHS)
def test_sod_varsc_qgdflux_flagship(path):
    """The shock-capturing flagship config (varScModel5 + qgdFlux outlet)
    on a quasi-1D 400x4 Sod tube to t = 0.2: density L1 < 0.02, the shock
    within 4 cells, the sensor engaged at the shock and relaxed elsewhere
    (tests/test_validation.py's bounds)."""
    n = 400
    dtype = np.float64 if path == "composable" else np.float32
    mesh = JMesh.uniform((n, 4), lengths=(1.0, 0.01), dtype=dtype)
    R, gamma = 1.0, 1.4
    zg = jbc.FieldBCs.uniform(jbc.ZeroGradient(), 2)
    solver = JQGDFoam(
        mesh=mesh, thermo=_gas(R, gamma * R / (gamma - 1)),
        tau_model=jcoeffs.VarScModel5(alpha=0.5, Pr=1.0, rC=0.5, minSc=0.05,
                                      maxSc=1.0, smoothCoeff=0.1),
        bc_U=zg, bc_p=zg.replace(0, 1, jbc.QGDFluxP()), bc_T=zg,
        time=jcommon.TimeControls(max_co=0.3, max_dt=1e-3, dt0=1e-6))
    x = np.asarray(mesh.centers[0])
    p0 = np.broadcast_to(np.where(x < 0.5, 1.0, 0.1)[:, None], (n, 4))
    rho0 = np.broadcast_to(np.where(x < 0.5, 1.0, 0.125)[:, None], (n, 4))
    js = solver.init(p0=jnp.asarray(p0), T0=jnp.asarray(p0 / (R * rho0)),
                     U0=jnp.zeros((2, n, 4)), sc0=jnp.full((n, 4), 0.05))
    run = _Run(solver, js, path)
    run.run_to(0.2)
    s = run.state
    rho_ex, _, p_ex = _sod_exact(x, float(s.t))
    assert np.mean(np.abs(s.rho[:, 2] - rho_ex)) < 0.02
    _, _, p = run.primitives()
    sh_ex = x[np.argmin(np.diff(p_ex))]
    sh_num = x[np.argmin(np.diff(p[:, 2]))]
    assert abs(sh_num - sh_ex) < 4.0 / n, (sh_num, sh_ex)
    sc = s.sc[:, 2]
    assert sc.max() > 2.0 * 0.05 and sc.min() < 1.2 * 0.05
    assert abs(x[np.argmax(sc)] - sh_ex) < 0.05
