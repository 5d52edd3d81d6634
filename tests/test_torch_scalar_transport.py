"""The port's scalarTransportQHDFoam against the JAX package and its oracles
on the port: conservation on a periodic box, the peak carried by the
frozen velocity, and the pure-diffusion decay of a Fourier mode.  Mirrors
tests/test_scalar_transport.py.

Both packages build each config from one description (the JAX solver,
carried across by `interop.solver_from`) and start from one State, in
float64.  Parity: n one-step windows of the port from the JAX States
(`_torch_parity.run_both`), each field within 2*cg_tol of its max a step
(the implicit diffusion solves to |r| <= cg_tol*|b|), equal CG iteration
counts for every solve; with explicit diffusion 1e-9.
"""
import dataclasses

import numpy as np
import pytest
import torch

from qgdsolver_tpu import cases as jcases
from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.core.mesh import Mesh as JMesh
from qgdsolver_tpu.physics.qgdcoeffs import ConstTau as JConstTau
from qgdsolver_tpu.physics.thermo import RhoConstThermo as JRhoConst
from qgdsolver_tpu.solvers import common as jcommon
from qgdsolver_tpu.solvers.scalar_transport import (
    ScalarTransportQHD as JScalarTransportQHD)
from qgdsolver_tpu_torch import cases, interop
from qgdsolver_tpu_torch.solvers import common
from qgdsolver_tpu_torch.solvers.scalar_transport import ScalarTransportQHD

from _torch_parity import F64, ROUND_OFF, run_both


@pytest.mark.parametrize("implicit", [True, False])
def test_scalar_box_matches_jax(implicit, monkeypatch):
    """cases.scalar_box at 32x32, 20 steps: implicit diffusion (one CG
    solve a step) and explicit."""
    js, jst = jcases.scalar_box(shape=(32, 32))
    js = dataclasses.replace(js, implicit_diffusion=implicit)
    tol = 2 * js.cg_tol if implicit else ROUND_OFF
    _, ts, log = run_both(js, jst, 20, tol, monkeypatch)
    assert [k for k, _ in log] == ["T"] * (20 if implicit else 0)
    assert np.isfinite(ts.T).all()
    solver = interop.solver_from(js, dtype=F64)
    assert isinstance(solver, ScalarTransportQHD)
    assert not hasattr(solver, "fused_supported")


def test_conservation_periodic():
    """50 steps on the periodic box: the sum of T conserved to 1e-10, the
    peak not raised, dt grown from its start."""
    solver, s = cases.scalar_box((32, 32), device="cpu")
    mass0 = float(s.T.sum())
    peak0 = float(s.T.max())
    s = common.run_steps(solver.make_step(), s, 50)
    assert bool(torch.isfinite(s.T).all())
    np.testing.assert_allclose(float(s.T.sum()), mass0, rtol=1e-10)
    assert float(s.T.max()) <= peak0 * 1.01
    assert float(s.t) > 0 and float(s.dt) > 1e-4


def test_advection_moves_peak():
    """Carried at U = (1, 0) to t ~ 0.25 the blob's peak moves from x = 0.5
    to ~0.75, its row unchanged."""
    solver, s = cases.scalar_box((32, 32), device="cpu")
    step = solver.make_step()
    while float(s.t) < 0.25:
        s = step(s)
    i, j = np.unravel_index(int(torch.argmax(s.T)), solver.mesh.shape)
    assert abs(solver.mesh.centers[0][i] - 0.75) < 0.1
    assert abs(j - int(np.argmin(np.abs(solver.mesh.centers[1] - 0.5)))) <= 1


def test_pure_diffusion_analytic(monkeypatch):
    """U = 0, constTau 0: a sin(2 pi x) mode decays as
    exp(-kappa (2 pi)^2 t), kappa = Hi_f = 0.05, over 200 steps of 1e-4
    (T within 2e-3 of the exact field); its first 10 steps held to the JAX
    package's."""
    mesh = JMesh.uniform((64, 4), lengths=(1.0, 1.0), dtype=np.float64)
    per = jbc.FieldBCs.uniform(jbc.Periodic(), 2)
    kappa = 0.05
    js = JScalarTransportQHD(
        mesh=mesh, thermo=JRhoConst(rho0=1.0, Cp=1.0, mu0=kappa, Pr=1.0),
        tau_model=JConstTau(tau0=0.0), bc_T=per, bc_U=per,
        time=jcommon.TimeControls(adjust_time_step=False, dt0=1e-4))
    x = np.asarray(mesh.centers[0])[:, None] * np.ones(mesh.shape)
    jst = js.init(1.0 + 0.5 * np.sin(2 * np.pi * x),
                  np.zeros((2,) + mesh.shape))
    run_both(js, jst, 10, 2 * js.cg_tol, monkeypatch)
    solver = interop.solver_from(js, dtype=F64)
    s = common.run_steps(solver.make_step(), solver.init(
        torch.tensor(np.asarray(jst.T)),
        torch.zeros((2,) + mesh.shape, dtype=F64)), 200)
    decay = np.exp(-kappa * (2 * np.pi) ** 2 * 200 * 1e-4)
    np.testing.assert_allclose(s.T.numpy(),
                               1.0 + 0.5 * decay * np.sin(2 * np.pi * x),
                               atol=2e-3)
