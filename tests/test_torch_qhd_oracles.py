"""Oracles of the port's QHD family and of QGDFoam with constTau, run on
the port: the masked cavity against the body-fitted one, the
backward-facing-step QHDFoam case (its solver and State built as the JAX
package builds them, its steps held to the JAX package's), the
Taylor-Green decay rate and the isentropic-vortex order.  Mirrors
tests/test_qhd_solid.py and tests/test_validation.py.

Bounds as tests/test_torch_qhd.py (its `run_both` windows: 2*cg_tol a
step and equal CG iteration counts).  The Taylor-Green transient (1000
steps, ~70 ms a step on the port's eager CPU step) runs whole in the JAX
package and as two port windows from its states: the first steps and the
last, whose port State carries the decay-rate assertion.  The de Vahl
Davis Nusselt number runs on the card (tests/test_torch_qhd_gpu.py).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.core.mesh import Mesh as JMesh
from qgdsolver_tpu.io import foam_case as jfc
from qgdsolver_tpu.physics import qgdcoeffs as jcoeffs
from qgdsolver_tpu.physics.thermo import RhoConstThermo as JRhoConst
from qgdsolver_tpu.solvers import common as jcommon
from qgdsolver_tpu.solvers.qhd import QHDFoam as JQHDFoam
from qgdsolver_tpu_torch import cases, interop
from qgdsolver_tpu_torch.core import bc
from qgdsolver_tpu_torch.core.mesh import Mesh
from qgdsolver_tpu_torch.io import foam_case
from qgdsolver_tpu_torch.physics import qgdcoeffs
from qgdsolver_tpu_torch.physics.thermo import PerfectGasThermo
from qgdsolver_tpu_torch.solvers import common
from qgdsolver_tpu_torch.solvers.qgd import QGDFoam
from qgdsolver_tpu_torch.solvers.qhd import QHDFoam

from _torch_parity import F64, run_both
from tests.test_qhd_solid import (
    test_backward_facing_step_qhd_case as _bfs_case)


def _cg(jsolver):
    """2*cg_tol: a step whose solves each stop at |r| <= cg_tol*|b|."""
    return 2.0 * jsolver.cg_tol


def test_masked_cavity_matches_bodyfitted():
    """tests/test_qhd_solid.py on the port: a solid band along y < 0.25
    of a 48x48 unit cavity against the body-fitted cavity on
    [0, 1] x [0.25, 1], 40 steps: equal dt chains, T and U within 1e-9,
    p within 1e-9 up to its reference constant."""
    n, ns = 48, 12
    solid = np.zeros((n, n), dtype=bool)
    solid[:, :ns] = True

    def cavity(mesh):
        solver, _ = cases.buoyant_cavity(device="cpu")
        return dataclasses.replace(solver, mesh=mesh, cg_tol=1e-12)

    sm = cavity(Mesh(x_faces=(np.linspace(0, 1, n + 1),) * 2, dtype=F64,
                     solid=solid))
    sb = cavity(Mesh(x_faces=(np.linspace(0, 1, n + 1),
                              np.linspace(0.25, 1.0, n - ns + 1)),
                     dtype=F64))
    zeros = lambda *shape: torch.zeros(shape, dtype=F64)  # noqa: E731
    st_m = common.run_steps(sm.make_step(),
                            sm.init(zeros(2, n, n), zeros(n, n)), 40)
    st_b = common.run_steps(sb.make_step(),
                            sb.init(zeros(2, n, n - ns), zeros(n, n - ns)),
                            40)
    np.testing.assert_allclose(float(st_m.dt), float(st_b.dt), rtol=1e-12)
    for f in ("T", "U"):
        np.testing.assert_allclose(getattr(st_m, f)[..., ns:].numpy(),
                                   getattr(st_b, f).numpy(), atol=1e-9)
    pm, pb = st_m.p[:, ns:].numpy(), st_b.p.numpy()
    np.testing.assert_allclose(pm - pm.mean(), pb - pb.mean(), atol=1e-9)
    assert st_b.U.abs().max() > 1e-8


def test_backward_facing_step_case(tmp_path, monkeypatch):
    """The L-shaped multi-block QHDFoam case of tests/test_qhd_solid.py
    (its JAX test writes the case and runs it): the port builds the same
    solver and State and runs 20 steps held to the JAX package's; the flow
    enters the channel and the solid quadrant's cells keep zero
    velocity."""
    _bfs_case(tmp_path)  # the JAX test: writes the case, runs 20 steps
    case = str(tmp_path / "bfs_qhd")
    js, jst = jfc.build_case(case)
    solver, state = foam_case.build_case(case, device="cpu", dtype=F64)
    assert isinstance(solver, QHDFoam)
    assert solver.mesh.solid.sum() == 16 * 8
    ref = interop.solver_from(js, dtype=F64)
    for f in ("thermo", "tau_model", "g", "time", "implicit_diffusion"):
        assert getattr(solver, f) == getattr(ref, f), f
    for f in state._fields:
        np.testing.assert_array_equal(getattr(state, f).numpy(),
                                      np.asarray(getattr(jst, f)))
    n = 20
    _, ts, _ = run_both(js, jst, n, _cg(js), monkeypatch)
    assert ts.U[0, :16, :8].max() > 0.01
    assert np.abs(ts.U[:, :16, 8:]).max() == 0.0


def _taylor_green(n=64, nu=0.02):
    """tests/test_validation.py's Taylor-Green vortex (dt 2e-3)."""
    mesh = JMesh.uniform((n, n), lengths=(2 * np.pi, 2 * np.pi),
                         dtype=np.float64)
    per = jbc.FieldBCs.uniform(jbc.Periodic(), 2)
    js = JQHDFoam(
        mesh=mesh, thermo=JRhoConst(rho0=1.0, Cp=1000.0, mu0=nu, Pr=1.0),
        tau_model=jcoeffs.H2bynuQHD(alpha=0.2), bc_U=per, bc_T=per,
        bc_p=per, time=jcommon.TimeControls(adjust_time_step=False,
                                             dt0=2e-3))
    X = np.asarray(mesh.centers[0])[:, None] * np.ones((1, n))
    Y = np.asarray(mesh.centers[1])[None, :] * np.ones((n, 1))
    U0 = np.stack([np.sin(X) * np.cos(Y), -np.cos(X) * np.sin(Y)])
    return js, js.init(U0=U0, T0=np.zeros((n, n))), U0


def test_taylor_green_decay_rate(monkeypatch):
    """KE of u = sin x cos y, v = -cos x sin y decays as exp(-4 nu t):
    the rate over t = 2 (1000 steps) within 5%.  The JAX package runs the
    transient; the port runs its first 5 steps and its last 5 from the
    JAX states, each window held to the JAX package, and the rate is
    taken from the port's final State."""
    js, jst, U0 = _taylor_green()
    w = 5
    run_both(js, jst, w, _cg(js), monkeypatch)
    step = js.make_step()
    mid = jax.jit(lambda s: jcommon.run_steps(step, s, 1000 - w))(jst)
    _, ts, _ = run_both(js, mid, w, _cg(js), monkeypatch)
    assert float(ts.t) == pytest.approx(2.0, rel=1e-12)
    ke0 = np.mean(np.sum(U0 * U0, axis=0))
    ke1 = np.mean(np.sum(ts.U ** 2, axis=0))
    rate = -np.log(ke1 / ke0) / 2.0
    assert abs(rate - 0.08) / 0.08 < 0.05, rate


def _vortex_error(n, t_end=0.25):
    """tests/test_validation.py's isentropic vortex on the port: QGDFoam
    with constTau tau = 0.05 h^2 and dt ~ h^2, the L1 error of rho at
    t_end."""
    from tests.test_validation import GAMMA, L_DOM, U_INF, \
        _vortex_primitives

    mesh = Mesh.uniform((n, n), lengths=(L_DOM, L_DOM), dtype=F64)
    h = L_DOM / n
    per = bc.FieldBCs.uniform(bc.Periodic(), 2)
    h32 = L_DOM / 32
    dt = (0.2 * h32 / (np.hypot(*U_INF) + np.sqrt(GAMMA * 1.2))
          * (h / h32) ** 2)
    n_steps = int(np.ceil(t_end / dt))
    solver = QGDFoam(
        mesh=mesh, thermo=PerfectGasThermo(R=1.0, Cp=GAMMA / (GAMMA - 1.0)),
        tau_model=qgdcoeffs.ConstTau(tau0=0.05 * h * h),
        bc_U=per, bc_p=per, bc_T=per,
        time=common.TimeControls(adjust_time_step=False,
                                 dt0=t_end / n_steps))
    X = np.asarray(mesh.centers[0])[:, None] * np.ones((1, n))
    Y = np.asarray(mesh.centers[1])[None, :] * np.ones((n, 1))
    rho0, u0, v0, p0 = _vortex_primitives(X, Y, 0.0)
    s = solver.init(p0=p0, T0=p0 / rho0, U0=np.stack([u0, v0]))
    s = common.run_steps(solver.make_step(), s, n_steps)
    rho_ex = _vortex_primitives(X, Y, t_end)[0]
    return np.mean(np.abs(s.rho.numpy() - rho_ex))


def test_isentropic_vortex_second_order():
    """The port's L1(rho) error drops at >= 1.9 order from 64 to 128
    cells (tests/test_validation.py's bar)."""
    errs = [_vortex_error(n) for n in (32, 64, 128)]
    orders = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert errs[0] > errs[1] > errs[2]
    assert orders[-1] >= 1.9, (errs, orders)
