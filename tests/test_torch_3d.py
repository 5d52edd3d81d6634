"""3D capability of the port's composable path, mirroring tests/test_3d.py
(fvsc exactness, QGD freestream and entropy wave on a periodic box), plus
f64 parity of the composable 3D step with the JAX package's for both 3D
cases, the Periodic pad rule, and the State interop in 3D.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgdsolver_tpu import cases as jcases
from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.core.mesh import Mesh as JMesh
from qgdsolver_tpu.ops.pad import ghost_pad as j_ghost_pad
from qgdsolver_tpu_torch import cases as tcases
from qgdsolver_tpu_torch import interop
from qgdsolver_tpu_torch.core import bc as tbc
from qgdsolver_tpu_torch.core.mesh import Mesh
from qgdsolver_tpu_torch.ops import fvsc
from qgdsolver_tpu_torch.ops.pad import ghost_pad
from qgdsolver_tpu_torch.physics import qgdcoeffs as tcoeffs
from qgdsolver_tpu_torch.physics.thermo import PerfectGasThermo
from qgdsolver_tpu_torch.solvers import common
from qgdsolver_tpu_torch.solvers.qgd import QGDFoam

CASES = ["supersonic_duct_3d", "supersonic_jet_3d_varsc"]


def _rel(a, b):
    a = np.asarray(a)
    return np.max(np.abs(a - np.asarray(b))) / max(np.max(np.abs(a)), 1e-300)


def test_fvsc_grad_linear_exact_3d():
    mesh = Mesh.uniform((6, 5, 4), lengths=(1.0, 2.0, 0.5),
                        dtype=torch.float64)
    c = [np.asarray(x) for x in mesh.centers]
    f = (2.0 * c[0][:, None, None] - 3.0 * c[1][None, :, None]
         + 5.0 * c[2][None, None, :] + 1.0)
    # exact ghost values for the linear field via FixedGradient per side
    bcs = tbc.FieldBCs((
        (tbc.FixedGradient(-2.0), tbc.FixedGradient(2.0)),
        (tbc.FixedGradient(3.0), tbc.FixedGradient(-3.0)),
        (tbc.FixedGradient(-5.0), tbc.FixedGradient(5.0)),
    ))
    g = fvsc.grad_from_padded(ghost_pad(mesh.tensor(f), bcs, mesh), mesh)
    expect = [2.0, -3.0, 5.0]
    for a in range(3):
        for i in range(3):
            np.testing.assert_allclose(g[a][i].numpy(), expect[i],
                                       atol=1e-12, err_msg=f"axis {a} {i}")


def _periodic_solver(shape, lengths, max_co):
    mesh = Mesh.uniform(shape, lengths=lengths, dtype=torch.float64)
    per = tbc.FieldBCs.uniform(tbc.Periodic(), 3)
    return QGDFoam(
        mesh=mesh, thermo=PerfectGasThermo(R=287.0, Cp=1004.5),
        tau_model=tcoeffs.ConstScPrModel1(alpha=0.5),
        bc_U=per, bc_p=per, bc_T=per,
        time=common.TimeControls(max_co=max_co, max_dt=1e-3, dt0=1e-6))


def test_qgd_freestream_3d():
    solver = _periodic_solver((8, 6, 4), (1.0, 1.0, 1.0), 0.3)
    shape = solver.mesh.shape
    U0 = np.stack([np.full(shape, 60.0), np.full(shape, -20.0),
                   np.full(shape, 10.0)])
    s = solver.init(p0=np.full(shape, 1e5), T0=np.full(shape, 300.0), U0=U0)
    s = common.run_steps(solver.make_step(), s, 10)
    np.testing.assert_allclose(s.rho.numpy(), float(s.rho[0, 0, 0]),
                               rtol=1e-12)
    np.testing.assert_allclose((s.rhoU[2] / s.rho).numpy(), 10.0, rtol=1e-10)


def test_qgd_entropy_wave_3d_stability():
    solver = _periodic_solver((24, 6, 4), (1.0, 0.25, 0.2), 0.25)
    shape = solver.mesh.shape
    x = np.asarray(solver.mesh.centers[0])[:, None, None] * np.ones(shape)
    T0 = 400.0 * (1 + 0.15 * np.exp(-((x - 0.3) / 0.08) ** 2))
    U0 = np.zeros((3,) + shape)
    U0[0] = 50.0
    s = solver.init(p0=np.full(shape, 1e5), T0=T0, U0=U0)
    s = common.run_steps(solver.make_step(), s, 150)
    assert bool(torch.isfinite(s.rho).all())
    # stays uniform transverse
    assert float(torch.max(torch.abs(s.rho - s.rho[:, :1, :1]))) < 1e-8


def test_periodic_pad_matches_jax():
    rng = np.random.default_rng(7)
    f = rng.standard_normal((3, 5, 4, 6))
    per = tbc.FieldBCs(((tbc.Periodic(), tbc.Periodic()),
                        (tbc.ZeroGradient(), tbc.FixedValue(2.0)),
                        (tbc.Periodic(), tbc.Periodic())))
    jper = jbc.FieldBCs(((jbc.Periodic(), jbc.Periodic()),
                         (jbc.ZeroGradient(), jbc.FixedValue(2.0)),
                         (jbc.Periodic(), jbc.Periodic())))
    got = ghost_pad(torch.as_tensor(f), per,
                    Mesh.uniform((5, 4, 6), dtype=torch.float64), vector=True)
    ref = j_ghost_pad(jnp.asarray(f), jper,
                      JMesh.uniform((5, 4, 6), dtype=np.float64), vector=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got[:, 0, 1:-1, 1:-1].numpy(), f[:, -1])


@pytest.mark.parametrize("name", CASES)
def test_composable_step_matches_jax_3d(name):
    """10 f64 steps of the composable 3D step against the JAX package's."""
    jsolver, js = getattr(jcases, name)(shape=(16, 10, 10), dtype=np.float64)
    tsolver, _ = getattr(tcases, name)(shape=(16, 10, 10),
                                       dtype=torch.float64, device="cpu")
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js),
                                  dtype=torch.float64)
    rho0 = np.asarray(js.rho)
    jstep = jax.jit(jsolver.make_step())
    ts = common.run_steps(tsolver.make_step(), ts, 10)
    for _ in range(10):
        js = jstep(js)
    out = interop.state_to_numpy(ts)
    assert _rel(rho0, out.rho) > 1e-6, "the state must evolve"
    for f in ("rho", "rhoU", "rhoE", "sc", "t", "dt"):
        assert _rel(getattr(js, f), getattr(out, f)) < 1e-12, f
    assert len(out.pbc) == len(js.pbc) == (1 if "varsc" in name else 0)
    for ja, tb in zip(js.pbc, out.pbc):
        assert _rel(ja, tb) < 1e-9


def test_model1_variants_step_as_model1():
    """ConstScPrModel1n and ConstScPrModel2 compute what model1 does."""
    tsolver, s = tcases.supersonic_duct_3d(shape=(8, 6, 6),
                                           dtype=torch.float64, device="cpu")
    ref = tsolver.make_step()(s)
    for cls in (tcoeffs.ConstScPrModel1n, tcoeffs.ConstScPrModel2):
        other = dataclasses.replace(tsolver,
                                    tau_model=cls(alpha=0.5, Sc=1.0, Pr=1.0))
        out = other.make_step()(s)
        for f in ("rho", "rhoU", "rhoE", "sc", "dt"):
            torch.testing.assert_close(getattr(out, f), getattr(ref, f),
                                       rtol=0.0, atol=0.0)


def test_interop_round_trip_3d():
    _, js = jcases.supersonic_jet_3d_varsc(shape=(8, 6, 4),
                                           dtype=np.float64)
    assert js.pbc[0].shape == (1, 6, 4)
    pbc = np.random.default_rng(5).standard_normal((1, 6, 4))
    jn = jax.tree.map(np.asarray, js._replace(pbc=(jnp.asarray(pbc),)))
    back = interop.state_to_numpy(
        interop.state_from_numpy(jn, dtype=torch.float64))
    for f in ("rho", "rhoU", "rhoE", "sc", "t", "dt"):
        np.testing.assert_array_equal(getattr(jn, f), getattr(back, f))
    np.testing.assert_array_equal(jn.pbc[0], back.pbc[0])
