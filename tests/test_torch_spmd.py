"""The port's decomposed composable step (`parallel.sharding.build_spmd_step`)
against the port's serial step and the JAX package's `build_spmd_step`.

Mirrors tests/test_spmd.py.  The ranks are processes started by
`parallel.distributed.spawn` on the CPU over gloo; one 4-rank world runs
every case of this module in turn (tests/_torch_rank_bodies.py, which
imports no JAX), and the JAX references run here, on the 8 virtual CPU
devices of tests/conftest.py.  Initial states are the JAX builders'
(f64), carried over with `interop`.  Bounds: the port's serial step within
1e-12 of each field's max (the decomposed step repeats its arithmetic; max
and min reductions are exact), JAX's decomposed step within 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_rank_bodies as bodies
from qgdsolver_tpu import cases as jcases
from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.core.mesh import Mesh as JMesh
from qgdsolver_tpu.parallel import sharding as jshd
from qgdsolver_tpu.physics.qgdcoeffs import ConstScPrModel1 as JModel1
from qgdsolver_tpu.physics.thermo import PerfectGasThermo as JThermo
from qgdsolver_tpu.solvers.common import TimeControls as JTimeControls
from qgdsolver_tpu.solvers.qgd import QGDFoam as JQGDFoam
from qgdsolver_tpu_torch import cases, interop
from qgdsolver_tpu_torch.parallel import distributed, sharding

# key: (case, shape, (px, py), steps)
CASES = {
    "jet_2x2": ("supersonic_jet", (32, 16), (2, 2), 10),
    "flagship_2x2": ("supersonic_jet_varsc", (64, 32), (2, 2), 10),
    "jet_4x1": ("supersonic_jet", (32, 16), (4, 1), 10),
    "duct3d_2x2": ("supersonic_duct_3d", (16, 8, 6), (2, 2), 6),
    "graded_jet_2x2": ("graded_jet", (48, 32), (2, 2), 10),
    "periodic_jet_1x4": ("periodic_jet", (32, 16), (1, 4), 10),
}


def _jax_graded_jet():
    """tests/test_spmd.py::test_qgd_graded_jet_parity_2x2's case."""
    nx, ny = 48, 32
    mesh = JMesh(x_faces=(bodies.graded_faces(nx, 4.0, 3.0),
                          bodies.graded_faces(ny, 2.0, 0.4)),
                 dtype=np.float64)
    th = JThermo(R=287.0, Cp=1004.5)
    u_jet = 2.0 * float(th.c(jnp.asarray(300.0)))
    y = np.asarray(mesh.centers[1])
    delta = 3.0 * float(mesh.dx[1][0])
    prof = 0.5 * (np.tanh((0.3 - np.abs(y - 1.0)) / delta) + 1.0)

    def inlet_u(t, coords):
        yy = coords[1]
        ux = u_jet * 0.5 * (jnp.tanh((0.3 - jnp.abs(yy - 1.0)) / delta)
                            + 1.0) * jnp.ones_like(yy)
        return jnp.stack(jnp.broadcast_arrays(ux, jnp.zeros_like(ux)), 0)

    solver = JQGDFoam(
        mesh=mesh, thermo=th, tau_model=JModel1(alpha=0.5, Sc=1.0),
        bc_U=jbc.FieldBCs(((jbc.FixedValue(inlet_u), jbc.ZeroGradient()),
                           (jbc.ZeroGradient(), jbc.ZeroGradient()))),
        bc_p=jbc.FieldBCs(((jbc.ZeroGradient(), jbc.FixedValue(1e5)),
                           (jbc.FixedValue(1e5), jbc.FixedValue(1e5)))),
        bc_T=jbc.FieldBCs(((jbc.FixedValue(300.0), jbc.ZeroGradient()),
                           (jbc.ZeroGradient(), jbc.ZeroGradient()))),
        time=JTimeControls(max_co=0.3, max_dt=1e-4, dt0=1e-7))
    U0 = np.zeros((2, nx, ny))
    U0[0] = u_jet * np.exp(-np.asarray(mesh.centers[0]))[:, None] \
        * prof[None, :]
    return solver, solver.init(jnp.asarray(np.full((nx, ny), 1e5)),
                               jnp.asarray(np.full((nx, ny), 300.0)),
                               jnp.asarray(U0))


def _jax_case(name, shape):
    """(JAX solver, JAX f64 initial state) of a case."""
    if name == "graded_jet":
        return _jax_graded_jet()
    base = "supersonic_jet" if name == "periodic_jet" else name
    solver, state = getattr(jcases, base)(shape=shape, dtype=np.float64)
    if name == "periodic_jet":
        solver = bodies.periodic_y(solver, jbc)
    if name == "supersonic_jet_varsc":
        # a density jump across the x partition edge, so the sensor and
        # its cross-partition smoothing are exercised (tests/test_spmd.py)
        x = np.asarray(solver.mesh.centers[0])
        bump = 1.0 + 0.4 * (np.abs(x[:, None] - x[len(x) // 2]) < 0.1)
        state = state._replace(rho=state.rho * bump, rhoE=state.rhoE * bump)
    return solver, state


def _to_port_numpy(jstate):
    return interop.state_to_numpy(interop.state_from_numpy(
        jax.tree.map(np.asarray, jstate), dtype=torch.float64))


@pytest.fixture(scope="module")
def world():
    """Every case on one 4-rank world: {key: (JAX solver, JAX initial
    state, per-rank (gathered port State, launches))}."""
    jax_cases, jobs = {}, []
    for key, (name, shape, grid, steps) in CASES.items():
        js, jst = _jax_case(name, shape)
        jax_cases[key] = (js, jst)
        jobs.append(("spmd", name, shape, "float64", grid, steps,
                     _to_port_numpy(jst)))
    jobs.append(("scaling", "supersonic_jet", (8, 8), "float64", (2, 2), 2,
                 None))
    per_rank = distributed.spawn(bodies.run_jobs, 4, jobs, "cpu",
                                 device="cpu", timeout=120)
    out = {key: jax_cases[key] + ([r[i][0] for r in per_rank],)
           for i, key in enumerate(CASES)}
    out["scaling"] = per_rank[0][-1][0]
    return out


def _port_serial(name, shape, steps, jst):
    solver = bodies.port_case(name, shape, torch.float64)
    s = interop.state_from_numpy(jax.tree.map(np.asarray, jst),
                                 dtype=torch.float64)
    step = solver.make_step()
    for _ in range(steps):
        s = step(s)
    return interop.state_to_numpy(s)


def _close(ref, got, tol, what):
    for f in ("rho", "rhoU", "rhoE", "sc", "t", "dt"):
        a = np.asarray(getattr(ref, f), dtype=np.float64)
        b = np.asarray(getattr(got, f), dtype=np.float64)
        scale = np.max(np.abs(a)) + 1e-300
        np.testing.assert_allclose(b / scale, a / scale, rtol=tol, atol=tol,
                                   err_msg=f"{what} {f}")
    assert len(ref.pbc) == len(got.pbc)
    for a, b in zip(ref.pbc, got.pbc):
        a = np.asarray(a, dtype=np.float64)
        scale = np.max(np.abs(a)) + 1e-300
        np.testing.assert_allclose(np.asarray(b) / scale, a / scale,
                                   rtol=tol, atol=tol, err_msg=f"{what} pbc")


@pytest.mark.parametrize("key", list(CASES))
def test_matches_port_serial_step(world, key):
    name, shape, _, steps = CASES[key]
    _, jst, ranks = world[key]
    ref = _port_serial(name, shape, steps, jst)
    for got in ranks:  # from_spmd gathers the same State onto every rank
        _close(ref, got, 1e-12, key)
    if name == "supersonic_jet_varsc":
        assert ref.sc.max() > ref.sc.min() + 0.01, "the sensor must be active"


@pytest.mark.parametrize("key", list(CASES))
def test_matches_jax_spmd_step(world, key):
    _, _, (px, py), steps = CASES[key]
    js, jst, ranks = world[key]
    cpu = jax.devices("cpu")
    dmesh = jshd.make_device_mesh(cpu[:px * py], shape=(px, py))
    step, to_spmd = jshd.build_spmd_step(js, dmesh, jst)
    s = to_spmd(jst)
    for _ in range(steps):
        s = step(s)
    _close(jax.tree.map(np.asarray, s), ranks[0], 1e-9, key)


def test_measure_scaling_runs_in_a_world(world):
    out = world["scaling"]
    assert out["devices"] == 4
    for k in ("points_per_s_1dev", "points_per_s_per_dev",
              "weak_scaling_efficiency"):
        assert np.isfinite(out[k]) and out[k] > 0, k


def test_indivisible_shape_raises():
    solver, _ = cases.supersonic_jet(shape=(30, 16), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        sharding.build_spmd_step(solver, sharding.ProcessGrid(4, 1))
    with pytest.raises(ValueError, match="not divisible"):
        sharding.build_spmd_step(solver, sharding.ProcessGrid(1, 3))


def test_factor2d_and_process_grid():
    for n in range(1, 17):
        assert sharding.factor2d(n) == jshd.factor2d(n)
    g = sharding.ProcessGrid(2, 3)
    assert [g.coords(r) for r in range(4)] == [(0, 0), (1, 0), (0, 1),
                                               (1, 1)]
    assert all(g.rank(*g.coords(r)) == r for r in range(g.size))
    assert sharding.ProcessGrid.parse("4X2") == sharding.ProcessGrid(4, 2)
    for bad in ("4", "0x2", "ax1"):
        with pytest.raises(ValueError):
            sharding.ProcessGrid.parse(bad)


def test_initialize_is_a_noop_without_a_launcher(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_spawn_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="planted failure"):
        distributed.spawn(bodies.fail, 2, "planted failure", device="cpu",
                          timeout=30)
