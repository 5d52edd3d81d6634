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


# key: (case, shape, (px, py), steps, bound against the serial port)
CASES2 = {
    # the CG's dots are all-reduced sums: their order differs from the
    # serial sums, so the two agree to the solves' tolerance, 2*n*cg_tol
    "implicit_jet_2x1": ("implicit_jet", (32, 16), (2, 1), 10, 2e-7),
    "implicit_wedge_blob_1x2": ("implicit_wedge_blob", (16, 16), (1, 2), 10,
                                2e-7),
    "wt_segmented_jet_1x2": ("wt_segmented_jet", (32, 16), (1, 2), 10,
                             1e-12),
    "wt_segmented_jet_2x1": ("wt_segmented_jet", (32, 16), (2, 1), 10,
                             1e-12),
    # a waveTransmissive segment of a split outlet side, its border inside
    # rank 0's block (1x2) or the side on rank 1 alone (2x1): bit for bit
    "wt_split_outlet_1x2": ("wt_split_outlet", (32, 16), (1, 2), 10, 0.0),
    "wt_split_outlet_2x1": ("wt_split_outlet", (32, 16), (2, 1), 10, 0.0),
}


@pytest.fixture(scope="module")
def world2():
    """The cases of CASES2 on one 2-rank world (gloo, CPU): {key: (port
    initial state, per-rank gathered port State)}."""
    jobs, init = [], {}
    for key, (name, shape, grid, steps, _) in CASES2.items():
        solver = bodies.port_case(name, shape, torch.float64)
        s0 = interop.state_to_numpy(solver.init(
            *_rest_state(solver, name)))
        init[key] = s0
        jobs.append(("spmd", name, shape, "float64", grid, steps, s0))
    per_rank = distributed.spawn(bodies.run_jobs, 2, jobs, "cpu",
                                 device="cpu", timeout=120)
    return {key: (init[key], [r[i][0] for r in per_rank])
            for i, key in enumerate(CASES2)}


def _rest_state(solver, name):
    """(p0, T0, U0) of a case: the builders' own initial fields."""
    base = {"implicit_jet": "supersonic_jet",
            "wt_segmented_jet": "supersonic_jet",
            "wt_split_outlet": "supersonic_jet",
            "implicit_wedge_blob": "wedge_blob"}[name]
    _, s = getattr(cases, base)(shape=solver.mesh.shape, dtype=torch.float64,
                                device="cpu")
    U, _, T, p = solver.primitives(s)
    return p, T, U


@pytest.mark.parametrize("key", list(CASES2))
def test_two_ranks_match_port_serial_step(world2, key):
    """Implicit diffusion (the CG's dots as all-reduces), a wedge,
    waveTransmissive outlets with a Segmented inlet, and waveTransmissive
    segments of a split outlet go through build_spmd_step unchanged: two
    ranks (2x1 and 1x2) against the serial port; the gathered
    waveTransmissive carry is the owner rank's."""
    name, shape, _, steps, tol = CASES2[key]
    s0, ranks = world2[key]
    solver = bodies.port_case(name, shape, torch.float64)
    s = interop.state_from_numpy(s0, dtype=torch.float64)
    step = solver.make_step()
    for _ in range(steps):
        s = step(s)
    ref = interop.state_to_numpy(s)
    assert len(ref.wt) == (2 if name.startswith("wt_") else 0)
    for got in ranks:
        _close(ref, got, tol, key)
        for a, b in zip(ref.wt, got.wt):
            np.testing.assert_allclose(b, a, rtol=tol, atol=0.0,
                                       err_msg=f"{key} wt")
    assert _rel_change(s0, ref) > 1e-6, "the state must evolve"


def _rel_change(a, b):
    return float(np.max(np.abs(a.rhoU - b.rhoU)) / np.max(np.abs(b.rhoU)))


def test_solid_masks_are_not_decomposed():
    """A stairstep solid mesh is refused by build_spmd_step, as in the
    JAX package (its stencils are globally indexed)."""
    import dataclasses

    from qgdsolver_tpu_torch.core.mesh import Mesh

    solver, _ = cases.supersonic_jet(shape=(16, 8), dtype=torch.float64,
                                     device="cpu")
    solid = np.zeros((16, 8), dtype=bool)
    solid[:4, :2] = True
    masked = dataclasses.replace(solver, mesh=Mesh(
        x_faces=solver.mesh.x_faces, dtype=torch.float64, solid=solid))
    assert sharding.spmd_supported(solver) is None
    assert "solid" in sharding.spmd_supported(masked)
    with pytest.raises(NotImplementedError, match="solid"):
        sharding.build_spmd_step(masked, sharding.ProcessGrid(2, 1))


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
