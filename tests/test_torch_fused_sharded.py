"""The port's decomposed fused steps K3 (`build_sharded_fused_step`, 2D) and
K5 (`build_sharded_fused_step_3d`, 3D x-ring) against the port's serial
fused steps and the JAX package's sharded kernels.

Mirrors tests/test_fused_sharded.py.  On the CPU the kernel wrappers run
their flagged plain versions; the CUDA kernels are held against the same
plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py).  The
ranks are processes started by `parallel.distributed.spawn` over gloo: one
2-rank and one 4-rank world run the cases of this module
(tests/_torch_rank_bodies.py, no JAX); the JAX sharded steps run here in
interpret mode on the virtual CPU devices.  Initial states are the JAX
builders' (f32), carried over with `interop`.

Bounds: an x-ring, the inletOutlet variant and the 3D duct equal the port's
serial step bit for bit.  The 2D splits are held to the JAX test's bounds
(dt equal; rho, rhoE rtol 1e-6; rhoU rtol 1e-5 atol 0.05), the flagship and
the 3D varsc jet to dt equal and 2e-5 (the JAX sharded tests' varsc
bounds); on the CPU they too are bitwise.  Against JAX: the JAX fused
tests' bounds (dt rtol 1e-6 (1e-5 varsc); fields within 1e-3 (2e-3 varsc)
of their max in 2D, 2e-5 in 3D).
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_rank_bodies as bodies
from qgdsolver_tpu import cases as jcases
from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.ops import fused_qgd2d as JF
from qgdsolver_tpu.ops import fused_qgd3d as JF3
from qgdsolver_tpu.parallel import sharding as jshd
from qgdsolver_tpu_torch import cli, interop
from qgdsolver_tpu_torch.io import foam_case
from qgdsolver_tpu_torch.ops import fused_qgd2d as F
from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
from qgdsolver_tpu_torch.ops import smoothing as S
from qgdsolver_tpu_torch.parallel import distributed, sharding
from test_torch_fused_qgd3d import _flagship as flagship_3d

SHAPE = (64, 32)
SHAPE3 = (16, 8, 6)
# key: (kind, case, shape, (px, py), steps)
WORLD2 = {
    "x_ring_2": ("k3", "supersonic_jet", SHAPE, (2, 1), 10),
    "inlet_outlet_2": ("k3", "inlet_outlet_jet", SHAPE, (2, 1), 10),
    "roundtrip": ("k3", "supersonic_jet_varsc", SHAPE, (2, 1), 0),
    "duct3d_2": ("k5", "supersonic_duct_3d", SHAPE3, (2, 1), 6),
    "varsc3d_2": ("k5", "supersonic_jet_3d_varsc", SHAPE3, (2, 1), 6),
}
WORLD4 = {
    "x_ring_4": ("k3", "supersonic_jet", SHAPE, (4, 1), 10),
    "split_2x2": ("k3", "supersonic_jet", SHAPE, (2, 2), 10),
    "split_1x4": ("k3", "supersonic_jet", SHAPE, (1, 4), 10),
    "flagship_2x2": ("k3", "supersonic_jet_varsc", SHAPE, (2, 2), 10),
}
CASES = {**WORLD2, **WORLD4}
BITWISE = ("x_ring_2", "x_ring_4", "inlet_outlet_2", "duct3d_2")


def _jax_case(name, shape):
    """(JAX solver, JAX f32 initial state) of a case."""
    if name == "supersonic_jet_3d_varsc":
        # the jet reaching the outlet and a pressure bump near it, so the
        # sensor and the qgdFlux plane carry signal
        return flagship_3d(jcases, shape, np.float32, jnp.asarray)
    base = "supersonic_jet" if name == "inlet_outlet_jet" else name
    solver, state = getattr(jcases, base)(shape=shape, dtype=np.float32)
    if name == "inlet_outlet_jet":
        import dataclasses

        solver = dataclasses.replace(
            solver, bc_U=solver.bc_U.replace(1, 1, jbc.InletOutlet(
                jnp.zeros(2))),
            bc_T=solver.bc_T.replace(0, 1, jbc.InletOutlet(300.0)))
    if name == "supersonic_jet_varsc":
        # a density jump across the x partition edge: the sensor and its
        # cross-partition smoothing wave are active
        x = np.asarray(solver.mesh.centers[0])
        bump = (1.0 + 0.4 * (np.abs(x[:, None] - x[len(x) // 2]) < 0.1)
                ).astype(np.float32)
        state = state._replace(rho=state.rho * bump, rhoE=state.rhoE * bump)
    return solver, state


def _port_state(jst):
    return interop.state_from_numpy(jax.tree.map(np.asarray, jst),
                                    dtype=torch.float32)


def _spawn(cases_, nprocs):
    jax_cases, jobs = {}, []
    for key, (kind, name, shape, grid, steps) in cases_.items():
        js, jst = _jax_case(name, shape)
        jax_cases[key] = (js, jst)
        jobs.append((kind, name, shape, "float32", grid, steps,
                     interop.state_to_numpy(_port_state(jst))))
    per_rank = distributed.spawn(bodies.run_jobs, nprocs, jobs, "cpu",
                                 device="cpu", timeout=120)
    return {key: jax_cases[key] + (per_rank[0][i][0],)
            for i, key in enumerate(cases_)}


@pytest.fixture(scope="module")
def world():
    """{key: (JAX solver, JAX state, the ranks' gathered port State)}."""
    return {**_spawn(WORLD2, 2), **_spawn(WORLD4, 4)}


def _port_serial(key, jst):
    kind, name, shape, _, steps = CASES[key]
    solver = bodies.port_case(name, shape, torch.float32)
    build = F.build_fused_step if kind == "k3" else F3.build_fused_step_3d
    step, to_f, from_f = build(solver, plain=True)
    fs = to_f(_port_state(jst))
    for _ in range(steps):
        fs = step(fs)
    return interop.state_to_numpy(from_f(fs))


def _jax_sharded(key, js, jst):
    kind, _, _, (px, py), steps = CASES[key]
    dmesh = jshd.make_device_mesh(jax.devices()[:px * py], shape=(px, py),
                                  axis_names=("X", "Y"))
    if kind == "k3":
        step, to_sh, from_sh = JF.build_sharded_fused_step(js, dmesh)
    else:
        step, to_sh, from_sh = JF3.build_sharded_fused_step_3d(
            js, dmesh, interpret=True)
    s, jstep = to_sh(jst), jax.jit(step)
    for _ in range(steps):
        s = jstep(s)
    return jax.tree.map(np.asarray, from_sh(s))


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    return np.max(np.abs(a - np.asarray(b, dtype=np.float64))) \
        / max(np.max(np.abs(a)), 1e-30)


@pytest.mark.parametrize("key", [k for k in CASES if k != "roundtrip"])
def test_matches_port_serial_fused_step(world, key):
    _, jst, got = world[key]
    ref = _port_serial(key, jst)
    if key in BITWISE:
        for f in ("rho", "rhoU", "rhoE", "t", "dt"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                          err_msg=f)
        return
    np.testing.assert_array_equal(got.dt, ref.dt)
    if key.startswith("split"):
        for f in ("rho", "rhoE"):
            np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                       rtol=1e-6, err_msg=f)
        np.testing.assert_allclose(got.rhoU, ref.rhoU, rtol=1e-5, atol=0.05)
        return
    assert ref.sc.max() > ref.sc.min() + 0.01, "the sensor must be active"
    for f in ("rho", "rhoE", "sc"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=2e-5, atol=1e-6, err_msg=f)
    # pbc = (p_ghost - p)/dx: a few ulp of p (tests/test_fused_sharded.py)
    ulp_p = float(np.spacing(np.float32(101325.0)))
    dx = 4.0 / CASES[key][2][0]
    for a, b in zip(ref.pbc, got.pbc):
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=4 * ulp_p / dx)


@pytest.mark.parametrize("key", [k for k in CASES if k != "roundtrip"])
def test_matches_jax_sharded_kernels(world, key):
    js, jst, got = world[key]
    ref = _jax_sharded(key, js, jst)
    varsc = CASES[key][1] in ("supersonic_jet_varsc",
                              "supersonic_jet_3d_varsc")
    dt_tol = 1e-5 if varsc and CASES[key][0] == "k3" else 1e-6
    f_tol = 2e-5 if CASES[key][0] == "k5" else (2e-3 if varsc else 1e-3)
    np.testing.assert_allclose(got.dt, np.asarray(ref.dt, np.float32),
                               rtol=dt_tol)
    np.testing.assert_allclose(got.t, np.asarray(ref.t, np.float32),
                               rtol=dt_tol)
    assert _rel(jst.rho, got.rho) > 1e-6, "the state must evolve"
    for f in ("rho", "rhoU", "rhoE", "sc"):
        assert _rel(getattr(ref, f), getattr(got, f)) < f_tol, f


def test_to_from_sharded_round_trip(world):
    _, jst, got = world["roundtrip"]
    ref = interop.state_to_numpy(_port_state(jst))
    for f in ("rho", "rhoU", "rhoE", "sc"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=1e-6, err_msg=f)


def test_k5_needs_an_x_ring():
    solver = bodies.port_case("supersonic_duct_3d", SHAPE3, torch.float32)
    assert not F3.sharded_supported(solver, sharding.ProcessGrid(2, 2))
    with pytest.raises(NotImplementedError):
        F3.build_sharded_fused_step_3d(solver, sharding.ProcessGrid(2, 2))
    assert not F.sharded_supported(
        bodies.port_case("supersonic_jet", (30, 32), torch.float32),
        sharding.ProcessGrid(4, 1))


def test_flagged_plain_versions_2d_match_the_serial_window():
    """Each block of a 4x4 split (every combination of physical and
    partition edges): `dt_fold_reference`, `update_reference` and
    `ghosts_reference` with the block's flags, on the block cut with its
    halo from a serial frame, give that window of the serial result; the
    folded quads give the serial dt.  This pins down what the kernels
    compute at a partition edge."""
    js, jst = _jax_case("supersonic_jet_varsc", SHAPE)
    solver = bodies.port_case("supersonic_jet_varsc", SHAPE, torch.float32)
    step, to_f, _ = F.build_fused_step(solver, plain=True)
    fs = to_f(_port_state(jst))
    for _ in range(3):
        fs = step(fs)
    prm, prof = F.make_params(solver)
    rho = solver.thermo.rho_from_p_T(fs.p[1:-1, 1:-1], fs.T[1:-1, 1:-1])
    sc = F._edge_frame(solver.tau_model.sc_update(solver.mesh, rho,
                                                  fs.sc[1:-1, 1:-1]))
    dt = F.dt_reference(prm, fs.T, fs.ux, fs.uy, fs.dt)
    new, side = F.update_reference(prm, fs.p, fs.T, fs.ux, fs.uy, sc, dt)
    ghosted = F.ghosts_reference(prm, [x.clone() for x in new], side,
                                 torch.as_tensor(prof))
    grid = sharding.ProcessGrid(4, 4)
    nxl, nyl = SHAPE[0] // 4, SHAPE[1] // 4
    quads = []
    for r in range(grid.size):
        ix, iy = grid.coords(r)
        bprm, bprof = F.block_params(
            solver, sharding.block_context(solver.mesh, grid, r))
        xs, ys = ix * nxl, iy * nyl
        win = (slice(xs, xs + nxl + 2), slice(ys, ys + nyl + 2))
        blk = [f[win].contiguous() for f in (fs.p, fs.T, fs.ux, fs.uy, sc)]
        quads.append(F.dt_fold_reference(bprm, *blk[1:4]))
        bnew, bside = F.update_reference(bprm, *blk, dt)
        for a, b in zip(new, bnew):
            assert torch.equal(a[win][1:-1, 1:-1], b[1:-1, 1:-1]), r
        for sd, phys in ((0, ix == 0), (1, ix == 3)):
            if phys:
                assert torch.equal(bside[sd, 1:-1],
                                   side[sd, ys + 1:ys + nyl + 1])
        F.ghosts_reference(bprm, bnew, bside, torch.as_tensor(bprof))
        # the halo exchange: rows over X at full width, then lanes over Y
        for b, g in zip(bnew, ghosted):
            gw = g[win]
            if ix > 0:
                b[0] = gw[0]
            if ix < 3:
                b[-1] = gw[-1]
            if iy > 0:
                b[:, 0] = gw[:, 0]
            if iy < 3:
                b[:, -1] = gw[:, -1]
            assert torch.equal(b, gw), r
    folded = torch.stack(quads).max(dim=0).values
    assert torch.equal(folded, F.dt_fold_reference(prm, fs.T, fs.ux, fs.uy))
    assert torch.equal(F.dt_apply_reference(prm, folded, fs.dt), dt)


def test_flagged_plain_versions_3d_match_the_serial_window():
    """The 3D flagged plain versions on each slab of a 4-slab x-ring, as
    the 2D test above; the sensor reads the exchanged halo planes."""
    js, jst = _jax_case("supersonic_jet_3d_varsc", SHAPE3)
    solver = bodies.port_case("supersonic_jet_3d_varsc", SHAPE3,
                              torch.float32)
    step, to_f, _ = F3.build_fused_step_3d(solver, plain=True)
    fs = to_f(_port_state(jst))
    for _ in range(3):
        fs = step(fs)
    prm, planes = F3.make_params(solver)
    planes = torch.as_tensor(planes)
    # the next step's sensor frame: fvc_smooth of the raw sensor, from its
    # carried first ring and flag
    sc = S.smooth_sensor(prm, fs.sc_s1, fs.sc_chg, S._smooth_plain,
                         F3.SMOOTH3_RINGS)
    dt = F3.dt_reference_3d(prm, fs.T, fs.ux, fs.uy, fs.uz, fs.dt)
    args = (fs.p, fs.T, fs.ux, fs.uy, fs.uz)
    new, side = F3.update_reference_3d(prm, *args, sc, dt)
    raw = F3.sensor_reference_3d(prm, new[0], new[1], sc)
    ghosted = F3.ghosts_reference_3d(prm, [x.clone() for x in new], side,
                                     planes)
    grid = sharding.ProcessGrid(4, 1)
    nxl = SHAPE3[0] // 4
    quads = []
    for r in range(4):
        bprm, _ = F3.block_params(
            solver, sharding.block_context(solver.mesh, grid, r))
        win = slice(r * nxl, r * nxl + nxl + 2)
        blk = [f[win].contiguous() for f in args + (sc,)]
        quads.append(F3.dt_fold_reference_3d(bprm, *blk[1:5]))
        bnew, bside = F3.update_reference_3d(bprm, *blk, dt)
        C = (slice(1, -1),) * 3
        for a, b in zip(new, bnew):
            assert torch.equal(a[win][C], b[C]), r
        F3.ghosts_reference_3d(bprm, bnew, bside, planes)
        for b, g in zip(bnew, ghosted):  # the plane exchange
            if r > 0:
                b[0] = g[win][0]
            if r < 3:
                b[-1] = g[win][-1]
            assert torch.equal(b, g[win]), r
        got = F3.sensor_reference_3d(bprm, bnew[0], bnew[1], blk[5])
        assert torch.equal(got, raw[r * nxl:(r + 1) * nxl]), r
    folded = torch.stack(quads).max(dim=0).values
    assert torch.equal(F3.dt_apply_reference_3d(prm, folded, fs.dt), dt)


def test_cli_devices_2x1_writes_the_serial_fields(tmp_path):
    """`run_case(..., devices="2x1", fused="always")` on the CPU runs K3's
    plain versions on two ranks; rank 0 writes what a serial fused run
    writes."""
    fixture = os.path.join(os.path.dirname(__file__), "fixtures", "jet_case")
    states, logs = [], {}
    for tag, kw in (("serial", {}), ("2x1", {"devices": "2x1"})):
        case = tmp_path / tag
        shutil.copytree(fixture, case)
        logs[tag] = []
        assert cli.run_case(str(case), max_steps=12, chunk=5, device="cpu",
                            fused="always", log=logs[tag].append, **kw) == 12
        ctrl = case / "system" / "controlDict"
        ctrl.write_text(ctrl.read_text().replace("startFrom       startTime;",
                                                 "startFrom       latestTime;"))
        states.append(foam_case.build_case(str(case), device="cpu")[1])
    assert any("build_sharded_fused_step (2x1 ranks)" in line
               for line in logs["2x1"])
    assert sum("writing fields" in line for line in logs["2x1"]) == 1
    for f in ("rho", "rhoU", "rhoE"):
        a, b = getattr(states[0], f), getattr(states[1], f)
        assert float((a - b).abs().max() / a.abs().max()) <= 1e-6, f
