"""The port's Lagrangian clouds and particle solvers against the JAX
package's.

Mirrors tests/test_particles.py and the particle parts of
tests/test_foam_case_e2e.py.  `ThermoCloud.evolve` (owner cells, Schiller-
Naumann drag, Ranz-Marshall heat, the walls, the two-way sources),
particlesQGDFoam (QGDFoam's `external_sources` hook), particlesQHDFoam
(one-way) and reactingLagrangianQGDFoam (the evaporating cloud through the
reacting solver's `sources` hook) are held to the JAX package float64 from
the same numpy-seeded States: one-step windows within 1e-9 of each field's
max without a CG, 2*cg_tol with one (CG counts equal).  The hook itself is
held through a tuple of sources and through a callable of dt.  The
analytic oracles run on the port: the Stokes drag relaxation, two-way
momentum conservation, parcels that escape, and the gas gaining the mass
the parcels evaporate.  tests/fixtures/particles_case builds, steps,
writes, checkpoints and runs through the CLI as the JAX package's does.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import same_iterations, solve_logs
from qgdsolver_tpu import cli as jcli
from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.core.mesh import Mesh as JMesh
from qgdsolver_tpu.io import foam_case as jfc
from qgdsolver_tpu.physics import species as jsp
from qgdsolver_tpu.physics.qgdcoeffs import ConstScPrModel1, HbyUQHD
from qgdsolver_tpu.physics.thermo import (ConstTransport, PerfectGasThermo,
                                          RhoConstThermo)
from qgdsolver_tpu.solvers import common as jcommon
from qgdsolver_tpu.solvers import particles as jp
from qgdsolver_tpu.solvers.qgd import QGDFoam as JQGD
from qgdsolver_tpu.solvers.qhd import QHDFoam as JQHD
from qgdsolver_tpu.solvers.reacting import ReactingQGDFoam as JReacting
from qgdsolver_tpu_torch import cases, cli, interop
from qgdsolver_tpu_torch.core.mesh import Mesh
from qgdsolver_tpu_torch.io import foam_case, foam_write
from qgdsolver_tpu_torch.solvers import common, particles
from qgdsolver_tpu_torch.utils import checkpoint

F64 = torch.float64
ROUND_OFF = 1e-9
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
PER = jbc.FieldBCs.uniform(jbc.Periodic(), 2)
CLOUD = ("x", "u", "Tp", "dp", "active")


def _gap(a, b, floor=0.0):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b))
                 / max(np.max(np.abs(a)), floor, 1e-300))


def _np(s):
    return jax.tree.map(np.asarray, s)


def _fields(s):
    return [f for f, v in zip(s._fields, s)
            if isinstance(v, np.ndarray) and v.ndim > 0]


def _windows(jsolver, js, n, monkeypatch, floors=None):
    """n steps of a JAX Lagrangian solver and n one-step windows of the
    port's from the JAX PStates: every fluid field and cloud array within
    1e-9 of its max (2*cg_tol for the fluid with a CG, each CG's
    iteration count equal).  Returns the JAX PStates."""
    floors = floors or {}
    tsolver = interop.solver_from(jsolver, dtype=F64)
    jstep = jax.jit(jsolver.make_step())
    tstep = tsolver.make_step()
    cg = getattr(jsolver.fluid, "implicit_diffusion", False)
    tol = 2 * jsolver.fluid.cg_tol if cg else ROUND_OFF
    states = [js]
    with solve_logs(monkeypatch) as (jlog, tlog):
        for _ in range(n):
            states.append(jstep(states[-1]))
        jax.block_until_ready(states[-1])
        for k in range(n):
            ref = _np(states[k + 1])
            got = interop.state_to_numpy(tstep(interop.state_from_numpy(
                _np(states[k]), dtype=F64)))
            for f in _fields(ref.fluid):
                gap = _gap(getattr(ref.fluid, f), getattr(got.fluid, f),
                           floors.get(f, 0.0))
                assert gap <= tol, (k, f, gap)
            for f in CLOUD:
                gap = _gap(getattr(ref.cloud, f), getattr(got.cloud, f))
                assert gap <= tol, (k, f, gap)
    same_iterations(jlog, tlog, getattr(jsolver.fluid, "cg_tol", 0.0))
    return states


def _gas(shape, u=1e-3):
    return (np.full(shape, 1.2),
            np.stack([np.full(shape, u), np.zeros(shape)]),
            np.full(shape, 300.0))


def _evolve_both(jcloud, mesh_shape, c, dt, gas, lengths=(1.0, 1.0)):
    """(JAX, port) results of one evolve on the same cloud and gas."""
    jmesh = JMesh.uniform(mesh_shape, lengths=lengths, dtype=np.float64)
    mesh = Mesh.uniform(mesh_shape, lengths=lengths, dtype=F64)
    rho, U, T = gas
    jc = jcloud.make(*(jnp.asarray(v) for v in c))
    tcloud = interop._carried(jcloud)
    tcl = tcloud.make(*c, dtype=F64)
    jout = jcloud.evolve(jc, jmesh, dt, rho_g=jnp.asarray(rho),
                         U_g=jnp.asarray(U), T_g=jnp.asarray(T))
    tout = tcloud.evolve(tcl, mesh, dt, rho_g=torch.as_tensor(rho),
                         U_g=torch.as_tensor(U), T_g=torch.as_tensor(T))
    return jout, tout, tcloud, tcl, mesh


def test_cloud_drag_relaxation_analytic():
    """Stokes regime: the parcel's velocity relaxes to the gas's with
    tau_p = rho_p dp^2/(18 mu) (Schiller-Naumann's finite-Re factor
    included) to 1e-6, as the JAX package's evolve does."""
    cloud = jp.ThermoCloud(rho_p=1000.0, mu_g=1.8e-5, two_way=False,
                           wall="periodic")
    c = (np.array([[0.5], [0.5]]), np.zeros((2, 1)), np.array([300.0]),
         np.array([20e-6]))
    tau_p = 1000.0 * 20e-6 ** 2 / (18 * 1.8e-5)
    jout, tout, *_ = _evolve_both(cloud, (16, 16), c, 0.3 * tau_p,
                                  _gas((16, 16)))
    for f in CLOUD:
        assert _gap(getattr(jout[0], f), getattr(tout[0], f)) <= ROUND_OFF
    Re = 1.2 * 1e-3 * 20e-6 / 1.8e-5
    expected = 1e-3 * (1 - np.exp(-0.3 * (1 + 0.15 * Re ** 0.687)))
    np.testing.assert_allclose(float(tout[0].u[0, 0]), expected, rtol=1e-6)


def test_two_way_momentum_conservation():
    """The exchange sources balance the parcels' gain: sum(rhoUSu V) dt =
    -(parcel momentum gain) to 1e-10; the sources and the moved cloud
    equal the JAX package's."""
    cloud = jp.ThermoCloud(rho_p=500.0, two_way=True, wall="periodic")
    rng = np.random.default_rng(0)
    n = 20
    c = (rng.uniform(0.1, 0.9, (2, n)), np.zeros((2, n)), np.full(n, 300.0),
         np.full(n, 100e-6))
    dt = 1e-4
    jout, tout, tcloud, tcl, mesh = _evolve_both(
        cloud, (8, 8), c, dt, _gas((8, 8), u=2.0))
    for j, t in zip(jout[1:], tout[1:]):
        assert _gap(j, t.numpy()) <= ROUND_OFF
    gain = float(torch.sum(tcloud.mass(tcl) * (tout[0].u[0] - tcl.u[0])))
    src = float(torch.sum(tout[1][0] * mesh.cell_volume)) * dt
    np.testing.assert_allclose(src, -gain, rtol=1e-10)


def test_owner_cells_in_float64():
    """A float32 cloud on a float32 mesh is located in float64 against the
    face coordinates, as the JAX package promotes it under x64: positions
    one float32 ulp either side of every face fall in the same cells as
    there (an all-float32 search misplaces some)."""
    jmesh = JMesh.uniform((40, 24), lengths=(0.7, 0.3), dtype=np.float32)
    mesh = Mesh.uniform((40, 24), lengths=(0.7, 0.3), dtype=torch.float32)
    xf = np.asarray(mesh.x_faces[0][1:-1], dtype=np.float32)
    xs = np.concatenate([np.nextafter(xf, np.float32(0)), xf,
                         np.nextafter(xf, np.float32(1))])
    x = np.stack([xs, np.full_like(xs, 0.15)])
    cloud = jp.ThermoCloud()
    jidx = cloud.locate(cloud.make(jnp.asarray(x), jnp.zeros_like(x),
                                   jnp.zeros(len(xs)), jnp.zeros(len(xs))),
                        jmesh)
    tidx = particles.owner_cells(torch.as_tensor(x), mesh)
    for a in range(2):
        assert np.array_equal(np.asarray(jidx[a]), tidx[a].numpy())
    f32 = torch.searchsorted(torch.as_tensor(mesh.x_faces[0],
                                             dtype=torch.float32),
                             torch.as_tensor(xs), right=True) - 1
    assert not torch.equal(f32, tidx[0])


def _jqgd_periodic():
    mesh = JMesh.uniform((24, 12), lengths=(1.0, 0.5), dtype=np.float64)
    return JQGD(mesh=mesh, thermo=PerfectGasThermo(R=287.0, Cp=1004.5),
                tau_model=ConstScPrModel1(alpha=0.5), bc_U=PER, bc_p=PER,
                bc_T=PER, time=jcommon.TimeControls(max_co=0.3, max_dt=1e-4,
                                                    dt0=1e-6))


def _particles_qgd():
    fluid = _jqgd_periodic()
    solver = jp.ParticlesQGDFoam(fluid=fluid, cloud=jp.ThermoCloud(
        rho_p=800.0, two_way=True, wall="periodic"))
    shape = fluid.mesh.shape
    n = 50
    rng = np.random.default_rng(1)
    s = solver.init(
        p0=jnp.full(shape, 1e5), T0=jnp.full(shape, 300.0),
        U0=jnp.stack([jnp.full(shape, 20.0), jnp.zeros(shape)]),
        x_p=jnp.asarray(np.stack([rng.uniform(0.1, 0.9, n),
                                  rng.uniform(0.1, 0.4, n)])),
        u_p=jnp.zeros((2, n)), T_p=jnp.full((n,), 350.0),
        d_p=jnp.full((n,), 50e-6))
    return solver, s


def test_particles_qgd_two_way(monkeypatch):
    """particlesQGDFoam, periodic: 3 windows against the JAX package; over
    30 steps of the port the fluid stays finite, the parcels are dragged
    downstream (mean u > 0.1) and the hot parcels cool."""
    solver, s = _particles_qgd()
    _windows(solver, s, 3, monkeypatch)
    tsolver = interop.solver_from(solver, dtype=F64)
    ts = common.run_steps(tsolver.make_step(),
                          interop.state_from_numpy(_np(s), dtype=F64), 30)
    assert bool(torch.isfinite(ts.fluid.rho).all())
    assert float(ts.cloud.u[0].mean()) > 0.1
    assert float(ts.cloud.Tp.max()) < 350.0


def test_particles_qhd_one_way(monkeypatch):
    """particlesQHDFoam with escaping walls: 3 windows against the JAX
    package (its pressure CG counts equal); over 40 steps of the port the
    parcels near the right wall escape and deactivate."""
    mesh = JMesh.uniform((16, 16), lengths=(1.0, 1.0), dtype=np.float64)
    fluid = JQHD(mesh=mesh, thermo=RhoConstThermo(rho0=1.0, Cp=1000.0,
                                                  mu0=1e-3, Pr=1.0),
                 tau_model=HbyUQHD(alpha=0.2, U0=1.0), g=(0.0, 0.0),
                 bc_U=PER, bc_T=PER, bc_p=PER,
                 time=jcommon.TimeControls(max_co=0.3, max_dt=5e-3,
                                           dt0=1e-3))
    solver = jp.ParticlesQHDFoam(fluid=fluid, cloud=jp.ThermoCloud(
        rho_p=2000.0, two_way=False, wall="escape"))
    n = 10
    s = solver.init(
        U0=jnp.stack([jnp.full(mesh.shape, 1.0), jnp.zeros(mesh.shape)]),
        T0=jnp.zeros(mesh.shape),
        x_p=jnp.asarray(np.stack([np.full(n, 0.9), np.linspace(0.2, 0.8,
                                                               n)])),
        u_p=jnp.stack([jnp.full((n,), 1.0), jnp.zeros((n,))]),
        T_p=jnp.zeros((n,)), d_p=jnp.full((n,), 1e-4))
    _windows(solver, s, 3, monkeypatch, floors={"T": 1.0, "p": 1.0})
    tsolver = interop.solver_from(solver, dtype=F64)
    ts = common.run_steps(tsolver.make_step(),
                          interop.state_from_numpy(_np(s), dtype=F64), 40)
    assert float(ts.cloud.active.sum()) < n
    assert bool(torch.isfinite(ts.fluid.U).all())


def test_reacting_lagrangian_evaporation(monkeypatch):
    """reactingLagrangianQGDFoam with implicit diffusion: 3 windows
    against the JAX package; over 25 steps of the port the parcels
    evaporate into the vapour specie and the gas gains the mass they lose
    (to 1e-4)."""
    mesh = JMesh.uniform((12, 12), lengths=(0.5, 0.5), dtype=np.float64)
    mix = jsp.MixtureThermo(
        species=(jsp.Specie(name="vapor", W=18.0, Cp=1900.0, Sc=0.7),
                 jsp.Specie(name="air", W=29.0, Cp=1005.0, Sc=1.0)),
        inert_index=1, transport=ConstTransport(1.8e-5), Pr=0.7)
    fluid = JReacting(mesh=mesh, mixture=mix,
                      tau_model=ConstScPrModel1(alpha=0.5),
                      implicit_diffusion=True, bc_U=PER, bc_p=PER, bc_T=PER,
                      bc_Y=PER, time=jcommon.TimeControls(
                          max_co=0.3, max_dt=2e-5, dt0=1e-6))
    solver = jp.ReactingLagrangianQGDFoam(fluid=fluid, cloud=jp.ReactingCloud(
        rho_p=1000.0, two_way=True, wall="periodic", evap_specie=0,
        K_evap=1e-7, latent_heat=2.3e6))
    n = 16
    rng = np.random.default_rng(2)
    s = solver.init(
        p0=jnp.full(mesh.shape, 1e5), T0=jnp.full(mesh.shape, 350.0),
        U0=jnp.zeros((2,) + mesh.shape),
        Y0=jnp.stack([jnp.zeros(mesh.shape), jnp.ones(mesh.shape)]),
        x_p=jnp.asarray(rng.uniform(0.1, 0.4, (2, n))),
        u_p=jnp.zeros((2, n)), T_p=jnp.full((n,), 330.0),
        d_p=jnp.full((n,), 200e-6))
    # the gas starts at rest: its momentum is the parcels' (~1e-9), held
    # against a 1 kg/(m^2 s) scale
    _windows(solver, s, 3, monkeypatch, floors={"rhoU": 1.0})
    tsolver = interop.solver_from(solver, dtype=F64)
    ts0 = interop.state_from_numpy(_np(s), dtype=F64)
    vol = tsolver.mesh.cell_volume
    m0 = float(tsolver.cloud.mass(ts0.cloud).sum())
    g0 = float((ts0.fluid.rho * vol).sum())
    ts = common.run_steps(tsolver.make_step(), ts0, 25)
    m1 = float(tsolver.cloud.mass(ts.cloud).sum())
    g1 = float((ts.fluid.rho * vol).sum())
    assert m1 < m0
    np.testing.assert_allclose(g1 - g0, m0 - m1, rtol=1e-4)
    assert float(ts.fluid.Y[0].max()) > 0.0
    assert bool(torch.isfinite(ts.fluid.T).all())


@pytest.mark.parametrize("form", ["tuple", "callable"])
def test_external_sources_hook_matches_jax(form):
    """QGDFoam's make_step(external_sources=True) takes (state, srcs):
    srcs a tuple (rhoSu, rhoUSu, rhoESu) of fields and numbers, or a
    callable of the dt the step applies.  3 steps from the same seeded
    State within 1e-9 of each field's max of the JAX package's; the
    sources move the State off the sourceless step."""
    jsolver = _jqgd_periodic()
    shape = jsolver.mesh.shape
    rng = np.random.default_rng(9)
    js = jsolver.init(p0=jnp.asarray(1e5 * (1 + 0.01 * rng.random(shape))),
                      T0=jnp.full(shape, 300.0),
                      U0=jnp.asarray(rng.normal(0.0, 5.0, (2,) + shape)))
    su = [rng.normal(0.0, 1.0, shape), rng.normal(0.0, 50.0, (2,) + shape),
          rng.normal(0.0, 1e4, shape)]

    def srcs(xp, conv):
        vals = (0.0, conv(su[1]), conv(su[2])) if form == "tuple" else None
        if vals is not None:
            return vals
        return lambda dt: (conv(su[0]) * dt * 1e6, conv(su[1]),
                           conv(su[2]) / (1.0 + dt * 1e5))

    tsolver = interop.solver_from(jsolver, dtype=F64)
    jstep = jax.jit(lambda s: jsolver.make_step(external_sources=True)(
        s, srcs(jnp, jnp.asarray)))
    tstep = tsolver.make_step(external_sources=True)
    plain = tsolver.make_step()
    s = js
    for _ in range(3):
        nxt = jstep(s)
        ts = interop.state_from_numpy(_np(s), dtype=F64)
        got = tstep(ts, srcs(torch, torch.as_tensor))
        for f in ("rho", "rhoU", "rhoE", "dt"):
            assert _gap(getattr(nxt, f), getattr(got, f).numpy()) \
                <= ROUND_OFF, f
        assert _gap(got.rhoE.numpy(), plain(ts).rhoE.numpy()) > 1e-8
        s = nxt


def _particles_copy(tmp_path, name="particles"):
    case = tmp_path / name
    shutil.copytree(os.path.join(FIX, "particles_case"), case)
    return case


def test_particles_case_builds_and_steps_as_jax(tmp_path):
    """tests/fixtures/particles_case (tests/test_foam_case_e2e.py:201):
    the cloud's constants and its three manual parcels; float32 by
    default, as the QGD solvers; float64 on request stepping 5 steps
    within 1e-9 of the JAX package's fields and parcels, the parcels
    advected downstream by the jet."""
    case = str(_particles_copy(tmp_path))
    solver, s = foam_case.build_case(case, device="cpu")
    assert isinstance(solver, particles.ParticlesQGDFoam)
    assert solver.cloud.rho_p == 2500.0 and solver.cloud.Cp_p == 900.0
    assert s.cloud.x.shape == (2, 3) and s.cloud.x.dtype == torch.float32
    np.testing.assert_allclose(s.cloud.dp.numpy(), 5e-5, rtol=1e-6)
    jsolver, js = jfc.build_case(case)
    solver, s = foam_case.build_case(case, device="cpu", dtype=F64)
    jref = jcommon.run_steps(jax.jit(jsolver.make_step()), js, 5)
    got = interop.state_to_numpy(common.run_steps(solver.make_step(), s, 5))
    for f in ("rho", "rhoU", "rhoE"):
        assert _gap(getattr(jref.fluid, f), getattr(got.fluid, f)) \
            <= ROUND_OFF, f
    for f in CLOUD:
        assert _gap(getattr(jref.cloud, f), getattr(got.cloud, f)) \
            <= ROUND_OFF, f
    assert float(np.max(got.cloud.x[0] - s.cloud.x[0].numpy())) > 0.0


def test_particles_case_writes_and_checkpoints(tmp_path):
    """The fluid's U, p and T are written (the parcels live in the
    checkpoint); a PState round-trips through save/restore leaf for leaf,
    its cloud's five arrays after the fluid's."""
    case = _particles_copy(tmp_path)
    solver, s = foam_case.build_case(str(case), device="cpu")
    s = common.run_steps(solver.make_step(), s, 3)
    tdir = foam_write.write_state(str(case), solver, s)
    assert sorted(os.listdir(tdir)) == ["T", "U", "p"]
    checkpoint.save(s, str(tmp_path / "ck"), 3)
    back, step = checkpoint.restore_latest(s, str(tmp_path / "ck"))
    assert step == 3 and isinstance(back, particles.PState)
    leaves = checkpoint._flatten(s)
    assert len(leaves) == len(checkpoint._flatten(s.fluid)) + 5
    for a, b in zip(leaves, checkpoint._flatten(back)):
        assert torch.equal(a, b)


def test_particles_cli_matches_jax_cli(tmp_path):
    """Both packages' CLIs on two copies of particles_case, 20 steps with
    a write every 10: the same time directories; the written fields read
    back within 1e-4 of their max (the port's float32 against the JAX
    package's float64, as tests/test_torch_cli.py holds the jet)."""
    def run(name, fn):
        case = _particles_copy(tmp_path, name)
        ctrl = case / "system" / "controlDict"
        text = ctrl.read_text().replace(
            "writeControl    adjustableRunTime;", "writeControl    timeStep;"
        ).replace("writeInterval   0.001;", "writeInterval   10;")
        ctrl.write_text(text)
        assert fn(str(case)) == 20
        dirs = sorted(float(d) for d in os.listdir(case)
                      if d not in ("0", "system", "constant"))
        ctrl.write_text(text.replace("startFrom       startTime;",
                                     "startFrom       latestTime;"))
        return case, dirs

    jcase, jdirs = run("j", lambda c: jcli.run_case(
        c, max_steps=20, chunk=10, log=lambda *_: None, fused="never"))
    tcase, tdirs = run("t", lambda c: cli.run_case(
        c, max_steps=20, chunk=10, log=lambda *_: None, device="cpu"))
    assert len(jdirs) == len(tdirs) == 2
    np.testing.assert_allclose(tdirs, jdirs, rtol=1e-5)
    _, a = jfc.build_case(str(jcase))
    _, b = foam_case.build_case(str(tcase), device="cpu")
    for f in ("rho", "rhoU", "rhoE"):
        assert _gap(getattr(a.fluid, f), getattr(b.fluid, f).numpy()) \
            < 1e-4, f


def test_raise_dropped_reads_a_serial_cloud_as_clean():
    """A serial cloud carries no dropped count: the CLI's read passes
    (a decomposed one's is tested in tests/test_torch_particles_spmd.py)."""
    _, fs = cases.supersonic_jet(shape=(8, 4), dtype=F64, device="cpu")
    cloud = particles.ThermoCloud().make(np.zeros((2, 1)), np.zeros((2, 1)),
                                         np.ones(1), np.ones(1), dtype=F64)
    particles.raise_dropped(particles.PState(fluid=fs, cloud=cloud))
    with pytest.raises(RuntimeError, match="dropped 2 parcels"):
        particles.raise_dropped(particles.PState(
            fluid=fs, cloud=cloud._replace(dropped=torch.tensor(2))))
