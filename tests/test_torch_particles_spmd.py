"""The port's decomposed Lagrangian cloud on gloo ranks on the CPU, against
the serial port.  Mirrors tests/test_spmd.py's
test_particles_spmd_parity_4x2, which holds the JAX package's decomposed
particlesQGDFoam to its serial run.

The ranks run `parallel.sharding.build_spmd_step` (rank bodies in
tests/_torch_rank_bodies.py, no JAX): `to_spmd` gives each rank the
parcels resident in its block, and after each move the parcels that left
a block hop to the block their position lies in (`particles.migrate`).  A
4-rank world runs the two-way jet on 2x2 blocks with parcels planted across
both partition faces, the diagonal hop included; a cloud whose slots
overflow, at `to_spmd` and in a migration; and a parcel outside the mesh.
A 3-rank world runs a periodic box on 3x1 blocks with parcels that wrap
the periodic edge, once as the port routes them and once with the JAX
package's routing put back (a wrapped parcel goes the long way round, a
block a step, its drag landing on blocks that do not hold it), which must
part from the serial run.  Bound: fields within 1e-11 of their max (the
two-way sources are summed in another parcel order) and the active
parcels equal as a multiset.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import _torch_rank_bodies as bodies
from qgdsolver_tpu_torch import cases, cli, interop
from qgdsolver_tpu_torch.io import foam_case
from qgdsolver_tpu_torch.parallel import distributed, sharding
from qgdsolver_tpu_torch.solvers import common
from qgdsolver_tpu_torch.solvers.particles import PState

F64 = torch.float64
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = 1e-11


def _jet_cloud(shape=(64, 32)):
    """The jet and 48 parcels from a numpy seed, uniform over the domain,
    with tests/test_spmd.py's movers planted across the 2x2 partition
    faces (x = 2, y = 1), the diagonal hop included."""
    solver = bodies.cloud_case("cloud_jet", shape, F64)
    _, fs = cases.supersonic_jet(shape=shape, dtype=F64, device="cpu")
    rng = np.random.default_rng(2)
    n = 48
    x = np.stack([rng.uniform(0.3, 3.7, n), rng.uniform(0.3, 1.7, n)])
    u = rng.uniform(-40.0, 40.0, (2, n))
    planted = [((2.0 - 5e-5, 0.5), (60.0, 0.0)),
               ((2.0 + 5e-5, 0.7), (-60.0, 0.0)),
               ((0.5, 1.0 - 5e-5), (0.0, 60.0)),
               ((2.5, 1.0 + 5e-5), (0.0, -60.0)),
               ((2.0 - 5e-5, 1.0 - 5e-5), (60.0, 60.0))]  # diagonal hop
    for k, (pos, vel) in enumerate(planted):
        x[:, k], u[:, k] = pos, vel
    cloud = solver.cloud.make(x, u, np.full(n, 350.0), np.full(n, 5e-5),
                              dtype=F64)
    return solver, PState(fluid=fs, cloud=cloud), len(planted)


def _periodic_cloud(shape=(48, 12)):
    """The periodic box and 30 parcels, 6 heavy ones just below the
    periodic x edge at 100 m/s, wrapping within the run."""
    solver = bodies.cloud_case("cloud_periodic", shape, F64)
    mesh = solver.mesh
    fs = solver.fluid.init(
        p0=np.full(mesh.shape, 1e5), T0=np.full(mesh.shape, 300.0),
        U0=np.stack([np.full(mesh.shape, 20.0), np.zeros(mesh.shape)]))
    rng = np.random.default_rng(3)
    n = 30
    x = np.stack([rng.uniform(0.05, 0.95, n), rng.uniform(0.05, 0.45, n)])
    u = np.zeros((2, n))
    x[0, :6] = 1.0 - np.linspace(1e-4, 1.5e-3, 6)
    u[0, :6] = 100.0
    d = np.full(n, 5e-5)
    d[:6] = 5e-4  # heavy movers: their drag marks where it lands
    cloud = solver.cloud.make(x, u, np.full(n, 350.0), d, dtype=F64)
    return solver, PState(fluid=fs, cloud=cloud)


def _overflow_cloud():
    """Two parcels on the 2x2 jet: one in rank 0's block, one in rank 1's,
    the first moving into rank 1's block within the run."""
    solver = bodies.cloud_case("cloud_jet", (64, 32), F64)
    _, fs = cases.supersonic_jet(shape=(64, 32), dtype=F64, device="cpu")
    cloud = solver.cloud.make(np.array([[2.0 - 5e-5, 3.0], [0.5, 0.5]]),
                              np.array([[300.0, 0.0], [0.0, 0.0]]),
                              np.full(2, 350.0), np.full(2, 5e-5),
                              dtype=F64)
    return PState(fluid=fs, cloud=cloud)


def _outside_cloud():
    """The jet with one active parcel beyond the mesh's x end."""
    s = _overflow_cloud()
    x = s.cloud.x.clone()
    x[0, 1] = 4.5
    return s._replace(cloud=s.cloud._replace(x=x))


def _np(s):
    return interop.state_to_numpy(s)


JET_STEPS = 10
PERIODIC_STEPS = 8


@pytest.fixture(scope="module")
def world4():
    """The 2x2 jobs on one 4-rank world."""
    _, s, _ = _jet_cloud()
    jobs = [("cloud_jet", (64, 32), (2, 2), JET_STEPS, _np(s), None, None),
            # a capacity of 1 slot a rank: the planted cloud overflows at
            # to_spmd, the two-parcel one when its mover arrives
            ("cloud_jet", (64, 32), (2, 2), JET_STEPS, _np(s), 1, None),
            ("cloud_jet", (64, 32), (2, 2), 4, _np(_overflow_cloud()), 1,
             None),
            ("cloud_jet", (64, 32), (2, 2), 1, _np(_outside_cloud()), None,
             None)]
    return distributed.spawn(bodies.run_cloud_jobs, 4, jobs, "cpu",
                             device="cpu", timeout=240)


@pytest.fixture(scope="module")
def world3():
    """The periodic box on 3x1 blocks, as the port routes the wrapped
    parcels and with the JAX package's routing put back."""
    _, s = _periodic_cloud()
    jobs = [("cloud_periodic", (48, 12), (3, 1), PERIODIC_STEPS, _np(s),
             None, fault) for fault in (None, "long_way")]
    return distributed.spawn(bodies.run_cloud_jobs, 3, jobs, "cpu",
                             device="cpu", timeout=240)


def _serial(solver, s, steps):
    return _np(common.run_steps(solver.make_step(), s, steps))


def _multiset(c):
    m = c.active > 0.5
    rows = np.concatenate([c.x[:, m], c.u[:, m], c.Tp[None, m],
                           c.dp[None, m]])
    return rows[:, np.lexsort(rows)]


def _field_gap(ref, got):
    return max(np.abs(getattr(ref.fluid, f) - getattr(got.fluid, f)).max()
               / np.abs(getattr(ref.fluid, f)).max()
               for f in ("rho", "rhoU", "rhoE"))


def _cloud_gap(ref, got):
    a, b = _multiset(ref.cloud), _multiset(got.cloud)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b) / np.maximum(
        np.abs(a).max(axis=1, keepdims=True), 1e-300)))


def test_jet_2x2_matches_serial_port(world4):
    """Every rank's gathered fields within 1e-11 of the serial port's and
    the same parcels; the planted movers changed blocks (the diagonal one
    in two hops of one step)."""
    solver, s0, n_planted = _jet_cloud()
    ref = _serial(solver, s0, JET_STEPS)
    for rank in world4:
        kind, got = rank[0]
        assert kind == "ok", got
        assert _field_gap(ref, got) <= TOL
        assert _cloud_gap(ref, got) <= TOL
        assert int(got.cloud.dropped) == 0
        # the slot blocks join in rank order: 4 x 48 slots
        assert got.cloud.x.shape == (2, 4 * 48)
    grid = sharding.ProcessGrid(2, 2)

    def ranks(x):
        return (np.clip((x[0] // 2.0).astype(int), 0, 1)
                + 2 * np.clip((x[1] // 1.0).astype(int), 0, 1))

    moved = ranks(ref.cloud.x[:, :n_planted]) != ranks(
        s0.cloud.x[:, :n_planted].numpy())
    assert moved.sum() == n_planted and grid.size == 4
    assert ranks(ref.cloud.x[:, 4:5])[0] == 3  # the diagonal mover


def test_overflow_raises_with_the_count(world4):
    """Slots too few: to_spmd refuses the planted cloud naming the rank's
    residents; a migration into a full rank drops the arrival, and the
    dropped count read after the run (as the CLI reads it once a chunk)
    raises with the count, on every rank."""
    for rank in world4:
        kind, cls, msg = rank[1]
        assert (kind, cls) == ("error", "ValueError")
        assert "parcels > capacity 1" in msg
        kind, cls, msg = rank[2]
        assert (kind, cls) == ("error", "RuntimeError")
        assert "dropped 1 parcels" in msg


def test_non_resident_cloud_refused(world4):
    """A parcel outside the mesh lies in no rank's block: to_spmd
    refuses it."""
    for rank in world4:
        kind, cls, msg = rank[3]
        assert (kind, cls) == ("error", "ValueError")
        assert "outside the mesh" in msg


def test_periodic_3x1_matches_serial_port(world3):
    """The wrapped parcels go to the cyclic neighbour across the periodic
    edge: the 3x1 run is the serial run (fields and parcels)."""
    solver, s0 = _periodic_cloud()
    ref = _serial(solver, s0, PERIODIC_STEPS)
    assert (ref.cloud.x[0, :6] < 0.2).all()  # every planted parcel wrapped
    for rank in world3:
        kind, got = rank[0]
        assert kind == "ok", got
        assert _field_gap(ref, got) <= TOL
        assert _cloud_gap(ref, got) <= TOL


def test_long_way_round_parts_from_serial(world3):
    """With the JAX package's routing put back the wrapped parcels travel
    through the middle block, and the run parts from the serial one by far
    more than the bound."""
    solver, s0 = _periodic_cloud()
    ref = _serial(solver, s0, PERIODIC_STEPS)
    for rank in world3:
        kind, got = rank[1]
        assert kind == "ok", got
        assert _field_gap(ref, got) > 1e3 * TOL


def test_tabulated_reacting_refused(tmp_path):
    """A DeviceISAT table is per-process state: spmd_supported names the
    reason, build_spmd_step and the CLI's --devices refuse the case."""
    case = str(tmp_path / "reacting")
    shutil.copytree(os.path.join(FIX, "reacting_case"), case)
    solver, _ = foam_case.build_case(case, device="cpu")
    reason = sharding.spmd_supported(solver)
    assert reason is not None and "DeviceISAT" in reason
    with pytest.raises(NotImplementedError, match="DeviceISAT"):
        sharding.build_spmd_step(solver, sharding.ProcessGrid(1, 1))
    with pytest.raises(RuntimeError, match="DeviceISAT chemistry table"):
        cli.run_case(case, max_steps=1, log=lambda *_: None, device="cpu",
                     devices="2x1")
