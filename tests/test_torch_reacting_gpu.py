"""The Lagrangian and reacting torch ops on the card against the CPU (marked
`gpu`: they skip where no CUDA device exists; run them there with
`python -m pytest tests/test_torch_reacting_gpu.py -m gpu -q`).

* DeviceISAT's writer (per slot, the largest cell index that maps to it,
  found by a `scatter_reduce` amax and written without collisions) on a
  saturated table: the card's table and retrieved rates bitwise the
  CPU's over three calls, the counters equal.
* Cloud deposition (`ops.deposit`: each cell's parcels summed in parcel
  order from zero, csrc/deposit.cu on the card): each cell within
  (k + 4) eps sum_k (1 + 1/f) |term| of the CPU's, k the parcels in the
  cell, f = 1 - exp(-dt/tau) of the parcel's drag or heat relaxation, the
  smaller (an ulp of exp on either device is 1/f ulps of f), and the
  moved parcels within 1e-13 of their max.  The deposition kernel itself
  equals its plain version (`index_add_` on the CPU) bit for bit on the
  same per-parcel terms, the jet's and an evaporating cloud's, and two
  runs of the two-way float32 jet from one State are equal bit for bit.
* The deposition kernel on tests/test_torch_deposit.py's duplication
  patterns (every parcel in one cell, a 4:1 ratio, a third inactive, and
  inactive parcels holding NaN in a row that is not all zero), float32
  and float64: bitwise its plain version on the CPU.
* particlesQGDFoam, 5 float64 steps on the card within 1e-9 of each field's
  max of the CPU's.
"""

import numpy as np
import pytest
import torch

from qgdsolver_tpu_torch import cases
from qgdsolver_tpu_torch.core.mesh import Mesh
from qgdsolver_tpu_torch.physics import chemistry
from qgdsolver_tpu_torch.solvers import common, particles

pytestmark = pytest.mark.gpu
F64 = torch.float64


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


class _Mix:
    n_species = 2


def _compute(Y, rho, T, p, dt, miss=None):
    return (-0.1 * Y[0] * T, 0.1 * Y[0] * T), 1e3 * Y[0] * T


def test_device_isat_writer_card_equals_cpu(device):
    """65536 cells, keys drawn from a few thousand compositions, into 1024
    slots: every call's rates and the table after it bitwise the CPU's."""
    rng = np.random.default_rng(0)
    tab = chemistry.DeviceISAT(tol=1e-3, capacity=1024)
    tables = {d: tab.init(2, dtype=F64, device=d) for d in ("cpu", device)}
    for call in range(3):
        pick = rng.integers(0, 3000 + 500 * call, 65536)
        T = 800.0 + 0.5 * pick
        Y0 = (pick % 97) / 200.0
        args = {d: (_Mix, tuple(torch.as_tensor(y, device=d)
                                for y in (Y0, 1.0 - Y0)),
                    torch.ones(65536, dtype=F64, device=d),
                    torch.as_tensor(T, device=d),
                    torch.full((65536,), 1e5, dtype=F64, device=d), 1e-6)
                for d in ("cpu", device)}
        out = {}
        for d in ("cpu", device):
            out[d], tables[d] = tab.rates_stateful(tables[d], _compute,
                                                   *args[d])
        (rc, qc), (rg, qg) = out["cpu"], out[device]
        assert torch.equal(qc, qg.cpu())
        assert all(torch.equal(a, b.cpu()) for a, b in zip(rc, rg))
        for k, v in tables["cpu"].items():
            assert torch.equal(v, tables[device][k].cpu()), (call, k)
    assert chemistry.DeviceISAT.counter(tables[device], "evictions") > 0


def test_cloud_deposition_within_the_atomics_bound(device):
    """One two-way evolve of 65536 parcels on a 256x128 float64 mesh, on
    the card and on the CPU."""
    shape = (256, 128)
    rng = np.random.default_rng(1)
    n = 65536
    gas = (rng.uniform(0.5, 1.5, shape),
           rng.normal(0.0, 50.0, (2,) + shape),
           rng.uniform(250.0, 400.0, shape))
    parcels = (np.stack([rng.uniform(0.0, 4.0, n), rng.uniform(0.0, 2.0, n)]),
               rng.normal(0.0, 20.0, (2, n)), rng.uniform(300.0, 350.0, n),
               rng.uniform(2e-5, 1e-4, n))
    cloud = particles.ThermoCloud(rho_p=2500.0, Cp_p=900.0, two_way=True)
    out = {}
    for d in ("cpu", device):
        mesh = Mesh.uniform(shape, lengths=(4.0, 2.0), dtype=F64, device=d)
        c = cloud.make(*parcels, device=d, dtype=F64)
        rho, U, T = (torch.as_tensor(g, device=d) for g in gas)
        out[d] = cloud.evolve(c, mesh, 1e-5, rho_g=rho, U_g=U, T_g=T)
    mesh = Mesh.uniform(shape, lengths=(4.0, 2.0), dtype=F64)
    (cc, uc, ec), (cg, ug, eg) = out["cpu"], out[device]
    for f in ("x", "u", "Tp", "dp", "active"):
        a, b = getattr(cc, f), getattr(cg, f).cpu()
        assert float((a - b).abs().max()) <= 1e-13 * float(a.abs().max()), f
    # the bound from the CPU's own terms: k parcels a cell, their |terms|
    c0 = cloud.make(*parcels, dtype=F64)
    flat = particles._flat(particles.owner_cells(c0.x, mesh), mesh)
    count = torch.zeros(shape[0] * shape[1], dtype=F64).index_add_(
        0, flat, torch.ones(n, dtype=F64)).reshape(shape)
    eps = torch.finfo(F64).eps
    for src_c, src_g, rows in ((uc, ug, 2), (ec, eg, 1)):
        src_c, src_g = src_c.reshape(rows, *shape), src_g.reshape(
            rows, *shape).cpu()
        # sum |term| a cell, recomputed by the same formulas in absolute
        # value: the cell's share of |m du w| and |q + work| w
        mag = _abs_terms(cloud, c0, mesh, gas, flat, rows)
        bound = (count + 4.0) * eps * mag
        assert bool(((src_c - src_g).abs() <= bound).all())
        assert float(src_c.abs().max()) > 0.0


def _abs_terms(cloud, c, mesh, gas, flat, rows):
    """sum over a cell's parcels of (1 + 1/f) |the deposited term| (per
    component for the momentum), the terms by evolve's formulas."""
    rho, U, T = (torch.as_tensor(g) for g in gas)
    rho_at = rho.reshape(-1)[flat]
    T_at = T.reshape(-1)[flat]
    U_at = torch.stack([U[a].reshape(-1)[flat] for a in range(2)])
    m = cloud.mass(c)
    du = U_at - c.u
    Re = torch.clamp(rho_at * du.norm(dim=0) * c.dp / cloud.mu_g, min=1e-12)
    tau_p = cloud.rho_p * c.dp ** 2 / (18.0 * cloud.mu_g) / (
        1.0 + 0.15 * Re ** 0.687)
    fac = 1.0 - torch.exp(-1e-5 / tau_p)
    dup = du * fac
    Nu = 2.0 + 0.6 * torch.sqrt(Re) * cloud.Pr_g ** (1.0 / 3.0)
    h = Nu * cloud.kappa_g / c.dp
    tau_T = m * cloud.Cp_p / (h * np.pi * c.dp ** 2)
    facT = 1.0 - torch.exp(-1e-5 / tau_T)
    # an ulp of exp on either device is 1/fac ulps of 1 - exp(-dt/tau)
    w = (1.0 + 1.0 / torch.minimum(fac, facT)) / (
        torch.broadcast_to(mesh.cell_volume, mesh.shape).reshape(-1)[flat]
        * 1e-5)
    if rows == 2:
        vals = [(m * dup[a] * w).abs() for a in range(2)]
    else:
        dTp = (T_at - c.Tp) * facT
        vals = [(m * cloud.Cp_p * dTp).abs() * w
                + (m * (dup * U_at).sum(0)).abs() * w]
    ncell = mesh.shape[0] * mesh.shape[1]
    return torch.stack([torch.zeros(ncell, dtype=F64).index_add_(0, flat, v)
                        for v in vals]).reshape(rows, *mesh.shape)


def test_particles_qgd_card_matches_cpu(device):
    """particlesQGDFoam (the jet with particles_case's cloud, 4096
    parcels), 5 float64 steps: each fluid field and cloud array on the card
    within 1e-9 of its max of the CPU's."""
    from qgdsolver_tpu_torch.solvers.particles import (ParticlesQGDFoam,
                                                       PState, ThermoCloud)

    rng = np.random.default_rng(2)
    n = 4096
    parcels = (np.stack([rng.uniform(0.0, 4.0, n), rng.uniform(0.0, 2.0, n)]),
               np.zeros((2, n)), np.full(n, 350.0), np.full(n, 5e-5))
    out = {}
    for d in ("cpu", device):
        fluid, fs = cases.supersonic_jet((128, 64), dtype=F64, device=d)
        solver = ParticlesQGDFoam(fluid=fluid, cloud=ThermoCloud(
            rho_p=2500.0, Cp_p=900.0))
        s = PState(fluid=fs, cloud=solver.cloud.make(*parcels, device=d,
                                                     dtype=F64))
        out[d] = common.run_steps(solver.make_step(), s, 5)
    a, b = out["cpu"], out[device]
    for f in ("rho", "rhoU", "rhoE"):
        x, y = getattr(a.fluid, f), getattr(b.fluid, f).cpu()
        assert float((x - y).abs().max()) <= 1e-9 * float(x.abs().max()), f
    for f in ("x", "u", "Tp"):
        x, y = getattr(a.cloud, f), getattr(b.cloud, f).cpu()
        assert float((x - y).abs().max()) <= 1e-9 * float(x.abs().max()), f


def _jet_cloud(device, shape=(256, 128), n=1 << 15):
    """particlesQGDFoam on the float32 jet with n seeded parcels (the
    particles_case cloud constants), two-way."""
    from qgdsolver_tpu_torch.solvers.particles import (ParticlesQGDFoam,
                                                       PState, ThermoCloud)

    rng = np.random.default_rng(5)
    fluid, fs = cases.supersonic_jet(shape, dtype=torch.float32,
                                     device=device)
    solver = ParticlesQGDFoam(fluid=fluid, cloud=ThermoCloud(
        rho_p=2500.0, Cp_p=900.0))
    parcels = (np.stack([rng.uniform(0.0, 4.0, n), rng.uniform(0.0, 2.0, n)]),
               np.zeros((2, n)), np.full(n, 350.0), np.full(n, 5e-5))
    return solver, PState(fluid=fs, cloud=solver.cloud.make(
        *parcels, device=device, dtype=torch.float32))


def _bits_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b)
               if torch.is_tensor(x))


def test_two_way_jet_runs_twice_bitwise(device, monkeypatch):
    """The two-way float32 jet (256x128, 32768 parcels), 3 steps twice
    from one State on the card: every field and cloud array equal bit for
    bit, and one deposit launch a step.  Each launch's inputs, and those of
    an evaporating cloud's deposit, give the kernel's sums bitwise its
    plain version's on the CPU."""
    from qgdsolver_tpu_torch.ops import deposit as D
    from qgdsolver_tpu_torch.solvers.particles import ReactingCloud

    solver, s0 = _jet_cloud(device)
    seen = []
    orig = particles.deposit

    def recorded(values, flat, ncell):
        out = orig(values, flat, ncell)
        seen.append((values, flat, ncell, out))
        return out

    monkeypatch.setattr(particles, "deposit", recorded)
    runs = []
    D.deposit.launches = 0
    for _ in range(2):
        step = solver.make_step()
        s = s0
        for _ in range(3):
            s = step(s)
        runs.append(s)
    assert D.deposit.launches == 6
    assert _bits_equal(runs[0].fluid, runs[1].fluid)
    assert _bits_equal(runs[0].cloud, runs[1].cloud)
    # an evaporating cloud's mass deposit after the move
    fs = runs[0].fluid
    U, _, T, _ = solver.fluid.primitives(fs)
    ReactingCloud(rho_p=2500.0, Cp_p=900.0, K_evap=1e-8,
                  latent_heat=2e6).evolve_reacting(
        runs[0].cloud, solver.mesh, fs.dt, rho_g=fs.rho, U_g=U, T_g=T,
        n_species=2)
    assert len(seen) == 8 and seen[-1][0].shape[0] == 1
    for values, flat, ncell, out in seen:
        ref = D.deposit_reference(values.cpu(), flat.cpu(), ncell)
        assert torch.equal(out.cpu().view(torch.int32),
                           ref.view(torch.int32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pattern", ["one_cell", "ratio_4", "inactive",
                                     "inactive_nan"])
def test_deposit_kernel_bitwise_on_card(device, pattern, dtype):
    from qgdsolver_tpu_torch.ops import deposit as D
    from test_torch_deposit import _inputs

    v, flat, ncell = _inputs(pattern.replace("_nan", ""), dtype)
    if pattern == "inactive_nan":
        # a NaN term is not zero: it stays in its cell's run
        v[1, 0] = np.nan
    v, flat = torch.as_tensor(v), torch.as_tensor(flat)
    launches = D.deposit.launches
    got = D.deposit(v.to(device), flat.to(device), ncell)
    assert D.deposit.launches == launches + 1
    ref = D.deposit_reference(v, flat, ncell)
    ints = torch.int32 if v.dtype == torch.float32 else torch.int64
    nan = ref.isnan()
    # a NaN's payload is the device's own
    assert torch.equal(got.cpu().isnan(), nan)
    assert torch.equal(got.cpu()[~nan].view(ints), ref[~nan].view(ints))
