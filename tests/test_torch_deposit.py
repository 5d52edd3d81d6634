"""The clouds' deposition (`ops.deposit`) against the JAX package's
`.at[flat].add` (qgdsolver_tpu/solvers/particles.py:160, :168, :372), bit
for bit, in float32 and float64: each cell's parcels added in parcel order
from zero.  On a CPU tensor `deposit` runs its plain version; the kernel,
which sums the same runs in the same order on the card, is held to it in
tests/test_torch_reacting_gpu.py and chip_smoke.py phase 24.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgdsolver_tpu_torch.ops import deposit as D
from qgdsolver_tpu_torch.solvers import particles

N = 4096


def _inputs(pattern, dtype, rows=3):
    """(values (rows, N), flat (N,), ncell) from a numpy seed: every
    parcel in one cell, a random 4:1 parcels-to-cells ratio, or that ratio
    with a third of the parcels inactive (their terms 0 times a value: a
    signed zero)."""
    rng = np.random.default_rng(11)
    ncell = N // 4
    flat = (np.full(N, 37) if pattern == "one_cell"
            else rng.integers(0, ncell, N))
    v = rng.standard_normal((rows, N)) * 10.0 ** rng.uniform(-6, 6,
                                                             (rows, N))
    if pattern == "inactive":
        act = (np.arange(N) % 3 != 0).astype(np.float64)
        v = -v * act
    return v.astype(dtype), flat, ncell


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype == np.float32 else np.int64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pattern", ["one_cell", "ratio_4", "inactive"])
def test_deposit_equals_jax_scatter_add(pattern, dtype):
    v, flat, ncell = _inputs(pattern, dtype)
    got = D.deposit(torch.as_tensor(v), torch.as_tensor(flat), ncell)
    assert got.dtype == torch.as_tensor(v).dtype
    for r in range(v.shape[0]):
        ref = jnp.zeros(ncell, dtype=dtype).at[jnp.asarray(flat)].add(
            jnp.asarray(v[r]))
        assert np.asarray(ref).dtype == dtype
        np.testing.assert_array_equal(_bits(got[r].numpy()), _bits(ref))


def test_deposit_checks_its_inputs():
    """deposit refuses values and cells that do not pair, and integer
    values."""
    flat = torch.tensor([3, 1, 3, 0, 1, 3])
    with pytest.raises(ValueError):
        D.deposit(torch.zeros(2, 5), flat, 4)
    with pytest.raises(TypeError):
        D.deposit(torch.zeros(1, 6, dtype=torch.int64), flat, 4)


def test_evolve_sources_equal_jax_deposition():
    """One two-way evolve of a float32 cloud (a third inactive): the
    momentum and energy sources equal `.at[flat].add` of evolve's own
    per-parcel terms, bit for bit."""
    from qgdsolver_tpu_torch.core.mesh import Mesh

    rng = np.random.default_rng(4)
    shape, n = (16, 8), 512
    mesh = Mesh.uniform(shape, lengths=(4.0, 2.0), dtype=torch.float32)
    cloud = particles.ThermoCloud(rho_p=2500.0, Cp_p=900.0)
    c = cloud.make(np.stack([rng.uniform(0, 4, n), rng.uniform(0, 2, n)]),
                   rng.normal(0, 20, (2, n)), rng.uniform(300, 350, n),
                   rng.uniform(2e-5, 1e-4, n), dtype=torch.float32)
    c = c._replace(active=torch.as_tensor(
        (np.arange(n) % 3 != 0).astype(np.float32)))
    rho = torch.as_tensor(rng.uniform(0.5, 1.5, shape), dtype=torch.float32)
    U = torch.as_tensor(rng.normal(0, 50, (2,) + shape), dtype=torch.float32)
    T = torch.as_tensor(rng.uniform(250, 400, shape), dtype=torch.float32)
    terms = []
    orig = particles.deposit

    def recorded(values, flat, ncell):
        terms.append((values.numpy().copy(), flat.numpy().copy(), ncell))
        return orig(values, flat, ncell)

    particles.deposit = recorded
    try:
        _, rhoUSu, rhoESu = cloud.evolve(c, mesh, 1e-5, rho_g=rho, U_g=U,
                                         T_g=T)
    finally:
        particles.deposit = orig
    (v, flat, ncell), = terms
    got = torch.cat([rhoUSu.reshape(2, -1), rhoESu.reshape(1, -1)])
    for r in range(3):
        ref = jnp.zeros(ncell, dtype=jnp.float32).at[flat].add(v[r])
        np.testing.assert_array_equal(_bits(got[r].numpy()), _bits(ref))
    assert float(got.abs().max()) > 0.0
