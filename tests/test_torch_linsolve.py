"""The port's matrix-free CG (`ops/linsolve.py`) against the JAX package's.

Mirrors tests/test_linsolve.py on the same 24x16 float64 problems, each
solved by both packages: the JAX CG and this one reduce their dots in
different orders, so the iterates agree to the solve's tolerance, not bit
for bit.  Bound: with tol = 1e-12 each solution is within 1e-9 of the
manufactured one (the reference test's bound) and the two within 1e-10 of
each other; the iteration counts are equal.  Then the port's own
contract: the grouped loop (`cg`, one host read per group) returns the
same x and iters as the loop that reads the stop test after every
iteration (`cg_exact_stop`), bit for bit, at convergence, at the
iteration cap and at a breakdown.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.core.mesh import Mesh as JMesh
from qgdsolver_tpu.ops import linsolve as jls
from qgdsolver_tpu_torch.core import bc as tbc
from qgdsolver_tpu_torch.core.mesh import Mesh as TMesh
from qgdsolver_tpu_torch.ops import linsolve as tls

F64 = torch.float64


def _meshes():
    return (JMesh.uniform((24, 16), lengths=(1.0, 1.0), dtype=np.float64),
            TMesh.uniform((24, 16), lengths=(1.0, 1.0), dtype=F64))


def _gammas(jm, tm, rng=None):
    """Unit face diffusivities, or seeded ones in [0.5, 1.5]."""
    out = []
    for a in range(2):
        g = (np.ones(jm.face_shape(a)) if rng is None
             else rng.uniform(0.5, 1.5, jm.face_shape(a)))
        out.append(g)
    return (tuple(jnp.asarray(g) for g in out),
            tuple(torch.as_tensor(g) for g in out))


def _solve_both(jbcs, tbcs, rhs, diag, rng=None, **kw):
    jm, tm = _meshes()
    jg, tg = _gammas(jm, tm, rng)
    jr = jls.solve_helmholtz(diag_coeff=diag, gamma_faces=jg,
                             rhs=jnp.asarray(rhs),
                             x0=jnp.zeros(jm.shape), bcs=jbcs, mesh=jm, **kw)
    tr = tls.solve_helmholtz(diag_coeff=diag, gamma_faces=tg,
                             rhs=torch.as_tensor(rhs),
                             x0=torch.zeros(tm.shape, dtype=F64), bcs=tbcs,
                             mesh=tm, **kw)
    assert int(jr.iters) == int(tr.iters)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=1e-10)
    return jr, tr


def _xy(jm):
    x = np.asarray(jm.cell_coords(0)) * np.ones(jm.shape)
    y = np.asarray(jm.cell_coords(1)) * np.ones(jm.shape)
    return x, y


def test_helmholtz_manufactured_dirichlet():
    jm, _ = _meshes()
    x, y = _xy(jm)
    x_true = np.sin(np.pi * x) * np.sin(np.pi * y)
    jbcs = jbc.FieldBCs.uniform(jbc.FixedValue(0.0), 2)
    tbcs = tbc.FieldBCs.uniform(tbc.FixedValue(0.0), 2)
    gamma = tuple(jnp.ones(jm.face_shape(a)) for a in range(2))
    rhs = np.asarray(jls.helmholtz_affine(
        jnp.asarray(x_true), diag_coeff=2.0, gamma_faces=gamma, bcs=jbcs,
        mesh=jm))
    _, tr = _solve_both(jbcs, tbcs, rhs, 2.0, tol=1e-12, maxiter=2000)
    np.testing.assert_allclose(tr.x.numpy(), x_true, atol=1e-9)
    assert 0 < int(tr.iters) < 2000


def test_poisson_neumann_singular():
    jm, _ = _meshes()
    x, _ = _xy(jm)
    x_true = np.cos(np.pi * x)  # Neumann-compatible, zero mean
    jbcs = jbc.FieldBCs.uniform(jbc.ZeroGradient(), 2)
    tbcs = tbc.FieldBCs.uniform(tbc.ZeroGradient(), 2)
    gamma = tuple(jnp.ones(jm.face_shape(a)) for a in range(2))
    rhs = np.asarray(jls.helmholtz_affine(
        jnp.asarray(x_true), diag_coeff=0.0, gamma_faces=gamma, bcs=jbcs,
        mesh=jm))
    _, tr = _solve_both(jbcs, tbcs, rhs, 0.0, tol=1e-12, maxiter=4000,
                        singular=True)
    err = tr.x.numpy() - x_true
    np.testing.assert_allclose(err - err.mean(), 0.0, atol=1e-8)


def test_inhomogeneous_bc_split():
    """FixedValue != 0 BCs: the affine split reproduces the exact solve,
    and a Mixed BC (the waveTransmissive substitution) splits as the JAX
    package splits it."""
    jm, _ = _meshes()
    jbcs = jbc.FieldBCs.uniform(jbc.FixedValue(3.0), 2)
    tbcs = tbc.FieldBCs.uniform(tbc.FixedValue(3.0), 2)
    rhs = 2.0 * np.full(jm.shape, 3.0)
    _, tr = _solve_both(jbcs, tbcs, rhs, 2.0, tol=1e-12, maxiter=2000)
    np.testing.assert_allclose(tr.x.numpy(), 3.0, atol=1e-9)
    rng = np.random.default_rng(3)
    frac = rng.uniform(0.2, 0.9, (1, 16))
    jmix = jbcs.replace(0, 1, jbc.Mixed(jnp.asarray(4.0 + frac),
                                       jnp.asarray(frac)))
    tmix = tbcs.replace(0, 1, tbc.Mixed(torch.as_tensor(4.0 + frac),
                                        torch.as_tensor(frac)))
    _solve_both(jmix, tmix, rhs, 2.0, rng=rng, tol=1e-12, maxiter=2000)


@pytest.mark.parametrize("wall", [False, True])
def test_masked_helmholtz_matches_jax(wall):
    """The stairstep-masked operator (zero-flux immersed faces, or no-slip
    Dirichlet walls) on an L-shaped fluid region, and its pieces
    (face masks, Jacobi diagonal), against the JAX package's."""
    jm, tm = _meshes()
    rng = np.random.default_rng(7)
    solid = np.zeros(jm.shape, dtype=bool)
    solid[:8, :6] = True
    for a, b in zip(jls.face_fluid_masks(solid, jm),
                    tls.face_fluid_masks(solid, tm)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jg, tg = _gammas(jm, tm, rng)
    diag = rng.uniform(1.0, 3.0, jm.shape)
    np.testing.assert_allclose(
        tls.helmholtz_diag(diag_coeff=torch.as_tensor(diag), gamma_faces=tg,
                           mesh=tm).numpy(),
        np.asarray(jls.helmholtz_diag(diag_coeff=jnp.asarray(diag),
                                      gamma_faces=jg, mesh=jm)),
        rtol=1e-15)
    rhs = rng.standard_normal(jm.shape)
    jbcs = jbc.FieldBCs.uniform(jbc.FixedValue(1.0), 2)
    tbcs = tbc.FieldBCs.uniform(tbc.FixedValue(1.0), 2)
    jr = jls.solve_helmholtz(
        diag_coeff=jnp.asarray(diag), gamma_faces=jg, rhs=jnp.asarray(rhs),
        x0=jnp.zeros(jm.shape), bcs=jbcs, mesh=jm, tol=1e-12, maxiter=2000,
        fluid_mask=~solid, solid_wall_dirichlet=wall)
    tr = tls.solve_helmholtz(
        diag_coeff=torch.as_tensor(diag), gamma_faces=tg,
        rhs=torch.as_tensor(rhs), x0=torch.zeros(tm.shape, dtype=F64),
        bcs=tbcs, mesh=tm, tol=1e-12, maxiter=2000, fluid_mask=~solid,
        solid_wall_dirichlet=wall)
    assert int(jr.iters) == int(tr.iters) > 0
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=1e-10)
    assert float(tr.x[:8, :6].abs().max()) == 0.0


def _spd_problem(n=40, seed=0):
    """A seeded SPD matrix (condition ~1e3) as a matvec, and a rhs."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = torch.as_tensor((q * np.logspace(0, 3, n)) @ q.T)
    b = torch.as_tensor(rng.standard_normal(n))
    return (lambda x: A @ x), b


@pytest.mark.parametrize("group", [1, 5, 16])
@pytest.mark.parametrize("stop", ["tol", "maxiter", "breakdown"])
def test_grouped_stop_equals_exact_stop(group, stop):
    """`cg`'s groups of iterations freeze the carry with torch.where once
    the stop test fails: x and iters equal the exact-stop loop's bit for
    bit, whether it stops on the tolerance, on maxiter (23, not a multiple
    of the groups) or at the breakdown guard (an indefinite preconditioner
    makes rz negative).  The host reads the test once a group:
    ceil(iters/group) + 1 reads."""
    matvec, b = _spd_problem()
    x0 = torch.zeros_like(b)
    tol, maxiter = 1e-10, (23 if stop == "maxiter" else 500)
    pre = (lambda r: -r) if stop == "breakdown" else (lambda r: r / 2.0)
    ref = tls.cg_exact_stop(matvec, b, x0, tol=tol, maxiter=maxiter,
                            precond=pre)
    tls.reset_counts()
    got = tls.cg(matvec, b, x0, tol=tol, maxiter=maxiter, precond=pre,
                 group=group)
    assert int(got.iters) == int(ref.iters) > 0
    assert torch.equal(got.x, ref.x)
    assert torch.equal(got.residual, ref.residual)
    n = int(ref.iters)
    assert tls.cg.reads == -(-n // group) + 1
    assert tls.cg.solves == 1 and int(tls.cg.iterations) == n
    assert n == {"tol": n, "maxiter": 23, "breakdown": 1}[stop]
    assert (float(got.residual) <= tol) == (stop == "tol")


def test_cg_breakdown_returns_the_breaking_iterate():
    """An indefinite preconditioner makes rz negative after the first
    iteration: both packages stop there (ok false) and return that
    iteration's iterate, not x0."""
    matvec, b = _spd_problem(seed=1)
    pre = (lambda r: -r)
    A = jnp.asarray(np.stack([matvec(e).numpy()
                              for e in torch.eye(b.shape[0],
                                                 dtype=b.dtype)], axis=1))
    j = jls.cg(lambda x: A @ x, jnp.asarray(b.numpy()), jnp.zeros(b.shape),
               tol=1e-10, maxiter=100, precond=lambda r: -r)
    t = tls.cg(matvec, b, torch.zeros_like(b), tol=1e-10, maxiter=100,
               precond=pre)
    e = tls.cg_exact_stop(matvec, b, torch.zeros_like(b), tol=1e-10,
                          maxiter=100, precond=pre)
    assert int(j.iters) == int(t.iters) == int(e.iters) == 1
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=1e-12)
    assert torch.equal(t.x, e.x) and bool(t.x.abs().max() > 0)


# ---------------------------------------------------------------------------
# cell volumes that vary: the CG on V*A (the JAX package's unweighted CG on
# the per-volume operator stalls there)
# ---------------------------------------------------------------------------


def _graded_faces(n, length, ratio):
    r = ratio ** (1.0 / (n - 1))
    w = r ** np.arange(n)
    return np.concatenate([[0.0], np.cumsum(w / w.sum() * length)])


def _varying_mesh(kind):
    from qgdsolver_tpu_torch.core.mesh import AxisymmetricMesh

    if kind == "graded":
        return TMesh(x_faces=(_graded_faces(24, 1.0, 8.0),
                              _graded_faces(16, 1.0, 0.2)), dtype=F64)
    return AxisymmetricMesh(x_faces=(np.linspace(0.0, 1.0, 25),
                                     np.linspace(0.0, 0.5, 17)), dtype=F64)


@pytest.mark.parametrize("singular", [True, False],
                         ids=["poisson_singular", "helmholtz"])
@pytest.mark.parametrize("kind", ["graded", "wedge"])
def test_weighted_cg_converges_where_volumes_vary(kind, singular):
    """A graded mesh (expansion 8 along x, 0.2 along y) and a wedge, with
    seeded face diffusivities and a seeded rhs: the pure-Neumann Poisson
    system (projected) and a Helmholtz one.  The CG in the volume-weighted
    inner product stops by its test, its unweighted residual |b - A x|/|b|
    recomputed from x within 10*tol, and the iterate solves the system
    (x + c for the singular one).  The same system run in the plain inner
    product, as the JAX package runs it, reaches maxiter."""
    from _torch_parity import assert_solves_converged

    rng = np.random.default_rng(7)
    mesh = _varying_mesh(kind)
    assert not mesh.uniform_volume
    gamma = tuple(torch.as_tensor(rng.uniform(0.5, 1.5, mesh.face_shape(a)))
                  for a in range(2))
    zg = tbc.FieldBCs.uniform(tbc.ZeroGradient(), 2)
    rhs = torch.as_tensor(rng.standard_normal(mesh.shape))
    kw = dict(diag_coeff=0.0 if singular else 3.0, gamma_faces=gamma,
              rhs=rhs, x0=torch.zeros(mesh.shape, dtype=F64), bcs=zg,
              mesh=mesh, tol=1e-10, maxiter=1000, singular=singular)
    with tls.true_residuals() as solves:
        res = tls.solve_helmholtz(**kw)
    assert_solves_converged(solves, 1e-10)
    assert int(res.iters) < 300
    # a mesh of the same geometry that claims uniform volumes: no weight
    plain_mesh = _varying_mesh(kind)
    object.__setattr__(plain_mesh, "uniform_volume", True)
    plain = tls.solve_helmholtz(**{**kw, "mesh": plain_mesh})
    assert int(plain.iters) == 1000 and float(plain.residual) > 1e-6


def test_cg_weight_only_where_volumes_vary(monkeypatch):
    """solve_helmholtz hands the CG no weight on a uniform mesh (one built
    by Mesh.uniform, one from linspace faces with round-off widths, and a
    decomposition's block of one), so those solves keep the JAX package's
    arithmetic; a graded mesh, a block of it, a wedge and a moving mesh's
    TracedMesh take their cell volumes."""
    from qgdsolver_tpu_torch.core.mesh import TracedMesh
    from qgdsolver_tpu_torch.parallel.shardmesh import ShardMesh

    seen = []
    orig = tls.cg

    def recorded(*args, **kw):
        seen.append(kw.get("weight"))
        return orig(*args, **kw)

    recorded.reads = recorded.solves = 0
    recorded.iterations = None
    monkeypatch.setattr(tls, "cg", recorded)
    uniform = TMesh.uniform((12, 8), lengths=(0.3, 0.7), dtype=F64)
    graded = _varying_mesh("graded")
    meshes = {
        "uniform": uniform,
        "linspace": TMesh(x_faces=(np.linspace(0.1, 0.37, 13),
                                   np.linspace(-1.0, 2.3, 9)), dtype=F64),
        "uniform block": ShardMesh.window(uniform, (6, 0), (6, 8)),
        "graded": graded,
        "graded block": ShardMesh.window(graded, (0, 8), (24, 8)),
        "wedge": _varying_mesh("wedge"),
        "traced": TracedMesh(tuple(torch.as_tensor(f) for f
                                   in uniform.x_faces)),
    }
    zg = tbc.FieldBCs.uniform(tbc.ZeroGradient(), 2)
    for name, m in meshes.items():
        gamma = tuple(torch.ones(m.face_shape(a), dtype=F64)
                      for a in range(2))
        tls.solve_helmholtz(diag_coeff=1.0, gamma_faces=gamma,
                            rhs=torch.ones(m.shape, dtype=F64),
                            x0=torch.zeros(m.shape, dtype=F64), bcs=zg,
                            mesh=m, tol=1e-8, maxiter=50)
        w = seen[-1]
        if name in ("uniform", "linspace", "uniform block"):
            assert w is None, name
        else:
            assert torch.equal(torch.broadcast_to(w, m.shape),
                               torch.broadcast_to(m.cell_volume, m.shape)), \
                name
