"""Shared parts of the port-against-JAX parity tests of the QHD family,
scalar transport, rhoQGDFoam and zQGDFoam: the float64 run of one config
in both packages from one State, held field by field, with the CG
iteration counts of every Helmholtz solve (p, U, T) recorded in both and
compared.  Imports the JAX package: only tests use it.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from qgdsolver_tpu.ops import linsolve as jlinsolve
from qgdsolver_tpu_torch import interop
from qgdsolver_tpu_torch.ops import linsolve

F64 = torch.float64
# composable float64 steps without a CG solve: round-off (the same formulas
# in the same order)
ROUND_OFF = 1e-9


def _rel(a, b, floor=0.0):
    """max |a - b| over max(max |a|, floor)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(a)), floor, 1e-300)


@contextlib.contextmanager
def solve_logs(monkeypatch):
    """([(kind, iterations, final |r|/|b|)] of the JAX package's
    Helmholtz solves, the same of the port's): p for a singular solve, U
    for a vector one, T otherwise.  The JAX counts arrive through an
    ordered debug callback, so its steps must be traced inside the
    context."""
    jlog, tlog = [], []
    jorig, torig = jlinsolve.solve_helmholtz, linsolve.solve_helmholtz

    def kind(kw):
        return "p" if kw.get("singular") else "U" if kw.get("vector") else "T"

    def jlogged(**kw):
        res = jorig(**kw)
        jax.debug.callback(
            lambda it, r, k=kind(kw): jlog.append((k, int(it), float(r))),
            res.iters, res.residual, ordered=True)
        return res

    def tlogged(**kw):
        res = torig(**kw)
        tlog.append((kind(kw), int(res.iters), float(res.residual)))
        return res

    monkeypatch.setattr(jlinsolve, "solve_helmholtz", jlogged)
    monkeypatch.setattr(linsolve, "solve_helmholtz", tlogged)
    yield jlog, tlog


def run_both(jsolver, js, n, tol, monkeypatch, floors=None, over=None,
             counts=True):
    """n steps of a JAX solver and of its port from one State.

    The JAX package runs its trajectory once, every State kept.  The port
    runs n one-step windows, each from the JAX State before it: each
    window's State is held to the JAX State after it within `tol` of each
    field's max (1e-9 without a CG; with one 2*cg_tol a step, each solve
    stopping at |r| <= cg_tol*|b| in both packages), and every Helmholtz
    solve of the windows (p, U, T, in order) takes as many CG iterations
    as the JAX package's (`same_iterations`).  The windows keep the two
    trajectories from parting: started from States that differ in the last
    bits, a pressure solve's residual a few iterations before its stop
    differs by far more than those bits (its recurrence carries
    ~eps*|A||p| against a small |b|), and the stop can then fall on either
    side of an iteration.
    `floors` ({field: scale}) sets a field's least scale: a field that is
    round-off of zero (the pressure of a uniform stream) is held against
    its physical scale.  `over` ({field: value}) sets fields of the port's
    solver, such as the torch counterparts of QHDDyMFoam's motion
    callables, which `interop.solver_from` cannot carry.  `counts=False`
    drops the count check, for a JAX package whose CG is replaced by
    `exact_jax_solves`.  Returns (the JAX States [0..n], the port's last
    window State with numpy leaves, the port's [(kind, iterations)])."""
    floors = floors or {}
    tsolver = interop.solver_from(jsolver, dtype=F64, **(over or {}))
    tstep = tsolver.make_step()
    step = jsolver.make_step()
    with solve_logs(monkeypatch) as (jlog, tlog):
        _, traj = jax.block_until_ready(jax.jit(lambda s: jax.lax.scan(
            lambda c, _: (lambda nxt: (nxt, nxt))(step(c)), s, None,
            length=n))(js))
        states = [js] + [jax.tree.map(lambda x, k=k: x[k], traj)
                         for k in range(n)]
        for k in range(n):
            ts = tstep(interop.state_from_numpy(
                jax.tree.map(np.asarray, states[k]), dtype=F64))
            ts = interop.state_to_numpy(ts)
            for f in ts._fields:
                if f in ("pbc", "wt"):
                    continue
                assert _rel(getattr(states[k + 1], f), getattr(ts, f),
                            floors.get(f, 0.0)) <= tol, (k, f)
    if counts:
        same_iterations(jlog, tlog, getattr(jsolver, "cg_tol", 0.0))
    return states, ts, [x[:2] for x in tlog]


def same_iterations(jlog, tlog, cg_tol, band=1e-3):
    """Both packages' solves in the same order and kinds with equal CG
    iteration counts.  The one exception is a stop decided by round-off:
    counts one apart where the solve that stopped first ended within
    `band` of its threshold (cg_tol*(1 - band) <= |r|/|b| <= cg_tol), the
    other package's residual at that iteration having landed just above
    it."""
    assert [x[0] for x in jlog] == [x[0] for x in tlog], (jlog, tlog)
    for j, t in zip(jlog, tlog):
        if j[1] == t[1]:
            continue
        first = j if j[1] < t[1] else t
        assert abs(j[1] - t[1]) == 1 and \
            cg_tol * (1.0 - band) <= first[2] <= cg_tol, (j, t)


def _exact_cg(matvec, b, x0, *, tol=1e-7, maxiter=1000, precond=None,
              project=None):
    """The JAX package's `cg` contract solved exactly: the dense matrix of
    the projected operator, assembled column by column from `matvec`, and
    its least-squares solution (the nullspace of a singular system taken
    out by `project`, as the CG takes it).  Reports 0 iterations and the
    residual of the solution."""
    P = project if project is not None else (lambda f: f)
    bp = P(b)
    n = b.size
    cols = jax.vmap(lambda e: P(matvec(e.reshape(b.shape))).ravel())(
        jnp.eye(n, dtype=b.dtype))
    x = P(jnp.linalg.lstsq(cols.T, bp.ravel())[0].reshape(b.shape))
    r = P(bp - matvec(x))
    nb = jnp.sqrt(jnp.sum(bp * bp))
    return jlinsolve.CGResult(
        x=x, iters=jnp.asarray(0),
        residual=jnp.sqrt(jnp.sum(r * r)) / jnp.where(nb > 0, nb, 1.0))


def exact_jax_solves(monkeypatch):
    """Every Helmholtz solve of the JAX package solved exactly (dense, for
    the small meshes of the tests) in place of its CG.  Where the cell
    volumes vary the JAX package's CG runs on the nonsymmetric V^-1 A and
    its pressure solves stall at cg_maxiter; the exact solution of the
    same system is what the port's CG on V*A converges to, so the port is
    held to the JAX package's discretisation (hoop terms, r-weighted
    metrics, BCs) within the conditioning of the system times cg_tol."""
    monkeypatch.setattr(jlinsolve, "cg", _exact_cg)


def assert_solves_converged(log, cg_tol):
    """Every solve of a `linsolve.true_residuals` log stopped by its test:
    fewer iterations than maxiter and |b - A x|/|b| <= 10*cg_tol."""
    assert log, "no solve recorded"
    for it, res, maxiter, _ in log:
        assert it < maxiter and res <= 10.0 * cg_tol, (it, res, log)
