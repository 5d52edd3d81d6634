"""Matrix-free linear solvers for the implicit steps (PyTorch port of
`qgdsolver_tpu.ops.linsolve`).

The reference hands every `fvm::laplacian` solve (implicit diffusion,
QGDUEqn/QGDEEqn) to OpenFOAM's PCG.  Here it is a matrix-free Jacobi-
preconditioned conjugate gradient whose matvec is the stencil Laplacian of
`ops.fvsc`; no sparse matrix is formed.  Its dots go through `spmd.all_sum`,
so under a decomposition it is a distributed CG.

The JAX package runs the Krylov loop in `lax.while_loop`, on the device.  A
Python loop that read the stop test every iteration would wait for the card
once an iteration; `cg` instead runs the body in groups of `group`
iterations, with the stop test carried as a 0-dim tensor: once it fails,
`torch.where` freezes the iterate (a multiply by 0 would turn an inf into a
NaN), and the host reads the test once a group.  The result, iterate and
count, is that of the loop that stops at once.

For singular pure-Neumann systems the nullspace (constants) is projected out
of the rhs and the iterates, the analogue of OpenFOAM's pRefCell.

The Helmholtz operator A = diag - lap is assembled per unit volume, so where
cell volumes vary (graded meshes, wedges, general mesh motion) it is not
symmetric; V*A, OpenFOAM's integrated fvMatrix, is.  There `solve_helmholtz`
runs the CG in the volume-weighted inner product <a, b> = sum(V a b), which
is CG on V*A with the Jacobi preconditioner V*D, and in which the
volume-weighted mean removal of a singular system is the orthogonal
projector.  The stop test stays |r| <= tol*|b| on the unweighted residual.
On a mesh whose volumes are uniform by construction (`Mesh.uniform_volume`)
no weight is taken, and the arithmetic is the JAX package's.  (The JAX
package runs every mesh unweighted: on a wedge its pressure solves stall at
maxiter.)
"""
from __future__ import annotations

import contextlib
import dataclasses
import typing as tp
from functools import partial

import numpy as np
import torch

from ..core import bc as bcm
from ..core.mesh import Mesh
from ..parallel import spmd
from . import fvsc

# iterations a group runs between two host reads of the stop test.  An
# iteration run past the stop (frozen) costs a whole body of launches,
# while a read costs one sync of a queue the host already holds back.  The
# implicit-diffusion solves of the f32 jet at 1024x512 take ~4 iterations:
# in one run its step took 61-70 ms with groups of 16 against 29-34 with
# groups of 4 (NVIDIA H100 80GB HBM3, chip_smoke.py phase 21; PERF.md)
CG_GROUP = 4


@dataclasses.dataclass(frozen=True)
class CGResult:
    x: tp.Any
    iters: tp.Any  # 0-dim int64 tensor
    residual: tp.Any  # final |r| / |b|


def _dot(a, b):
    """Inner product; an all-reduce over the ranks under an spmd context."""
    return spmd.all_sum(torch.sum(a * b))


class _Carry(tp.NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    rr: torch.Tensor
    it: torch.Tensor
    ok: torch.Tensor


def _cg_parts(matvec, b, x0, tol, maxiter, precond, project, weight):
    """(carry0, cond, body, norm_b, project) of the reference's loop:
    cond(c) = rr > (tol*|b|)^2 and it < maxiter and ok.  weight: the cell
    weights of the inner product that drives alpha, beta and rz (None: the
    plain sum)."""
    dot = _dot if weight is None else (lambda a, c: _dot(weight * a, c))
    if project is not None:
        b = project(b)
        x0 = project(x0)
    M = precond if precond is not None else (lambda r: r)
    tiny = torch.finfo(b.dtype).tiny
    r0 = b - matvec(x0)
    if project is not None:
        r0 = project(r0)
    z0 = M(r0)
    if project is not None:
        # a nonuniform preconditioner reintroduces nullspace components:
        # project z too, or p.Ap collapses while rz stays finite
        z0 = project(z0)
    norm_b = torch.sqrt(_dot(b, b))
    norm_b = torch.where(norm_b > 0, norm_b, torch.ones_like(norm_b))
    thresh = torch.square(tol * norm_b)

    def cond(c: _Carry):
        return c.ok & (c.rr > thresh) & (c.it < maxiter)

    def body(c: _Carry) -> _Carry:
        Ap = matvec(c.p)
        if project is not None:
            Ap = project(Ap)
        alpha = c.rz / torch.clamp(dot(c.p, Ap), min=tiny)
        x = c.x + alpha * c.p
        r = c.r - alpha * Ap
        z = M(r)
        if project is not None:
            z = project(z)
        rz = dot(r, z)
        beta = rz / torch.clamp(c.rz, min=tiny)
        p = z + beta * c.p
        rr = _dot(r, r)
        # SPD breakdown guard: rz must stay positive; once the residual is
        # rounding noise the recurrence degrades, so stop with this
        # (converged) iterate
        ok = torch.isfinite(rr) & (rz > 0)
        return _Carry(x, r, z, p, rz, rr, c.it + 1, ok)

    carry = _Carry(x0, r0, z0, z0, dot(r0, z0), _dot(r0, r0),
                   torch.zeros((), dtype=torch.int64, device=b.device),
                   torch.ones((), dtype=torch.bool, device=b.device))
    return carry, cond, body, norm_b


def cg(matvec, b, x0, *, tol=1e-7, maxiter=1000, precond=None, project=None,
       weight=None, group=CG_GROUP) -> CGResult:
    """Preconditioned conjugate gradient for a symmetric positive
    (semi)definite `matvec`: stops when |r| <= tol*|b|, after `maxiter`
    iterations, or at a breakdown (the iterate of the breaking iteration).

    precond: approximate inverse (Jacobi); identity if None.  project:
    nullspace projector applied to b, x, the residuals and z.  weight:
    cell weights of the inner product (a `matvec` self-adjoint in it: V for
    a per-volume operator); None, the plain sum.  The host
    reads the stop test once every `group` iterations and nothing else:
    `cg.reads` counts the reads and `cg.solves` the solves, and
    `cg.iterations` sums the iteration counts on the device (a 0-dim
    tensor; reading it is the caller's sync)."""
    c, cond, body, norm_b = _cg_parts(matvec, b, x0, tol, maxiter, precond,
                                      project, weight)
    live = cond(c)
    while True:
        cg.reads += 1
        if not bool(live):
            break
        for _ in range(group):
            new = body(c)
            c = _Carry(*(torch.where(live, n, o) for n, o in zip(new, c)))
            live = cond(c)
    x = c.x if project is None else project(c.x)
    cg.solves += 1
    if cg.iterations is None or cg.iterations.device != c.it.device:
        cg.iterations = c.it.clone()
    else:
        cg.iterations += c.it
    return CGResult(x=x, iters=c.it, residual=torch.sqrt(c.rr) / norm_b)


def reset_counts():
    """Zero `cg`'s read, solve and iteration counts."""
    cg.reads = cg.solves = 0
    cg.iterations = None


reset_counts()


@contextlib.contextmanager
def true_residuals():
    """[(iterations, |b - A x|/|b|, maxiter, the rhs's number of axes)] of
    every `cg` solve in the context, the residual recomputed from the
    returned x with the unweighted system's own matvec (b and r projected
    for a singular system, as the CG takes them).  Where the cell volumes
    vary the CG runs in the volume-weighted inner product, and this is the
    system it must solve.  Each entry reads the device once; `cg`'s counts
    go on counting."""
    global cg
    log = []
    orig = cg

    def recorded(matvec, b, x0, **kw):
        res = orig(matvec, b, x0, **kw)
        proj = kw.get("project") or (lambda f: f)
        bp = proj(b)
        r = proj(bp - matvec(res.x))
        nb = float(torch.linalg.vector_norm(bp))
        log.append((int(res.iters),
                    float(torch.linalg.vector_norm(r)) / max(nb, 1e-300),
                    kw.get("maxiter", 1000), b.dim()))
        return res

    # `cg` keeps its counts on the module's `cg`, this wrapper meanwhile
    recorded.reads, recorded.solves = orig.reads, orig.solves
    recorded.iterations = orig.iterations
    cg = recorded
    try:
        yield log
    finally:
        cg = orig
        orig.reads, orig.solves = recorded.reads, recorded.solves
        orig.iterations = recorded.iterations


def cg_exact_stop(matvec, b, x0, *, tol=1e-7, maxiter=1000, precond=None,
                  project=None, weight=None) -> CGResult:
    """`cg` with the stop test read after every iteration: the loop `cg`'s
    groups must reproduce (its test)."""
    c, cond, body, norm_b = _cg_parts(matvec, b, x0, tol, maxiter, precond,
                                      project, weight)
    while bool(cond(c)):
        c = body(c)
    x = c.x if project is None else project(c.x)
    return CGResult(x=x, iters=c.it, residual=torch.sqrt(c.rr) / norm_b)


# ---------------------------------------------------------------------------
# Helmholtz assembly (the fvm::laplacian replacements)
# ---------------------------------------------------------------------------


def _ext_pairs(m: np.ndarray, a: int):
    """(lo, hi) views of a cell mask edge-extended along axis a: the cells
    on either side of each a-face."""
    nd = m.ndim
    ext = np.concatenate([np.take(m, [0], axis=a), m,
                          np.take(m, [-1], axis=a)], axis=a)
    lo = [slice(None)] * nd
    lo[a] = slice(0, -1)
    hi = [slice(None)] * nd
    hi[a] = slice(1, None)
    return ext[tuple(lo)], ext[tuple(hi)]


def face_fluid_masks(solid, mesh: Mesh):
    """Per-axis face multipliers for a stairstep solid mask: 1 on faces
    between two fluid cells and on domain-boundary faces of fluid cells, 0
    on every face touching a solid cell (a zero-flux immersed wall), which
    keeps the masked Helmholtz operator SPD on the fluid cells."""
    fluid = ~np.asarray(solid, dtype=bool)
    masks = []
    for a in range(mesh.ndim):
        lo, hi = _ext_pairs(fluid, a)
        masks.append(mesh.tensor((lo & hi).astype(np.float64)))
    return tuple(masks)


def helmholtz_affine(x, *, diag_coeff, gamma_faces, bcs, mesh: Mesh, t=0.0,
                     vector=False):
    """A(x) = diag_coeff*x - laplacian(Gamma_f, x) under `bcs`: the
    discretization of fvm::Sp(diag) - fvm::laplacian(Gamma, x)."""
    lap = fvsc.laplacian_explicit(gamma_faces, x, bcs, mesh, t=t,
                                  vector=vector)
    return diag_coeff * x - lap


def helmholtz_diag(*, diag_coeff, gamma_faces, mesh: Mesh):
    """Jacobi diagonal of the Helmholtz operator on a rectilinear mesh:
    diag + sum_f Gamma_f*|S_f| / (d_cc * V)."""
    nd = mesh.ndim
    tot = 0.0
    for a in range(nd):
        g = gamma_faces[a] * mesh.face_area(a)
        w = g / mesh.bcast(mesh.d_centers[a], a)
        ax = w.ndim - nd + a
        n = w.shape[ax]
        tot = tot + w.narrow(ax, 0, n - 1) + w.narrow(ax, 1, n - 1)
    return diag_coeff + tot / mesh.cell_volume


def solve_helmholtz(*, diag_coeff, gamma_faces, rhs, x0, bcs, mesh: Mesh,
                    t=0.0, vector=False, tol=1e-7, maxiter=1000,
                    singular=False, fluid_mask=None,
                    solid_wall_dirichlet=False) -> CGResult:
    """Solve diag*x - lap(Gamma_f, x) = rhs under `bcs`.

    The affine BC part is split off (the homogeneous-BC linear part feeds
    the CG, A(0) moves to the rhs), so FixedValue/FixedGradient/Mixed BCs
    keep a matvec that is symmetric in the CG's inner product: the plain
    sum on a mesh of uniform volumes, else the volume-weighted one (CG on
    V*A; module docstring).  singular=True projects out the volume-weighted
    mean (the pure-Neumann pressure equation; the result has zero mean).

    fluid_mask: boolean fluid-cell array of a stairstep solid mesh.  Faces
    touching solid cells carry no flux, solid rows become an identity block
    with zero rhs, and the projector acts on the fluid cells.  With
    solid_wall_dirichlet=True the immersed faces are homogeneous Dirichlet
    walls instead (the no-slip mirror adds 2*Gamma_f*|S_f|/(d*V) to the
    adjacent fluid cell's diagonal), what a body-fitted fixedValue-0 wall
    gives."""
    solid_sel = None
    wall_diag = 0.0
    if fluid_mask is not None:
        fm = np.asarray(fluid_mask, dtype=bool)
        fmasks = face_fluid_masks(~fm, mesh)
        if solid_wall_dirichlet:
            # immersed-wall faces: exactly one side solid (domain-boundary
            # faces replicate their cell and never qualify)
            nd = mesh.ndim
            wall_diag = torch.zeros(mesh.shape, dtype=mesh.dtype,
                                    device=mesh.device)
            for a in range(nd):
                lo, hi = _ext_pairs(fm, a)
                wmask = mesh.tensor((lo != hi).astype(np.float64))
                gw = torch.broadcast_to(
                    gamma_faces[a] * wmask * mesh.face_area(a)
                    / mesh.bcast(mesh.d_centers[a], a), wmask.shape)
                n = gw.shape[a]
                wall_diag = wall_diag + 2.0 * (gw.narrow(a, 0, n - 1)
                                               + gw.narrow(a, 1, n - 1))
            wall_diag = (wall_diag / mesh.cell_volume
                         * mesh.tensor(fm.astype(np.float64)))
        gamma_faces = tuple(g * m for g, m in zip(gamma_faces, fmasks))
        fluid_f = mesh.tensor(fm.astype(np.float64))
        solid_sel = torch.as_tensor(~fm, device=mesh.device)
        rhs = torch.where(solid_sel, 0.0, rhs)
        x0 = torch.where(solid_sel, 0.0, x0)

    bcs_h = bcs.map(bcm.homogeneous)
    aff = partial(helmholtz_affine, diag_coeff=diag_coeff,
                  gamma_faces=gamma_faces, mesh=mesh, t=t, vector=vector)

    def add_solid(ax, x):
        # unit rows keep the operator SPD when diag_coeff == 0; wall_diag
        # is the immersed no-slip Dirichlet part
        if solid_sel is None:
            return ax
        return ax + torch.where(solid_sel, x, 0.0) + wall_diag * x

    b = rhs - aff(torch.zeros_like(rhs), bcs=bcs)

    def matvec(x):
        return add_solid(aff(x, bcs=bcs_h), x)

    diag = helmholtz_diag(diag_coeff=diag_coeff, gamma_faces=gamma_faces,
                          mesh=mesh)
    if solid_sel is not None:
        diag = diag + torch.where(solid_sel, 1.0, 0.0) + wall_diag
    diag = torch.broadcast_to(diag, rhs.shape)

    def precond(r):
        return r / diag

    project = None
    if singular:
        vol = torch.broadcast_to(mesh.cell_volume, mesh.shape)
        if solid_sel is not None:
            vol = vol * fluid_f
        vtot = spmd.all_sum(torch.sum(vol))

        def project(f):  # noqa: F811 - volume-weighted mean removal
            m = spmd.all_sum(torch.sum(f * vol)) / vtot
            if solid_sel is not None:
                return f - torch.where(solid_sel, 0.0, m)
            return f - m

    weight = None if mesh.uniform_volume else mesh.cell_volume
    return cg(matvec, b, x0, tol=tol, maxiter=maxiter, precond=precond,
              project=project, weight=weight)
