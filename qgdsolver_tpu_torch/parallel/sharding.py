"""Domain decomposition of the composable step over torch.distributed ranks
(PyTorch port of the shard_map part of `qgdsolver_tpu.parallel.sharding`).

The reference runs `decomposePar + mpirun <solver>`: each rank owns a block
of the mesh, exchanges one ring of halo cells with its neighbours and joins
the global reductions.  `build_spmd_step` is that here: the solver is rebuilt
on this rank's block (`ShardMesh`) and its unmodified `make_step()` runs
under an active `parallel.spmd` context, which routes the partition-edge
ghosts of `ghost_pad` through the neighbour ranks and turns the Courant,
tau and fvc::smooth reductions into collectives (QHDDyMFoam and
interQHDFoam included).  The JAX package's GSPMD
helpers (`sharded_step`, `shard_state`, ...) have no counterpart: this is
the one decomposed composable path.
"""
from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch
import torch.distributed as dist

from . import spmd
from .shardmesh import ShardMesh


def factor2d(n: int):
    """Near-square factorization n = px*py (px >= py)."""
    py = int(math.isqrt(n))
    while n % py:
        py -= 1
    return n // py, py


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """A (px, py) grid of ranks over the first two mesh axes.  X is
    contiguous: rank r holds block (r % px, r // px), so the ranks of one
    host (consecutive local ranks) share an x-ring and only the y
    neighbours of a host's blocks lie on other hosts."""

    px: int
    py: int = 1

    @staticmethod
    def parse(spec: str) -> "ProcessGrid":
        """'PXxPY' -> ProcessGrid(PX, PY)."""
        try:
            px, py = (int(v) for v in str(spec).lower().split("x"))
        except ValueError:
            raise ValueError(f"devices {spec!r}: expected PXxPY, e.g. 2x1")
        if px < 1 or py < 1:
            raise ValueError(f"devices {spec!r}: counts must be positive")
        return ProcessGrid(px, py)

    @property
    def size(self) -> int:
        return self.px * self.py

    def coords(self, rank: int) -> tp.Tuple[int, int]:
        return rank % self.px, rank // self.px

    def rank(self, ix: int, iy: int) -> int:
        return iy * self.px + ix


def this_rank(grid: ProcessGrid) -> int:
    """This process's rank, checked against the grid's size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != grid.size:
        raise ValueError(f"a {grid.px}x{grid.py} grid needs {grid.size} "
                         f"ranks, the world has {world}")
    return dist.get_rank() if dist.is_initialized() else 0


def block_context(mesh, grid: ProcessGrid, rank=None) -> spmd.SpmdContext:
    """The SpmdContext of this rank's block of `mesh` on `grid` (x and y
    split; a third axis whole), or of block `rank` when given (outside a
    world, to look at one block).  Raises ValueError unless every split
    divides its axis."""
    sizes = (grid.px, grid.py) + (1,) * (mesh.ndim - 2)
    if mesh.ndim < 2 and grid.py > 1:
        raise ValueError("a 1D mesh splits along x only")
    axes = []
    for a, n in enumerate(mesh.shape):
        if n % sizes[a]:
            raise ValueError(
                f"axis {a}: {n} cells not divisible by {sizes[a]} blocks")
        axes.append(spmd.AxisShard(sizes[a], n // sizes[a])
                    if sizes[a] > 1 else None)
    ix, iy = grid.coords(this_rank(grid) if rank is None else rank)
    coords = ((ix, iy) + (0,) * mesh.ndim)[:mesh.ndim]
    return spmd.SpmdContext(axes=tuple(axes), global_shape=tuple(mesh.shape),
                            coords=coords, grid=grid, global_mesh=mesh)


def block_mesh(ctx: spmd.SpmdContext) -> ShardMesh:
    mesh = ctx.global_mesh
    shape = tuple(n if ax is None else ax.n_local
                  for n, ax in zip(mesh.shape, ctx.axes))
    return ShardMesh.window(mesh, [ctx.start(a) for a in range(mesh.ndim)],
                            shape)


def spmd_supported(solver) -> tp.Optional[str]:
    """None if `build_spmd_step` can decompose this solver; else the reason.
    Graded spacings and wedge metrics ride the ShardMesh windows, and
    per-cell cqSc floors and const-Sc cellSets are windowed per block
    (`spmd.localize_cells`); a moving mesh's post-motion geometry is
    windowed per step (`TracedShardMesh`), and interQHDFoam's State
    (U, alpha1, p) windows as any other; stairstep solid masks are not
    decomposed, as in the reference (their stencils are indexed
    globally)."""
    if not hasattr(solver, "make_step"):
        return f"{type(solver).__name__} has no composable step"
    if getattr(solver.mesh, "solid", None) is not None:
        return "stairstep solid masks are globally indexed"
    fluid = getattr(solver, "fluid", solver)
    if hasattr(fluid, "_tabulation") and fluid._tabulation()[0] is not None:
        # the table's slots hash compositions from every cell of the
        # process; the JAX package's decomposition refuses it too (its
        # key rows are taken for a spatial leaf)
        return ("a DeviceISAT chemistry table is per-process state and is "
                "not decomposed")
    return None


def _window(x, ctx: spmd.SpmdContext, nd: int):
    """This block's window of a state leaf: the trailing nd axes of global
    extent are cut to the block; size-1 extents (the lagged boundary rows
    along their normal axis) and scalars pass through."""
    if isinstance(x, tuple):
        return tuple(_window(v, ctx, nd) for v in x)
    if not torch.is_tensor(x) or x.ndim < nd:
        return x
    for a in range(nd):
        ax = x.ndim - nd + a
        if ctx.sharded(a) and x.shape[ax] == ctx.global_shape[a]:
            x = x.narrow(ax, ctx.start(a), ctx.axes[a].n_local)
    return x.contiguous()


def _join(blocks, ctx: spmd.SpmdContext, nd: int, owner=None):
    """The global leaf from every rank's block (rank order).  With
    owner=(a, side) only the blocks at that global boundary of axis a are
    used: the lagged boundary rows, which only the edge rank computes from
    a physical face."""
    grid = ctx.grid
    px, py = (grid.px, grid.py)
    cols = []
    for ix in range(px):
        if owner is not None and owner[0] == 0 \
                and ix != (0 if owner[1] == 0 else px - 1):
            continue
        row = []
        for iy in range(py):
            if owner is not None and owner[0] == 1 \
                    and iy != (0 if owner[1] == 0 else py - 1):
                continue
            row.append(blocks[grid.rank(ix, iy)])
        cols.append(row[0] if len(row) == 1 or nd < 2 else
                    torch.cat(row, dim=row[0].ndim - nd + 1))
    x = cols[0]
    return x if len(cols) == 1 else torch.cat(cols, dim=x.ndim - nd)


def _with_mesh(solver, mesh):
    """`solver` on `mesh`; the Lagrangian solvers nest it in their fluid."""
    if hasattr(solver, "fluid"):
        return dataclasses.replace(
            solver, fluid=dataclasses.replace(solver.fluid, mesh=mesh))
    return dataclasses.replace(solver, mesh=mesh)


def build_spmd_step(solver, grid: ProcessGrid, capacity=None):
    """(step, to_spmd, from_spmd): the solver's composable step on this
    rank's block of `grid`, inside a launched world of grid.size ranks.

    step runs the solver's unmodified `make_step()`, built on the block's
    ShardMesh, under `spmd.active`; to_spmd cuts this rank's block out of a
    global State; from_spmd gathers the global State onto every rank (a
    collective: every rank calls it).  The lagged qgdFlux rows of a State
    (`pbc`) and its waveTransmissive face values (`wt`) are computed on
    every rank, but only the rank at the physical side reads them (its
    ghost_pad is the only one that applies that BC): from_spmd takes the
    owner's rows and no broadcast is made.  (The JAX
    version takes a template state to derive its PartitionSpecs; here the
    windows follow from the mesh.)

    A Lagrangian solver's PState: the fluid State windows as above and
    to_spmd gives this rank the cloud's parcels resident in its block, in
    `capacity` slots (default: the cloud's slot count, which no rank can
    overflow; `particles.distribute_cloud`, which raises ValueError for a
    rank with more residents or a parcel outside the mesh); from_spmd
    joins the ranks' slot blocks in rank order and sums their dropped
    counts.  Raises ValueError when a split does not divide its axis, and
    NotImplementedError for a solver `spmd_supported` rejects."""
    reason = spmd_supported(solver)
    if reason is not None:
        raise NotImplementedError(f"spmd decomposition unsupported: {reason}")
    mesh = solver.mesh
    nd = mesh.ndim
    ctx = block_context(mesh, grid)
    local_step = _with_mesh(solver, block_mesh(ctx)).make_step()
    # the QGD States' boundary rows (the QHD, scalar-transport and
    # reacting States have none)
    fluid = getattr(solver, "fluid", solver)
    owners = {}
    if hasattr(fluid, "_flux_sides"):
        owners = {"pbc": fluid._flux_sides(),
                  "wt": tuple(w[1:3] for w in fluid._wt_sides())}

    def step(s):
        with spmd.active(ctx):
            return local_step(s)

    def to_spmd(s):
        if hasattr(s, "cloud"):
            return type(s)(fluid=to_spmd(s.fluid),
                           cloud=_cloud_block(s.cloud, mesh, grid, ctx,
                                              capacity))
        return type(s)(*(_window(v, ctx, nd) for v in s))

    def from_spmd(s):
        if hasattr(s, "cloud"):
            return type(s)(fluid=from_spmd(s.fluid),
                           cloud=_join_cloud(s.cloud))
        out = {}
        for name, v in zip(s._fields, s):
            if name in owners:
                out[name] = tuple(
                    _join(spmd.all_gather(g), ctx, nd, owner)
                    for g, owner in zip(v, owners[name]))
            elif torch.is_tensor(v) and v.ndim >= nd:
                out[name] = _join(spmd.all_gather(v), ctx, nd)
            else:
                out[name] = v
        return type(s)(**out)

    return step, to_spmd, from_spmd


def _cloud_block(cloud, mesh, grid: ProcessGrid, ctx, capacity):
    """This rank's slot block of a global cloud: its resident parcels,
    active first, in `capacity` slots, and a zero dropped count."""
    from ..solvers.particles import distribute_cloud

    cap = int(capacity if capacity is not None else cloud.active.shape[0])
    blocks = distribute_cloud(cloud, mesh, grid, cap)
    r = grid.rank(*ctx.coords[:2]) if mesh.ndim > 1 else ctx.coords[0]
    return type(cloud)(
        *(v.narrow(v.ndim - 1, r * cap, cap).contiguous()
          for v in blocks[:5]),
        dropped=torch.zeros((), dtype=torch.int64, device=cloud.x.device))


def _join_cloud(c):
    """The ranks' slot blocks joined in rank order (a collective), with the
    dropped counts summed."""
    fields = [torch.cat(spmd.all_gather(v), dim=v.ndim - 1) for v in c[:5]]
    dropped = None if c.dropped is None else sum(spmd.all_gather(c.dropped))
    return type(c)(*fields, dropped=dropped)
