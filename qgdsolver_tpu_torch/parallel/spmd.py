"""The SPMD context that makes the composable solver layer run decomposed
(PyTorch port of `qgdsolver_tpu.parallel.spmd`).

The reference's MPI parallelism has two ingredients: the halo exchange
around each rank's block and the global reductions (the Courant gMax, the
fvc::smooth termination test).  Every stencil of this package reads
ghost-padded tensors built by `ops.pad.ghost_pad`, and every global quantity
goes through a few reduction helpers, so one context makes both
decomposition-aware:

* `ghost_pad` consults `current()`: on a decomposed mesh axis the ghost
  layer at a partition edge comes from the neighbour rank (`halo_layers`,
  one `batch_isend_irecv`), and the physical BC layer is used only at the
  global boundary.  Axes are padded in turn, so the second axis' exchange
  carries the corner ghosts of the first.
* `all_max`, `all_min`, `all_sum`, `all_any` are `dist.all_reduce` over the
  world.

In the JAX package "rank-local" means traced `axis_index` values inside
`shard_map`; here each process is one block, so the block's position is a
plain tuple of ints (`SpmdContext.coords`) and the edge predicates are
Python bools.  Without an active context every helper is a no-op.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import typing as tp

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AxisShard:
    """Decomposition of one mesh axis: `size` blocks of `n_local` cells."""

    size: int
    n_local: int


@dataclasses.dataclass(frozen=True)
class SpmdContext:
    """The active decomposition as this rank sees it.

    axes[a] is an AxisShard, or None where mesh axis `a` is whole;
    coords[a] is this rank's block index along axis a; `grid` maps the
    block indices of the first two axes to a rank (`rank(ix, iy)`);
    `global_mesh` is the full-domain mesh, on which BC value callables are
    evaluated before their layers are windowed to the block."""

    axes: tp.Tuple[tp.Optional[AxisShard], ...]
    global_shape: tp.Tuple[int, ...]
    coords: tp.Tuple[int, ...]
    grid: tp.Any
    global_mesh: tp.Any = None

    def sharded(self, a: int) -> bool:
        ax = self.axes[a]
        return ax is not None and ax.size > 1

    def is_lo(self, a: int) -> bool:
        """True if this block touches the global low boundary of axis a."""
        return self.coords[a] == 0

    def is_hi(self, a: int) -> bool:
        ax = self.axes[a]
        return ax is None or self.coords[a] == ax.size - 1

    def start(self, a: int) -> int:
        """The global index of this block's first cell along axis a."""
        ax = self.axes[a]
        return 0 if ax is None else self.coords[a] * ax.n_local

    def neighbour(self, a: int, step: int,
                  periodic: bool = False) -> tp.Optional[int]:
        """The rank `step` blocks away along axis a, or None past an end."""
        n = self.axes[a].size
        i = self.coords[a] + step
        if periodic:
            i %= n
        elif not 0 <= i < n:
            return None
        c = list(self.coords) + [0, 0]
        c[a] = i
        return self.grid.rank(c[0], c[1])


_state = threading.local()


def current() -> tp.Optional[SpmdContext]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def active(ctx: SpmdContext):
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


# ---------------------------------------------------------------------------
# what goes over the wire
# ---------------------------------------------------------------------------
#
# gloo moves no CUDA tensor point to point, so when ranks share one card
# (fewer cards than ranks: the gloo backend) every collective of a CUDA
# tensor goes through pinned host memory.  This pair of helpers is the one
# place that knows about that staging; under NCCL, and for CPU tensors, the
# tensors themselves go over the wire.


def _staged(x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend() == "gloo"


def _wire(x: torch.Tensor, copy: bool = True) -> torch.Tensor:
    """The tensor a collective takes for x: x itself, or a pinned host copy
    (an empty one with copy=False, for receiving)."""
    if not _staged(x):
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return host.copy_(x) if copy else host


def _unwire(dst: torch.Tensor, wire: torch.Tensor) -> None:
    if wire is not dst:
        dst.copy_(wire)


# ---------------------------------------------------------------------------
# reductions (no-ops without an active context)
# ---------------------------------------------------------------------------


def _reduce(x, op):
    """Elementwise all-reduce of a tensor of any shape, into a new tensor."""
    if current() is None or not dist.is_initialized():
        return x
    buf = x.detach().reshape(-1).clone()
    w = _wire(buf)
    dist.all_reduce(w, op=op)
    _unwire(buf, w)
    return buf.reshape(x.shape)


def all_max(x):
    """Global max of an already locally reduced tensor (gMax), elementwise:
    one collective for the fused steps' whole dt quad."""
    return _reduce(x, dist.ReduceOp.MAX)


def all_min(x):
    return _reduce(x, dist.ReduceOp.MIN)


def all_sum(x):
    return _reduce(x, dist.ReduceOp.SUM)


def all_any(x):
    """Global logical-or of a local boolean tensor."""
    if current() is None:
        return x
    return all_max(x.to(torch.int32)) > 0


def first_shard_value(v):
    """The value of the 0-dim tensor `v` on the rank whose every block
    coordinate is 0 (the owner of the global cell (0, ..., 0)), broadcast
    to every rank: one all-reduce of `v` masked to that rank (the pRefCell
    fix of a decomposed pressure solve)."""
    ctx = current()
    if ctx is None:
        return v
    first = all(c == 0 for c in ctx.coords)
    return all_sum(v if first else torch.zeros_like(v))


def all_gather(x: torch.Tensor) -> list:
    """Every rank's x (same shape on each), in rank order, on x's device."""
    if not dist.is_initialized():
        return [x]
    w = _wire(x.contiguous())
    out = [torch.empty_like(w) for _ in range(dist.get_world_size())]
    dist.all_gather(out, w)
    return [o.to(x.device) for o in out]


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------


def exchange(a: int, send_lo, send_hi, recv_lo, recv_hi,
             periodic: bool = False) -> None:
    """One `batch_isend_irecv` along mesh axis a.  send_lo[k] (this block's
    first layer) goes to the previous rank, whose recv_hi[k] takes it;
    send_hi[k] (the last layer) goes to the next rank's recv_lo[k].  The
    recv tensors are contiguous and filled in place; a side with no
    neighbour (a chain end unless periodic) neither sends nor receives."""
    ctx = current()
    prev = ctx.neighbour(a, -1, periodic)
    nxt = ctx.neighbour(a, +1, periodic)
    # tags pair the k-th layer of each direction under gloo; NCCL pairs the
    # operations of one peer in the order they are posted, which this order
    # keeps the same on both sides, a ring of two included
    ops, back = [], []
    for k in range(len(send_lo)):
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, _wire(send_hi[k].contiguous()),
                                  nxt, tag=2 * k))
        if prev is not None:
            ops.append(dist.P2POp(dist.isend, _wire(send_lo[k].contiguous()),
                                  prev, tag=2 * k + 1))
    for k in range(len(send_lo)):
        for peer, dst, tag in ((prev, recv_lo[k], 2 * k),
                               (nxt, recv_hi[k], 2 * k + 1)):
            if peer is not None:
                w = _wire(dst, copy=False)
                back.append((dst, w))
                ops.append(dist.P2POp(dist.irecv, w, peer, tag=tag))
    if not ops:
        return
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for dst, w in back:
        _unwire(dst, w)


def hop_exchange(a: int, up: torch.Tensor, down: torch.Tensor):
    """One hop of fixed-size slot arrays along decomposed mesh axis a,
    cyclically, as one `batch_isend_irecv`: `up` goes to the next rank,
    `down` to the previous one.  Returns (from_prev, from_next): what the
    previous rank sent up and the next rank sent down.  A Lagrangian
    cloud's migration packs its slot arrays (x, u, Tp, dp, active) into
    one tensor a direction."""
    from_prev = torch.empty_like(up)
    from_next = torch.empty_like(down)
    exchange(a, [down], [up], [from_prev], [from_next], periodic=True)
    return from_prev, from_next


def _sl(arr, axis, s):
    idx = [slice(None)] * arr.ndim
    idx[axis] = s
    return arr[tuple(idx)]


def halo_layers(arr, arr_axis: int, mesh_axis: int, periodic: bool = False):
    """The neighbour edge layers of `arr` along a decomposed mesh axis.

    Returns (from_prev, from_next, is_lo, is_hi): the previous rank's last
    layer and the next rank's first layer (size-1 slices along arr_axis,
    zeros at a chain end unless periodic), and whether this block touches
    the global low / high boundary.  The caller keeps the physical BC layer
    there: the pair is this port's processorFvPatch::patchNeighbourField."""
    ctx = current()
    n = arr.shape[arr_axis]
    boolean = arr.dtype == torch.bool
    if boolean:
        arr = arr.to(torch.uint8)
    from_prev = torch.zeros_like(_sl(arr, arr_axis, slice(0, 1))).contiguous()
    from_next = torch.zeros_like(from_prev)
    exchange(mesh_axis, [_sl(arr, arr_axis, slice(0, 1))],
             [_sl(arr, arr_axis, slice(n - 1, n))], [from_prev], [from_next],
             periodic)
    if boolean:
        from_prev, from_next = from_prev.bool(), from_next.bool()
    return from_prev, from_next, ctx.is_lo(mesh_axis), ctx.is_hi(mesh_axis)


# ---------------------------------------------------------------------------
# halo-framed blocks: the fused steps' carry
# ---------------------------------------------------------------------------
#
# A fused decomposed step carries each field as this rank's block with a
# one-cell halo frame on every side: (n_local + 2) along a decomposed axis,
# (n + 2) along a whole one.  The blocks of neighbouring ranks overlap on
# their halos.


def frame_window(ctx: SpmdContext, coords=None) -> tuple:
    """The slices of the halo-framed block at `coords` (this rank's by
    default) in the halo-framed global array."""
    coords = ctx.coords if coords is None else coords
    return tuple(slice(None) if ax is None else
                 slice(c * ax.n_local, c * ax.n_local + ax.n_local + 2)
                 for ax, c in zip(ctx.axes, coords))


def exchange_frames(frames) -> list:
    """Fill the partition-side halo layers of halo-framed blocks in place
    from the neighbours' edge layers, one decomposed axis after another.  An
    axis' layers span the whole frame, the halos of the axes before it
    included, so the corners come from the diagonal neighbour in two hops.
    Contiguous layers (the first axis') go as views; strided ones are packed
    and unpacked."""
    ctx = current()
    for a, ax in enumerate(ctx.axes):
        if not ctx.sharded(a):
            continue
        n = ax.n_local
        recv = [(f.select(a, 0), f.select(a, n + 1)) for f in frames]
        bufs = [tuple(x if x.is_contiguous() else
                      torch.empty(x.shape, dtype=x.dtype, device=x.device)
                      for x in pair) for pair in recv]
        exchange(a, [f.select(a, 1) for f in frames],
                 [f.select(a, n) for f in frames], [b[0] for b in bufs],
                 [b[1] for b in bufs])
        filled = (not ctx.is_lo(a), not ctx.is_hi(a))
        for pair, buf in zip(recv, bufs):
            for dst, b, got in zip(pair, buf, filled):
                if got and b is not dst:
                    dst.copy_(b)
    return frames


def join_frames(f: torch.Tensor, ctx: SpmdContext) -> torch.Tensor:
    """The halo-framed global array from every rank's block f (a
    collective: every rank calls it); the blocks' overlapping halos hold
    the same cells."""
    out = torch.empty(tuple(n + 2 for n in ctx.global_shape), dtype=f.dtype,
                      device=f.device)
    nd = len(ctx.axes)
    for r, blk in enumerate(all_gather(f)):
        coords = (tuple(ctx.grid.coords(r)) + (0,) * nd)[:nd]
        out[frame_window(ctx, coords)] = blk
    return out


# ---------------------------------------------------------------------------
# windows of global arrays
# ---------------------------------------------------------------------------


def localize_cells(v, mesh_ndim: int):
    """Window a spatially global cell array (a per-cell cqSc floor) to this
    block: each decomposed axis of global extent is cut to the block's
    [start, start + n_local).  Local or size-1 extents pass through."""
    ctx = current()
    if ctx is None or getattr(v, "ndim", 0) == 0:
        return v
    for b in range(mesh_ndim):
        if not ctx.sharded(b):
            continue
        ax = v.ndim - mesh_ndim + b
        if ax < 0:
            continue
        ext, nl = int(v.shape[ax]), ctx.axes[b].n_local
        if ext in (1, nl):
            continue
        if ext != ctx.global_shape[b]:
            raise ValueError(
                f"cell array extent {ext} along axis {b} matches neither "
                f"the local ({nl}) nor the global ({ctx.global_shape[b]}) "
                "size")
        v = _sl(v, ax, slice(ctx.start(b), ctx.start(b) + nl))
    return v


def localize_layer(v, a: int, mesh_ndim: int):
    """Window a spatially global BC layer (a value array, or a callable's
    result on the global coordinates) to this block along each decomposed
    axis b != a: extent n_global is cut to [start, start + n_local);
    extent n_global + 2 (edge-extended, axes < a being padded already) to
    [start, start + n_local + 2), which starts at the previous block's last
    entry and so reproduces the serial corner values."""
    ctx = current()
    if ctx is None or getattr(v, "ndim", 0) == 0:
        return v
    for b in range(mesh_ndim):
        if b == a or not ctx.sharded(b):
            continue
        ax = v.ndim - mesh_ndim + b
        if ax < 0:
            continue
        ext, nl = int(v.shape[ax]), ctx.axes[b].n_local
        ng = ctx.global_shape[b]
        if ext in (1, nl, nl + 2):
            continue
        if ext == ng:
            v = _sl(v, ax, slice(ctx.start(b), ctx.start(b) + nl))
        elif ext == ng + 2:
            v = _sl(v, ax, slice(ctx.start(b), ctx.start(b) + nl + 2))
        else:
            raise ValueError(
                f"BC layer extent {ext} along axis {b} matches neither the "
                f"local ({nl}) nor the global ({ng}) boundary size")
    return v
