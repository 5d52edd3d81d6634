"""Ghost-cell padding of cell fields under boundary conditions (PyTorch port
of `qgdsolver_tpu.ops.pad`).

Corner/edge ghosts come from padding the axes sequentially: the layer fed to
a later axis' BC already contains the earlier axes' ghosts, so the diagonal
ghost cells the vertex ("full") gradient stencil needs are consistent.

Under an active `parallel.spmd` context (a decomposed step) the ghost layer
of a decomposed axis at a partition edge comes from the neighbour rank, and
the physical BC layer is built only by the rank at the global boundary; the
sequential axis order then carries the diagonal corner ghosts across block
corners in two hops, as the serial construction makes them.
"""
from __future__ import annotations

import torch

from ..core import bc as bcm
from ..core.mesh import Mesh
from ..parallel import spmd


def _spatial_axis(arr_ndim: int, mesh_ndim: int, a: int) -> int:
    """Mesh axis a -> tensor axis (spatial axes are the trailing mesh_ndim)."""
    return arr_ndim - mesh_ndim + a


def _sl(arr, axis, s):
    idx = [slice(None)] * arr.ndim
    idx[axis] = s
    return arr[tuple(idx)]


def _layer_coords(mesh: Mesh, a: int, side: int):
    """Broadcastable coordinate tensors of the ghost layer being built while
    padding axis `a` (axes < a already padded -> extended centers)."""
    nd = mesh.ndim
    coords = []
    for b in range(nd):
        if b == a:
            c = mesh.tensor(mesh.x_faces[a][0 if side == 0 else -1]
                            ).reshape((1,) * nd)
        else:
            vals = mesh.ext_centers[b] if b < a else mesh.centers[b]
            shape = [1] * nd
            shape[b] = len(vals)
            c = mesh.tensor(vals).reshape(shape)
        coords.append(c)
    return tuple(coords)


def _eval_bc_value(v, t, coords, vector, ncomp, like):
    """Evaluate a BC value spec into a tensor broadcastable with the layer."""
    if callable(v):
        return v(t, coords)
    v = bcm.as_value(v, like)
    if vector and v.ndim == 1 and v.shape[0] == ncomp:
        return v.reshape((ncomp,) + (1,) * (like.ndim - 1))
    return v


def _ghost_layers(bc_lo, bc_hi, arr, mesh, a, t, vector):
    """(lo, hi) ghost layers (size 1 along the padded axis) for mesh axis a.

    With an active spmd context and axis `a` decomposed, a block edge that
    is a partition edge takes the neighbour rank's edge layer, and only a
    block at the global boundary builds that side's BC layer."""
    nd = mesh.ndim
    ax = _spatial_axis(arr.ndim, nd, a)
    ncomp = arr.shape[0] if vector else 0
    ctx = spmd.current()
    # BC value callables see the GLOBAL boundary coordinates (of this
    # step's moved mesh when the block is a window of one); the layer is
    # then windowed to the block
    cmesh = mesh if ctx is None else getattr(mesh, "global_mesh",
                                             ctx.global_mesh)

    def extend_prior(v):
        """Extend a BC layer along the already-padded axes b < a to the
        interior layer's ghosted extent: neighbour values across partition
        edges, edge replication at physical boundaries (the construction
        the interior ghosts got)."""
        if not torch.is_tensor(v) or v.ndim < nd:
            return v
        for b in range(a):
            axb = _spatial_axis(v.ndim, nd, b)
            if v.shape[axb] != mesh.shape[b] or mesh.shape[b] == 1:
                continue
            first = v.narrow(axb, 0, 1)
            last = v.narrow(axb, v.shape[axb] - 1, 1)
            if ctx is not None and ctx.sharded(b):
                prev_l, next_l, b_lo, b_hi = spmd.halo_layers(v, axb, b)
                first = first if b_lo else prev_l
                last = last if b_hi else next_l
            v = torch.cat([first, v, last], dim=axb)
        return v

    def ev(raw, side, interior):
        coords = _layer_coords(cmesh, a, side)
        v = _eval_bc_value(raw, t, coords, vector, ncomp, interior)
        return extend_prior(spmd.localize_layer(v, a, nd))

    def one(bc, side, interior, other_interior, dx, near2):
        if isinstance(bc, bcm.FixedValue):
            return 2.0 * ev(bc.value, side, interior) - interior
        if isinstance(bc, bcm.ZeroGradient):
            return interior
        if isinstance(bc, bcm.Symmetry):
            if vector:
                sign = torch.ones(ncomp, dtype=interior.dtype,
                                  device=interior.device)
                sign[a] = -1.0
                return interior * sign.reshape(
                    (ncomp,) + (1,) * (interior.ndim - 1))
            return interior
        if isinstance(bc, bcm.FixedGradient):
            return interior + ev(bc.grad, side, interior) * dx
        if isinstance(bc, bcm.Mixed):
            v = ev(bc.value, side, interior)
            f = ev(bc.fraction, side, interior)
            return 2.0 * (f * v + (1.0 - f) * interior) - interior
        if isinstance(bc, bcm.Periodic):
            return other_interior
        if isinstance(bc, (bcm.Extrapolated, bcm.WaveTransmissive)):
            # QGDFoam substitutes Mixed for WaveTransmissive before it
            # pads; elsewhere a whole-side marker is the
            # linear-extrapolation outflow, as in the JAX package
            return 2.0 * interior - near2
        if isinstance(bc, bcm.FluxSwitched):
            v = ev(bc.value, side, interior)
            mask = extend_prior(spmd.localize_layer(bc.outflow, a, nd))
            return torch.where(mask, interior, 2.0 * v - interior)
        if isinstance(bc, bcm.Segmented):
            # each segment's layer on its global face rectangles, later
            # segments winning where they overlap
            layer = None
            for rects, sub in bc.segments:
                if isinstance(sub, bcm.WaveTransmissive):
                    raise TypeError(
                        "a waveTransmissive segment of a split side needs "
                        "its carried face value, which only QGDFoam's step "
                        "substitutes: not padded as an extrapolation")
                sub_layer = one(sub, side, interior, other_interior, dx,
                                near2)
                if layer is None:
                    layer = torch.broadcast_to(sub_layer, interior.shape)
                else:
                    m = _segment_mask(rects, a, mesh, ctx, interior.device)
                    layer = torch.where(m, sub_layer, layer)
            return layer
        if isinstance(bc, bcm.InletOutlet):
            raise TypeError(
                "InletOutlet must be resolved per step via "
                "bc.resolve_inlet_outlet before padding")
        raise NotImplementedError(f"BC {bc!r} is not in the port")

    n = arr.shape[ax]
    i_lo = _sl(arr, ax, slice(0, 1))
    i_hi = _sl(arr, ax, slice(n - 1, n))
    is_lo = is_hi = True
    if ctx is not None and ctx.sharded(a):
        periodic = isinstance(bc_lo, bcm.Periodic)
        from_prev, from_next, is_lo, is_hi = spmd.halo_layers(
            arr, ax, a, periodic=periodic)
        if periodic:
            # the global wraparound is the neighbour exchange
            return from_prev, from_next, ax
    lo = one(bc_lo, 0, i_lo, i_hi, mesh.dx[a][0],
             _sl(arr, ax, slice(1, 2))) if is_lo else from_prev
    hi = one(bc_hi, 1, i_hi, i_lo, mesh.dx[a][-1],
             _sl(arr, ax, slice(n - 2, n - 1))) if is_hi else from_next
    return lo, hi, ax


def _segment_mask(rects, a, mesh, ctx, device):
    """Boolean mask over the axis-`a` ghost layer's spatial dims that
    selects the global cell-index rectangles `rects` (tangential axes in
    ascending order).  Axes < a carry one ghost position on each side
    (index -1 and n, clamped into the nearest cell); under an spmd context
    local positions are offset by the block's start."""
    nd = mesh.ndim
    tang = [b for b in range(nd) if b != a]
    glob = ctx.global_mesh if ctx is not None else mesh
    mask = None
    for rect in rects:
        m = None
        for k, b in enumerate(tang):
            lo_k, hi_k = rect[k]
            ext = mesh.shape[b] + 2 if b < a else mesh.shape[b]
            idx = torch.arange(ext, device=device) - (1 if b < a else 0)
            if ctx is not None:
                idx = idx + ctx.start(b)
            idx = torch.clamp(idx, 0, glob.shape[b] - 1)
            shape = [1] * nd
            shape[b] = ext
            cond = ((idx >= lo_k) & (idx < hi_k)).reshape(shape)
            m = cond if m is None else (m & cond)
        mask = m if mask is None else (mask | m)
    return mask


def ghost_pad(field, bcs: bcm.FieldBCs, mesh: Mesh, t=0.0,
              vector: bool = False):
    """Pad `field` with one ghost layer per spatial axis.

    field: (..., n0, n1[, n2]) — trailing axes are spatial; for vector=True
    the leading axis is the component axis and Symmetry flips the normal
    component.
    """
    out = field
    for a in range(mesh.ndim):
        lo, hi, ax = _ghost_layers(bcs[a, 0], bcs[a, 1], out, mesh, a, t,
                                   vector)
        shape = list(out.shape)
        shape[ax] = 1
        out = torch.cat([torch.broadcast_to(lo, shape), out,
                         torch.broadcast_to(hi, shape)], dim=ax)
    return out


def trim_other_axes(arr, mesh_ndim: int, keep_axis: int):
    """Drop the ghost layers along every spatial axis except `keep_axis`."""
    sl = [slice(None)] * arr.ndim
    for a in range(mesh_ndim):
        if a != keep_axis:
            n = arr.shape[_spatial_axis(arr.ndim, mesh_ndim, a)]
            sl[_spatial_axis(arr.ndim, mesh_ndim, a)] = slice(1, n - 1)
    return arr[tuple(sl)]
