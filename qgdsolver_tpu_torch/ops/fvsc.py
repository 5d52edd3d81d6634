"""Face-centered differential operators (PyTorch port of
`qgdsolver_tpu.ops.fvsc`).

On a structured rectilinear mesh the reference's full-stencil schemes
(leastSquares, GaussVolPoint) coincide with the tensor-product vertex
reconstruction implemented here as `scheme="full"`; `scheme="reduced"` is
the face-normal-only operator (grad f ~= nf * snGrad(f)).  All operators
are slicing + multiply-add on ghost-padded tensors.

Conventions: cell fields have the `mesh.ndim` spatial axes trailing, leading
component axes broadcast through; face fields are tuples with one tensor per
axis (n_a+1 entries along axis a); (grad U)[i, j] = d U_j / d x_i.
"""
from __future__ import annotations

import torch

from ..core import bc as bcm
from ..core.mesh import Mesh
from .pad import _sl, _spatial_axis, ghost_pad, trim_other_axes


def _ax(arr, mesh_ndim, a):
    return _spatial_axis(arr.ndim, mesh_ndim, a)


def _bcast_1d(vals, arr, axis):
    shape = [1] * arr.ndim
    shape[axis] = len(vals)
    return torch.as_tensor(vals, dtype=arr.dtype,
                           device=arr.device).reshape(shape)


def _lo(arr, axis):
    return _sl(arr, axis, slice(0, arr.shape[axis] - 1))


def _hi(arr, axis):
    return _sl(arr, axis, slice(1, None))


def _interp_padded(fp, mesh: Mesh, a: int):
    """Linear interpolation along axis a of a tensor padded along a."""
    ax = _ax(fp, mesh.ndim, a)
    w = _bcast_1d(mesh.w_face[a], fp, ax)
    return w * _lo(fp, ax) + (1.0 - w) * _hi(fp, ax)


def _sn_grad_padded(fp, mesh: Mesh, a: int):
    """Face-normal gradient along axis a of a tensor padded along a."""
    ax = _ax(fp, mesh.ndim, a)
    d = _bcast_1d(mesh.d_centers[a], fp, ax)
    return (_hi(fp, ax) - _lo(fp, ax)) / d


def _tangential_deriv(fa, mesh: Mesh, b: int):
    """d/dx_b at a-face centers, from a-face values still padded along b:
    interpolate to the b-vertices, then difference across each cell."""
    ax = _ax(fa, mesh.ndim, b)
    wv = _bcast_1d(mesh.w_vertex[b], fa, ax)
    v = wv * _lo(fa, ax) + (1.0 - wv) * _hi(fa, ax)
    dxb = _bcast_1d(mesh.dx[b], fa, ax)
    return (_hi(v, ax) - _lo(v, ax)) / dxb


def interpolate(field, bcs: bcm.FieldBCs, mesh: Mesh, t=0.0, vector=False):
    """qgdInterpolate: linear cell->face interpolation, as a face tuple."""
    return interp_from_padded(ghost_pad(field, bcs, mesh, t=t, vector=vector),
                              mesh)


def interp_from_padded(fp, mesh: Mesh):
    """Face interpolation of an already ghost-padded tensor."""
    return tuple(trim_other_axes(_interp_padded(fp, mesh, a), mesh.ndim, a)
                 for a in range(mesh.ndim))


def interp_axis_from_padded(fp, mesh: Mesh, a: int):
    """Face interpolation of a padded tensor to faces of a single axis."""
    return trim_other_axes(_interp_padded(fp, mesh, a), mesh.ndim, a)


def grad(field, bcs: bcm.FieldBCs, mesh: Mesh, scheme="full", t=0.0,
         vector=False):
    """fvsc::grad of a cell field under `bcs` (`grad_from_padded` of its
    ghost-padded tensor)."""
    return grad_from_padded(ghost_pad(field, bcs, mesh, t=t, vector=vector),
                            mesh, scheme=scheme)


def sn_grad(field, bcs: bcm.FieldBCs, mesh: Mesh, t=0.0, vector=False):
    """Face-normal gradient per axis (a face tuple) of a cell field under
    `bcs`."""
    return sn_grad_from_padded(ghost_pad(field, bcs, mesh, t=t,
                                         vector=vector), mesh)


def sn_grad_from_padded(fp, mesh: Mesh):
    """Face-normal gradient per axis of an already ghost-padded tensor."""
    return tuple(trim_other_axes(_sn_grad_padded(fp, mesh, a), mesh.ndim, a)
                 for a in range(mesh.ndim))


def scheme_for(spec, term: str) -> str:
    """Per-term fvsc scheme selection: one word for every term, or a dict
    keyed by term name with an optional "default" entry."""
    if isinstance(spec, str):
        return spec
    return spec.get(term, spec.get("default", "full"))


_SCHEMES = {"leastSquares": "full", "leastSquaresOpt": "full",
            "GaussVolPoint": "full", "full": "full", "reduced": "reduced"}


def normalize_scheme(scheme: str, ndim: int) -> str:
    """A reference fvsc scheme word -> "full" or "reduced".  The
    leastSquares words are refused on 3D meshes, as the reference does."""
    if scheme not in _SCHEMES:
        raise ValueError(f"unknown fvsc scheme {scheme!r}")
    if ndim == 3 and scheme in ("leastSquares", "leastSquaresOpt"):
        raise ValueError("leastSquares fvsc schemes are forbidden on 3D "
                         "meshes; use GaussVolPoint/full")
    return _SCHEMES[scheme]


def grad_from_padded(fp, mesh: Mesh, scheme="full"):
    """fvsc::grad of an already ghost-padded tensor.

    Scalar input (..., cells+ghosts) -> per-axis tensors (ndim, ..., faces_a):
    leading axis = derivative direction i.  Vector input (d, ...) ->
    (ndim, d, faces_a), G[i, j] = d U_j / d x_i.  The "reduced" scheme
    keeps the normal component and zeroes the tangential ones.
    """
    full = normalize_scheme(scheme, mesh.ndim) == "full"
    nd = mesh.ndim
    out = []
    for a in range(nd):
        comps = [None] * nd
        comps[a] = trim_other_axes(_sn_grad_padded(fp, mesh, a), nd, a)
        fa = _interp_padded(fp, mesh, a) if full else None
        for b in range(nd):
            if b == a:
                continue
            if not full:
                comps[b] = torch.zeros_like(comps[a])
                continue
            tb = _tangential_deriv(fa, mesh, b)
            # tb consumed the b-ghosts; trim the remaining ghost axes
            sl = [slice(None)] * tb.ndim
            for c in range(nd):
                if c != a and c != b:
                    n = tb.shape[_ax(tb, nd, c)]
                    sl[_ax(tb, nd, c)] = slice(1, n - 1)
            comps[b] = tb[tuple(sl)]
        out.append(torch.stack(comps, dim=0))
    return tuple(out)


def div_flux(phi_faces, mesh: Mesh):
    """Cell divergence of an area-included face flux: fvc::div(phi)."""
    nd = mesh.ndim
    tot = None
    for a, phi in enumerate(phi_faces):
        ax = _ax(phi, nd, a)
        d = _hi(phi, ax) - _lo(phi, ax)
        tot = d if tot is None else tot + d
    return tot / mesh.cell_volume


def grad_cell(field, bcs: bcm.FieldBCs, mesh: Mesh, t=0.0):
    """fvc::grad — Gauss cell-centered gradient of a scalar, (ndim, cells)."""
    return grad_cell_from_faces(interpolate(field, bcs, mesh, t=t), mesh)


def grad_cell_from_faces(faces, mesh: Mesh):
    """fvc::grad from face values already interpolated: (ndim, ..., cells),
    row a the difference along axis a over dx_a.  A vector's faces give
    G[i, j] = d U_j / d x_i."""
    nd = mesh.ndim
    comps = []
    for a in range(nd):
        fa = faces[a]
        ax = _ax(fa, nd, a)
        dxa = _bcast_1d(mesh.dx[a], fa, ax)
        comps.append((_hi(fa, ax) - _lo(fa, ax)) / dxa)
    return torch.stack(comps, dim=0)


def grad_cell_vector(U, bcs: bcm.FieldBCs, mesh: Mesh, t=0.0):
    """fvc::grad of a vector field -> cell tensor (ndim, d, cells),
    G[i, j] = d U_j / d x_i."""
    return grad_cell_from_faces(interpolate(U, bcs, mesh, t=t, vector=True),
                                mesh)


def laplacian_explicit(gamma_faces, field, bcs: bcm.FieldBCs, mesh: Mesh,
                       t=0.0, vector=False):
    """fvc::laplacian(Gamma_f, x) = (1/V) sum_f Gamma_f |S_f| snGrad(x),
    gamma_faces per-axis face tensors (or scalars)."""
    fp = ghost_pad(field, bcs, mesh, t=t, vector=vector)
    nd = mesh.ndim
    tot = None
    for a in range(nd):
        g = trim_other_axes(_sn_grad_padded(fp, mesh, a), nd, a)
        flux = gamma_faces[a] * mesh.face_area(a) * g
        ax = _ax(flux, nd, a)
        d = _hi(flux, ax) - _lo(flux, ax)
        tot = d if tot is None else tot + d
    return tot / mesh.cell_volume
