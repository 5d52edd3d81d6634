"""Mesh-quality screening, the selectBadCells utility (PyTorch port of
`qgdsolver_tpu.utils.badcells`).

The reference utility (utils/selectBadCells, selectBadCells_8C_source.html:
47-186) flags cells whose faces are near-parallel (badFaceAngle,
|n_i . n_k| >= faceCosine) and cells with aspectRatio > maxAspectRatio
(highAspectRatio), writing cellSets read from system/QGDCellQuality.

On a rectilinear block mesh face normals are axis-aligned, and opposite
faces of a brick share no vertex, so the angle check passes by
construction.  What remains meaningful are the aspect ratio and the
expansion (grading) ratio, both reported as boolean cell masks (the
"cellSet" analogue).  They are computed with torch ops in float64 on the
mesh's device, whatever the mesh's dtype, as the JAX version computes them
in float64 numpy.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CellQualityReport:
    high_aspect_ratio: torch.Tensor  # bool mask over the cells
    high_expansion: torch.Tensor  # bool mask over the cells
    max_aspect_ratio: float
    max_expansion: float
    n_bad: int  # cells in either mask


def select_bad_cells(mesh, max_aspect_ratio: float = 100.0,
                     max_expansion: float = 3.0) -> CellQualityReport:
    """Screen the mesh (config mirror of system/QGDCellQuality:
    selectBadCells_8C:62-75 reads faceCosine/maxAspectRatio).  The masks
    lie on the mesh's device; the three numbers come back in one host
    read."""
    nd, shape = mesh.ndim, tuple(mesh.shape)
    dxs = [torch.as_tensor(d, dtype=torch.float64, device=mesh.device)
           for d in mesh.dx]
    ones = torch.ones(shape, dtype=torch.float64, device=mesh.device)

    # aspect ratio: max over axis pairs of dx_a/dx_b per cell
    ar = ones
    for a in range(nd):
        for b in range(nd):
            if a != b:
                ratio = _bcast(dxs[a], a, nd) / _bcast(dxs[b], b, nd)
                ar = torch.maximum(ar, ratio.expand(shape))
    # expansion ratio: neighbour dx ratio along each axis
    ex = ones
    for a in range(nd):
        d = dxs[a]
        r = torch.ones_like(d)
        if d.shape[0] > 1:
            r[1:] = torch.maximum(d[1:] / d[:-1], d[:-1] / d[1:])
            r[0] = r[1]
        ex = torch.maximum(ex, _bcast(r, a, nd).expand(shape))

    high_ar = ar > max_aspect_ratio
    high_ex = ex > max_expansion
    n_bad = torch.count_nonzero(high_ar | high_ex).to(torch.float64)
    top_ar, top_ex, n = torch.stack([ar.max(), ex.max(), n_bad]).tolist()
    return CellQualityReport(high_aspect_ratio=high_ar,
                             high_expansion=high_ex, max_aspect_ratio=top_ar,
                             max_expansion=top_ex, n_bad=int(n))


def _bcast(arr, axis, nd):
    shape = [1] * nd
    shape[axis] = arr.shape[0]
    return arr.reshape(shape)
