"""Stairstep immersed solid regions: the dead cells of L-shaped multi-block
meshes (PyTorch port of `qgdsolver_tpu.core.solid`).

The structured mesh keeps the bounding box and marks the blocked-out cells
in `Mesh.solid`.  Wall behaviour comes from a mirror fill before each step:
every solid cell next to fluid takes the mirror of its fluid neighbours
(U <- -avg(U_nb), zero-gradient scalars <- avg), so the shared face sees a
zero normal velocity and the wall pressure, as a domain-boundary ghost
would.  A solid cell averages over all its fluid neighbours, so convex
corners are first order; cells deep in the solid keep their values and
never reach the flow.
"""
from __future__ import annotations

import numpy as np
import torch


class StairstepSolid:
    """The neighbour stencils and the mirror fill of a boolean solid mask,
    with its masks on `device`."""

    def __init__(self, solid, device="cpu"):
        solid = np.asarray(solid, dtype=bool)
        nd = solid.ndim
        fluid = ~solid
        nb = []  # (axis, shift, solid cells with that fluid neighbour)
        cnt = np.zeros(solid.shape, dtype=np.int32)
        for a in range(nd):
            for s in (1, -1):
                nf = np.roll(fluid, -s, axis=a)
                edge = [slice(None)] * nd
                edge[a] = slice(-1, None) if s == 1 else slice(0, 1)
                nf[tuple(edge)] = False  # no wrapped neighbours
                m = nf & solid
                if m.any():
                    nb.append((a, s, torch.as_tensor(m, device=device)))
                cnt += m
        self.nb = nb
        self.solid = torch.as_tensor(solid, device=device)
        self.boundary = torch.as_tensor((cnt > 0) & solid, device=device)
        self.count = torch.as_tensor(np.maximum(cnt, 1).astype(np.float64),
                                     device=device)

    def mirror(self, f, sign: float = 1.0):
        """Solid boundary cells <- sign * avg(adjacent fluid values); sign
        +1 is the zero-gradient mirror (scalars), -1 the no-slip mirror
        (velocity components).  Other cells pass through."""
        acc = torch.zeros_like(f)
        for a, s, m in self.nb:
            acc = acc + torch.where(m, torch.roll(f, -s, dims=a), 0.0)
        fill = (sign / self.count) * acc
        return torch.where(self.boundary, fill.to(f.dtype), f)

    def mirror_vector(self, U):
        """No-slip mirror of a (nd, *cells) velocity stack."""
        return torch.stack([self.mirror(U[i], sign=-1.0)
                            for i in range(U.shape[0])])
