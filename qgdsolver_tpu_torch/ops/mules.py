"""MULES: the multidimensional universal limiter for explicit solution
(PyTorch port of `qgdsolver_tpu.ops.mules`).

mulesQHDFoam's T equation (reference MULESTEqn.H) advects T with
`MULES::explicitSolve` between global gMin/gMax bounds.  Here that is the
Zalesak flux-corrected-transport limiter of the same structure: low-order
upwind transport plus an antidiffusive correction whose per-face weights
are tightened over a few iterations, all per-axis tensor ops.

Fluxes are area-included face values: `phi` the volumetric transport flux,
`phiH` the high-order scalar flux limited toward upwind.  The upwind donor
at a boundary face is the boundary cell itself (an edge-replicated layer),
as in the JAX package.  Under an spmd context the layer across a partition
edge is the neighbour rank's (`spmd.halo_layers`), for the donors and for
the limiter's per-cell ratios, so a decomposed run computes every face as
the serial run does; the bounds are the caller's global ones.
"""
from __future__ import annotations

import torch

from ..core.mesh import Mesh
from ..parallel import spmd
from . import fvsc


def _edge_ext(f, nd: int, a: int):
    """f with one more layer at each end of mesh axis a: the neighbour
    rank's edge layer across a partition edge, f's own edge layer at the
    global boundary."""
    ax = f.ndim - nd + a
    n = f.shape[ax]
    first = f.narrow(ax, 0, 1)
    last = f.narrow(ax, n - 1, 1)
    ctx = spmd.current()
    if ctx is not None and ctx.sharded(a):
        prev_l, next_l, is_lo, is_hi = spmd.halo_layers(f, ax, a)
        first = first if is_lo else prev_l
        last = last if is_hi else next_l
    return torch.cat([first, f, last], dim=ax)


def _pairs(f, nd: int, a: int):
    """(lo, hi): the cells on either side of each a-face of an extended
    tensor."""
    ax = f.ndim - nd + a
    n = f.shape[ax]
    return f.narrow(ax, 0, n - 1), f.narrow(ax, 1, n - 1)


def _upwind_flux(T, phi, mesh: Mesh, a: int):
    """Low-order (upwind donor) face flux of T along axis a."""
    lo, hi = _pairs(_edge_ext(T, mesh.ndim, a), mesh.ndim, a)
    return torch.where(phi >= 0, lo, hi) * phi


def _cell_sums(corr, mesh: Mesh):
    """(P_in, P_out): per-cell sums of incoming and outgoing antidiffusive
    flux.  At a cell's high face the outward flux is +corr, at its low
    face -corr."""
    nd = mesh.ndim
    p_in = p_out = 0.0
    for a, c in enumerate(corr):
        c_lo, c_hi = _pairs(c, nd, a)  # the cell's low and high faces
        p_in = p_in + torch.clamp(c_lo, min=0.0) \
            + torch.clamp(-c_hi, min=0.0)
        p_out = p_out + torch.clamp(-c_lo, min=0.0) \
            + torch.clamp(c_hi, min=0.0)
    return p_in, p_out


def limit(T, phi, phiH, dt, mesh: Mesh, t_max, t_min, n_iter: int = 3,
          eps: float = 1e-30):
    """The limited face fluxes phiBD + lam*(phiH - phiBD), a per-axis
    tuple.

    T: the transported cell field (old values); phi: per-axis volumetric
    face fluxes; phiH: per-axis high-order scalar face fluxes; t_max,
    t_min: the bounds (tensors or scalars; MULESTEqn uses the global
    gMax/gMin)."""
    nd = mesh.ndim
    vol = mesh.cell_volume
    phiBD = tuple(_upwind_flux(T, phi[a], mesh, a) for a in range(nd))
    corr = tuple(phiH[a] - phiBD[a] for a in range(nd))
    # the low-order provisional solution
    T_low = T - dt * fvsc.div_flux(phiBD, mesh)

    lam = tuple(torch.ones_like(c) for c in corr)
    for _ in range(n_iter):
        p_in, p_out = _cell_sums(tuple(lam[a] * corr[a] for a in range(nd)),
                                 mesh)
        q_in = (t_max - T_low) * vol / dt
        q_out = (T_low - t_min) * vol / dt
        r_in = torch.clamp(torch.clamp(q_in, min=0.0) / (p_in + eps),
                           max=1.0)
        r_out = torch.clamp(torch.clamp(q_out, min=0.0) / (p_out + eps),
                            max=1.0)
        new_lam = []
        for a in range(nd):
            ri_up, ri_dn = _pairs(_edge_ext(r_in, nd, a), nd, a)
            ro_up, ro_dn = _pairs(_edge_ext(r_out, nd, a), nd, a)
            # a positive correction flows out of the low cell into the
            # high one
            lam_a = torch.where(corr[a] >= 0, torch.minimum(ro_up, ri_dn),
                                torch.minimum(ri_up, ro_dn))
            new_lam.append(lam_a * lam[a])
        lam = tuple(new_lam)
    return tuple(phiBD[a] + lam[a] * corr[a] for a in range(nd))


def explicit_solve(T, phi, phiH, dt, mesh: Mesh, t_max, t_min,
                   n_iter: int = 3):
    """MULES::explicitSolve: the bounded explicit update of T with the
    limited fluxes; returns (T_new, fluxes)."""
    flux = limit(T, phi, phiH, dt, mesh, t_max, t_min, n_iter=n_iter)
    return T - dt * fvsc.div_flux(flux, mesh), flux
