"""The two-phase (VoF) properties and interface machinery of interQHDFoam
(PyTorch port of `qgdsolver_tpu.physics.twophase`).

The reference's TwoPhaseQGD library:
  * constTwoPhaseProperties: per-phase constants nu1/nu2, rho1/rho2 and the
    per-phase relaxation times Tau1/Tau2;
  * twoPhaseIcoQGDThermo: the mixture rho = (rho1 - rho2)*alpha1 + rho2,
    mu = (rho1*nu1 - rho2*nu2)*alpha1 + rho2*nu2;
  * twoPhaseConstTau: tau = alpha1*Tau1 + (1 - alpha1)*Tau2;
  * qInterfaceProperties: the interface normals nHatf, the curvature
    K = -div(nHatf) and the surface-tension force interp(sigma*K)*snGrad(a1),
    with the wall contact angles of correctContactAngle.

Every per-step quantity is a torch op on the fields' device.  On a wedge
(`AxisymmetricMesh`) the r-weighted metrics carry the curvature's hoop part
through the conservative divergence, and `reconstruct` divides by the
per-face areas.  Under a decomposition the ghost layers come from the
neighbour blocks, and a contact angle acts only on the block that owns its
wall.
"""
from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch

from ..core import bc as bcm
from ..ops import fvsc
from ..parallel import spmd


@dataclasses.dataclass(frozen=True)
class TwoPhaseProperties:
    """constTwoPhaseProperties and the interface constants."""

    rho1: float
    rho2: float
    nu1: float
    nu2: float
    tau1: float
    tau2: float
    sigma: float = 0.0  # surface tension coefficient
    c_alpha: float = 1.0  # interface compression (cAlpha)

    # the mixture closures (twoPhaseIcoQGDThermo)
    def rho(self, alpha1):
        return (self.rho1 - self.rho2) * alpha1 + self.rho2

    def mu(self, alpha1):
        return (self.rho1 * self.nu1 - self.rho2 * self.nu2) * alpha1 \
            + self.rho2 * self.nu2

    def tau(self, alpha1):
        """The twoPhaseConstTau blend."""
        return alpha1 * self.tau1 + (1.0 - alpha1) * self.tau2


class Interface(tp.NamedTuple):
    """A step's interface quantities."""

    n_hat_f: tuple  # per-axis face normal flux nHatf = nHat & Sf
    K: torch.Tensor  # cell curvature
    stf: tuple  # per-axis surface-tension force (a face scalar)


def delta_n(mesh) -> float:
    """The stabilisation deltaN = 1e-8/cbrt(mean cell volume) of `mesh` (a
    host read of its volumes: call it once per solver, on the whole
    mesh)."""
    vol = mesh.cell_volume.detach().cpu().numpy()
    return 1e-8 / float(np.cbrt(np.mean(np.broadcast_to(vol, mesh.shape))))


@dataclasses.dataclass(frozen=True)
class ContactAngle:
    """A wall's contact angle (the constant/dynamicAlphaContactAngle BCs of
    qInterfaceProperties::correctContactAngle), theta0 in radians.  The
    dynamic variant (uTheta > 0):
    theta = theta0 + (thetaA - thetaR)*tanh(u_wall/uTheta)."""

    theta0: float
    uTheta: float = 0.0
    thetaA: float = 0.0
    thetaR: float = 0.0

    def theta(self, u_wall=0.0):
        if self.uTheta <= 0.0:
            return self.theta0
        return self.theta0 + (self.thetaA - self.thetaR) * torch.tanh(
            torch.as_tensor(u_wall, dtype=torch.float64) / self.uTheta)


def owns_wall(a: int, side: int) -> bool:
    """Whether this block's edge (axis a, side) is the mesh's boundary
    (always, undecomposed)."""
    ctx = spmd.current()
    return ctx is None or (ctx.is_lo(a) if side == 0 else ctx.is_hi(a))


def _apply_contact_angle(n_hat_f, contact_angles, mesh, u_wall):
    """correctContactAngle on a brick mesh: at a wall (axis a, side s) the
    corrected unit normal has nHat.nf = cos(theta), nf the outward wall
    normal, so the wall face's normal flux is -/+ cos(theta)*|Sf| (the
    reference's rotation lands there exactly; the tangential part does not
    enter nHatf).  Decomposed, only a block whose edge is that wall sets
    it: its other edges are partition faces."""
    nd = mesh.ndim
    out = list(n_hat_f)
    for (a, side), ca in contact_angles.items():
        if not owns_wall(a, side):
            continue
        th = ca.theta(u_wall.get((a, side), 0.0)
                      if isinstance(u_wall, dict) else u_wall)
        cosv = (torch.cos(th) if torch.is_tensor(th) else math.cos(th))
        f = out[a]
        ax = f.ndim - nd + a
        n = f.shape[ax]
        idx = 0 if side == 0 else n - 1
        # the outward normal at the low side is -e_a: nHat.e_a = -cos(theta)
        orient = -1.0 if side == 0 else 1.0
        new_layer = orient * cosv * mesh.face_area(a)
        if torch.is_tensor(new_layer):
            new_layer = new_layer.to(device=f.device, dtype=f.dtype)
        shape = [1] * f.ndim
        shape[ax] = n
        iota = torch.arange(n, device=f.device).reshape(shape)
        out[a] = torch.where(iota == idx, new_layer, f)
    return tuple(out)


def interface_properties(alpha1, bc_alpha, mesh, sigma: float, t=0.0,
                         contact_angles=None, u_wall=0.0,
                         dN=None) -> Interface:
    """nHatf, the curvature and the surface-tension force.
    `contact_angles` maps (axis, side) -> ContactAngle for wall patches;
    `u_wall` is the wall slip speed (a scalar, or {(axis, side): value})
    of the dynamic variant; dN the stabilisation (`delta_n` of `mesh` when
    None: a host read, so a solver passes it).  On a wedge the curvature's
    hoop part n_r/r comes from the r-weighted divergence with zero-area
    axis faces, which limits to 2*dn_r/dr on the first ring."""
    nd = mesh.ndim
    if dN is None:
        dN = delta_n(mesh)
    grad_a = fvsc.grad_cell(alpha1, bc_alpha, mesh, t=t)  # (d, cells)
    bc_zg = bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
    grad_af = fvsc.interpolate(grad_a, bc_zg, mesh)
    n_hat_f = []
    for a in range(nd):
        g = grad_af[a]
        mag = torch.sqrt(torch.sum(g * g, dim=0)) + dN
        n_hat_f.append(g[a] / mag * mesh.face_area(a))  # nHat & Sf
    if contact_angles:
        n_hat_f = _apply_contact_angle(tuple(n_hat_f), contact_angles, mesh,
                                       u_wall)
    K = -fvsc.div_flux(tuple(n_hat_f), mesh)
    sigK_f = fvsc.interpolate(sigma * K, bc_zg, mesh)
    sn_a = fvsc.sn_grad(alpha1, bc_alpha, mesh, t=t)
    stf = tuple(sigK_f[a] * sn_a[a] for a in range(nd))
    return Interface(n_hat_f=tuple(n_hat_f), K=K, stf=stf)


def reconstruct(face_flux, mesh):
    """fvc::reconstruct of a face-normal flux (X & Sf) into a cell vector:
    component a = (flux_lo + flux_hi)/(area_lo + area_hi), the brick
    formula (lo + hi)/(2|S_a|) on constant per-axis areas, with the
    per-face areas of r-weighted (wedge) metrics."""
    nd = mesh.ndim
    comps = []
    for a, f in enumerate(face_flux):
        ax = f.ndim - nd + a
        n = f.shape[ax]
        area = torch.broadcast_to(mesh.face_area(a), f.shape[f.ndim - nd:])
        comps.append((f.narrow(ax, 0, n - 1) + f.narrow(ax, 1, n - 1))
                     / (area.narrow(a, 0, n - 1) + area.narrow(a, 1, n - 1)))
    return torch.stack(comps, dim=0)
