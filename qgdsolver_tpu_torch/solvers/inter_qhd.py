"""interQHDFoam — the two-phase incompressible VoF QHD solver with surface
tension (PyTorch port of `qgdsolver_tpu.solvers.inter_qhd`).

Per step (reference interQHDFoam.C):
  thermo.correct : the mixture rho/mu/tau and the interface curvature
                   (`physics.twophase`)
  updateFields   : gradUf, gradAlpha1f, da1dt = -(U.grad alpha1),
                   cFrc = reconstruct(stf*|Sf|),
                   BdFrc = g*(rho + da1dt*(Tau1*rho1 - Tau2*rho2))
  updateFluxes   : phiwon = Sf&((Uf.grad)U - g);
                   phiwo_k = (phiwon - phicf/rho_k)*Tau_k
  mixture pEqn   : div(phiu) + div(phiwm)
                   - lap(alpha1f*Tau1/rho1 + alpha2f*Tau2/rho2, p) = 0,
                   phiwm = -phiwo1*alpha1f - phiwo2*alpha2f
                           + phiu*da1dtf*(Tau1 - Tau2),
                   with the mQhdFlux p BC substituted per step; the pRef fix
                   on a pure-Neumann system; per-phase fluxes
                   phiw_k = phiwo_k + (Tau_k/rho_k)|Sf| snGrad p;
                   phi = phiu + phiwm + pEqn.flux()
  alpha1 eqn     : the QGD relative-flux terms and interface compression
                   cAlpha*|phi|*nHatf, limited to [0, 1] by MULES, an
                   explicit solve and a clip; optionally smoothed
                   (smoothSolution.H)
  mass fluxes    : rhoPhi = phiAlpha1f*rho1 + phiAlpha2f*rho2
  UEqn           : ddt(rho, U) + div(rhoPhi*Uf - phiu*(alpha1f rho1 W1
                   + alpha2f rho2 W2)) - lap(mu_f, U) - div(transpose)
                   - BdFrc + (reconstruct(snGrad(p)|Sf|) - cFrc)
                   *(1 + da1dt*(Tau1 - Tau2)) = 0, with the wedge's hoop
                   source, implicit (CG) or explicit.

Under a decomposition (`parallel.sharding`) the step sees at each
partition face what the serial step sees, where the JAX package's shard
body does not: the upwind donor of the compression fluxes is the
neighbour block's cell (`upwind_flux` through `mules._edge_ext`), the pRef
value is the global cell (0, ..., 0)'s (`pressure_reference`), the
compression flux is zeroed at the global boundary only (`uncoupled_zeroed`)
and deltaN is the whole mesh's, taken once (`_whole_mesh`).  These names
are module attributes so that a test can put the JAX behaviour back and see
the decomposed run part from the serial one.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ..core import bc as bcm
from ..core.mesh import Mesh
from ..ops import fvsc, linsolve, mules
from ..parallel import spmd
from ..physics import twophase
from ..physics.twophase import TwoPhaseProperties, reconstruct
from . import common
from .common import TimeControls


class State(tp.NamedTuple):
    U: torch.Tensor  # (d, *cells)
    alpha1: torch.Tensor
    p: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor


def upwind_flux(phi_a, fld, nd: int, a: int):
    """fvc::flux(phi, fld) with the upwind donor along axis a; across a
    partition face the donor is the neighbour block's cell."""
    ext = mules._edge_ext(fld, nd, a)
    lo, hi = mules._pairs(ext, nd, a)
    return torch.where(phi_a >= 0, lo, hi) * phi_a


def pressure_reference(p, nd: int):
    """p at the global cell (0, ..., 0): its owner's value on every
    rank."""
    return spmd.first_shard_value(p[(0,) * nd])


def uncoupled_zeroed(phic, nd: int, a: int):
    """phic zeroed on the uncoupled boundary faces of axis a: the first
    and last face of the global mesh, not a block's partition faces."""
    ctx = spmd.current()
    ax = phic.ndim - nd + a
    n = phic.shape[ax]
    mask = torch.ones(n, dtype=phic.dtype, device=phic.device)
    if ctx is None or ctx.is_lo(a):
        mask[0] = 0.0
    if ctx is None or ctx.is_hi(a):
        mask[n - 1] = 0.0
    shape = [1] * phic.ndim
    shape[ax] = n
    return phic * mask.reshape(shape)


def _whole_mesh(mesh):
    """The whole mesh of a block (deltaN is the whole mesh's)."""
    return getattr(mesh, "global_mesh", mesh)


@dataclasses.dataclass(frozen=True)
class InterQHDFoam:
    mesh: Mesh
    props: TwoPhaseProperties
    g: tp.Optional[tp.Tuple[float, ...]] = None
    bc_U: tp.Optional[bcm.FieldBCs] = None
    bc_alpha: tp.Optional[bcm.FieldBCs] = None
    bc_p: tp.Optional[bcm.FieldBCs] = None
    time: TimeControls = TimeControls()
    implicit_diffusion: bool = True
    p_ref_value: float = 0.0
    cg_tol: float = 1e-8
    cg_maxiter: int = 1000
    fvsc_scheme: tp.Any = "full"
    mules_n_iter: int = 3
    # wall contact angles: {(axis, side): twophase.ContactAngle}
    contact_angles: tp.Optional[dict] = None
    # the alpha smoothing flags (smoothSolution.H):
    # alpha1 <- (1 - c)*alpha1 + c*faceAverage(alpha1), nSmoothIters times
    smooth_alpha: bool = False
    n_smooth_iters: int = 1
    # the field file of the phase-1 fraction ("alpha.<phase1>"): a write
    # and a resume keep a non-water phase pair's name
    alpha_field: str = "alpha.water"
    smooth_coeff: float = 0.5

    def _bcs(self):
        nd = self.mesh.ndim
        bu = self.bc_U or bcm.FieldBCs.uniform(bcm.FixedValue([0.0] * nd),
                                               nd)
        ba = self.bc_alpha or bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        bp = self.bc_p or bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        return bu, ba, bp

    def init(self, U0, alpha0, p0=None, t0=0.0) -> State:
        mesh = self.mesh
        U0, alpha0 = (x if torch.is_tensor(x) else mesh.tensor(x)
                      for x in (U0, alpha0))
        if p0 is None:
            p0 = torch.zeros_like(alpha0)
        elif not torch.is_tensor(p0):
            p0 = mesh.tensor(p0)
        return State(U=U0, alpha1=alpha0, p=p0, t=bcm.as_value(t0, alpha0),
                     dt=bcm.as_value(self.time.dt0, alpha0))

    def make_step(self):
        mesh = self.mesh
        nd = mesh.ndim
        pr = self.props
        bc_U, bc_a, bc_p0 = self._bcs()
        tc = self.time
        sch_U = fvsc.scheme_for(self.fvsc_scheme, "grad(U)")
        sch_a = fvsc.scheme_for(self.fvsc_scheme, "grad(alpha1)")
        sch_p = fvsc.scheme_for(self.fvsc_scheme, "grad(p)")
        bc_zg = bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        g = tuple(float(x) for x in (self.g if self.g is not None
                                     else (0.0,) * nd))
        gb = mesh.tensor(g).reshape((nd,) + (1,) * nd)
        area = tuple(mesh.face_area(a) for a in range(nd))
        rho1, rho2, Tau1, Tau2 = pr.rho1, pr.rho2, pr.tau1, pr.tau2
        singular = not any(isinstance(bc_p0[a, s], bcm.FixedValue)
                           for a in range(nd) for s in (0, 1))
        flux_sides = tuple((a, side) for a in range(nd) for side in (0, 1)
                           if isinstance(bc_p0[a, side], bcm.QHDFluxP))
        dN = twophase.delta_n(_whole_mesh(mesh))
        # the face areas of each cell's low and high faces, for the
        # smoothing's area-weighted face average (they vary on a wedge)
        pair_areas = []
        for a in range(nd):
            ar = torch.broadcast_to(area[a], mesh.face_shape(a))
            pair_areas.append((ar.narrow(a, 0, mesh.shape[a]),
                               ar.narrow(a, 1, mesh.shape[a])))
        wsum = sum(lo + hi for lo, hi in pair_areas)

        def helmholtz(**kw):
            return linsolve.solve_helmholtz(
                mesh=mesh, tol=self.cg_tol, maxiter=self.cg_maxiter, **kw).x

        def step(s: State) -> State:
            U, alpha1, p, t, dt = s
            alpha2 = 1.0 - alpha1
            rho_old = pr.rho(alpha1)
            mu = pr.mu(alpha1)

            # thermo.correct(): the interface machinery
            iface = twophase.interface_properties(
                alpha1, bc_a, mesh, pr.sigma, t=t,
                contact_angles=self.contact_angles, dN=dN)

            # updateFields.H
            gradUf = fvsc.grad(U, bc_U, mesh, scheme=sch_U, t=t, vector=True)
            gradA1f = fvsc.grad(alpha1, bc_a, mesh, scheme=sch_a, t=t)
            muf = fvsc.interpolate(mu, bc_zg, mesh)
            Uf = fvsc.interpolate(U, bc_U, mesh, t=t, vector=True)
            a1f = tuple(torch.clamp(f, 0.0, 1.0)
                        for f in fvsc.interpolate(alpha1, bc_a, mesh, t=t))
            a2f = tuple(1.0 - f for f in a1f)
            da1dtf = tuple(-sum(Uf[a][i] * gradA1f[a][i] for i in range(nd))
                           for a in range(nd))
            grad_a1_cell = fvsc.grad_cell(alpha1, bc_a, mesh, t=t)
            da1dt = -torch.sum(U * grad_a1_cell, dim=0)
            cFrc = reconstruct(tuple(iface.stf[a] * area[a]
                                     for a in range(nd)), mesh)
            cFrcf = iface.stf  # stf*Sf/|Sf|: its normal component is stf
            BdFrc = gb * (rho_old + da1dt * (Tau1 * rho1 - Tau2 * rho2))[None]

            # updateFluxes.H
            u_gradU = tuple([sum(Uf[a][i] * gradUf[a][i, j]
                                 for i in range(nd)) for j in range(nd)]
                            for a in range(nd))
            phiu = tuple(Uf[a][a] * area[a] for a in range(nd))
            phiwon = tuple((u_gradU[a][a] - g[a]) * area[a]
                           for a in range(nd))
            phicf = tuple(cFrcf[a] * area[a] for a in range(nd))
            phiwo1 = tuple((phiwon[a] - phicf[a] / rho1) * Tau1
                           for a in range(nd))
            phiwo2 = tuple((phiwon[a] - phicf[a] / rho2) * Tau2
                           for a in range(nd))

            # Courant + setDeltaT (mQGDCourantNo: the QHD advective one)
            co = common.courant_advective(Uf, dt, mesh)
            tau_f_all = tuple(a1f[a] * Tau1 + a2f[a] * Tau2
                              for a in range(nd))
            dt_new = common.set_delta_t(dt, co,
                                        common.tau_f_min(tau_f_all), tc)

            # the mixture pEqn
            phiwm = tuple(-phiwo1[a] * a1f[a] - phiwo2[a] * a2f[a]
                          + phiu[a] * da1dtf[a] * (Tau1 - Tau2)
                          for a in range(nd))
            coeffp = tuple(a1f[a] * Tau1 / rho1 + a2f[a] * Tau2 / rho2
                           for a in range(nd))
            # the mQhdFlux p BC: the outward gradient phiwm/(coeffp*|Sf|),
            # so the pEqn's boundary flux cancels phiwm and phi reduces to
            # the velocity BC's phiu there; zero-area (wedge axis) faces
            # carry no flux
            bc_p = bc_p0
            for a, side in flux_sides:
                n = mesh.shape[a] + 1
                idx = 0 if side == 0 else n - 1
                wm = phiwm[a].narrow(phiwm[a].ndim - nd + a, idx, 1)
                cp = coeffp[a].narrow(coeffp[a].ndim - nd + a, idx, 1)
                ar = torch.broadcast_to(area[a], mesh.face_shape(a)).narrow(
                    a, idx, 1)
                sign = -1.0 if side == 0 else 1.0
                grad = torch.where(
                    ar > 0.0,
                    sign * wm / (cp * torch.where(ar > 0.0, ar, 1.0)), 0.0)
                bc_p = bc_p.replace(a, side, bcm.FixedGradient(grad))
            rhs_p = fvsc.div_flux(phiu, mesh) + fvsc.div_flux(phiwm, mesh)
            # solve_helmholtz solves diag*x - lap(gamma, x) = rhs: the
            # reference's lap(coeffp, p) = div(phiu) + div(phiwm) takes
            # rhs = -rhs_p
            p_new = helmholtz(diag_coeff=0.0, gamma_faces=coeffp,
                              rhs=-rhs_p, x0=p, bcs=bc_p, t=t,
                              singular=singular)
            if singular:
                p_new = p_new + (self.p_ref_value
                                 - pressure_reference(p_new, nd))

            snp = fvsc.sn_grad(p_new, bc_p, mesh, t=t)
            phiw1 = tuple(phiwo1[a] + (Tau1 / rho1) * area[a] * snp[a]
                          for a in range(nd))
            phiw2 = tuple(phiwo2[a] + (Tau2 / rho2) * area[a] * snp[a]
                          for a in range(nd))
            phi = tuple(phiu[a] + phiwm[a] - coeffp[a] * area[a] * snp[a]
                        for a in range(nd))

            # W1/W2, the velocity regularizers
            gradpf = fvsc.grad(p_new, bc_p, mesh, scheme=sch_p, t=t)
            cFrcf_lin = fvsc.interpolate(cFrc, bc_zg, mesh, vector=True)

            def regularizer(rho_k, tau_k):
                return tuple(torch.stack([
                    (u_gradU[a][j] + gradpf[a][j] / rho_k - g[j]
                     - cFrcf_lin[a][j] / rho_k) * tau_k
                    for j in range(nd)], dim=0) for a in range(nd))

            W1 = regularizer(rho1, Tau1)
            W2 = regularizer(rho2, Tau2)

            # the alpha1 equation
            phiWr = tuple((phiw1[a] - phiw2[a]) * a2f[a] for a in range(nd))
            phiA1 = [phi[a] * a1f[a] - phiWr[a] * a1f[a]
                     + phiu[a] * da1dtf[a] * (Tau1 - a1f[a] * (Tau1 - Tau2))
                     for a in range(nd)]
            if pr.c_alpha > 1e-30:
                for a in range(nd):
                    # |phi|/|Sf| is the face speed; the wedge axis faces
                    # have zero area (and zero phi)
                    ar = torch.broadcast_to(area[a],
                                            phi[a].shape[phi[a].ndim - nd:])
                    phic = pr.c_alpha * torch.where(
                        ar > 0.0, torch.abs(phi[a])
                        / torch.where(ar > 0.0, ar, 1.0), 0.0)
                    # no compression at uncoupled boundary faces
                    if not isinstance(bc_a[a, 0], bcm.Periodic):
                        phic = uncoupled_zeroed(phic, nd, a)
                    phir = phic * iface.n_hat_f[a]  # nHatf includes |Sf|
                    inner = -upwind_flux(-phir, alpha2, nd, a)
                    phiA1[a] = phiA1[a] + upwind_flux(inner, alpha1, nd, a)

            # MULES: limited to [0, 1], the explicit solve and a clip
            alpha1_new, phiA1_lim = mules.explicit_solve(
                alpha1, phi, tuple(phiA1), dt_new, mesh, 1.0, 0.0,
                n_iter=self.mules_n_iter)
            alpha1_new = torch.clamp(alpha1_new, 0.0, 1.0)
            if self.smooth_alpha:
                # smoothSolution.H: blend toward the area-weighted average
                # of the face-interpolated field (the face values of a
                # partition face come through its ghost layer)
                for _ in range(self.n_smooth_iters):
                    af = fvsc.interpolate(alpha1_new, bc_a, mesh, t=t)
                    avg = sum(
                        af[a].narrow(a, 0, mesh.shape[a]) * pair_areas[a][0]
                        + af[a].narrow(a, 1, mesh.shape[a])
                        * pair_areas[a][1]
                        for a in range(nd)) / wsum
                    alpha1_new = ((1.0 - self.smooth_coeff) * alpha1_new
                                  + self.smooth_coeff * avg)
                alpha1_new = torch.clamp(alpha1_new, 0.0, 1.0)

            # the mixture density and the mass fluxes
            rho_new = pr.rho(alpha1_new)
            phiA2 = tuple(phi[a] - phiA1_lim[a] for a in range(nd))
            rhoPhi = tuple(phiA1_lim[a] * rho1 + phiA2[a] * rho2
                           for a in range(nd))
            phiRhofWf = tuple(
                phiu[a] * (a1f[a] * rho1 * W1[a] + a2f[a] * rho2 * W2[a])
                for a in range(nd))
            phiUfRhof = tuple(rhoPhi[a] * Uf[a] - phiRhofWf[a]
                              for a in range(nd))

            # UEqn
            snp_flux = tuple(snp[a] * area[a] for a in range(nd))
            press_frc = (reconstruct(snp_flux, mesh) - cFrc) * (
                1.0 + da1dt * (Tau1 - Tau2))[None]
            # (Sf & T(gradU))_j = |Sf| dU_a/dx_j, column a of
            # G[i, j] = dU_j/dx_i
            gradU_cell = fvsc.grad_cell_vector(U, bc_U, mesh, t=t)
            gradU_f = fvsc.interpolate(
                gradU_cell.reshape((nd * nd,) + tuple(mesh.shape)), bc_zg,
                mesh)
            transp_flux = tuple(
                muf[a] * area[a]
                * gradU_f[a].reshape((nd, nd) + mesh.face_shape(a))[:, a]
                for a in range(nd))
            rhs_U = (rho_old[None] * U / dt_new
                     - fvsc.div_flux(phiUfRhof, mesh)
                     + fvsc.div_flux(transp_flux, mesh)
                     + BdFrc
                     - press_frc)
            if mesh.axisymmetric:
                # the cylindrical vector laplacian's hoop term -mu u_r/r^2
                # (the r-weighted metrics give the rest)
                r_c = mesh.cell_coords(1)
                rhs_U = torch.stack([rhs_U[0],
                                     rhs_U[1] + -mu * U[1] / (r_c * r_c)])
            if self.implicit_diffusion:
                U_new = helmholtz(diag_coeff=rho_new / dt_new,
                                  gamma_faces=muf, rhs=rhs_U, x0=U,
                                  bcs=bc_U, t=t, vector=True)
            else:
                lapU = fvsc.laplacian_explicit(muf, U, bc_U, mesh, t=t,
                                               vector=True)
                U_new = (rhs_U + lapU) * dt_new / rho_new[None]

            return State(U=U_new, alpha1=alpha1_new, p=p_new,
                         t=t + dt_new, dt=dt_new)

        return step
