"""zQGDFoam — the high-Mach QGD variant with entropy-consistent log-mean
fluxes (PyTorch port of `qgdsolver_tpu.solvers.zqgd`).

What differs from QGDFoam (reference zQGDFoam updateFields.H and
updateFluxes.H):
  * owner/neighbour upwind face values of rho, e and U (directionInterpolate:
    plain upwind along the +- face direction);
  * entropy-consistent means rhoLnf = logmean(rho+, rho-) and
    eLnf = e+ e- / logmean(e+, e-);
  * the mass flux jm = rhoLnf*(Uf - wf) with the regularizer split
    wHat = (tau/rho_f)(rho_f (U.grad)U + grad p),
    w = wHat + (tau/rho_f) Uf div(rhoU)_f;
  * Pi = rho_f Uf wHat + tau I((U.grad p) + gamma p1f divU) [+ mu gradU],
    p1f = (gamma-1) rho_f e_f;
  * the energy flux from E1f = rhoLnf (U+ . U-)/2 + rhoLnf eLnf + pf, less
    the h^2 dissipation phih2 = h_f^2/4 snGrad(U_n) snGrad(p) |Sf|;
  * the explicit rho/rhoU/rhoE updates of QGDFoam, and with implicit
    diffusion its Helmholtz solves of U and e.

The State is QGDFoam's and so is `init`.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ..core import bc as bcm
from ..core.mesh import Mesh
from ..ops import fvsc, linsolve
from ..ops.pad import ghost_pad, trim_other_axes
from ..physics.qgdcoeffs import ConstScPrModel1, TauModel
from ..physics.thermo import PerfectGasThermo
from . import common
from .common import TimeControls
from .qgd import QGDFoam, State  # noqa: F401 — the same prognostic State


def logmean(a, b, eps=1e-4):
    """Stable logarithmic mean (a - b)/(ln a - ln b): the Ismail-Roe series
    where u = ((a/b - 1)/(a/b + 1))^2 < eps, and the guarded logarithm
    elsewhere."""
    zeta = a / b
    f = (zeta - 1.0) / (zeta + 1.0)
    u = f * f
    F_small = 1.0 + u / 3.0 + u * u / 5.0 + u * u * u / 7.0
    F_big = torch.log(torch.clamp(zeta, min=1e-30)) / torch.where(
        torch.abs(f) < 1e-30, 1.0, 2.0 * f)
    F = torch.where(u < eps, F_small, F_big)
    return (a + b) / (2.0 * F)


@dataclasses.dataclass(frozen=True)
class ZQGDFoam:
    mesh: Mesh
    thermo: PerfectGasThermo
    tau_model: TauModel = ConstScPrModel1()
    bc_U: tp.Optional[bcm.FieldBCs] = None
    bc_p: tp.Optional[bcm.FieldBCs] = None
    bc_T: tp.Optional[bcm.FieldBCs] = None
    time: TimeControls = TimeControls()
    implicit_diffusion: bool = False
    cg_tol: float = 1e-8
    cg_maxiter: int = 500
    fvsc_scheme: tp.Any = "full"

    # QGDFoam's BC sets, State construction and primitive reconstruction
    _bcs = QGDFoam._bcs
    _flux_sides = QGDFoam._flux_sides
    _wt_sides = QGDFoam._wt_sides
    _pbc_zeros = QGDFoam._pbc_zeros
    init = QGDFoam.init
    primitives = QGDFoam.primitives

    def make_step(self):
        mesh = self.mesh
        nd = mesh.ndim
        th = self.thermo
        bc_U, bc_p0, bc_T = self._bcs()
        tc = self.time
        scheme = self.fvsc_scheme
        sch_U = fvsc.scheme_for(scheme, "grad(U)")
        sch_e = fvsc.scheme_for(scheme, "grad(e)")
        sch_rho = fvsc.scheme_for(scheme, "grad(rho)")
        sch_p = fvsc.scheme_for(scheme, "grad(p)")
        sch_rhoU = fvsc.scheme_for(scheme, "grad(rhoU)")
        bc_zg = bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        bc_e = common.e_bcs_from_T(bc_T, th.e_from_T,
                                   getattr(th, "Cv", None))
        gamma = th.gamma
        area = tuple(mesh.face_area(a) for a in range(nd))

        def pos_neg(fp, a):
            """Owner/neighbour face values along axis a of a padded tensor
            (directionInterpolate upwind in the +- face directions)."""
            ax = fp.ndim - nd + a
            n = fp.shape[ax]
            return (trim_other_axes(fp.narrow(ax, 0, n - 1), nd, a),
                    trim_other_axes(fp.narrow(ax, 1, n - 1), nd, a))

        def step(s: State) -> State:
            rho, rhoU, rhoE, sc_prev, t, dt = s[:6]
            U, e, T, p = self.primitives(s)
            # resolve inletOutlet markers against the current flow direction
            bc_Us = bcm.resolve_inlet_outlet(bc_U, U, nd)
            bc_Ts = bcm.resolve_inlet_outlet(bc_T, U, nd)
            bc_ps = bcm.resolve_inlet_outlet(bc_p0, U, nd)
            bc_es = bcm.resolve_inlet_outlet(bc_e, U, nd)
            c = th.c_from_pT(p, T)
            mu_mol = th.mu(p, T)
            alphau_mol = th.alphah(p, T)

            coeffs = self.tau_model.correct(
                mesh, c=c, p=p, rho=rho, sc_prev=sc_prev, mu=mu_mol,
                bc_p=bc_ps, t=t)
            tau_f = coeffs.tau_f
            mu_eff = mu_mol + coeffs.mu_qgd
            alphau_eff = alphau_mol + coeffs.alphau_qgd

            p_pad = ghost_pad(p, bc_ps, mesh, t=t)
            T_pad = ghost_pad(T, bc_Ts, mesh, t=t)
            U_pad = ghost_pad(U, bc_Us, mesh, t=t, vector=True)
            rho_pad = th.rho_from_p_T(p_pad, T_pad)
            e_pad = th.e_from_T(T_pad)
            rhoU_pad = rho_pad[None] * U_pad
            c_pad = th.c_from_pT(p_pad, T_pad)

            rhof = fvsc.interp_from_padded(rho_pad, mesh)
            Uf = fvsc.interp_from_padded(U_pad, mesh)
            pf = fvsc.interp_from_padded(p_pad, mesh)
            cf = fvsc.interp_from_padded(c_pad, mesh)
            ef = fvsc.interp_from_padded(e_pad, mesh)
            muf = fvsc.interpolate(mu_eff, bc_zg, mesh)
            alphauf = fvsc.interpolate(alphau_eff, bc_zg, mesh)

            gradUf = fvsc.grad_from_padded(U_pad, mesh, scheme=sch_U)
            gradef = fvsc.grad_from_padded(e_pad, mesh, scheme=sch_e)
            gradRhof = fvsc.grad_from_padded(rho_pad, mesh, scheme=sch_rho)
            gradPf = fvsc.grad_from_padded(p_pad, mesh, scheme=sch_p)
            gradRhoUf = fvsc.grad_from_padded(rhoU_pad, mesh,
                                              scheme=sch_rhoU)
            snU = fvsc.sn_grad_from_padded(U_pad, mesh)
            snP = fvsc.sn_grad_from_padded(p_pad, mesh)

            phiJm, mom_flux, e_flux = [], [], []
            for a in range(nd):
                gU = gradUf[a]
                uf = Uf[a]
                rho_p, rho_n = pos_neg(rho_pad, a)
                e_p, e_n = pos_neg(e_pad, a)
                U_p, U_n = pos_neg(U_pad, a)
                rhoLnf = logmean(rho_p, rho_n)
                eLnf = e_p * e_n / logmean(e_p, e_n)

                divU = sum(gU[i, i] for i in range(nd))
                # div(rhoU) at faces: the trace of grad(rhoU)
                divRhoU = sum(gradRhoUf[a][i, i] for i in range(nd))
                u_gradU = [sum(uf[i] * gU[i, j] for i in range(nd))
                           for j in range(nd)]
                wHat = [(tau_f[a] / rhof[a])
                        * (rhof[a] * u_gradU[j] + gradPf[a][j])
                        for j in range(nd)]
                w = [wHat[j] + (tau_f[a] / rhof[a]) * uf[j] * divRhoU
                     for j in range(nd)]
                phiJm_a = rhoLnf * (uf[a] - w[a]) * area[a]
                phiJm.append(phiJm_a)

                p1f = (gamma - 1.0) * rhof[a] * ef[a]
                u_gradp = sum(uf[i] * gradPf[a][i] for i in range(nd))
                iso = tau_f[a] * (u_gradp + gamma * p1f * divU)
                pi_row = []
                for j in range(nd):
                    pij = rhof[a] * uf[a] * wHat[j] + (iso if j == a else 0.0)
                    if not self.implicit_diffusion:
                        # the Navier-Stokes part is mu*gradU only (the
                        # reference disables its transpose)
                        pij = pij + muf[a] * gU[a, j]
                    pi_row.append(pij)
                mf = phiJm_a * uf
                mf[a] = mf[a] + area[a] * pf[a]  # Sf*pf: normal component
                mom_flux.append(mf - area[a] * torch.stack(pi_row, dim=0))

                E1f = (0.5 * rhoLnf * sum(U_p[i] * U_n[i] for i in range(nd))
                       + rhoLnf * eLnf + pf[a])
                phih2 = (0.25 * mesh.h_face(a) ** 2 * snU[a][a] * snP[a]
                         * area[a])
                u_grade = sum(uf[i] * gradef[a][i] for i in range(nd))
                u_gradrho = sum(uf[i] * gradRhof[a][i] for i in range(nd))
                q_n = -tau_f[a] * rhof[a] * uf[a] * (
                    u_grade - (p1f / rhof[a] ** 2) * u_gradrho)
                if not self.implicit_diffusion:
                    q_n = q_n - alphauf[a] * gradef[a][a]
                phiPiU = area[a] * sum(pi_row[j] * uf[j] for j in range(nd))
                e_flux.append((E1f * (uf[a] - w[a]) * area[a] - phih2)
                              + q_n * area[a] - phiPiU)

            co = common.courant_acoustic(Uf, cf, dt, mesh)
            dt_new = common.set_delta_t(dt, co, common.tau_f_min(tau_f), tc)

            rho_new = rho - dt_new * fvsc.div_flux(tuple(phiJm), mesh)
            rhoU_new = rhoU - dt_new * fvsc.div_flux(tuple(mom_flux), mesh)
            U_new = rhoU_new / rho_new[None]
            rhoE_new = rhoE - dt_new * fvsc.div_flux(tuple(e_flux), mesh)

            if self.implicit_diffusion:
                U_new = linsolve.solve_helmholtz(
                    diag_coeff=rho_new / dt_new, gamma_faces=muf,
                    rhs=rho_new * U_new / dt_new, x0=U_new, bcs=bc_Us,
                    mesh=mesh, t=t, vector=True, tol=self.cg_tol,
                    maxiter=self.cg_maxiter).x
                rhoU_new = rho_new[None] * U_new
                e_new = rhoE_new / rho_new \
                    - 0.5 * torch.sum(U_new * U_new, dim=0)
                e_new = linsolve.solve_helmholtz(
                    diag_coeff=rho_new / dt_new, gamma_faces=alphauf,
                    rhs=rho_new * e_new / dt_new, x0=e_new, bcs=bc_es,
                    mesh=mesh, t=t, tol=self.cg_tol,
                    maxiter=self.cg_maxiter).x
                rhoE_new = rho_new * (e_new
                                      + 0.5 * torch.sum(U_new * U_new, dim=0))

            return State(rho=rho_new, rhoU=rhoU_new, rhoE=rhoE_new,
                         sc=coeffs.sc, t=t + dt_new, dt=dt_new, pbc=s.pbc)

        return step
