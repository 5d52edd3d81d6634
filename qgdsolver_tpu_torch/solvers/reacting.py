"""reactingLagrangianQGDFoam's Eulerian core: multicomponent reacting QGD
(PyTorch port of `qgdsolver_tpu.solvers.reacting`).

Per step, on top of the QGDFoam flux stack:
  * species fluxes (updateFluxes.H): per active specie
      phiJmY_i = phiJm*Yf_i - phi*tau_f*(Uf.grad Yf_i),
    the tau term doubling as the specie's diffusive flux;
  * QGDYEqn.H: combustion->correct, Qdot; per active specie
      ddt(rho, Yi) + div(phiJmYi) - laplacian(muf/Sc_i, Yi)
        = R(Yi) [+ parcel sources],
    with the inert closure Y_inert = 1 - sum(Y);
  * addEnergyFluxes.H: per-specie enthalpy transport added to phiQ,
      phiQ += diffusiveFlux_i*Hs_i_f + snGrad(Y_i)|Sf|*(Es_i*alphaEff)_f;
  * QGDEEqn with rhoESu = Qdot (+ the parcels' Sh through `sources`).

The mixture thermo (`physics.species`) gives Y-dependent gamma, c and psi;
gamma is interpolated to the faces.  With a `DeviceISAT` tabulation its
table rides in `State.tab`.  Lagrangian parcel sources enter through the
`sources` hook of `make_step` (`solvers.particles`).
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ..core import bc as bcm
from ..core.mesh import Mesh
from ..ops import fvsc, linsolve
from ..ops.pad import ghost_pad
from ..physics.chemistry import (CombustionModel, DeviceISAT, NoCombustion,
                                 TDACChemistrySolver, _call)
from ..physics.qgdcoeffs import ConstScPrModel1, TauModel
from ..physics.species import MixtureThermo
from . import common
from .common import TimeControls
from .qgd import dev2T


class State(tp.NamedTuple):
    rho: torch.Tensor
    rhoU: torch.Tensor  # (d, *cells)
    rhoE: torch.Tensor
    Y: torch.Tensor  # (n_species, *cells)
    T: torch.Tensor  # carried as the Newton initial guess
    sc: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    # the DeviceISAT table (a dict of tensors) when tabulation is
    # configured, else None
    tab: tp.Any = None


@dataclasses.dataclass(frozen=True)
class ReactingQGDFoam:
    mesh: Mesh
    mixture: MixtureThermo
    combustion: CombustionModel = NoCombustion()
    # the stiff source's integrator (physics.chemistry: none,
    # EulerImplicit, ode, TDAC)
    chemistry_solver: tp.Any = None
    # a DeviceISAT; a TDAC chemistry_solver carrying one engages it too
    tabulation: tp.Any = None
    tau_model: TauModel = ConstScPrModel1()
    bc_U: tp.Optional[bcm.FieldBCs] = None
    bc_p: tp.Optional[bcm.FieldBCs] = None
    bc_T: tp.Optional[bcm.FieldBCs] = None
    # one FieldBCs for all species, or a per-specie tuple of FieldBCs
    bc_Y: tp.Any = None
    time: TimeControls = TimeControls()
    implicit_diffusion: bool = False
    cg_tol: float = 1e-8
    cg_maxiter: int = 500
    fvsc_scheme: tp.Any = "full"

    def _bcs(self):
        nd = self.mesh.ndim
        zg = bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        return (self.bc_U or zg, self.bc_p or zg, self.bc_T or zg,
                self.bc_Y or zg)

    def _tabulation(self):
        """(DeviceISAT or None, the chemistry solver that computes the
        misses): a configured `tabulation`, or the DeviceISAT of a TDAC
        chemistry_solver (whose own tabulation hook is then bypassed, the
        device table doing the caching)."""
        solver = self.chemistry_solver
        tabu = self.tabulation
        if tabu is None and isinstance(solver, TDACChemistrySolver) and \
                isinstance(solver.tabulation, DeviceISAT):
            tabu = solver.tabulation
            solver = dataclasses.replace(solver, tabulation=None)
        return tabu, solver

    def init(self, p0, T0, U0, Y0, t0=0.0) -> State:
        mix = self.mixture
        mesh = self.mesh
        p0, T0, U0, Y0 = (x if torch.is_tensor(x) else mesh.tensor(x)
                          for x in (p0, T0, U0, Y0))
        rho = mix.rho_from_p_T(Y0, p0, T0)
        e = mix.e_from_T(Y0, T0)
        rhoU = rho[None] * U0
        rhoE = rho * e + 0.5 * rho * torch.sum(U0 * U0, dim=0)
        tabu, _ = self._tabulation()
        tab = (tabu.init(mix.n_species, dtype=rho.dtype, device=rho.device)
               if tabu is not None else None)
        return State(rho=rho, rhoU=rhoU, rhoE=rhoE, Y=Y0, T=T0,
                     sc=torch.zeros_like(rho), t=bcm.as_value(t0, rho),
                     dt=bcm.as_value(self.time.dt0, rho), tab=tab)

    def primitives(self, s: State):
        mix = self.mixture
        U = s.rhoU / s.rho[None]
        e = s.rhoE / s.rho - 0.5 * torch.sum(U * U, dim=0)
        T = mix.T_from_e(s.Y, e, s.T)
        p = mix.p_from_rho_T(s.Y, s.rho, T)
        return U, e, T, p

    def make_step(self, sources: tp.Optional[tp.Callable] = None):
        """The step State -> State.  sources(state, primitives, dt) ->
        (rhoSu, rhoUSu, rhoESu, YSu), each None or a cell field (YSu a
        per-specie list): the parcels' SU/Sh/SYi; `dt` is the dt this step
        applies, so the exchange conserves under adaptive time steps."""
        mesh = self.mesh
        nd = mesh.ndim
        mix = self.mixture
        ns = mix.n_species
        inert = mix.inert
        sc_nums = mix.sc_numbers()
        bc_U, bc_p0, bc_T, bc_Y = self._bcs()
        tc = self.time
        implicit = self.implicit_diffusion
        scheme = self.fvsc_scheme
        sch_U = fvsc.scheme_for(scheme, "grad(U)")
        sch_e = fvsc.scheme_for(scheme, "grad(e)")
        sch_rho = fvsc.scheme_for(scheme, "grad(rho)")
        sch_p = fvsc.scheme_for(scheme, "grad(p)")
        sch_Y = fvsc.scheme_for(scheme, "grad(Yi)")
        bc_zg = bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        area = tuple(mesh.face_area(a) for a in range(nd))
        tabu, chem_solver = self._tabulation()
        combustion = self.combustion

        def step(s: State) -> State:
            rho, rhoU, rhoE, Y = s.rho, s.rhoU, s.rhoE, s.Y
            sc_prev, t, dt = s.sc, s.t, s.dt
            U, e, T, p = self.primitives(s)
            # resolve inletOutlet markers against the current flow
            bc_Us = bcm.resolve_inlet_outlet(bc_U, U, nd)
            bc_Ts = bcm.resolve_inlet_outlet(bc_T, U, nd)
            bc_ps = bcm.resolve_inlet_outlet(bc_p0, U, nd)
            bc_Ys = (bcm.resolve_inlet_outlet(bc_Y, U, nd)
                     if isinstance(bc_Y, bcm.FieldBCs) else
                     tuple(bcm.resolve_inlet_outlet(b, U, nd) for b in bc_Y))
            c = mix.c_from_pT(Y, p, T)
            mu_mol = mix.mu(p, T)
            alphau_mol = mix.alphah(p, T)

            coeffs = self.tau_model.correct(
                mesh, c=c, p=p, rho=rho, sc_prev=sc_prev, mu=mu_mol,
                bc_p=bc_ps, t=t)
            tau_f = coeffs.tau_f
            mu_eff = mu_mol + coeffs.mu_qgd
            alphau_eff = alphau_mol + coeffs.alphau_qgd

            # padded primitives with thermodynamically consistent ghosts
            p_pad = ghost_pad(p, bc_ps, mesh, t=t)
            T_pad = ghost_pad(T, bc_Ts, mesh, t=t)
            U_pad = ghost_pad(U, bc_Us, mesh, t=t, vector=True)
            Y_pad = _pad_species(Y, bc_Ys, mesh, t)  # leading species axis
            rho_pad = mix.rho_from_p_T(Y_pad, p_pad, T_pad)
            e_pad = mix.e_from_T(Y_pad, T_pad)
            rhoU_pad = rho_pad[None] * U_pad
            rhoE_pad = rho_pad * e_pad \
                + 0.5 * rho_pad * torch.sum(U_pad * U_pad, dim=0)
            H_pad = (rhoE_pad + p_pad) / rho_pad
            c_pad = mix.c_from_pT(Y_pad, p_pad, T_pad)
            gamma_pad = mix.gamma(Y_pad, T_pad)

            rhof = fvsc.interp_from_padded(rho_pad, mesh)
            Uf = fvsc.interp_from_padded(U_pad, mesh)
            rhoUf = fvsc.interp_from_padded(rhoU_pad, mesh)
            UrhoUf_row = tuple(
                fvsc.interp_axis_from_padded(U_pad[a] * rhoU_pad, mesh, a)
                for a in range(nd))
            pf = fvsc.interp_from_padded(p_pad, mesh)
            cf = fvsc.interp_from_padded(c_pad, mesh)
            Hf = fvsc.interp_from_padded(H_pad, mesh)
            gammaf = fvsc.interp_from_padded(gamma_pad, mesh)
            Yf = fvsc.interp_from_padded(Y_pad, mesh)
            muf = fvsc.interpolate(mu_eff, bc_zg, mesh)
            alphauf = fvsc.interpolate(alphau_eff, bc_zg, mesh)

            gradUf = fvsc.grad_from_padded(U_pad, mesh, scheme=sch_U)
            gradef = fvsc.grad_from_padded(e_pad, mesh, scheme=sch_e)
            gradRhof = fvsc.grad_from_padded(rho_pad, mesh, scheme=sch_rho)
            gradPf = fvsc.grad_from_padded(p_pad, mesh, scheme=sch_p)
            gradYf = fvsc.grad_from_padded(Y_pad, mesh, scheme=sch_Y)
            snYf = fvsc.sn_grad_from_padded(Y_pad, mesh)

            phiJm, mom_flux, phiJmH, phiQ, phiPiU = [], [], [], [], []
            phiJmY = [[None] * nd for _ in range(ns)]
            diffusiveFlux = [[None] * nd for _ in range(ns)]
            for a in range(nd):
                gU = gradUf[a]
                uf = Uf[a]
                ruf = rhoUf[a]
                divU = sum(gU[i, i] for i in range(nd))
                u_gradrho = sum(uf[i] * gradRhof[a][i] for i in range(nd))
                rhoU_gradU = [sum(ruf[i] * gU[i, j] for i in range(nd))
                              for j in range(nd)]
                w_star = [tau_f[a] * (u_gradrho * uf[j] + ruf[j] * divU
                                      + rhoU_gradU[j])
                          for j in range(nd)]
                jm_n = ruf[a] - (w_star[a] + tau_f[a] * gradPf[a][a])
                phiJm_a = jm_n * area[a]
                phiJm.append(phiJm_a)
                phi_mass = ruf[a] * area[a]  # phi = Sf & rhoUf

                u_gradp = sum(uf[i] * gradPf[a][i] for i in range(nd))
                iso = u_gradp + gammaf[a] * pf[a] * divU
                urr = UrhoUf_row[a]
                pi_row = []
                for j in range(nd):
                    pij = tau_f[a] * (
                        sum(urr[k] * gU[k, j] for k in range(nd))
                        + uf[a] * gradPf[a][j]
                        + (iso if j == a else 0.0))
                    if not implicit:
                        pij = pij + muf[a] * (
                            gU[a, j] + gU[j, a]
                            - ((2.0 / 3.0) * divU if j == a else 0.0))
                    pi_row.append(pij)
                mf = phiJm_a * uf
                mf[a] = mf[a] + area[a] * pf[a]  # Sf*pf: normal component
                mom_flux.append(mf - area[a] * torch.stack(pi_row, dim=0))

                phiJmH.append(phiJm_a * Hf[a])
                de = [gradef[a][k] - (pf[a] / rhof[a] ** 2) * gradRhof[a][k]
                      for k in range(nd)]
                q_n = -tau_f[a] * sum(urr[k] * de[k] for k in range(nd))
                if not implicit:
                    q_n = q_n - alphauf[a] * gradef[a][a]
                phiQ.append(q_n * area[a])
                phiPiU.append(area[a] * sum(pi_row[j] * uf[j]
                                            for j in range(nd)))

                # species fluxes (updateFluxes.H); gradYf[a][k, i] is
                # dY_i/dx_k
                for i in range(ns):
                    if i == inert:
                        continue
                    u_gradY = sum(uf[k] * gradYf[a][k, i] for k in range(nd))
                    dydtflux = -phi_mass * tau_f[a] * u_gradY
                    phiJmY[i][a] = phiJm_a * Yf[a][i] + dydtflux
                    diffusiveFlux[i][a] = dydtflux

            co = common.courant_acoustic(Uf, cf, dt, mesh)
            dt_new = common.set_delta_t(dt, co, common.tau_f_min(tau_f), tc)

            rhoSu = rhoUSu = rhoESu_extra = YSu = None
            if sources is not None:
                rhoSu, rhoUSu, rhoESu_extra, YSu = sources(s, (U, e, T, p),
                                                           dt_new)

            # QGDRhoEqn
            rho_new = rho - dt_new * fvsc.div_flux(tuple(phiJm), mesh)
            if rhoSu is not None:
                rho_new = rho_new + dt_new * rhoSu

            # QGDYEqn: combustion, species transport, the inert closure;
            # the gradient-limited families and EDC read aux fields
            aux = None
            if getattr(combustion, "needs_aux", False):
                aux = {"mu_eff": mu_eff}
                if getattr(combustion, "needs_grad", False):
                    aux["gradY"] = tuple(
                        fvsc.grad_cell(Y[i], _bc_species(bc_Ys, i), mesh,
                                       t=t) for i in range(ns))

            def rates(Yc, rhoc, Tc, pc, dtc, miss=None):
                if chem_solver is not None:
                    return chem_solver.rates(combustion, mix, Yc, rhoc, Tc,
                                             pc, dtc, aux=aux)
                return _call(combustion, mix, Yc, rhoc, Tc, pc, dtc, aux=aux)

            if tabu is not None:
                (RR, Qdot), tab_new = tabu.rates_stateful(
                    s.tab, rates, mix, tuple(Y), rho, T, p, dt_new)
            else:
                RR, Qdot = rates(tuple(Y), rho, T, p, dt_new)
                tab_new = s.tab
            Y_new = [None] * ns
            Yt = torch.zeros_like(rho)
            for i in range(ns):
                if i == inert:
                    continue
                bc_i = _bc_species(bc_Ys, i)
                gamma_y = tuple(muf[a] / sc_nums[i] for a in range(nd))
                rhs = rho * Y[i] / dt_new - fvsc.div_flux(
                    tuple(phiJmY[i]), mesh) + RR[i]
                if YSu is not None:
                    rhs = rhs + YSu[i]
                if implicit:
                    Yi = linsolve.solve_helmholtz(
                        diag_coeff=rho_new / dt_new, gamma_faces=gamma_y,
                        rhs=rhs, x0=Y[i], bcs=bc_i, mesh=mesh, t=t,
                        tol=self.cg_tol, maxiter=self.cg_maxiter).x
                else:
                    lap_Yi = fvsc.laplacian_explicit(gamma_y, Y[i], bc_i,
                                                     mesh, t=t)
                    Yi = (rhs + lap_Yi) * dt_new / rho_new
                Yi = torch.clamp(Yi, min=0.0)
                Y_new[i] = Yi
                Yt = Yt + Yi
                # the diffusive flux completed with the laplacian's face
                # flux, -Gamma*snGrad(Yi)*|Sf|
                for a in range(nd):
                    diffusiveFlux[i][a] = diffusiveFlux[i][a] - \
                        (muf[a] / sc_nums[i]) * snYf[a][i] * area[a]
            Y_new[inert] = torch.clamp(1.0 - Yt, min=0.0)
            Y_new = torch.stack(Y_new, dim=0)

            # addEnergyFluxes.H: the species' enthalpy fluxes into phiQ
            Hs_cells = torch.stack([mix.hs_i(i, T) for i in range(ns)],
                                   dim=0)
            Es_alpha = torch.stack([mix.es_i(i, T) * alphau_eff
                                    for i in range(ns)], dim=0)
            Hs_f = fvsc.interpolate(Hs_cells, bc_zg, mesh)
            EsA_f = fvsc.interpolate(Es_alpha, bc_zg, mesh)
            for a in range(nd):
                extra = 0.0
                for i in range(ns):
                    if i == inert:
                        continue
                    extra = extra + diffusiveFlux[i][a] * Hs_f[a][i] \
                        + snYf[a][i] * area[a] * EsA_f[a][i]
                # the inert specie's diffusive flux closes the sum
                inert_flux = -sum(diffusiveFlux[i][a] for i in range(ns)
                                  if i != inert)
                extra = extra + inert_flux * Hs_f[a][inert] \
                    + snYf[a][inert] * area[a] * EsA_f[a][inert]
                phiQ[a] = phiQ[a] + extra

            # QGDUEqn (explicit)
            rhoU_new = rhoU - dt_new * fvsc.div_flux(tuple(mom_flux), mesh)
            if rhoUSu is not None:
                rhoU_new = rhoU_new + dt_new * rhoUSu
            U_new = rhoU_new / rho_new[None]

            phiSigmaDotU = None
            if implicit:
                # the implicit Navier-Stokes diffusion sub-step
                gradU_cell = fvsc.grad_cell_vector(U, bc_Us, mesh, t=t)
                tauMC = mu_eff * dev2T(gradU_cell, nd)
                tauMC_f = fvsc.interpolate(
                    tauMC.reshape((nd * nd,) + mesh.shape), bc_zg, mesh)
                tauMC_row = [tauMC_f[a].reshape((nd, nd)
                                                + mesh.face_shape(a))[a]
                             for a in range(nd)]
                phiTauMC = tuple(area[a] * tauMC_row[a] for a in range(nd))
                U_new = linsolve.solve_helmholtz(
                    diag_coeff=rho_new / dt_new, gamma_faces=muf,
                    rhs=rho_new * U_new / dt_new
                    + fvsc.div_flux(phiTauMC, mesh),
                    x0=U_new, bcs=bc_Us, mesh=mesh, t=t, vector=True,
                    tol=self.cg_tol, maxiter=self.cg_maxiter).x
                rhoU_new = rho_new[None] * U_new
                gradU_f = fvsc.interpolate(
                    gradU_cell.reshape((nd * nd,) + mesh.shape), bc_zg, mesh)
                phiSigmaDotU = tuple(
                    area[a] * torch.sum(
                        (muf[a] * gradU_f[a].reshape(
                            (nd, nd) + mesh.face_shape(a))[a]
                         + tauMC_row[a]) * Uf[a], dim=0)
                    for a in range(nd))

            # QGDEEqn with rhoESu = Qdot (+ the parcels')
            e_flux = tuple(
                phiJmH[a] + phiQ[a] - phiPiU[a]
                - (phiSigmaDotU[a] if phiSigmaDotU is not None else 0.0)
                for a in range(nd))
            rhoE_new = rhoE - dt_new * fvsc.div_flux(e_flux, mesh) \
                + dt_new * Qdot
            if rhoESu_extra is not None:
                rhoE_new = rhoE_new + dt_new * rhoESu_extra

            e_new = rhoE_new / rho_new - 0.5 * torch.sum(U_new * U_new, dim=0)
            if implicit:
                # the implicit heat diffusion sub-step
                e_new = linsolve.solve_helmholtz(
                    diag_coeff=rho_new / dt_new, gamma_faces=alphauf,
                    rhs=rho_new * e_new / dt_new, x0=e_new, bcs=bc_zg,
                    mesh=mesh, t=t, tol=self.cg_tol,
                    maxiter=self.cg_maxiter).x
                rhoE_new = rho_new * (e_new
                                      + 0.5 * torch.sum(U_new * U_new, dim=0))
            T_new = mix.T_from_e(Y_new, e_new, T)

            return State(rho=rho_new, rhoU=rhoU_new, rhoE=rhoE_new, Y=Y_new,
                         T=T_new, sc=coeffs.sc, t=t + dt_new, dt=dt_new,
                         tab=tab_new)

        return step


def _bc_species(bc_Y, i: int) -> bcm.FieldBCs:
    """Specie i's BCs: bc_Y is one FieldBCs for every specie, or one
    FieldBCs per specie (each specie field carries its own patches)."""
    if isinstance(bc_Y, bcm.FieldBCs):
        return bc_Y
    return bc_Y[i]


def _pad_species(Y, bc_Y, mesh, t):
    """Ghost-pad the (ns, *cells) species stack under per-specie BCs."""
    if isinstance(bc_Y, bcm.FieldBCs):
        return ghost_pad(Y, bc_Y, mesh, t=t)
    return torch.stack([ghost_pad(Y[i], bc_Y[i], mesh, t=t)
                        for i in range(Y.shape[0])], dim=0)
