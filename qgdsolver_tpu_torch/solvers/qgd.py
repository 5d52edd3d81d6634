"""QGDFoam — compressible QGD solver, explicit branch (PyTorch port of
`qgdsolver_tpu.solvers.qgd`).

Per step (reference QGDFoam.C):
  updateFields.H : interpolate rho, U, rhoU, U*rhoU, p, c, H, muEff,
                   alphaEff to faces
  updateFluxes.H : gradUf/gradef/gradRhof/gradPf = fvsc::grad; divUf
                   rhoW = tau_f*((Uf.gradRhof)Uf + rhoUf*divUf + (rhoUf.grad)Uf)
                   jm = rhoUf - rhoW - tau_f*gradPf; Pif; qf
  QGDCourantNo.H + setDeltaT
  QGDRhoEqn.H, QGDUEqn.H, QGDEEqn.H : explicit updates
  closure        : p = rho/psi

Primitive ghosts are derived thermodynamically from the p/T/U boundary
conditions (rho_ghost = p_ghost*psi(T_ghost) etc.); each primitive is padded
once and reused by all four fvsc gradients.

Not in the port yet (raise NotImplementedError): implicit diffusion, the
qgdFlux limiter and relaxation.  Stairstep solids, waveTransmissive and
axisymmetric meshes have no representation in this package yet.

The step runs decomposed as it is: `parallel.sharding.build_spmd_step`
builds it on a block mesh under an spmd context, which `ghost_pad` and the
reductions consult.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ..core import bc as bcm
from ..core.mesh import Mesh
from ..ops import fvsc
from ..ops.pad import ghost_pad
from ..physics.qgdcoeffs import ConstScPrModel1, TauModel
from ..physics.thermo import PerfectGasThermo
from . import common
from .common import TimeControls


class State(tp.NamedTuple):
    rho: torch.Tensor
    rhoU: torch.Tensor  # (d, *cells)
    rhoE: torch.Tensor
    sc: torch.Tensor  # ScQGD carried state (varScModel5 relaxation)
    t: torch.Tensor
    dt: torch.Tensor
    # lagged qgdFlux p-BC gradients, one per QGDFluxP-marked (axis, side):
    # dp/dn = -phiwStar/(tau_f*|Sf|) from the PREVIOUS step's fluxes
    pbc: tp.Tuple[torch.Tensor, ...] = ()


@dataclasses.dataclass(frozen=True)
class QGDFoam:
    mesh: Mesh
    thermo: PerfectGasThermo
    tau_model: TauModel = ConstScPrModel1()
    bc_U: tp.Optional[bcm.FieldBCs] = None
    bc_p: tp.Optional[bcm.FieldBCs] = None
    bc_T: tp.Optional[bcm.FieldBCs] = None
    time: TimeControls = TimeControls()
    implicit_diffusion: bool = False
    fvsc_scheme: tp.Any = "full"  # word or {term: word} dict
    qgdflux_limit: tp.Optional[float] = None
    qgdflux_relax: float = 1.0

    def _bcs(self):
        nd = self.mesh.ndim
        zg = bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        return self.bc_U or zg, self.bc_p or zg, self.bc_T or zg

    def _flux_sides(self):
        """(axis, side) pairs carrying the qgdFlux p BC."""
        _, bp, _ = self._bcs()
        return tuple((a, side) for a in range(self.mesh.ndim)
                     for side in (0, 1)
                     if isinstance(bp[a, side], bcm.QGDFluxP))

    def _pbc_zeros(self):
        out = []
        for a, _ in self._flux_sides():
            shape = list(self.mesh.shape)
            shape[a] = 1
            out.append(torch.zeros(shape, dtype=self.mesh.dtype,
                                   device=self.mesh.device))
        return tuple(out)

    def init(self, p0, T0, U0, t0=0.0, sc0=None) -> State:
        th = self.thermo
        mesh = self.mesh
        p0, T0, U0 = (mesh.tensor(x) if not torch.is_tensor(x) else x
                      for x in (p0, T0, U0))
        rho = th.rho_from_p_T(p0, T0)
        e = th.e_from_T(T0)
        rhoU = rho[None] * U0
        rhoE = rho * e + 0.5 * rho * torch.sum(U0 * U0, dim=0)
        sc = torch.zeros_like(rho) if sc0 is None else bcm.as_value(sc0, rho)
        return State(rho=rho, rhoU=rhoU, rhoE=rhoE, sc=sc,
                     t=bcm.as_value(t0, rho), dt=bcm.as_value(self.time.dt0, rho),
                     pbc=self._pbc_zeros())

    def primitives(self, s: State):
        th = self.thermo
        U = s.rhoU / s.rho[None]
        e = s.rhoE / s.rho - 0.5 * torch.sum(U * U, dim=0)
        T = th.T_from_e(e)
        p = th.p_from_rho_T(s.rho, T)
        return U, e, T, p

    def make_step(self):
        """Build the explicit step State -> State."""
        if self.implicit_diffusion:
            raise NotImplementedError("implicit diffusion is not in the port")
        if self.qgdflux_limit is not None or self.qgdflux_relax != 1.0:
            raise NotImplementedError(
                "the qgdFlux limiter and relaxation are not in the port")
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
        bc_zg = bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        area = tuple(mesh.face_area(a) for a in range(nd))
        gamma = th.gamma
        flux_sides = self._flux_sides()

        def step(s: State) -> State:
            rho, rhoU, rhoE, sc_prev, t, dt = s[:6]
            # substitute the lagged qgdFlux gradients into the p BCs
            bc_p = bc_p0
            for i, (a, side) in enumerate(flux_sides):
                bc_p = bc_p.replace(a, side, bcm.FixedGradient(s.pbc[i]))
            U, e, T, p = self.primitives(s)
            # resolve inletOutlet markers against the current flow direction
            bc_Ur = bcm.resolve_inlet_outlet(bc_U, U, nd)
            bc_Tr = bcm.resolve_inlet_outlet(bc_T, U, nd)
            bc_p = bcm.resolve_inlet_outlet(bc_p, U, nd)
            c = th.c_from_pT(p, T)
            mu_mol = th.mu(p, T)
            alphau_mol = th.alphah(p, T)

            # thermo.correct(): tau coefficients + effective transport
            coeffs = self.tau_model.correct(mesh, c=c, p=p, rho=rho,
                                            sc_prev=sc_prev, mu=mu_mol)
            tau_f = coeffs.tau_f
            mu_eff = mu_mol + coeffs.mu_qgd
            alphau_eff = alphau_mol + coeffs.alphau_qgd

            p_pad = ghost_pad(p, bc_p, mesh, t=t)
            T_pad = ghost_pad(T, bc_Tr, mesh, t=t)
            U_pad = ghost_pad(U, bc_Ur, mesh, t=t, vector=True)
            # thermodynamically consistent derived ghosts
            rho_pad = th.rho_from_p_T(p_pad, T_pad)
            e_pad = th.e_from_T(T_pad)
            rhoU_pad = rho_pad[None] * U_pad
            rhoE_pad = rho_pad * e_pad \
                + 0.5 * rho_pad * torch.sum(U_pad * U_pad, dim=0)
            H_pad = (rhoE_pad + p_pad) / rho_pad
            c_pad = th.c_from_pT(p_pad, T_pad)

            # updateFields.H: face interpolations
            rhof = fvsc.interp_from_padded(rho_pad, mesh)
            Uf = fvsc.interp_from_padded(U_pad, mesh)
            rhoUf = fvsc.interp_from_padded(rhoU_pad, mesh)
            # UrhoUf = interp(U*rhoU): the product is interpolated, and only
            # row a is needed at a-faces
            UrhoUf_row = tuple(
                fvsc.interp_axis_from_padded(U_pad[a] * rhoU_pad, mesh, a)
                for a in range(nd))
            pf = fvsc.interp_from_padded(p_pad, mesh)
            cf = fvsc.interp_from_padded(c_pad, mesh)
            Hf = fvsc.interp_from_padded(H_pad, mesh)
            muf = fvsc.interpolate(mu_eff, bc_zg, mesh)
            alphauf = fvsc.interpolate(alphau_eff, bc_zg, mesh)

            # updateFluxes.H: fvsc gradients
            gradUf = fvsc.grad_from_padded(U_pad, mesh, scheme=sch_U)
            gradef = fvsc.grad_from_padded(e_pad, mesh, scheme=sch_e)
            gradRhof = fvsc.grad_from_padded(rho_pad, mesh, scheme=sch_rho)
            gradPf = fvsc.grad_from_padded(p_pad, mesh, scheme=sch_p)

            # flux assembly, unrolled over the static component indices; only
            # row a of the Pi tensor is needed at a-faces
            phiJm, mom_flux, e_flux, phiwStar = [], [], [], []
            for a in range(nd):
                gU = gradUf[a]  # (i, j, faces)
                uf = Uf[a]
                ruf = rhoUf[a]
                divU = sum(gU[i, i] for i in range(nd))
                u_gradrho = sum(uf[i] * gradRhof[a][i] for i in range(nd))
                rhoU_gradU = [sum(ruf[i] * gU[i, j] for i in range(nd))
                              for j in range(nd)]
                w_star = [tau_f[a] * (u_gradrho * uf[j] + ruf[j] * divU
                                      + rhoU_gradU[j])
                          for j in range(nd)]
                phiwStar.append(w_star[a] * area[a])
                jm_n = ruf[a] - (w_star[a] + tau_f[a] * gradPf[a][a])
                phiJm_a = jm_n * area[a]
                phiJm.append(phiJm_a)

                # momentum fluxes
                u_gradp = sum(uf[i] * gradPf[a][i] for i in range(nd))
                iso = u_gradp + gamma * pf[a] * divU
                urr = UrhoUf_row[a]  # (k, faces): interp(U_a * rhoU_k)
                pi_row = []
                for j in range(nd):
                    pij = tau_f[a] * (
                        sum(urr[k] * gU[k, j] for k in range(nd))
                        + uf[a] * gradPf[a][j]
                        + (iso if j == a else 0.0))
                    pij = pij + muf[a] * (
                        gU[a, j] + gU[j, a]
                        - ((2.0 / 3.0) * divU if j == a else 0.0))
                    pi_row.append(pij)
                phiPi = area[a] * torch.stack(pi_row, dim=0)
                mf = phiJm_a * uf
                mf[a] = mf[a] + area[a] * pf[a]  # Sf*pf: normal component
                mom_flux.append(mf - phiPi)

                # energy fluxes
                de = [gradef[a][k] - (pf[a] / rhof[a] ** 2) * gradRhof[a][k]
                      for k in range(nd)]
                q_n = -tau_f[a] * sum(urr[k] * de[k] for k in range(nd))
                q_n = q_n - alphauf[a] * gradef[a][a]
                phiPiU = area[a] * sum(pi_row[j] * uf[j] for j in range(nd))
                e_flux.append(phiJm_a * Hf[a] + q_n * area[a] - phiPiU)

            # Courant + setDeltaT (acoustic)
            co = common.courant_acoustic(Uf, cf, dt, mesh)
            dt_new = common.set_delta_t(dt, co, common.tau_f_min(tau_f), tc)

            rho_new = rho - dt_new * fvsc.div_flux(tuple(phiJm), mesh)
            rhoU_new = rhoU - dt_new * fvsc.div_flux(tuple(mom_flux), mesh)
            rhoE_new = rhoE - dt_new * fvsc.div_flux(tuple(e_flux), mesh)

            # the lagged qgdFlux gradients from this step's phiwStar.  Under
            # decomposition every rank computes rows at its block edge, but
            # only the rank at the physical side reads them (its ghost_pad
            # alone builds that BC layer): no broadcast is made, and
            # parallel.sharding's from_spmd takes the owner's rows
            pbc_new = []
            for a, side in flux_sides:
                ax = phiwStar[a].ndim - nd + a
                idx = 0 if side == 0 else phiwStar[a].shape[ax] - 1
                ws = phiwStar[a].narrow(ax, idx, 1)
                tf = tau_f[a].narrow(ax, idx, 1)
                sign = -1.0 if side == 0 else 1.0
                arb = torch.broadcast_to(area[a], tau_f[a].shape
                                         ).narrow(ax, idx, 1)
                pbc_new.append(-sign * ws / (tf * arb))

            return State(rho=rho_new, rhoU=rhoU_new, rhoE=rhoE_new,
                         sc=coeffs.sc, t=t + dt_new, dt=dt_new,
                         pbc=tuple(pbc_new))

        return step

    # -- fused kernel path ----------------------------------------------------
    def fused_supported(self) -> bool:
        """True if this config runs on a fused step: 2D (ops.fused_qgd2d) or
        3D (ops.fused_qgd3d), both hand-written CUDA kernels on the card."""
        if self.mesh.ndim == 3:
            from ..ops import fused_qgd3d

            return fused_qgd3d.supported(self)
        from ..ops import fused_qgd2d

        return fused_qgd2d.supported(self)

    def fused_builder(self):
        """The builder `make_fused_step` takes: `build_fused_step_3d` on 3D
        meshes; on 2D, `build_tiled_fused_step` (K2: the raw sensor and the
        first smoothing ring folded into the step by `qgd2d_emit`) for
        varScModel5 with a scalar cqSc, and `build_fused_step` (K1 with the
        plain sensor pre-pass) for every other config.  The reference's
        choice between its two 2D kernels is a VMEM fit, which the card does
        not have."""
        if self.mesh.ndim == 3:
            from ..ops import fused_qgd3d

            return fused_qgd3d.build_fused_step_3d
        from ..ops import fused_qgd2d

        if fused_qgd2d.folds_sensor(self):
            return fused_qgd2d.build_tiled_fused_step
        return fused_qgd2d.build_fused_step

    def make_fused_step(self):
        """(step, to_fused, from_fused) of the builder `fused_builder()`
        names.  `step` maps the fused carry (FusedState, TiledState or
        Fused3DState) to the next; to_fused / from_fused convert to and from
        the composable State."""
        return self.fused_builder()(self)
