"""QGDFoam — compressible QGD solver (PyTorch port of
`qgdsolver_tpu.solvers.qgd`).

Per step (reference QGDFoam.C):
  updateFields.H : interpolate rho, U, rhoU, U*rhoU, p, c, H, muEff,
                   alphaEff to faces
  updateFluxes.H : gradUf/gradef/gradRhof/gradPf = fvsc::grad; divUf
                   rhoW = tau_f*((Uf.gradRhof)Uf + rhoUf*divUf + (rhoUf.grad)Uf)
                   jm = rhoUf - rhoW - tau_f*gradPf; Pif; qf
                   (the Navier-Stokes stress and heat flux in Pif and qf
                   only with explicit diffusion)
  QGDCourantNo.H + setDeltaT
  QGDRhoEqn.H    : explicit update
  QGDUEqn.H      : explicit update; with implicitDiffusion the Helmholtz
                   solve rho/dt(U - U*) - lap(muEff_f, U) = div(phiTauMC)
  QGDEEqn.H      : explicit update; with implicitDiffusion
                   rho/dt(e - e*) - lap(alphaEff_f, e) = 0
  closure        : p = rho/psi

Primitive ghosts are derived thermodynamically from the p/T/U boundary
conditions (rho_ghost = p_ghost*psi(T_ghost) etc.); each primitive is padded
once and reused by all four fvsc gradients.  Beside the main path the step
takes stairstep solid masks (`Mesh.solid`: mirror fill before the step,
solid cells clamped after it, masked Helmholtz solves), wedge meshes
(`AxisymmetricMesh`: the radial hoop source, always explicit),
waveTransmissive outflows (a carried face value in `State.wt`, substituted
as a Mixed BC each step, on a whole side or on its segment of a split side)
and the qgdFlux limiter and relaxation.

The step runs decomposed as it is: `parallel.sharding.build_spmd_step`
builds it on a block mesh under an spmd context, which `ghost_pad`, the
reductions and the CG's dots consult (solid masks are not decomposed).
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ..core import bc as bcm
from ..core.mesh import Mesh
from ..ops import fvsc, linsolve
from ..ops.pad import _segment_mask, ghost_pad
from ..parallel import spmd
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
    # waveTransmissive carried face values, one per marked (field, axis,
    # side, segment) in `QGDFoam._wt_sides` order, each a whole-side
    # boundary layer (size 1 along its axis); a segment's layer holds the
    # boundary cells' values outside the segment, which nothing reads
    wt: tp.Tuple[torch.Tensor, ...] = ()


def _edge(f, nd, a, side):
    """The boundary cell layer of f (trailing nd spatial axes) at side
    `side` of axis a, kept as a size-1 axis."""
    ax = f.ndim - nd + a
    return f.narrow(ax, 0 if side == 0 else f.shape[ax] - 1, 1)


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
    cg_tol: float = 1e-8
    cg_maxiter: int = 500
    fvsc_scheme: tp.Any = "full"  # word or {term: word} dict
    # qgdFlux robustness for a shock standing on the patch: qgdflux_limit
    # clamps |dp/dn| to limit x the interior |snGrad p| at the patch, and
    # qgdflux_relax under-relaxes the carried gradient.  The defaults (None,
    # 1.0) are the reference BC as it is.
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

    def _wt_sides(self):
        """(field, axis, side, bc, seg) of every waveTransmissive BC of the
        p, T and U BCs, in that field order: a whole side (seg None), or
        segment `seg` of a split (Segmented) side."""
        bu, bp, bt = self._bcs()
        out = []
        for key, bcs in (("p", bp), ("T", bt), ("U", bu)):
            for a in range(self.mesh.ndim):
                for side in (0, 1):
                    b = bcs[a, side]
                    if isinstance(b, bcm.WaveTransmissive):
                        out.append((key, a, side, b, None))
                    elif isinstance(b, bcm.Segmented):
                        out.extend((key, a, side, sub, i) for i, (_, sub)
                                   in enumerate(b.segments)
                                   if isinstance(sub, bcm.WaveTransmissive))
        return tuple(out)

    def _pbc_zeros(self):
        out = []
        for a, _ in self._flux_sides():
            shape = list(self.mesh.shape)
            shape[a] = 1
            out.append(torch.zeros(shape, dtype=self.mesh.dtype,
                                   device=self.mesh.device))
        return tuple(out)

    def init(self, p0, T0, U0, t0=0.0, sc0=None) -> State:
        """The conservative State of primitive fields (ZQGDFoam's too)."""
        th = self.thermo
        mesh = self.mesh
        p0, T0, U0 = (mesh.tensor(x) if not torch.is_tensor(x) else x
                      for x in (p0, T0, U0))
        rho = th.rho_from_p_T(p0, T0)
        e = th.e_from_T(T0)
        rhoU = rho[None] * U0
        rhoE = rho * e + 0.5 * rho * torch.sum(U0 * U0, dim=0)
        sc = torch.zeros_like(rho) if sc0 is None else bcm.as_value(sc0, rho)
        fields = {"p": p0, "T": T0, "U": U0}
        # the carried waveTransmissive face values start at the boundary
        # cells
        wt = tuple(_edge(fields[key], mesh.ndim, a, side)
                   for key, a, side, _, _ in self._wt_sides())
        return State(rho=rho, rhoU=rhoU, rhoE=rhoE, sc=sc,
                     t=bcm.as_value(t0, rho), dt=bcm.as_value(self.time.dt0, rho),
                     pbc=self._pbc_zeros(), wt=wt)

    def primitives(self, s: State):
        th = self.thermo
        U = s.rhoU / s.rho[None]
        e = s.rhoE / s.rho - 0.5 * torch.sum(U * U, dim=0)
        T = th.T_from_e(e)
        p = th.p_from_rho_T(s.rho, T)
        return U, e, T, p

    def make_step(self, external_sources: bool = False):
        """Build the step State -> State.

        external_sources=True: the step takes (state, srcs), srcs a tuple
        (rhoSu, rhoUSu, rhoESu) or a callable of the dt this step applies
        returning one (the parcel exchange then conserves exactly under
        adaptive time steps): the createZeroSources.H slots of the
        Lagrangian solvers (particlesQGDFoam: rhoUSu = parcels.SU(U),
        rhoESu = parcels.Sh(e)), each a cell field or a number."""
        mesh = self.mesh
        nd = mesh.ndim
        th = self.thermo
        bc_U, bc_p0, bc_T = self._bcs()
        tc = self.time
        implicit = self.implicit_diffusion
        scheme = self.fvsc_scheme
        sch_U = fvsc.scheme_for(scheme, "grad(U)")
        sch_e = fvsc.scheme_for(scheme, "grad(e)")
        sch_rho = fvsc.scheme_for(scheme, "grad(rho)")
        sch_p = fvsc.scheme_for(scheme, "grad(p)")
        bc_zg = bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        area = tuple(mesh.face_area(a) for a in range(nd))
        # a constant gamma for the calorically perfect thermos; None for a
        # variable cp (JANAF), whose gamma(T) is interpolated to the faces
        # each step
        gamma = getattr(th, "gamma", None)
        Cv = getattr(th, "Cv", None)
        flux_sides = self._flux_sides()

        # stairstep solids: mirror fill before the step, solid cells
        # clamped after it, masked Helmholtz solves
        wall = fluid_mask = None
        if mesh.solid is not None:
            from ..core.solid import StairstepSolid

            wall = StairstepSolid(mesh.solid, device=mesh.device)
            fluid_mask = ~wall.solid.cpu().numpy()

        wt_sides = self._wt_sides()
        # the segments of each split side a waveTransmissive segment sits in
        wt_segs = [None if seg is None else
                   {"p": bc_p0, "T": bc_T, "U": bc_U}[key][a, side].segments
                   for key, a, side, _, seg in wt_sides]
        wt_has_T = any(w[0] == "T" for w in wt_sides)
        # e BCs from the T BCs (e_wall = e(T_wall)), for the implicit e
        # solve; per step when a T side carries a waveTransmissive value
        bc_e = (None if wt_has_T else
                common.e_bcs_from_T(bc_T, th.e_from_T, Cv))

        def step(s: State, srcs=None) -> State:
            rho, rhoU, rhoE, sc_prev, t, dt = s[:6]
            # substitute the lagged qgdFlux gradients into the p BCs
            bc_p = bc_p0
            for i, (a, side) in enumerate(flux_sides):
                bc_p = bc_p.replace(a, side, bcm.FixedGradient(s.pbc[i]))
            U, e, T, p = self.primitives(s)
            if wall is not None:
                # mirror fill of the solid boundary cells: the shared faces
                # see a zero normal velocity and the wall pressure
                T = wall.mirror(T)
                p = wall.mirror(p)
                U = wall.mirror_vector(U)
                e = torch.where(wall.boundary, th.e_from_T(T), e)
                rho = torch.where(wall.boundary, th.rho_from_p_T(p, T), rho)
                rhoU = torch.where(wall.boundary[None], rho[None] * U, rhoU)
                rhoE = torch.where(
                    wall.boundary,
                    rho * e + 0.5 * rho * torch.sum(U * U, dim=0), rhoE)
            # waveTransmissive (advectiveFvPatchField, Euler ddt): the BC
            # acts as the mixed condition face = frac*ref + (1-frac)*cell,
            # ref = (v_old + k*field_inf)/(1+k), frac = (1+k)/(1+alpha+k),
            # alpha = w dt/delta, k = w dt/lInf, w = max(Un, 0) + c; per
            # face, so on a segment of a split side the Mixed condition
            # replaces that segment alone
            sub_bcs = {"p": bc_p, "T": bc_T, "U": bc_U}
            wt_ref, wt_frac = [], []
            for i, (key, a, side, b, seg) in enumerate(wt_sides):
                un = _edge(U[a], nd, a, side) * (1.0 if side else -1.0)
                w = torch.clamp(un, min=0.0) + th.c_from_pT(
                    _edge(p, nd, a, side), _edge(T, nd, a, side))
                delta = 0.5 * float(mesh.dx[a][-1 if side else 0])
                al = w * dt / delta
                k = (w * dt / b.l_inf) if b.l_inf > 0 else 0.0
                ref = (s.wt[i] + k * b.field_inf) / (1.0 + k)
                frac = (1.0 + k) / (1.0 + al + k)
                wt_ref.append(ref)
                wt_frac.append(frac)
                sub_bcs[key] = sub_bcs[key].replace(a, side, _substitute(
                    sub_bcs[key][a, side], seg, bcm.Mixed(ref, frac)))
            bc_p, bc_Tw, bc_Uw = sub_bcs["p"], sub_bcs["T"], sub_bcs["U"]
            bc_ew = (common.e_bcs_from_T(bc_Tw, th.e_from_T, Cv)
                     if wt_has_T else bc_e)
            # resolve inletOutlet markers against the current flow direction
            bc_Ur = bcm.resolve_inlet_outlet(bc_Uw, U, nd)
            bc_Tr = bcm.resolve_inlet_outlet(bc_Tw, U, nd)
            bc_p = bcm.resolve_inlet_outlet(bc_p, U, nd)
            bc_er = bcm.resolve_inlet_outlet(bc_ew, U, nd)
            c = th.c_from_pT(p, T)
            mu_mol = th.mu(p, T)
            alphau_mol = th.alphah(p, T)

            # thermo.correct(): tau coefficients + effective transport
            coeffs = self.tau_model.correct(mesh, c=c, p=p, rho=rho,
                                            sc_prev=sc_prev, mu=mu_mol,
                                            bc_p=bc_p, t=t)
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
            gammaf = ((gamma,) * nd if gamma is not None else
                      fvsc.interp_from_padded(th.gamma_of(T_pad), mesh))
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

                # momentum fluxes (the Navier-Stokes stress only when the
                # diffusion is explicit)
                u_gradp = sum(uf[i] * gradPf[a][i] for i in range(nd))
                iso = u_gradp + gammaf[a] * pf[a] * divU
                urr = UrhoUf_row[a]  # (k, faces): interp(U_a * rhoU_k)
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
                phiPi = area[a] * torch.stack(pi_row, dim=0)
                mf = phiJm_a * uf
                mf[a] = mf[a] + area[a] * pf[a]  # Sf*pf: normal component
                mom_flux.append(mf - phiPi)

                # energy fluxes
                de = [gradef[a][k] - (pf[a] / rhof[a] ** 2) * gradRhof[a][k]
                      for k in range(nd)]
                q_n = -tau_f[a] * sum(urr[k] * de[k] for k in range(nd))
                if not implicit:
                    q_n = q_n - alphauf[a] * gradef[a][a]
                phiPiU = area[a] * sum(pi_row[j] * uf[j] for j in range(nd))
                e_flux.append(phiJm_a * Hf[a] + q_n * area[a] - phiPiU)

            # Courant + setDeltaT (acoustic)
            co = common.courant_acoustic(Uf, cf, dt, mesh)
            dt_new = common.set_delta_t(dt, co, common.tau_f_min(tau_f), tc)

            if callable(srcs):
                srcs = srcs(dt_new)
            rho_new = rho - dt_new * _less(fvsc.div_flux(tuple(phiJm), mesh),
                                           srcs, 0)
            if wall is not None:
                # solid cells are not prognostic: clamp to the mirror fill
                rho_new = torch.where(wall.solid, rho, rho_new)
            rhoU_new = rhoU - dt_new * _less(
                fvsc.div_flux(tuple(mom_flux), mesh), srcs, 1)
            if mesh.axisymmetric:
                # wedge hoop terms of the radial momentum (u_theta = 0): the
                # side faces' (p - Pi_theta_theta)/r per volume, with
                #   Pi_tt = tau*(U.grad p + gamma*p*divU)
                #           + mu_eff*(2 u_r/r - (2/3) divU),
                # divU the cylindrical divergence.  The viscous part stays
                # explicit in both diffusion modes: the implicit Helmholtz
                # solve has no 1/r^2 hoop term.
                r_c = mesh.cell_coords(1)
                divU_cell = fvsc.div_flux(
                    tuple(Uf[a][a] * area[a] for a in range(nd)), mesh)
                gradp_cell = fvsc.grad_cell_from_faces(pf, mesh)
                u_gradp_cell = sum(U[i] * gradp_cell[i] for i in range(nd))
                gam_c = gamma if gamma is not None else th.gamma_of(T)
                pi_tt = (coeffs.tau * (u_gradp_cell + gam_c * p * divU_cell)
                         + mu_eff * (2.0 * U[1] / r_c
                                     - (2.0 / 3.0) * divU_cell))
                rhoU_new = torch.stack(
                    [rhoU_new[0], rhoU_new[1] + dt_new * (p - pi_tt) / r_c])
            if wall is not None:
                rhoU_new = torch.where(wall.solid[None], rhoU, rhoU_new)
            U_new = rhoU_new / rho_new[None]

            if implicit:
                # tauMC = muEff*dev2(grad(U)^T), phiTauMC = Sf & interp(tauMC)
                gradU_cell = fvsc.grad_cell_vector(U, bc_Ur, mesh, t=t)
                if wall is not None:
                    # solid cells take the adjacent fluid cell's gradient
                    gradU_cell = torch.stack([
                        torch.stack([wall.mirror(gradU_cell[i, j])
                                     for j in range(nd)])
                        for i in range(nd)])
                tauMC = mu_eff * dev2T(gradU_cell, nd)
                tauMC_f = fvsc.interpolate(
                    tauMC.reshape((nd * nd,) + mesh.shape), bc_zg, mesh)
                tauMC_row = [tauMC_f[a].reshape((nd, nd)
                                                + mesh.face_shape(a))[a]
                             for a in range(nd)]
                phiTauMC = tuple(area[a] * tauMC_row[a] for a in range(nd))
                rhs_U = rho_new * U_new / dt_new \
                    + fvsc.div_flux(phiTauMC, mesh)
                U_new = linsolve.solve_helmholtz(
                    diag_coeff=rho_new / dt_new, gamma_faces=muf, rhs=rhs_U,
                    x0=U_new, bcs=bc_Ur, mesh=mesh, t=t, vector=True,
                    tol=self.cg_tol, maxiter=self.cg_maxiter,
                    fluid_mask=fluid_mask, solid_wall_dirichlet=True).x
                if wall is not None:
                    # the solve left the solid cells at 0: restore them
                    U_new = torch.where(wall.solid[None], U, U_new)
                rhoU_new = rho_new[None] * U_new
                # sigmaDotU = (muf*interp(grad U) + tauMC_f) & Uf
                gradU_f = fvsc.interpolate(
                    gradU_cell.reshape((nd * nd,) + mesh.shape), bc_zg, mesh)
                for a in range(nd):
                    sig = muf[a] * gradU_f[a].reshape(
                        (nd, nd) + mesh.face_shape(a))[a] + tauMC_row[a]
                    e_flux[a] = e_flux[a] - area[a] * torch.sum(
                        sig * Uf[a], dim=0)

            rhoE_new = rhoE - dt_new * _less(
                fvsc.div_flux(tuple(e_flux), mesh), srcs, 2)
            if wall is not None:
                rhoE_new = torch.where(wall.solid, rhoE, rhoE_new)
            if implicit or wt_sides:
                e_new = rhoE_new / rho_new \
                    - 0.5 * torch.sum(U_new * U_new, dim=0)
            if implicit:
                e_new = linsolve.solve_helmholtz(
                    diag_coeff=rho_new / dt_new, gamma_faces=alphauf,
                    rhs=rho_new * e_new / dt_new, x0=e_new, bcs=bc_er,
                    mesh=mesh, t=t, tol=self.cg_tol,
                    maxiter=self.cg_maxiter, fluid_mask=fluid_mask).x
                if wall is not None:
                    e_new = torch.where(wall.solid, e, e_new)
                rhoE_new = rho_new * (e_new
                                      + 0.5 * torch.sum(U_new * U_new, dim=0))

            # the lagged qgdFlux gradients from this step's phiwStar.  Under
            # decomposition every rank computes rows at its block edge, but
            # only the rank at the physical side reads them (its ghost_pad
            # alone builds that BC layer): no broadcast is made, and
            # parallel.sharding's from_spmd takes the owner's rows
            pbc_new = []
            for i, (a, side) in enumerate(flux_sides):
                ax = phiwStar[a].ndim - nd + a
                idx = 0 if side == 0 else phiwStar[a].shape[ax] - 1
                ws = phiwStar[a].narrow(ax, idx, 1)
                tf = tau_f[a].narrow(ax, idx, 1)
                sign = -1.0 if side == 0 else 1.0
                arb = torch.broadcast_to(area[a], tau_f[a].shape
                                         ).narrow(ax, idx, 1)
                g = -sign * ws / (tf * arb)
                if self.qgdflux_limit is not None:
                    # face-local clamp: |dp/dn| <= limit * interior |snGrad|
                    n = p.shape[a]
                    pm1 = p.narrow(a, n - 1 if side else 0, 1)
                    pm2 = p.narrow(a, n - 2 if side else 1, 1)
                    dxe = float(mesh.dx[a][-1 if side else 0])
                    cap = self.qgdflux_limit * torch.abs(pm1 - pm2) / dxe
                    g = torch.clamp(g, min=-cap, max=cap)
                if self.qgdflux_relax != 1.0:
                    g = ((1.0 - self.qgdflux_relax) * s.pbc[i]
                         + self.qgdflux_relax * g)
                pbc_new.append(g)

            # the realized waveTransmissive face values: the mixed condition
            # against the updated boundary cells (only the rank at the
            # physical side reads them, as pbc)
            wt_new = []
            for i, (key, a, side, _, seg) in enumerate(wt_sides):
                if key == "U":
                    phi_c = _edge(U_new, nd, a, side)
                else:
                    T_edge = th.T_from_e(_edge(e_new, nd, a, side))
                    phi_c = T_edge if key == "T" else th.p_from_rho_T(
                        _edge(rho_new, nd, a, side), T_edge)
                v = wt_frac[i] * wt_ref[i] + (1.0 - wt_frac[i]) * phi_c
                if seg is not None:
                    # outside the segment: the boundary cells
                    v = torch.where(_segment_cells(wt_segs[i], seg, a,
                                                   mesh), v, phi_c)
                wt_new.append(v)

            return State(rho=rho_new, rhoU=rhoU_new, rhoE=rhoE_new,
                         sc=coeffs.sc, t=t + dt_new, dt=dt_new,
                         pbc=tuple(pbc_new), wt=tuple(wt_new))

        if external_sources:
            return step
        return lambda s: step(s)

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


def _substitute(bc, seg, sub):
    """bc with sub in place of segment `seg` of a Segmented bc, or sub
    itself for a whole side (seg None)."""
    if seg is None:
        return sub
    segs = bc.segments
    return bcm.Segmented(segs[:seg] + ((segs[seg][0], sub),)
                         + segs[seg + 1:])


def _segment_cells(segments, seg, a, mesh):
    """Bool mask over the axis-a boundary layer of the cells that segment
    `seg` of a Segmented side holds: its face rectangles less those of the
    later segments, which win where they overlap (`ops.pad`)."""
    ctx = spmd.current()
    nd = mesh.ndim

    def cells(rects):
        m = _segment_mask(rects, a, mesh, ctx, mesh.device)
        # the mask spans the ghosts of the axes padded before a
        for b in range(a):
            m = m.narrow(b, 1, mesh.shape[b])
        return m

    mask = cells(segments[seg][0])
    for rects, _ in segments[seg + 1:]:
        mask = mask & ~cells(rects)
    return mask.reshape([1 if b == a else mesh.shape[b] for b in range(nd)])


def _less(div, srcs, i):
    """div minus source i of srcs (rho, rhoU, rhoE), the order of the
    reference's `ddt = -(div - Su)`; div itself without sources."""
    return div if srcs is None else div - srcs[i]


def dev2T(gradU_cell, nd):
    """dev2(T^t) = T^t - (2/3) tr(T) I for T = grad(U), the deviator of
    tauMC (OpenFOAM dev2 of the transposed gradient)."""
    eye = torch.eye(nd, dtype=gradU_cell.dtype, device=gradU_cell.device
                    ).reshape((nd, nd) + (1,) * (gradU_cell.ndim - 2))
    tr = sum(gradU_cell[i, i] for i in range(nd))
    return gradU_cell.transpose(0, 1) - (2.0 / 3.0) * eye * tr
