"""QHDFoam — the incompressible quasi-hydrodynamic solver with Boussinesq
buoyancy (PyTorch port of `qgdsolver_tpu.solvers.qhd`, static meshes).

Per step (reference QHDFoam.C):
  updateFields.H : gradUf/gradTf (fvsc), interpolations, BdFrc = beta*T*g
                   (less 2*Omega x U in a rotating frame, SRFQHDFoam)
  updateFluxes.H : phiu = Sf&Uf; phiwo = Sf&(tau_f((Uf.grad)U - BdFrc)_f);
                   taubyrhof = tau_f/rho_f
  QHDCourantNo.H + setDeltaT (advective)
  QHDpEqn.H      : div(phiu) - div(phiwo) - laplacian(tau/rho, p) = 0;
                   phi = phiu - phiwo + pEqn.flux()
  pRef fix       : p += pRefValue - p[pRefCell] on a pure-Neumann system
  QHDUEqn.H      : Wf = tau_f((Uf.grad)U + gradPf/rho_f - BdFrcf);
                   ddt(U) + div(phi*Uf - phiu*Wf) - lap(nu_f, U)
                   - div(nu_f Sf.(gradU)^T_f) = -grad(p)/rho + BdFrc
  QHDTEqn.H      : ddt(T) + div(phi*Tf) - lap(Hi_f, T)
                   - div(tau_f*phiu*(Uf.gradTf)) = 0, or with
                   t_equation="mules" (mulesQHDFoam) bounded explicit
                   advection and an implicit diffusion correction.

The pressure and the implicit U/T diffusion are solved by the matrix-free
CG of `ops.linsolve` (the pressure system is singular on pure-Neumann
boundaries: mean projection, then the pRef fix).  `phi` is assembled from
the same face expression whose divergence the CG drove to zero, so
div(phi) = 0 to the solver's tolerance.  Stairstep solids (`Mesh.solid`)
take the mirror fill, masked operators and the first fluid cell as pRef
cell.  Under an spmd context the step runs decomposed as it is: the CG's
dots and the bounds are collectives and the pRef value comes from the rank
that owns the global cell (0, ..., 0) (`spmd.first_shard_value`).

Mesh motion (QHDDyMFoam: `mesh_velocity`, `mesh_scale`, `mesh_faces`,
`check_mesh_courant`) keeps its fields but is not in the port yet.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from ..core import bc as bcm
from ..core.mesh import Mesh
from ..ops import fvsc, linsolve, mules
from ..parallel import spmd
from ..physics.qgdcoeffs import HbyUQHD, TauModel
from ..physics.thermo import RhoConstThermo
from . import common
from .common import TimeControls


class State(tp.NamedTuple):
    U: torch.Tensor  # (d, *cells)
    T: torch.Tensor
    p: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor


def _cross_omega(omega, U, nd):
    """Omega x U for a 3-vector Omega and an nd-component velocity.  2D
    fields lie in the z = const plane: only omega_z acts."""
    if nd == 2:
        wz = omega[2] if len(omega) == 3 else omega[0]
        return torch.stack([-wz * U[1], wz * U[0]], dim=0)
    return torch.stack([omega[1] * U[2] - omega[2] * U[1],
                        omega[2] * U[0] - omega[0] * U[2],
                        omega[0] * U[1] - omega[1] * U[0]], dim=0)


def _sub_flux_bc(bc_p, grads):
    """bc_p with its QHDFluxP markers replaced by this step's
    FixedGradient layers ({(axis, side): gradient})."""
    out = bc_p
    for (a, side), g in grads.items():
        out = out.replace(a, side, bcm.FixedGradient(g))
    return out


@dataclasses.dataclass(frozen=True)
class QHDFoam:
    mesh: Mesh
    thermo: RhoConstThermo
    tau_model: TauModel = HbyUQHD()
    g: tp.Optional[tp.Tuple[float, ...]] = None  # gravity, len = ndim
    omega: tp.Optional[tp.Tuple[float, float, float]] = None  # SRF rotation
    # QHDDyMFoam's moving meshes (a prescribed rigid velocity, per-axis
    # dilation, per-axis face trajectories, and the mesh Courant cap): not
    # in the port yet, make_step raises when one is set
    mesh_velocity: tp.Optional[tp.Callable] = None
    mesh_scale: tp.Optional[tp.Callable] = None
    mesh_faces: tp.Optional[tp.Callable] = None
    check_mesh_courant: bool = False
    bc_U: tp.Optional[bcm.FieldBCs] = None
    bc_T: tp.Optional[bcm.FieldBCs] = None
    bc_p: tp.Optional[bcm.FieldBCs] = None
    time: TimeControls = TimeControls()
    implicit_diffusion: bool = True
    p_ref_value: float = 0.0
    cg_tol: float = 1e-8
    cg_maxiter: int = 1000
    fvsc_scheme: tp.Any = "full"
    # "standard": QHDTEqn.H; "mules": MULESTEqn.H (mulesQHDFoam)
    t_equation: str = "standard"
    mules_n_iter: int = 3

    def _bcs(self):
        nd = self.mesh.ndim
        bu = self.bc_U or bcm.FieldBCs.uniform(bcm.FixedValue([0.0] * nd),
                                               nd)
        bt = self.bc_T or bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        bp = self.bc_p or bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        return bu, bt, bp

    def _p_singular(self, bp) -> bool:
        """A pure-Neumann p system (no FixedValue side): it needs the
        reference fix."""
        return not any(isinstance(bp[a, s], bcm.FixedValue)
                       for a in range(self.mesh.ndim) for s in (0, 1))

    def init(self, U0, T0, p0=None, t0=0.0) -> State:
        mesh = self.mesh
        U0, T0 = (x if torch.is_tensor(x) else mesh.tensor(x)
                  for x in (U0, T0))
        if p0 is None:
            p0 = torch.zeros_like(T0)
        elif not torch.is_tensor(p0):
            p0 = mesh.tensor(p0)
        return State(U=U0, T=T0, p=p0, t=bcm.as_value(t0, T0),
                     dt=bcm.as_value(self.time.dt0, T0))

    def make_step(self):
        for name in ("mesh_velocity", "mesh_scale", "mesh_faces"):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"QHDFoam {name}: moving meshes are not in the PyTorch "
                    "port yet: ROADMAP queue 1, item 8b (QHDDyMFoam)")
        if self.check_mesh_courant:
            raise NotImplementedError(
                "QHDFoam check_mesh_courant: moving meshes are not in the "
                "PyTorch port yet: ROADMAP queue 1, item 8b (QHDDyMFoam)")
        mesh = self.mesh
        nd = mesh.ndim
        bc_U, bc_T, bc_p0 = self._bcs()
        thermo = self.thermo
        tc = self.time
        gvec = mesh.tensor(np.asarray(self.g if self.g is not None
                                      else (0.0,) * nd, dtype=np.float64)
                           ).reshape((nd,) + (1,) * nd)
        omega = (None if self.omega is None else
                 mesh.tensor(np.asarray(self.omega, dtype=np.float64)))
        singular = self._p_singular(bc_p0)
        bc_zg = bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        sch_U = fvsc.scheme_for(self.fvsc_scheme, "grad(U)")
        sch_T = fvsc.scheme_for(self.fvsc_scheme, "grad(T)")
        sch_p = fvsc.scheme_for(self.fvsc_scheme, "grad(p)")
        area = tuple(mesh.face_area(a) for a in range(nd))
        mules_T = self.t_equation == "mules"
        flux_sides = tuple((a, side) for a in range(nd) for side in (0, 1)
                           if isinstance(bc_p0[a, side], bcm.QHDFluxP))

        # stairstep solids: mirror fill before the step, masked
        # Helmholtz/Poisson operators (zero-flux immersed faces), solid
        # cells clamped after it; the pRef cell is the first fluid cell
        wall = fluid_mask = fmasks = None
        ref_cell = (0,) * nd
        if mesh.solid is not None:
            from ..core.solid import StairstepSolid

            wall = StairstepSolid(mesh.solid, device=mesh.device)
            fluid_mask = ~np.asarray(mesh.solid, dtype=bool)
            fmasks = linsolve.face_fluid_masks(mesh.solid, mesh)
            ref_cell = tuple(int(i) for i in np.argwhere(fluid_mask)[0])

        def helmholtz(**kw):
            return linsolve.solve_helmholtz(
                mesh=mesh, tol=self.cg_tol, maxiter=self.cg_maxiter,
                fluid_mask=fluid_mask, **kw).x

        def step(s: State) -> State:
            U, T, p, t, dt = s
            if wall is not None:
                # mirror fill of the solid boundary cells: the shared faces
                # see zero normal velocity and zero-gradient scalars
                T = wall.mirror(T)
                p = wall.mirror(p)
                U = wall.mirror_vector(U)
            # resolve inletOutlet markers against the current flow direction
            bc_Us = bcm.resolve_inlet_outlet(bc_U, U, nd)
            bc_Ts = bcm.resolve_inlet_outlet(bc_T, U, nd)
            rho = thermo.rho(p, T)
            mu = thermo.mu(p, T)
            alpha = thermo.alphah(p, T)

            # updateFields.H
            gradUf = fvsc.grad(U, bc_Us, mesh, scheme=sch_U, t=t, vector=True)
            gradTf = fvsc.grad(T, bc_Ts, mesh, scheme=sch_T, t=t)
            muf = fvsc.interpolate(mu, bc_zg, mesh)
            alphaf = fvsc.interpolate(alpha, bc_zg, mesh)
            rhof = fvsc.interpolate(rho, bc_zg, mesh)
            Uf = fvsc.interpolate(U, bc_Us, mesh, t=t, vector=True)
            Tf = fvsc.interpolate(T, bc_Ts, mesh, t=t)
            BdFrc = thermo.beta * T[None] * gvec
            if omega is not None:
                # the SRF Coriolis force: BdFrc -= 2*Omega x U
                BdFrc = BdFrc - 2.0 * _cross_omega(omega, U, nd)
            BdFrcf = fvsc.interpolate(BdFrc, bc_zg, mesh, vector=True)
            Hif = tuple(alphaf[a] / rhof[a] for a in range(nd))
            tau_f = self.tau_model.correct(mesh, p=p, T=T, ref=T, mu=mu,
                                           rho=rho).tau_f

            # updateFluxes.H: (Uf & gradUf)_a[j] = sum_i Uf_i dU_j/dx_i at
            # a-faces, unrolled over the components
            u_dot_gradU = tuple(
                torch.stack([sum(Uf[a][i] * gradUf[a][i, j]
                                 for i in range(nd)) for j in range(nd)],
                            dim=0)
                for a in range(nd))
            phiu = tuple(Uf[a][a] * area[a] for a in range(nd))
            wo = tuple(tau_f[a] * (u_dot_gradU[a] - BdFrcf[a])
                       for a in range(nd))
            phiwo = tuple(wo[a][a] * area[a] for a in range(nd))
            taubyrhof = tuple(tau_f[a] / rhof[a] for a in range(nd))
            # phiu/phiwo are not masked at immersed faces: the mirror fill
            # reproduces the body-fitted wall values there

            # Courant + setDeltaT
            co = common.courant_advective(Uf, dt, mesh)
            dt_new = common.set_delta_t(dt, co, common.tau_f_min(tau_f), tc)

            # QHDpEqn.H; the qhdFlux p BC: dp/dn = -phiwStar*rho_f /
            # (tau_f*|Sf|), phiwStar = phiwo (the regularizer flux without
            # grad p)
            flux_grads = {}
            for a, side in flux_sides:
                n = wo[a].shape[1 + a]
                idx = 0 if side == 0 else n - 1
                wn = wo[a][a].narrow(a, idx, 1)
                rf = rhof[a].narrow(a, idx, 1)
                tf = tau_f[a].narrow(a, idx, 1)
                sign = -1.0 if side == 0 else 1.0
                flux_grads[(a, side)] = -sign * wn * rf / tf
            bc_p = bcm.resolve_inlet_outlet(_sub_flux_bc(bc_p0, flux_grads),
                                            U, nd)
            rhs_p = fvsc.div_flux(phiu, mesh) - fvsc.div_flux(phiwo, mesh)
            p_new = helmholtz(diag_coeff=0.0, gamma_faces=taubyrhof,
                              rhs=-rhs_p, x0=p, bcs=bc_p, t=t,
                              singular=singular)
            if singular:
                # the pRef fix at cell (0, ..., 0), or the first fluid
                # cell on a solid-masked mesh; decomposed, the global
                # corner's rank owns it
                p_ref = spmd.first_shard_value(p_new[ref_cell])
                p_new = p_new + (self.p_ref_value - p_ref)
            if wall is not None:
                # the solve leaves solid cells at 0: every reader of p_new
                # below sees the wall mirror instead
                p_new = wall.mirror(p_new)

            # phi = phiu - phiwo + pEqn.flux(): the face flux the CG
            # balanced (its laplacian part masked at immersed faces, as
            # the masked operator was)
            snp = fvsc.sn_grad(p_new, bc_p, mesh, t=t)
            if fmasks is not None:
                snp = tuple(snp[a] * fmasks[a] for a in range(nd))
            phi = tuple(phiu[a] - phiwo[a] - taubyrhof[a] * area[a] * snp[a]
                        for a in range(nd))

            # QHDUEqn.H
            gradPf = fvsc.grad(p_new, bc_p, mesh, scheme=sch_p, t=t)
            Wf = tuple(tau_f[a] * (u_dot_gradU[a] + gradPf[a] / rhof[a]
                                   - BdFrcf[a]) for a in range(nd))
            # phiUf = qgdFlux(phi, U, Uf) - Sf&(Uf*Wf) = phi*Uf - phiu*Wf
            phiUf = tuple(phi[a] * Uf[a] - phiu[a] * Wf[a] for a in range(nd))
            nuf = tuple(muf[a] / rhof[a] for a in range(nd))
            # the explicit transposed stress div(nu_f Sf & interp(T(gradU))):
            # at an a-face (Sf & T(gradU))_j = |Sf| dU_a/dx_j, column a of
            # G[i, j] = dU_j/dx_i
            gradU_cell = fvsc.grad_cell_vector(U, bc_Us, mesh, t=t)
            if wall is not None:
                # solid cells take the adjacent fluid cell's gradient
                gradU_cell = torch.stack([
                    torch.stack([wall.mirror(gradU_cell[i, j])
                                 for j in range(nd)]) for i in range(nd)])
            gradU_f = fvsc.interpolate(
                gradU_cell.reshape((nd * nd,) + tuple(mesh.shape)), bc_zg,
                mesh)
            transp_flux = tuple(
                nuf[a] * area[a]
                * gradU_f[a].reshape((nd, nd) + mesh.face_shape(a))[:, a]
                for a in range(nd))
            grad_p_cell = fvsc.grad_cell(p_new, bc_p, mesh, t=t)
            rhs_U = (U / dt_new
                     - fvsc.div_flux(phiUf, mesh)
                     + fvsc.div_flux(transp_flux, mesh)
                     - grad_p_cell / rho[None]
                     + BdFrc)
            if mesh.axisymmetric:
                # the cylindrical vector laplacian's hoop term -u_r/r^2 of
                # (lap U)_r (the r-weighted metrics give the rest)
                r_c = mesh.cell_coords(1)
                rhs_U = torch.stack([
                    rhs_U[0], rhs_U[1] + -(mu / rho) * U[1] / (r_c * r_c)])
            if self.implicit_diffusion:
                U_new = helmholtz(diag_coeff=1.0 / dt_new, gamma_faces=nuf,
                                  rhs=rhs_U, x0=U, bcs=bc_Us, t=t,
                                  vector=True, solid_wall_dirichlet=True)
            else:
                # explicit diffusion on immersed walls: the mirror-filled U
                # already holds the no-slip ghost
                U_new = dt_new * (rhs_U + fvsc.laplacian_explicit(
                    nuf, U, bc_Us, mesh, t=t, vector=True))

            phiTf = tuple(phi[a] * Tf[a] for a in range(nd))
            Hif_m = (tuple(Hif[a] * fmasks[a] for a in range(nd))
                     if fmasks is not None else Hif)
            if mules_T:
                # MULESTEqn.H: bounded explicit advection between the
                # global bounds, then the diffusion correction
                T_adv, _ = mules.explicit_solve(
                    T, phi, phiTf, dt_new, mesh, spmd.all_max(torch.max(T)),
                    spmd.all_min(torch.min(T)), n_iter=self.mules_n_iter)
                if self.implicit_diffusion:
                    T_new = helmholtz(diag_coeff=1.0 / dt_new,
                                      gamma_faces=Hif, rhs=T_adv / dt_new,
                                      x0=T_adv, bcs=bc_Ts, t=t)
                else:
                    T_new = T_adv + dt_new * fvsc.laplacian_explicit(
                        Hif_m, T_adv, bc_Ts, mesh, t=t)
            else:
                # QHDTEqn.H
                phiTauTReg = tuple(
                    tau_f[a] * phiu[a] * torch.sum(Uf[a] * gradTf[a], dim=0)
                    for a in range(nd))
                rhs_T = (T / dt_new - fvsc.div_flux(phiTf, mesh)
                         + fvsc.div_flux(phiTauTReg, mesh))
                if self.implicit_diffusion:
                    T_new = helmholtz(diag_coeff=1.0 / dt_new,
                                      gamma_faces=Hif, rhs=rhs_T, x0=T,
                                      bcs=bc_Ts, t=t)
                else:
                    T_new = dt_new * (rhs_T + fvsc.laplacian_explicit(
                        Hif_m, T, bc_Ts, mesh, t=t))

            if wall is not None:
                # solid cells are not prognostic: they keep their carried
                # values (the mirror fill makes the wall ghosts next step)
                U_new = torch.where(wall.solid[None], s.U, U_new)
                T_new = torch.where(wall.solid, s.T, T_new)
                p_new = torch.where(wall.solid, s.p, p_new)
            return State(U=U_new, T=T_new, p=p_new, t=t + dt_new, dt=dt_new)

        return step
