"""QHDFoam — the incompressible quasi-hydrodynamic solver with Boussinesq
buoyancy, on static and moving meshes (PyTorch port of
`qgdsolver_tpu.solvers.qhd`).

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

Mesh motion (QHDDyMFoam, `solvers.qhd_dym`, whose docstring states the
motion callables' contract): a rigid `mesh_velocity` makes the convective
flux relative to the mesh (fvc::makeRelative) and the Courant number of
the relative face speed; a per-axis dilation `mesh_scale` runs the step on
the logical grid with metric factors on every operator, the moving-volume
ddt and Thomas-Lombard mixed-area mesh fluxes; general per-axis face
motion `mesh_faces` takes the Courant number and setDeltaT on the
pre-motion mesh, then runs the whole step on the post-motion geometry (a
`TracedMesh` of face tensors on the device; decomposed, this block's
`TracedShardMesh` window of it) with the volume ratio V_old/V_new in the
ddt and the Thomas-Lombard sweeps, so the discrete geometric conservation
law holds exactly.  `check_mesh_courant` folds the mesh face speed's
Courant number (global under a decomposition) into the dt controller.
No path reads `t` or any geometry back to the host.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

import numbers

from ..core import bc as bcm
from ..core.mesh import Mesh, TracedMesh
from ..ops import fvsc, linsolve, mules
from ..parallel import spmd
from ..parallel.shardmesh import TracedShardMesh
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


def motion_value(v, like):
    """A motion callable's value as a tensor in `like`'s dtype on its
    device: a tensor is moved (a no-op on that device), a number filled on
    the device, a sequence stacked element by element, anything else
    (a numpy array) copied from the host.  Nothing is read back."""
    if torch.is_tensor(v):
        return v.to(dtype=like.dtype, device=like.device)
    if isinstance(v, numbers.Number):
        return torch.full((), float(v), dtype=like.dtype, device=like.device)
    if isinstance(v, (tuple, list)):
        return torch.stack([motion_value(x, like) for x in v])
    return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=like.dtype,
                           device=like.device)


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
    # QHDDyMFoam's moving meshes: a rigid velocity t -> (ndim,), per-axis
    # dilation factors t -> (ndim,) (x_a = s_a(t)*xi_a, may be combined
    # with the rigid velocity), or per-axis face trajectories t -> tuple of
    # (n_a + 1,) strictly increasing coordinates (alone); and the mesh
    # Courant cap
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
        general = self.mesh_faces is not None
        deform = self.mesh_scale is not None
        rigid = self.mesh_velocity is not None
        if deform and self.t_equation == "mules":
            raise NotImplementedError("mules T-equation on a deforming mesh")
        if general and (deform or rigid):
            raise ValueError(
                "mesh_faces is the general motion spec: do not combine it "
                "with mesh_velocity/mesh_scale")
        if general and self.t_equation == "mules":
            raise NotImplementedError("mules T-equation on a deforming mesh")
        mesh = self.mesh
        nd = mesh.ndim
        if general and mesh.axisymmetric:
            # a moved mesh's geometry is planar (TracedMesh): the wedge's
            # r-weighted metrics and hoop source would be lost
            raise NotImplementedError("mesh_faces on a wedge mesh")
        bc_U, bc_T, bc_p0 = self._bcs()
        thermo = self.thermo
        tc = self.time
        check_co = self.check_mesh_courant
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
        mules_T = self.t_equation == "mules"
        flux_sides = tuple((a, side) for a in range(nd) for side in (0, 1)
                           if isinstance(bc_p0[a, side], bcm.QHDFluxP))
        # the logical face coordinates xi of a dilating mesh (x = s(t)*xi),
        # on the device once
        xi_f = (tuple(mesh.bcast(mesh.x_faces[a], a) for a in range(nd))
                if deform else None)

        # stairstep solids: mirror fill before the step, masked
        # Helmholtz/Poisson operators (zero-flux immersed faces), solid
        # cells clamped after it; the pRef cell is the first fluid cell
        wall = fluid_mask = fmasks = None
        ref_cell = (0,) * nd
        if mesh.solid is not None:
            from ..core.solid import StairstepSolid

            if general or deform or rigid:
                raise NotImplementedError("solid masks on a deforming mesh")
            wall = StairstepSolid(mesh.solid, device=mesh.device)
            fluid_mask = ~np.asarray(mesh.solid, dtype=bool)
            fmasks = linsolve.face_fluid_masks(mesh.solid, mesh)
            ref_cell = tuple(int(i) for i in np.argwhere(fluid_mask)[0])

        def helmholtz(m, **kw):
            return linsolve.solve_helmholtz(
                mesh=m, tol=self.cg_tol, maxiter=self.cg_maxiter,
                fluid_mask=fluid_mask, **kw).x

        def traced(faces, like):
            """The post-motion geometry of face coordinates `faces`: a
            TracedMesh, or under a decomposition this block's window of
            the global one (its partition faces see the neighbour's
            spacing)."""
            tm = TracedMesh(tuple(motion_value(f, like) for f in faces),
                            dtype=like.dtype, device=like.device)
            ctx = spmd.current()
            if ctx is None:
                return tm
            return TracedShardMesh(tm, [ctx.start(b) for b in range(nd)],
                                   mesh.shape)

        def step(s: State) -> State:
            U, T, p, t, dt = s
            m = mesh
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
            um = motion_value(self.mesh_velocity(t), T) if rigid else None

            if general:
                # OpenFOAM's order: Courant + setDeltaT on the pre-motion
                # mesh, mesh.update(), then the whole step on the
                # post-motion geometry
                m_old = traced(self.mesh_faces(t), T)
                m_est = traced(self.mesh_faces(t + dt), T)
                Uf0 = fvsc.interpolate(U, bc_Us, m_old, t=t, vector=True)
                Uf_rel0 = []
                mesh_co = torch.zeros((), dtype=T.dtype, device=T.device)
                for a in range(nd):
                    um_f = m_old.bcast(
                        (m_est.x_faces[a] - m_old.x_faces[a]) / dt, a)
                    Uf_rel0.append(torch.cat(
                        [Uf0[a][i:i + 1] - um_f[None] if i == a
                         else Uf0[a][i:i + 1] for i in range(nd)], dim=0))
                    if check_co:
                        mesh_co = torch.maximum(
                            mesh_co,
                            spmd.all_max(torch.max(torch.abs(um_f))) * dt
                            / spmd.all_min(torch.min(m_old.h_face(a))))
                co0 = common.courant_advective(tuple(Uf_rel0), dt, m_old)
                if check_co:
                    co0 = torch.maximum(co0, mesh_co)
                coeffs0 = self.tau_model.correct(m_old, p=p, T=T, ref=T,
                                                 mu=mu, rho=rho)
                dt_new = common.set_delta_t(
                    dt, co0, common.tau_f_min(coeffs0.tau_f), tc)
                m = traced(self.mesh_faces(t + dt_new), T)
                vol_ratio = m_old.cell_volume / m.cell_volume
                # Thomas-Lombard mixed-area mesh fluxes (axis a: the new
                # spacings for b < a, the old for b > a): the face sweeps
                # telescope to V_new - V_old per cell exactly, the
                # discrete geometric conservation law
                mesh_sweep = []
                for a in range(nd):
                    sw = m.bcast((m.x_faces[a] - m_old.x_faces[a])
                                 * (1.0 / dt_new), a)
                    for b in range(nd):
                        if b < a:
                            sw = sw * m.bcast(m.dx[b], b)
                        elif b > a:
                            sw = sw * m_old.bcast(m_old.dx[b], b)
                    mesh_sweep.append(sw)

            # updateFields.H
            gradUf = fvsc.grad(U, bc_Us, m, scheme=sch_U, t=t, vector=True)
            gradTf = fvsc.grad(T, bc_Ts, m, scheme=sch_T, t=t)
            if deform:
                # per-axis dilation x_i = s_i(t)*xi_i: the logical-grid
                # derivatives take 1/s_i metric factors
                s_old = [motion_value(v, T) for v in self.mesh_scale(t)]
                gradUf = tuple(torch.stack([gradUf[a][i] / s_old[i]
                                            for i in range(nd)])
                               for a in range(nd))
                gradTf = tuple(torch.stack([gradTf[a][i] / s_old[i]
                                            for i in range(nd)])
                               for a in range(nd))
            muf = fvsc.interpolate(mu, bc_zg, m)
            alphaf = fvsc.interpolate(alpha, bc_zg, m)
            rhof = fvsc.interpolate(rho, bc_zg, m)
            Uf = fvsc.interpolate(U, bc_Us, m, t=t, vector=True)
            Tf = fvsc.interpolate(T, bc_Ts, m, t=t)
            BdFrc = thermo.beta * T[None] * gvec
            if omega is not None:
                # the SRF Coriolis force: BdFrc -= 2*Omega x U
                BdFrc = BdFrc - 2.0 * _cross_omega(omega, U, nd)
            BdFrcf = fvsc.interpolate(BdFrc, bc_zg, m, vector=True)
            Hif = tuple(alphaf[a] / rhof[a] for a in range(nd))
            tau_f = self.tau_model.correct(m, p=p, T=T, ref=T, mu=mu,
                                           rho=rho).tau_f

            # updateFluxes.H: (Uf & gradUf)_a[j] = sum_i Uf_i dU_j/dx_i at
            # a-faces, unrolled over the components
            u_dot_gradU = tuple(
                torch.stack([sum(Uf[a][i] * gradUf[a][i, j]
                                 for i in range(nd)) for j in range(nd)],
                            dim=0)
                for a in range(nd))
            area = tuple(m.face_area(a) for a in range(nd))
            phiu = tuple(Uf[a][a] * area[a] for a in range(nd))
            wo = tuple(tau_f[a] * (u_dot_gradU[a] - BdFrcf[a])
                       for a in range(nd))
            phiwo = tuple(wo[a][a] * area[a] for a in range(nd))
            taubyrhof = tuple(tau_f[a] / rhof[a] for a in range(nd))
            # phiu/phiwo are not masked at immersed faces: the mirror fill
            # reproduces the body-fitted wall values there

            # Courant + setDeltaT (general motion chose dt before the
            # motion): on a moving mesh the face velocity relative to the
            # mesh, and with check_mesh_courant the mesh face speed too
            if deform:
                # the physical h_face is h*s: 1/s folds into the velocity;
                # the mesh face speed is u_m = sdot_a*xi_a + um_a
                sv = torch.stack(s_old).reshape((nd,) + (1,) * nd)
                um0 = um.reshape((nd,) + (1,) * nd) if rigid else 0.0
                s_fwd = [motion_value(v, T) for v in self.mesh_scale(t + dt)]
                mesh_co = torch.zeros((), dtype=T.dtype, device=T.device)
                Uf_co = []
                for a in range(nd):
                    sdot_a = (s_fwd[a] - s_old[a]) / dt
                    dil = torch.broadcast_to(sdot_a * xi_f[a],
                                             Uf[a].shape[1:])[None]
                    dil = torch.cat([dil if i == a else torch.zeros_like(dil)
                                     for i in range(nd)], dim=0)
                    Uf_co.append((Uf[a] - um0 - dil) / sv)
                    if check_co:
                        # global reductions under a decomposition
                        h_phys = (spmd.all_min(torch.min(m.h_face(a)))
                                  * s_old[a])
                        um0_a = um[a] if rigid else 0.0
                        mesh_co = torch.maximum(
                            mesh_co,
                            spmd.all_max(torch.max(torch.abs(
                                sdot_a * xi_f[a] + um0_a))) * dt / h_phys)
                co = common.courant_advective(tuple(Uf_co), dt, m)
                if check_co:
                    co = torch.maximum(co, mesh_co)
            elif rigid:
                Uf_rel = tuple(Uf[a] - um.reshape((nd,) + (1,) * nd)
                               for a in range(nd))
                co = common.courant_advective(Uf_rel, dt, m)
                if check_co:
                    co = torch.maximum(co, torch.max(torch.stack([
                        torch.abs(um[a]) * dt
                        / spmd.all_min(torch.min(m.h_face(a)))
                        for a in range(nd)])))
            elif not general:
                co = common.courant_advective(Uf, dt, m)
            if not general:
                dt_new = common.set_delta_t(dt, co, common.tau_f_min(tau_f),
                                            tc)

            # the deforming mesh's metric factors: face areas fA, the
            # moving-volume ddt (V/V')*old/dt, the physical divergence 1/V'
            if deform:
                s_new = [motion_value(v, T)
                         for v in self.mesh_scale(t + dt_new)]
                sp_old, sp_new = s_old[0], s_new[0]
                for b in range(1, nd):
                    sp_old = sp_old * s_old[b]
                    sp_new = sp_new * s_new[b]
                fA = [sp_new / s_new[a] for a in range(nd)]
                vr = sp_old / sp_new
                inv_v = 1.0 / sp_new
                phiu = tuple(phiu[a] * fA[a] for a in range(nd))
                phiwo = tuple(phiwo[a] * fA[a] for a in range(nd))
                gam_p = tuple(taubyrhof[a] / (s_new[a] * s_new[a])
                              for a in range(nd))
            else:
                # general motion's operators already live on the
                # post-motion geometry: only the volume ratio enters
                vr = vol_ratio if general else None
                inv_v = None
                gam_p = taubyrhof

            def scaled(x):
                return x if inv_v is None else x * inv_v

            def ddt_old(x):
                return x / dt_new if vr is None else x * vr / dt_new

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
            rhs_p = scaled(fvsc.div_flux(phiu, m) - fvsc.div_flux(phiwo, m))
            p_new = helmholtz(m, diag_coeff=0.0, gamma_faces=gam_p,
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
            # the masked operator was; on a dilating mesh the flux of
            # sp_new*gam_p over the logical area)
            snp = fvsc.sn_grad(p_new, bc_p, m, t=t)
            if fmasks is not None:
                snp = tuple(snp[a] * fmasks[a] for a in range(nd))
            tb_flux = (tuple(taubyrhof[a] * fA[a] / s_new[a]
                             for a in range(nd)) if deform else taubyrhof)
            phi = tuple(phiu[a] - phiwo[a] - tb_flux[a] * area[a] * snp[a]
                        for a in range(nd))
            if general:
                # fvc::makeRelative(phi, U) with the Thomas-Lombard sweeps
                phi = tuple(phi[a] - mesh_sweep[a] for a in range(nd))
            elif rigid or deform:
                # fvc::makeRelative(phi, U): less the mesh face flux; a
                # dilation's u_m = sdot*xi + um over Thomas-Lombard mixed
                # areas, so that sum_f u_m.A*dt = V' - V per cell exactly
                umv = um if rigid else torch.zeros(nd, dtype=T.dtype,
                                                   device=T.device)
                phim = []
                for a in range(nd):
                    if deform:
                        sdot = (s_new[a] - s_old[a]) / dt_new
                        a_mesh = area[a]
                        for b in range(nd):
                            if b < a:
                                a_mesh = a_mesh * s_new[b]
                            elif b > a:
                                a_mesh = a_mesh * s_old[b]
                        phim.append((sdot * xi_f[a] + umv[a]) * a_mesh)
                    else:
                        phim.append(umv[a] * area[a])
                phi = tuple(phi[a] - phim[a] for a in range(nd))

            # QHDUEqn.H
            gradPf = fvsc.grad(p_new, bc_p, m, scheme=sch_p, t=t)
            if deform:
                gradPf = tuple(torch.stack([gradPf[a][i] / s_new[i]
                                            for i in range(nd)])
                               for a in range(nd))
            Wf = tuple(tau_f[a] * (u_dot_gradU[a] + gradPf[a] / rhof[a]
                                   - BdFrcf[a]) for a in range(nd))
            # phiUf = qgdFlux(phi, U, Uf) - Sf&(Uf*Wf) = phi*Uf - phiu*Wf
            phiUf = tuple(phi[a] * Uf[a] - phiu[a] * Wf[a] for a in range(nd))
            nuf = tuple(muf[a] / rhof[a] for a in range(nd))
            # the explicit transposed stress div(nu_f Sf & interp(T(gradU))):
            # at an a-face (Sf & T(gradU))_j = |Sf| dU_a/dx_j, column a of
            # G[i, j] = dU_j/dx_i
            gradU_cell = fvsc.grad_cell_vector(U, bc_Us, m, t=t)
            if wall is not None:
                # solid cells take the adjacent fluid cell's gradient
                gradU_cell = torch.stack([
                    torch.stack([wall.mirror(gradU_cell[i, j])
                                 for j in range(nd)]) for i in range(nd)])
            gradU_f = fvsc.interpolate(
                gradU_cell.reshape((nd * nd,) + tuple(m.shape)), bc_zg, m)
            transp_flux = tuple(
                nuf[a] * area[a]
                * gradU_f[a].reshape((nd, nd) + m.face_shape(a))[:, a]
                for a in range(nd))
            nuf_lap = nuf
            grad_p_cell = fvsc.grad_cell(p_new, bc_p, m, t=t)
            if deform:
                # flux component j carries d/dx_j: 1/s_j; A_phys = A*fA
                transp_flux = tuple(
                    torch.stack([transp_flux[a][i] * (fA[a] / s_new[i])
                                 for i in range(nd)]) for a in range(nd))
                nuf_lap = tuple(nuf[a] / (s_new[a] * s_new[a])
                                for a in range(nd))
                grad_p_cell = torch.stack([grad_p_cell[i] / s_new[i]
                                           for i in range(nd)])
            rhs_U = (ddt_old(U)
                     - scaled(fvsc.div_flux(phiUf, m))
                     + scaled(fvsc.div_flux(transp_flux, m))
                     - grad_p_cell / rho[None]
                     + BdFrc)
            if m.axisymmetric:
                # the cylindrical vector laplacian's hoop term -u_r/r^2 of
                # (lap U)_r (the r-weighted metrics give the rest)
                r_c = m.cell_coords(1)
                rhs_U = torch.stack([
                    rhs_U[0], rhs_U[1] + -(mu / rho) * U[1] / (r_c * r_c)])
            if self.implicit_diffusion:
                U_new = helmholtz(m, diag_coeff=1.0 / dt_new,
                                  gamma_faces=nuf_lap, rhs=rhs_U, x0=U,
                                  bcs=bc_Us, t=t, vector=True,
                                  solid_wall_dirichlet=True)
            else:
                # explicit diffusion on immersed walls: the mirror-filled U
                # already holds the no-slip ghost
                U_new = dt_new * (rhs_U + fvsc.laplacian_explicit(
                    nuf_lap, U, bc_Us, m, t=t, vector=True))

            phiTf = tuple(phi[a] * Tf[a] for a in range(nd))
            Hif_m = (tuple(Hif[a] * fmasks[a] for a in range(nd))
                     if fmasks is not None else Hif)
            if mules_T:
                # MULESTEqn.H: bounded explicit advection between the
                # global bounds, then the diffusion correction
                T_adv, _ = mules.explicit_solve(
                    T, phi, phiTf, dt_new, m, spmd.all_max(torch.max(T)),
                    spmd.all_min(torch.min(T)), n_iter=self.mules_n_iter)
                if self.implicit_diffusion:
                    T_new = helmholtz(m, diag_coeff=1.0 / dt_new,
                                      gamma_faces=Hif, rhs=T_adv / dt_new,
                                      x0=T_adv, bcs=bc_Ts, t=t)
                else:
                    T_new = T_adv + dt_new * fvsc.laplacian_explicit(
                        Hif_m, T_adv, bc_Ts, m, t=t)
            else:
                # QHDTEqn.H
                phiTauTReg = tuple(
                    tau_f[a] * phiu[a] * torch.sum(Uf[a] * gradTf[a], dim=0)
                    for a in range(nd))
                rhs_T = (ddt_old(T) - scaled(fvsc.div_flux(phiTf, m))
                         + scaled(fvsc.div_flux(phiTauTReg, m)))
                if self.implicit_diffusion:
                    Hif_lap = (tuple(Hif[a] / (s_new[a] * s_new[a])
                                     for a in range(nd)) if deform else Hif)
                    T_new = helmholtz(m, diag_coeff=1.0 / dt_new,
                                      gamma_faces=Hif_lap, rhs=rhs_T, x0=T,
                                      bcs=bc_Ts, t=t)
                else:
                    Hif_lap = (tuple(Hif_m[a] / (s_new[a] * s_new[a])
                                     for a in range(nd)) if deform else Hif_m)
                    T_new = dt_new * (rhs_T + fvsc.laplacian_explicit(
                        Hif_lap, T, bc_Ts, m, t=t))

            if wall is not None:
                # solid cells are not prognostic: they keep their carried
                # values (the mirror fill makes the wall ghosts next step)
                U_new = torch.where(wall.solid[None], s.U, U_new)
                T_new = torch.where(wall.solid, s.T, T_new)
                p_new = torch.where(wall.solid, s.p, p_new)
            return State(U=U_new, T=T_new, p=p_new, t=t + dt_new, dt=dt_new)

        return step
