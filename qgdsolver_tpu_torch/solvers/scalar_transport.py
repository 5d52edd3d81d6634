"""scalarTransportQHDFoam — passive-scalar QHD advection-diffusion (PyTorch
port of `qgdsolver_tpu.solvers.scalar_transport`).

A frozen velocity U carries T with the QGD regularizing flux (reference
scalarTransportQHDFoam.C):
  phiTf      = phiu * T_f
  phiTauTReg = tau_f * phiu * (U_f . grad_f T)
  solve  ddt(T) + div(phiTf) - Sp(div(phiu), T)
         - laplacian(Hi_f, T) - div(phiTauTReg) = 0
with Hi_f = alpha_f/rho_f, dt from the |Uf| Courant number, and the
diffusion implicit through `linsolve.solve_helmholtz` (or explicit).
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ..core import bc as bcm
from ..core.mesh import Mesh
from ..ops import fvsc, linsolve
from ..physics.qgdcoeffs import HbyUQHD, TauModel
from ..physics.thermo import RhoConstThermo
from . import common
from .common import TimeControls


class State(tp.NamedTuple):
    T: torch.Tensor
    U: torch.Tensor  # the frozen velocity (d, *cells)
    t: torch.Tensor
    dt: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ScalarTransportQHD:
    mesh: Mesh
    thermo: RhoConstThermo
    tau_model: TauModel = HbyUQHD()
    bc_T: tp.Optional[bcm.FieldBCs] = None
    bc_U: tp.Optional[bcm.FieldBCs] = None
    time: TimeControls = TimeControls()
    implicit_diffusion: bool = True
    cg_tol: float = 1e-8
    cg_maxiter: int = 500

    def _bcs(self):
        zg = bcm.FieldBCs.uniform(bcm.ZeroGradient(), self.mesh.ndim)
        return self.bc_T or zg, self.bc_U or zg

    def init(self, T0, U0, t0=0.0) -> State:
        mesh = self.mesh
        T0, U0 = (x if torch.is_tensor(x) else mesh.tensor(x)
                  for x in (T0, U0))
        return State(T=T0, U=U0, t=bcm.as_value(t0, T0),
                     dt=bcm.as_value(self.time.dt0, T0))

    def make_step(self):
        mesh = self.mesh
        nd = mesh.ndim
        bc_T, bc_U = self._bcs()
        thermo = self.thermo
        tc = self.time
        # coefficient fields interpolate with zero-gradient (`calculated`)
        # ghosts: the T BCs' ghosts would zero a fixed-T wall's diffusivity
        bc_zg = bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        area = tuple(mesh.face_area(a) for a in range(nd))

        def step(s: State) -> State:
            T, U, t, dt = s
            rho = thermo.rho(None, T)
            alpha = thermo.alphah(None, T)

            # updateFields.H
            gradTf = fvsc.grad(T, bc_T, mesh, t=t)
            alphaf = fvsc.interpolate(alpha, bc_zg, mesh)
            rhof = fvsc.interpolate(rho, bc_zg, mesh)
            Tf = fvsc.interpolate(T, bc_T, mesh, t=t)
            Uf = fvsc.interpolate(U, bc_U, mesh, t=t, vector=True)
            Hif = tuple(alphaf[a] / rhof[a] for a in range(nd))
            tau_f = self.tau_model.correct(
                mesh, p=T, T=T, ref=T, mu=thermo.mu(None, T), rho=rho,
                c=None).tau_f

            # updateFluxes.H: phiu = Sf & Uf
            phiu = tuple(Uf[a][a] * area[a] for a in range(nd))
            co = common.courant_mag(Uf, dt, mesh)
            dt_new = common.set_delta_t(dt, co, common.tau_f_min(tau_f), tc)

            phiTf = tuple(phiu[a] * Tf[a] for a in range(nd))
            phiTauTReg = tuple(
                tau_f[a] * phiu[a] * torch.sum(Uf[a] * gradTf[a], dim=0)
                for a in range(nd))
            # ddt(T) + div(phiTf) - Sp(div(phiu), T) - lap(Hif, T)
            # - div(reg) = 0
            rhs = (T / dt_new - fvsc.div_flux(phiTf, mesh)
                   + fvsc.div_flux(phiu, mesh) * T
                   + fvsc.div_flux(phiTauTReg, mesh))
            if self.implicit_diffusion:
                T_new = linsolve.solve_helmholtz(
                    diag_coeff=1.0 / dt_new, gamma_faces=Hif, rhs=rhs, x0=T,
                    bcs=bc_T, mesh=mesh, t=t + dt_new, tol=self.cg_tol,
                    maxiter=self.cg_maxiter).x
            else:
                T_new = dt_new * (rhs + fvsc.laplacian_explicit(
                    Hif, T, bc_T, mesh, t=t))
            return State(T=T_new, U=U, t=t + dt_new, dt=dt_new)

        return step
