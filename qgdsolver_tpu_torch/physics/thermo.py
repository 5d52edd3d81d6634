"""Thermophysical models (PyTorch port of `qgdsolver_tpu.physics.thermo`):
the calorically perfect psi-gas, the incompressible rhoConst liquid of the
QHD family, the rho-based thermo with a pluggable equation of state
(perfect or stiffened gas) of rhoQGDFoam, and the JANAF caloric closure,
each with constant, Sutherland or power-law transport.

A thermo model is a frozen dataclass of scalars with elementwise methods on
tensors.  Only `PerfectGasThermo` has the constant `gamma` the fused
kernels take: their gates test `isinstance(th, PerfectGasThermo)`, so no
other thermo here subclasses it.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ..core.registry import register


class Transport:
    """Base marker for dynamic-viscosity models mu(p, T)."""


@register("transport", "const")
@dataclasses.dataclass(frozen=True)
class ConstTransport(Transport):
    """constTransport: mu = const."""

    mu0: float

    def mu(self, p, T):
        return torch.full_like(T, self.mu0)


@register("transport", "sutherland")
@dataclasses.dataclass(frozen=True)
class SutherlandTransport(Transport):
    """sutherlandTransport: mu = As*sqrt(T)/(1 + Ts/T)."""

    As: float
    Ts: float

    def mu(self, p, T):
        return self.As * torch.sqrt(T) / (1.0 + self.Ts / T)


@register("transport", "powerLaw")
@dataclasses.dataclass(frozen=True)
class PowerLawTransport(Transport):
    """powerLawTransport: mu = mu0*(T/T0)^k."""

    mu0: float
    T0: float
    k: float

    def mu(self, p, T):
        return self.mu0 * (T / self.T0) ** self.k


@register("thermo", "psiPerfectGas")
@dataclasses.dataclass(frozen=True)
class PerfectGasThermo:
    """Calorically perfect gas, psi-based: e = Cv*T, psi = 1/(R*T),
    p = rho*R*T, gamma = Cp/Cv, c = sqrt(gamma R T).  R is the specific gas
    constant [J/(kg K)]."""

    R: float
    Cp: float
    transport: Transport = ConstTransport(0.0)
    Pr: float = 1.0

    @property
    def Cv(self) -> float:
        return self.Cp - self.R

    @property
    def gamma(self) -> float:
        return self.Cp / self.Cv

    def gamma_of(self, T):
        """The interface of the variable-cp thermos: a constant here."""
        return self.gamma

    def T_from_e(self, e):
        return e / self.Cv

    def e_from_T(self, T):
        return self.Cv * T

    def psi(self, T):
        return 1.0 / (self.R * T)

    def p_from_rho_T(self, rho, T):
        return rho * self.R * T

    def rho_from_p_T(self, p, T):
        return p * self.psi(T)

    def c(self, T):
        """Speed of sound sqrt(gamma/psi) = sqrt(gamma R T)."""
        return torch.sqrt(self.gamma * self.R * T)

    def c_from_pT(self, p, T):
        return self.c(T)

    def mu(self, p, T):
        return self.transport.mu(p, T)

    def alphah(self, p, T):
        """Thermal diffusivity alpha = kappa/Cp = mu/Pr [kg/(m s)]."""
        return self.transport.mu(p, T) / self.Pr


@register("thermo", "rhoConst")
@dataclasses.dataclass(frozen=True)
class RhoConstThermo:
    """Incompressible liquid of the QHD family (heRhoQGDThermo with
    rhoConst): rho = rho0, mu = mu0, alpha = mu0/Pr, and the Boussinesq
    expansion coefficient beta [1/K]."""

    rho0: float
    Cp: float
    mu0: float
    Pr: float = 1.0
    beta: float = 0.0

    def rho(self, p, T):
        return torch.full_like(T, self.rho0)

    def mu(self, p, T):
        return torch.full_like(T, self.mu0)

    def alphah(self, p, T):
        """alpha = kappa/Cp = mu/Pr [kg/(m s)]."""
        return torch.full_like(T, self.mu0 / self.Pr)

    def nu(self):
        return self.mu0 / self.rho0


class EquationOfState:
    """rho(p, T) closures of the rho-based thermo."""


@register("eos", "perfectGas")
@dataclasses.dataclass(frozen=True)
class PerfectGasEoS(EquationOfState):
    R: float

    def rho(self, p, T):
        return p / (self.R * T)

    def psi(self, p, T):
        return 1.0 / (self.R * T)

    def dpdrho_T(self, p, T):
        return self.R * T


@register("eos", "stiffenedGas")
@dataclasses.dataclass(frozen=True)
class StiffenedGasEoS(EquationOfState):
    """Stiffened gas: p = rho*R*T - p_inf."""

    R: float
    p_inf: float

    def rho(self, p, T):
        return (p + self.p_inf) / (self.R * T)

    def psi(self, p, T):
        return 1.0 / (self.R * T)

    def dpdrho_T(self, p, T):
        return self.R * T


@register("thermo", "rhoThermo")
@dataclasses.dataclass(frozen=True)
class RhoThermo:
    """Density-based thermo with a pluggable equation of state (rhoQGDFoam's
    heRhoQGDThermo): e = Cv*T, c = sqrt(gamma/psi)."""

    eos: EquationOfState
    Cp: float
    R: float
    transport: Transport = ConstTransport(0.0)
    Pr: float = 1.0

    @property
    def Cv(self) -> float:
        return self.Cp - self.R

    @property
    def gamma(self) -> float:
        return self.Cp / self.Cv

    def gamma_of(self, T):
        return self.gamma

    def T_from_e(self, e):
        return e / self.Cv

    def e_from_T(self, T):
        return self.Cv * T

    def rho(self, p, T):
        return self.eos.rho(p, T)

    def psi(self, p, T):
        return self.eos.psi(p, T)

    def p_from_rho_T(self, rho, T):
        """The EoS inverted for p; both equations of state are affine in
        p."""
        p0 = torch.zeros_like(T)
        return (rho - self.eos.rho(p0, T)) / self.eos.psi(p0, T)

    def rho_from_p_T(self, p, T):
        return self.eos.rho(p, T)

    def c(self, p, T):
        return torch.sqrt(self.gamma / self.eos.psi(p, T))

    def c_from_pT(self, p, T):
        return self.c(p, T)

    def mu(self, p, T):
        return self.transport.mu(p, T)

    def alphah(self, p, T):
        return self.transport.mu(p, T) / self.Pr


@dataclasses.dataclass(frozen=True)
class JanafThermo:
    """7-coefficient NASA/JANAF polynomials of one specie:
    cp/R = a0 + a1 T + a2 T^2 + a3 T^3 + a4 T^4,
    h/(R T) = a0 + a1/2 T + ... + a4/5 T^4 + a5/T.  T from e by a Newton
    solve with a fixed iteration count."""

    R: float  # specific gas constant of the specie
    low: tp.Tuple[float, ...]  # 7 coefficients, T < Tcommon
    high: tp.Tuple[float, ...]  # 7 coefficients, T >= Tcommon
    Tcommon: float = 1000.0

    def _coeffs(self, T):
        lo = torch.as_tensor(self.low, dtype=T.dtype, device=T.device)
        hi = torch.as_tensor(self.high, dtype=T.dtype, device=T.device)
        return torch.where(T[..., None] < self.Tcommon, lo, hi)

    def cp(self, T):
        a = self._coeffs(T)
        poly = a[..., 0] + T * (a[..., 1] + T * (a[..., 2] + T * (
            a[..., 3] + T * a[..., 4])))
        return self.R * poly

    def h_abs(self, T):
        a = self._coeffs(T)
        poly = a[..., 0] + T * (a[..., 1] / 2 + T * (a[..., 2] / 3 + T * (
            a[..., 3] / 4 + T * a[..., 4] / 5)))
        return self.R * (T * poly + a[..., 5])

    def e_abs(self, T):
        return self.h_abs(T) - self.R * T

    def s_abs(self, T):
        """Standard-state entropy s0(T): s/R = a0 ln T + a1 T + a2 T^2/2
        + a3 T^3/3 + a4 T^4/4 + a6 (the equilibrium constants of reversible
        reactions take it)."""
        a = self._coeffs(T)
        poly = (a[..., 0] * torch.log(T)
                + T * (a[..., 1] + T * (a[..., 2] / 2
                                        + T * (a[..., 3] / 3
                                               + T * a[..., 4] / 4)))
                + a[..., 6])
        return self.R * poly

    def cv(self, T):
        return self.cp(T) - self.R

    def T_from_e(self, e, T0, iters: int = 8):
        """Newton solve of e_abs(T) = e from T0, `iters` iterations, T
        clamped to [10, 20000] after each."""
        T = T0
        for _ in range(iters):
            T = T - (self.e_abs(T) - e) / torch.clamp(self.cv(T), min=1e-30)
            T = torch.clamp(T, 10.0, 20000.0)
        return T


@register("thermo", "janafPerfectGas")
@dataclasses.dataclass(frozen=True)
class JanafPerfectGasThermo:
    """Single-gas psi-thermo with a JANAF caloric closure (sensible
    internal energy): e_s(T) = h_a(T) - h_a(Tstd) - R*T, cv = cp - R,
    gamma(T) = cp/cv, psi = 1/(R*T), c = sqrt(gamma R T).  It has no
    constant gamma or Cv: the QGD step interpolates gamma(T) to the
    faces."""

    janaf: JanafThermo
    transport: Transport = ConstTransport(0.0)
    Pr: float = 1.0
    Tstd: float = 298.15

    @property
    def R(self) -> float:
        return self.janaf.R

    def _h_std(self, like):
        return self.janaf.h_abs(torch.full((), self.Tstd, dtype=like.dtype,
                                           device=like.device))

    def e_from_T(self, T):
        if not torch.is_tensor(T):
            T = torch.as_tensor(T, dtype=torch.float64)
        return self.janaf.e_abs(T) - self._h_std(T)

    def T_from_e(self, e, iters: int = 12):
        e_abs = e + self._h_std(e)
        return self.janaf.T_from_e(e_abs, torch.full_like(e, 1000.0),
                                   iters=iters)

    def gamma_of(self, T):
        return self.janaf.cp(T) / self.janaf.cv(T)

    def psi(self, T):
        return 1.0 / (self.R * T)

    def p_from_rho_T(self, rho, T):
        return rho * self.R * T

    def rho_from_p_T(self, p, T):
        return p * self.psi(T)

    def c_from_pT(self, p, T):
        return torch.sqrt(self.gamma_of(T) * self.R * T)

    def mu(self, p, T):
        return self.transport.mu(p, T)

    def alphah(self, p, T):
        """alpha = kappa/cp: Sutherland transport takes the modified Eucken
        kappa = mu*cv*(1.32 + 1.77*R/cv); const and power law mu/Pr."""
        mu = self.transport.mu(p, T)
        if isinstance(self.transport, SutherlandTransport):
            cv = self.janaf.cv(T)
            return mu * cv * (1.32 + 1.77 * self.R / cv) / self.janaf.cp(T)
        return mu / self.Pr
