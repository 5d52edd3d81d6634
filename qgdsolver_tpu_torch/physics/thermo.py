"""Thermophysical models (PyTorch port of `qgdsolver_tpu.physics.thermo`:
the calorically perfect psi-gas with constant, Sutherland or power-law
transport).

A thermo model is a frozen dataclass of scalars with elementwise methods on
tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.registry import register, register_missing


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


register_missing("thermo", "ROADMAP queue 1, item 7 (JANAF thermo; RhoThermo "
                 "and rhoConst with rhoQGDFoam and zQGDFoam)",
                 "rhoConst", "rhoThermo", "janafPerfectGas")
