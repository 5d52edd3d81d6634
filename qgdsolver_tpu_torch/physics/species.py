"""Multicomponent mixture thermodynamics (PyTorch port of
`qgdsolver_tpu.physics.species`, the psiQGDReactionThermo equivalent).

A `Specie` couples a gas constant with a constant-cp or a JANAF caloric
polynomial; `MixtureThermo` weights them by mass fraction and inverts
e(T, Y) with a fixed-iteration Newton (the THE equivalent).  Every method is
elementwise torch; the species axis is the leading axis of Y.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch

from .thermo import ConstTransport, JanafThermo, Transport

R_UNIVERSAL = 8314.46261815324  # J/(kmol K)


@dataclasses.dataclass(frozen=True)
class Specie:
    """One chemical specie: molar mass W [kg/kmol] and a caloric model.

    Constant-cp mode: Cp and hf (formation enthalpy, J/kg).  JANAF mode:
    `janaf` (Cp and hf unused).  Sc is the specie's Schmidt number."""

    name: str
    W: float
    Cp: float = 1000.0
    hf: float = 0.0
    janaf: tp.Optional[JanafThermo] = None
    Sc: float = 1.0

    @property
    def R(self) -> float:
        return R_UNIVERSAL / self.W

    def cp(self, T):
        if self.janaf is not None:
            return self.janaf.cp(T)
        return torch.full_like(T, self.Cp)

    def cv(self, T):
        return self.cp(T) - self.R

    def hs(self, T, Tref=298.15):
        """Sensible enthalpy."""
        if self.janaf is not None:
            return self.janaf.h_abs(T) - self.janaf.h_abs(
                torch.full_like(T, Tref))
        return self.Cp * (T - Tref)

    def es(self, T, Tref=298.15):
        """Sensible internal energy Hs - R(T - Tref)."""
        return self.hs(T, Tref) - self.R * (T - Tref)


@dataclasses.dataclass(frozen=True)
class MixtureThermo:
    """Mass-fraction-weighted mixture with the sensible internal energy as
    its caloric variable: e_s = sum_i Y_i Es_i(T)."""

    species: tp.Tuple[Specie, ...]
    inert_index: int = -1  # the last specie by default
    transport: Transport = ConstTransport(1.8e-5)
    Pr: float = 0.7
    Tref: float = 298.15

    @property
    def n_species(self) -> int:
        return len(self.species)

    @property
    def inert(self) -> int:
        return self.inert_index % len(self.species)

    def R(self, Y):
        return sum(Y[i] * sp.R for i, sp in enumerate(self.species))

    def cp(self, Y, T):
        return sum(Y[i] * sp.cp(T) for i, sp in enumerate(self.species))

    def cv(self, Y, T):
        return self.cp(Y, T) - self.R(Y)

    def e_from_T(self, Y, T):
        return sum(Y[i] * sp.es(T, self.Tref)
                   for i, sp in enumerate(self.species))

    def T_from_e(self, Y, e, T0, iters: int = 8):
        """Newton inversion of e(T) from T0, `iters` iterations, T clamped
        to [10, 20000] after each."""
        T = T0
        for _ in range(iters):
            T = T - (self.e_from_T(Y, T) - e) / torch.clamp(self.cv(Y, T),
                                                             min=1e-3)
            T = torch.clamp(T, 10.0, 20000.0)
        return T

    def psi(self, Y, T):
        return 1.0 / (self.R(Y) * T)

    def rho_from_p_T(self, Y, p, T):
        return p * self.psi(Y, T)

    def p_from_rho_T(self, Y, rho, T):
        return rho * self.R(Y) * T

    def gamma(self, Y, T):
        cp = self.cp(Y, T)
        return cp / (cp - self.R(Y))

    def c_from_pT(self, Y, p, T):
        """c = sqrt(gamma/psi)."""
        return torch.sqrt(self.gamma(Y, T) / self.psi(Y, T))

    def mu(self, p, T):
        return self.transport.mu(p, T)

    def alphah(self, p, T):
        return self.transport.mu(p, T) / self.Pr

    def hs_i(self, i, T):
        return self.species[i].hs(T, self.Tref)

    def es_i(self, i, T):
        return self.species[i].es(T, self.Tref)

    def sc_numbers(self):
        return tuple(sp.Sc for sp in self.species)
