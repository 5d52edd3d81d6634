"""Chemistry and combustion models (PyTorch port of
`qgdsolver_tpu.physics.chemistry`, the ChemistryQGD/CombustionQGD
equivalents).

Given (Y, rho, T, p) a combustion model produces per-specie reaction sources
R(Yi) [kg/m^3/s] and a heat release Qdot [W/m^3] (QGDYEqn.H).  The words of
the reference's selection tables are registered under the kinds
`combustion`, `chemistrySolver`, `chemistryReduction` and
`chemistryTabulation`:

* combustion: `Laminar` finite-rate Arrhenius kinetics (reversible through
  Kc, third bodies with efficiencies), the mixing-limited families,
  PaSR/EDC scalings of Laminar, FSD, the diffusion flame sheets and zones;
* chemistry solvers: instantaneous rates, sub-cycled explicit Euler
  (EulerImplicit) and RK4 (ode) at frozen (rho, T, p), returning the mean
  rate over dt, and TDAC around one of them;
* reduction: DRG, run once on the host against a reference state;
* tabulation: the host `ISAT` (a dict keyed on the host, eager only) and
  `DeviceISAT`, a fixed-capacity open-addressed table kept as explicit
  state on the device.
"""
from __future__ import annotations

import dataclasses
import inspect
import typing as tp

import numpy as np
import torch

from ..core.registry import register
from .species import MixtureThermo, R_UNIVERSAL

P_STD = 101325.0  # standard-state pressure for Kp [Pa]


def _clamp0(x):
    return torch.clamp(x, min=0.0)


@dataclasses.dataclass(frozen=True)
class Reaction:
    """Arrhenius reaction kf = A T^beta exp(-Ta/T); lhs/rhs are
    ((specie index, stoichiometric coefficient), ...).

    reversible: kr = kf/Kc, Kc from the species' JANAF Gibbs energies.
    third_body: the rate is multiplied by [M] = sum_i eff_i*conc_i, the
    efficiencies 1.0 unless listed."""

    lhs: tp.Tuple[tp.Tuple[int, float], ...]
    rhs: tp.Tuple[tp.Tuple[int, float], ...]
    A: float
    beta: float = 0.0
    Ta: float = 0.0  # activation temperature Ea/Ru
    reversible: bool = False
    third_body: bool = False
    efficiencies: tp.Tuple[tp.Tuple[int, float], ...] = ()

    def kf(self, T):
        return self.A * torch.pow(T, self.beta) * torch.exp(
            -self.Ta / torch.clamp(T, min=1.0))

    def equilibrium_kc(self, mix, T):
        """Kc(T) = Kp*(p0/(Ru T))^dnu, Kp = exp(-dG0/(Ru T)), the molar
        Gibbs energies from the JANAF polynomials."""
        dg = 0.0
        dnu = 0.0
        for sgn, side in ((-1.0, self.lhs), (1.0, self.rhs)):
            for i, nu in side:
                sp = mix.species[i]
                if sp.janaf is None:
                    raise NotImplementedError(
                        f"reversible reaction requires JANAF data for "
                        f"{sp.name} (no entropy in const-cp species)")
                g_over_rut = (sp.janaf.h_abs(T) / (sp.janaf.R * T)
                              - sp.janaf.s_abs(T) / sp.janaf.R)
                dg = dg + sgn * nu * g_over_rut
                dnu = dnu + sgn * nu
        return torch.exp(-dg) * torch.pow(P_STD / (R_UNIVERSAL * T), dnu)

    def net_rate(self, conc, T, mix=None):
        """Net omega, the reverse rate and third-body factor included."""
        k = self.kf(T)
        w = k
        for i, nu in self.lhs:
            w = w * torch.pow(_clamp0(conc[i]), nu)
        if self.reversible:
            wr = k / torch.clamp(self.equilibrium_kc(mix, T), min=1e-300)
            for i, nu in self.rhs:
                wr = wr * torch.pow(_clamp0(conc[i]), nu)
            w = w - wr
        if self.third_body:
            eff = dict(self.efficiencies)
            w = w * sum(eff.get(i, 1.0) * _clamp0(conc[i])
                        for i in range(len(conc)))
        return w


def _single_step(mix, T, fuel, oxidizer, products, s, rate):
    """Per-specie sources of one fuel + s oxidizer -> products step."""
    rr = [torch.zeros_like(T) for _ in range(mix.n_species)]
    rr[fuel] = -rate
    rr[oxidizer] = -s * rate
    for i, yield_i in products:
        rr[i] = rr[i] + yield_i * rate
    return rr


class CombustionModel:
    """Base: correct(mix, Y, rho, T, p) -> (RR[i] tuple, Qdot)."""


@register("combustion", "none")
@register("combustion", "noCombustion")
@dataclasses.dataclass(frozen=True)
class NoCombustion(CombustionModel):
    def correct(self, mix: MixtureThermo, Y, rho, T, p):
        zero = torch.zeros_like(T)
        return tuple(zero for _ in mix.species), zero


@register("combustion", "laminar")
@dataclasses.dataclass(frozen=True)
class Laminar(CombustionModel):
    """Finite-rate Arrhenius kinetics."""

    reactions: tp.Tuple[Reaction, ...]

    def correct(self, mix: MixtureThermo, Y, rho, T, p):
        ns = mix.n_species
        conc = [rho * Y[i] / mix.species[i].W for i in range(ns)]
        rr = [torch.zeros_like(T) for _ in range(ns)]
        for rxn in self.reactions:
            w = rxn.net_rate(conc, T, mix)
            for i, nu in rxn.lhs:
                rr[i] = rr[i] - nu * w * mix.species[i].W
            for i, nu in rxn.rhs:
                rr[i] = rr[i] + nu * w * mix.species[i].W
        # heat release from the formation enthalpies
        qdot = -sum(mix.species[i].hf * rr[i] for i in range(ns))
        return tuple(rr), qdot


@register("combustion", "eddyDissipation")
@dataclasses.dataclass(frozen=True)
class EddyDissipation(CombustionModel):
    """Mixing-limited single step: C/t_mix*rho*min(Y_F, Y_O/s)."""

    fuel: int
    oxidizer: int
    products: tp.Tuple[tp.Tuple[int, float], ...]  # (index, mass yield)
    s: float  # stoichiometric oxidizer/fuel mass ratio
    C: float = 4.0
    t_mix: float = 1e-3
    q_fuel: float = 0.0  # heat release per kg fuel

    def correct(self, mix: MixtureThermo, Y, rho, T, p):
        rate = self.C / self.t_mix * rho * torch.minimum(
            _clamp0(Y[self.fuel]), _clamp0(Y[self.oxidizer]) / self.s)
        rr = _single_step(mix, T, self.fuel, self.oxidizer, self.products,
                          self.s, rate)
        return tuple(rr), self.q_fuel * rate


@register("combustion", "infinitelyFastChemistry")
@dataclasses.dataclass(frozen=True)
class InfinitelyFastChemistry(CombustionModel):
    """Mixed-is-burnt: the deficient reactant consumed within C steps,
    rho*min(Y_F, Y_O/s)/(C*dt)."""

    fuel: int
    oxidizer: int
    products: tp.Tuple[tp.Tuple[int, float], ...]
    s: float
    C: float = 5.0
    q_fuel: float = 0.0

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None):
        dt = 1e-6 if dt is None else dt
        rate = rho * torch.minimum(
            _clamp0(Y[self.fuel]),
            _clamp0(Y[self.oxidizer]) / self.s) / (self.C * dt)
        rr = _single_step(mix, T, self.fuel, self.oxidizer, self.products,
                          self.s, rate)
        return tuple(rr), self.q_fuel * rate


@register("combustion", "PaSR")
@dataclasses.dataclass(frozen=True)
class PaSR(CombustionModel):
    """Partially-stirred reactor: Laminar's rates scaled by
    kappa = tau_c/(tau_c + t_mix), tau_c from the consumption rates."""

    base: "Laminar"
    t_mix: float = 1e-4

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None):
        rr, qdot = self.base.correct(mix, Y, rho, T, p)
        denom = sum(torch.abs(r) for r in rr) + 1e-30
        tau_c = rho * sum(_clamp0(Y[i])
                          for i in range(mix.n_species)) / denom
        kappa = tau_c / (tau_c + self.t_mix)
        return tuple(kappa * r for r in rr), kappa * qdot


@register("combustion", "eddyDissipationDiffusion")
@dataclasses.dataclass(frozen=True)
class EddyDissipationDiffusion(CombustionModel):
    """Mixing-limited rate bounded by the products too:
    rate ~ min(Y_F, Y_O/s, C_d*Y_P/(1+s))."""

    fuel: int
    oxidizer: int
    products: tp.Tuple[tp.Tuple[int, float], ...]
    s: float
    C: float = 4.0
    Cd: float = 0.5
    t_mix: float = 1e-3
    q_fuel: float = 0.0

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None):
        yp = sum(_clamp0(Y[i]) for i, _ in self.products)
        lim = torch.minimum(
            torch.minimum(_clamp0(Y[self.fuel]),
                          _clamp0(Y[self.oxidizer]) / self.s),
            self.Cd * yp / (1.0 + self.s))
        rate = self.C / self.t_mix * rho * lim
        rr = _single_step(mix, T, self.fuel, self.oxidizer, self.products,
                          self.s, rate)
        return tuple(rr), self.q_fuel * rate


@register("combustion", "zoneCombustion")
@dataclasses.dataclass(frozen=True)
class ZoneCombustion(CombustionModel):
    """A base model's sources zeroed outside a static cell mask."""

    base: CombustionModel
    mask: tp.Any  # (cells) 0/1 array

    needs_aux: bool = dataclasses.field(default=True, init=False)

    @property
    def needs_grad(self):
        return getattr(self.base, "needs_grad", False)

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None, aux=None):
        rr, qdot = _call(self.base, mix, Y, rho, T, p, dt, aux=aux)
        m = torch.as_tensor(np.asarray(self.mask) if not torch.is_tensor(
            self.mask) else self.mask, dtype=qdot.dtype, device=qdot.device)
        return tuple(m * r for r in rr), m * qdot


def _takes(fn, name: str) -> bool:
    return name in inspect.signature(fn).parameters


def _call(model, mix, Y, rho, T, p, dt, aux=None):
    """model.correct, passed dt and aux where its signature takes them.

    `aux` holds a step's auxiliary fields: the gradient-limited families
    read aux['gradY'] (a tuple of (ndim, cells) tensors) and aux['mu_eff'];
    EDC reads aux['k'], aux['eps'], aux['nu'].  Models that need it set
    `needs_aux` (and `needs_grad` for the gradients), so the solver
    computes them only then."""
    kw = {}
    if _takes(model.correct, "dt"):
        kw["dt"] = dt
    if aux is not None and getattr(model, "needs_aux", False) \
            and _takes(model.correct, "aux"):
        kw["aux"] = aux
    return model.correct(mix, Y, rho, T, p, **kw)


@register("combustion", "EDC")
@dataclasses.dataclass(frozen=True)
class EDC(CombustionModel):
    """Eddy Dissipation Concept: Laminar's rates scaled by
    kappa = gamma_L^expo/(1 - gamma_L^3), gamma_L = Cgamma*(nu eps/k^2)^(1/4),
    k, eps and nu from aux or the model's constants."""

    base: "Laminar"
    Cgamma: float = 2.1377
    Ctau: float = 0.4083
    expo: int = 2
    k: float = 1.0
    eps: float = 1e3
    nu: float = 1.5e-5
    needs_aux: bool = dataclasses.field(default=True, init=False)

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None, aux=None):
        aux = aux or {}

        def val(name):
            return torch.as_tensor(aux.get(name, getattr(self, name)),
                                   dtype=T.dtype, device=T.device)

        k, eps, nu = val("k"), val("eps"), val("nu")
        gammaL = torch.clamp(
            self.Cgamma * torch.pow(nu * eps / torch.clamp(k * k, min=1e-30),
                                    0.25), 0.0, 0.999)
        kappa = torch.pow(gammaL, self.expo) / (1.0 - gammaL ** 3)
        rr, qdot = self.base.correct(mix, Y, rho, T, p)
        return tuple(kappa * r for r in rr), kappa * qdot


@register("combustion", "FSD")
@dataclasses.dataclass(frozen=True)
class FSD(CombustionModel):
    """Flame surface density: rho_u*S_L*Xi*Sigma*Y_F0 with
    Sigma = 4c(1 - c)/delta_L over the progress variable
    c = 1 - Y_F/Y_F0, where both reactants remain."""

    fuel: int
    oxidizer: int
    products: tp.Tuple[tp.Tuple[int, float], ...]
    s: float
    YF0: float
    S_L: float
    delta_L: float
    rho_u: float
    Xi: float = 1.0
    q_fuel: float = 0.0

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None):
        c = torch.clamp(1.0 - _clamp0(Y[self.fuel]) / self.YF0, 0.0, 1.0)
        sigma_fsd = 4.0 * c * (1.0 - c) / self.delta_L
        rate = self.rho_u * self.S_L * self.Xi * sigma_fsd * self.YF0
        rate = rate * (Y[self.fuel] > 0.0) * (Y[self.oxidizer] > 0.0)
        rr = _single_step(mix, T, self.fuel, self.oxidizer, self.products,
                          self.s, rate)
        return tuple(rr), self.q_fuel * rate


@register("combustion", "diffusion")
@dataclasses.dataclass(frozen=True)
class Diffusion(CombustionModel):
    """Diffusion-limited flame sheet: R_F = C*mu_eff*|grad Y_F . grad Y_O|
    where both reactants are present (aux['gradY'], aux['mu_eff'])."""

    fuel: int
    oxidizer: int
    products: tp.Tuple[tp.Tuple[int, float], ...]
    s: float
    C: float = 500.0
    q_fuel: float = 0.0
    needs_grad: bool = dataclasses.field(default=True, init=False)
    needs_aux: bool = dataclasses.field(default=True, init=False)

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None, aux=None):
        aux = aux or {}
        gY = aux.get("gradY")
        if gY is None:
            raise ValueError("diffusion combustion model needs aux['gradY']")
        mu_eff = aux.get("mu_eff", 1e-5)
        dot = torch.sum(gY[self.fuel] * gY[self.oxidizer], dim=0)
        rate = self.C * mu_eff * torch.abs(dot)
        rate = rate * (Y[self.fuel] > 0.0) * (Y[self.oxidizer] > 0.0)
        rr = _single_step(mix, T, self.fuel, self.oxidizer, self.products,
                          self.s, rate)
        return tuple(rr), self.q_fuel * rate


@register("combustion", "diffusionMulticomponent")
@dataclasses.dataclass(frozen=True)
class DiffusionMulticomponent(CombustionModel):
    """One diffusion-limited flame sheet per (fuel, oxidizer) pair, with
    per-pair rate constants Ci and stoichiometry si, summed."""

    pairs: tp.Tuple[tp.Tuple[int, int], ...]
    si: tp.Tuple[float, ...]
    Ci: tp.Tuple[float, ...]
    products: tp.Tuple[tp.Tuple[int, float], ...]
    q_fuel: tp.Tuple[float, ...] = ()
    needs_grad: bool = dataclasses.field(default=True, init=False)
    needs_aux: bool = dataclasses.field(default=True, init=False)

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None, aux=None):
        aux = aux or {}
        gY = aux.get("gradY")
        if gY is None:
            raise ValueError("diffusionMulticomponent needs aux['gradY']")
        mu_eff = aux.get("mu_eff", 1e-5)
        rr = [torch.zeros_like(T) for _ in range(mix.n_species)]
        qdot = torch.zeros_like(T)
        qf = self.q_fuel or (0.0,) * len(self.pairs)
        for (fi, oi), s, C, q in zip(self.pairs, self.si, self.Ci, qf):
            dot = torch.sum(gY[fi] * gY[oi], dim=0)
            rate = C * mu_eff * torch.abs(dot)
            rate = rate * (Y[fi] > 0.0) * (Y[oi] > 0.0)
            rr[fi] = rr[fi] - rate
            rr[oi] = rr[oi] - s * rate
            total = (1.0 + s) * rate
            for i, yield_i in self.products:
                rr[i] = rr[i] + yield_i * total
            qdot = qdot + q * rate
        return tuple(rr), qdot


# ---------------------------------------------------------------------------
# chemistry solvers: integrate the stiff sources over dt by sub-cycling at
# frozen (rho, T, p) and return the mean rates for the split YEqn
# ---------------------------------------------------------------------------


class ChemistrySolver:
    """Base: rates(model, mix, Y, rho, T, p, dt) -> (RR tuple, Qdot)."""


@register("chemistrySolver", "none")
@dataclasses.dataclass(frozen=True)
class DirectRates(ChemistrySolver):
    """Instantaneous rates, no sub-integration."""

    def rates(self, model, mix, Y, rho, T, p, dt, aux=None):
        return _call(model, mix, Y, rho, T, p, dt, aux=aux)


@register("chemistrySolver", "EulerImplicit")
@register("chemistrySolver", "euler")
@dataclasses.dataclass(frozen=True)
class SubcycledEuler(ChemistrySolver):
    """n_sub forward-Euler sub-steps of dY/dt = RR/rho; the mean rate over
    dt advances Y exactly to the sub-integrated endpoint."""

    n_sub: int = 8

    def rates(self, model, mix, Y, rho, T, p, dt, aux=None):
        h = dt / self.n_sub
        Yc = list(Y)
        q_acc = 0.0
        for _ in range(self.n_sub):
            rr, qdot = _call(model, mix, tuple(Yc), rho, T, p, h, aux=aux)
            for i in range(mix.n_species):
                Yc[i] = Yc[i] + h * rr[i] / rho
            q_acc = q_acc + qdot
        rr_eff = tuple((Yc[i] - Y[i]) * rho / dt
                       for i in range(mix.n_species))
        return rr_eff, q_acc / self.n_sub


@register("chemistrySolver", "ode")
@dataclasses.dataclass(frozen=True)
class SubcycledRK4(ChemistrySolver):
    """RK4 sub-steps at frozen (rho, T, p)."""

    n_sub: int = 4

    def rates(self, model, mix, Y, rho, T, p, dt, aux=None):
        ns = mix.n_species
        h = dt / self.n_sub

        def f(Yc):
            rr, qdot = _call(model, mix, tuple(Yc), rho, T, p, h, aux=aux)
            return [r / rho for r in rr], qdot

        Yc = list(Y)
        q_acc = 0.0
        for _ in range(self.n_sub):
            k1, q1 = f(Yc)
            k2, _ = f([Yc[i] + 0.5 * h * k1[i] for i in range(ns)])
            k3, _ = f([Yc[i] + 0.5 * h * k2[i] for i in range(ns)])
            k4, _ = f([Yc[i] + h * k3[i] for i in range(ns)])
            Yc = [Yc[i] + h / 6.0 * (k1[i] + 2 * k2[i] + 2 * k3[i] + k4[i])
                  for i in range(ns)]
            q_acc = q_acc + q1
        rr_eff = tuple((Yc[i] - Y[i]) * rho / dt for i in range(ns))
        return rr_eff, q_acc / self.n_sub


# ---------------------------------------------------------------------------
# TDAC: mechanism reduction and tabulation.  OpenFOAM's TDAC reduces the
# mechanism per cell each step and tabulates ODE solutions in a binary tree.
# Here DRG runs once at build time against a reference state (the step
# integrates the pruned mechanism), the host ISAT caches on the host, and
# DeviceISAT keeps a fixed-capacity table on the device.
# ---------------------------------------------------------------------------


class ChemistryReduction:
    """Base: reduce(mix, reactions, Y0, T0, p0) -> (reactions', active)."""


@register("chemistryReduction", "none")
@dataclasses.dataclass(frozen=True)
class NoReduction(ChemistryReduction):
    def reduce(self, mix, reactions, Y0, T0, p0):
        return tuple(reactions), tuple(range(mix.n_species))


@register("chemistryReduction", "DRG")
@dataclasses.dataclass(frozen=True)
class DRG(ChemistryReduction):
    """Directed Relation Graph at a reference state: interaction
    coefficient r_AB = sum_{i: B in rxn i} |nu_Ai w_i| / sum_i |nu_Ai w_i|;
    a search from `targets` keeps every specie reachable through edges with
    r >= threshold; reactions that touch a removed specie are pruned.
    Scalar host arithmetic."""

    targets: tp.Tuple[int, ...]
    threshold: float = 0.01

    def reduce(self, mix, reactions, Y0, T0, p0):
        ns = mix.n_species
        T0, p0 = float(T0), float(p0)
        conc = [max(float(Y0[i]), 0.0) * p0 /
                (R_UNIVERSAL * T0 * mix.species[i].W) for i in range(ns)]
        w = []
        for rxn in reactions:
            k = rxn.A * T0 ** rxn.beta * np.exp(-rxn.Ta / max(T0, 1.0))
            for i, nu in rxn.lhs:
                k *= max(conc[i], 0.0) ** nu
            w.append(abs(k))
        denom = np.zeros(ns)
        nu_net = []
        for rxn, wi in zip(reactions, w):
            nus = {}
            for i, nu in rxn.lhs:
                nus[i] = nus.get(i, 0.0) - nu
            for i, nu in rxn.rhs:
                nus[i] = nus.get(i, 0.0) + nu
            nu_net.append(nus)
            for i, nu in nus.items():
                denom[i] += abs(nu * wi)
        # r[A][B]: A depends on B
        r = np.zeros((ns, ns))
        for rxn, wi, nus in zip(reactions, w, nu_net):
            involved = set(nus) | {i for i, _ in rxn.lhs}
            for A, nuA in nus.items():
                if denom[A] <= 0.0:
                    continue
                for B in involved:
                    if B != A:
                        r[A, B] = max(r[A, B], abs(nuA * wi) / denom[A])
        keep = set(self.targets)
        frontier = list(self.targets)
        while frontier:
            A = frontier.pop()
            for B in range(ns):
                if B not in keep and r[A, B] >= self.threshold:
                    keep.add(B)
                    frontier.append(B)
        pruned = tuple(
            rxn for rxn in reactions
            if all(i in keep for i, _ in rxn.lhs)
            and all(i in keep for i, _ in rxn.rhs))
        return pruned, tuple(sorted(keep))


class ChemistryTabulation:
    """Base: a retrieve/grow cache of integrated rates."""


@register("chemistryTabulation", "none")
@dataclasses.dataclass(frozen=True)
class NoTabulation(ChemistryTabulation):
    def rates(self, compute, mix, Y, rho, T, p, dt):
        return compute(Y, rho, T, p, dt)


@register("chemistryTabulation", "ISAT")
class ISAT(ChemistryTabulation):
    """Host tabulation: cells are keyed by (log T, log p, Y) quantized to
    `tol` steps; only the cells whose key misses the table are computed
    (on the miss subset, in float64) and stored.  The table is cleared
    wholesale when it outgrows `max_size` (OpenFOAM ISAT's maxNLeafs).
    Every call reads its inputs back to the host: for eager runs."""

    def __init__(self, tol: float = 1e-3, max_size: int = 100000):
        self.tol = tol
        self.max_size = max_size
        self.table: dict = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _host(x):
        return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                          dtype=np.float64).reshape(-1)

    def _keys(self, Y, T, p):
        q = [np.round(np.log(np.maximum(self._host(T), 1e-300))
                      / self.tol).astype(np.int64),
             np.round(np.log(np.maximum(self._host(p), 1e-300))
                      / self.tol).astype(np.int64)]
        for Yi in Y:
            q.append(np.round(self._host(Yi) / self.tol).astype(np.int64))
        return list(zip(*(arr.tolist() for arr in q)))

    def rates(self, compute, mix, Y, rho, T, p, dt):
        ns = mix.n_species
        shape = T.shape
        keys = self._keys(Y, T, p)
        ncells = len(keys)
        miss_idx = [i for i, k in enumerate(keys) if k not in self.table]
        if miss_idx:
            if len(self.table) > self.max_size:
                self.table.clear()
            sel = torch.as_tensor(miss_idx, device=T.device)

            def flat(x):
                x = torch.as_tensor(x, device=T.device)
                return torch.broadcast_to(x, shape).reshape(-1).to(
                    torch.float64)[sel]

            rr_m, q_m = compute(tuple(flat(Yi) for Yi in Y), flat(rho),
                                flat(T), flat(p), dt)
            rr_m = [self._host(r) for r in rr_m]
            q_m = self._host(q_m)
            for j, i in enumerate(miss_idx):
                self.table[keys[i]] = (tuple(float(r[j]) for r in rr_m),
                                       float(q_m[j]))
        self.misses += len(miss_idx)
        self.hits += ncells - len(miss_idx)
        rr_out = np.zeros((ns, ncells))
        q_out = np.zeros(ncells)
        for i, k in enumerate(keys):
            vals, qv = self.table[k]
            rr_out[:, i] = vals
            q_out[i] = qv

        def back(a):
            return torch.as_tensor(a.reshape(shape), dtype=T.dtype,
                                   device=T.device)

        return tuple(back(rr_out[i]) for i in range(ns)), back(q_out)


@register("chemistrySolver", "TDAC")
@dataclasses.dataclass(frozen=True)
class TDACChemistrySolver(ChemistrySolver):
    """A base integrator with DRG pruning of Laminar kinetics (at build
    time, against `ref_state` = (Y0, T0, p0)) and an optional tabulation
    of the integrated rates."""

    base: ChemistrySolver
    reduction: tp.Optional[ChemistryReduction] = None
    tabulation: tp.Optional[ChemistryTabulation] = None
    ref_state: tp.Optional[tuple] = None

    def _pruned(self, model, mix):
        if self.reduction is None or self.ref_state is None:
            return model
        Y0, T0, p0 = self.ref_state
        if isinstance(model, Laminar):
            rxns, _ = self.reduction.reduce(mix, model.reactions, Y0, T0, p0)
            return dataclasses.replace(model, reactions=rxns)
        if isinstance(model, (PaSR, EDC)):
            return dataclasses.replace(
                model, base=self._pruned(model.base, mix))
        return model

    def rates(self, model, mix, Y, rho, T, p, dt, aux=None):
        model = self._pruned(model, mix)
        if self.tabulation is not None:
            def compute(Yc, rhoc, Tc, pc, dtc):
                return self.base.rates(model, mix, Yc, rhoc, Tc, pc, dtc,
                                       aux=aux)
            return self.tabulation.rates(compute, mix, Y, rho, T, p, dt)
        return self.base.rates(model, mix, Y, rho, T, p, dt, aux=aux)


_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 16777619
_U32 = 0xFFFFFFFF


@register("chemistryTabulation", "ISATDevice")
@dataclasses.dataclass(frozen=True)
class DeviceISAT(ChemistryTabulation):
    """Device-resident tabulation: a fixed-capacity open-addressed hash
    table kept as explicit state (a dict of tensors that rides in the
    solver State), so retrieval and insertion are tensor ops of the step.

      key   = quantized (log T, log p, log dt, Y/tol) int32 rows (dt is
              part of the key: the value is the mean rate over dt), hashed
              by FNV-1a (32-bit, in int64 masked to 32 bits) to one slot;
      hit   = the slot is valid AND its full stored key equals the cell's
              (a hash collision never returns wrong rates);
      miss  = rates computed; each touched slot takes the entry of the
              largest flat cell index that maps to it (a miss writes its
              key and rates, a hit leaves the slot as it is), the order
              the JAX package's scatter applies, here made explicit and
              deterministic on every device.

    The batched compute is skipped when every cell hits: one host read of
    `miss.any()` a call, counted in `DeviceISAT.reads`.  The `hits`,
    `lookups` and `evictions` (a miss landing on a valid slot of another
    key) counters are int64 0-dim tensors; `counter` reads one.

        tab = DeviceISAT(tol=1e-3, capacity=1 << 15)
        table = tab.init(n_species, dtype=torch.float64, device=dev)
        (rr, q), table = tab.rates_stateful(table, compute, mix, Y, rho,
                                            T, p, dt)
    where compute(Y, rho, T, p, dt[, miss]) returns (rr tuple, Qdot); a
    `miss` parameter, when compute has one, gets the miss mask.
    """

    tol: float = 1e-3
    capacity: int = 1 << 15  # slots

    reads = 0  # host reads of the all-hit test, all tables together

    def init(self, n_species: int, dtype=torch.float32, device="cpu"):
        cap = self.capacity

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        return {
            "keys": zeros((n_species + 3, cap), torch.int32),
            "valid": zeros((cap,), torch.bool),
            "rr": zeros((n_species, cap), dtype),
            "q": zeros((cap,), dtype),
            "hits": zeros((), torch.int64),
            "lookups": zeros((), torch.int64),
            "evictions": zeros((), torch.int64),
        }

    @staticmethod
    def counter(table, name: str) -> int:
        """A counter of the table as a Python int (a host read)."""
        return int(table[name])

    def _key(self, Y, T, p, dt):
        """Quantized key rows (n_species+3, cells) and the FNV-1a slot of
        each cell."""
        def quant(x):
            return torch.round(torch.log(torch.clamp(x, min=1e-30))
                               / self.tol).to(torch.int32)

        dt = torch.as_tensor(dt, dtype=T.dtype, device=T.device)
        rows = [quant(T), quant(p), torch.broadcast_to(quant(dt), T.shape)]
        for Yi in Y:
            rows.append(torch.round(Yi / self.tol).to(torch.int32))
        key = torch.stack(rows)
        h = torch.full(T.shape, _FNV_OFFSET, dtype=torch.int64,
                       device=T.device)
        for v in rows:
            # xor with the uint32 view of the int32 row, then the 32-bit
            # product
            h = (torch.bitwise_xor(h, v.to(torch.int64) & _U32)
                 * _FNV_PRIME) & _U32
        return key, h % self.capacity

    def rates_stateful(self, table, compute, mix, Y, rho, T, p, dt):
        """((rates, Qdot), table'): retrieve the hits, compute the misses
        (unless there are none) and insert them."""
        shape = T.shape
        Tf, pf = T.reshape(-1), p.reshape(-1)
        n = Tf.shape[0]
        key, slot = self._key(tuple(Yi.reshape(-1) for Yi in Y), Tf, pf, dt)
        stored_key = table["keys"][:, slot]
        hit = table["valid"][slot] & torch.all(stored_key == key, dim=0)
        miss = ~hit
        rr_tab = table["rr"][:, slot]
        q_tab = table["q"][slot]
        DeviceISAT.reads += 1
        if bool(miss.any()):
            kw = {"miss": miss.reshape(shape)} if _takes(compute, "miss") \
                else {}
            rr_c, q_c = compute(Y, rho, T, p, dt, **kw)
            rr_cf = torch.stack([r.reshape(-1) for r in rr_c]).to(
                table["rr"].dtype)
            q_cf = q_c.reshape(-1).to(table["q"].dtype)
            rr_out = torch.where(hit[None, :], rr_tab, rr_cf)
            q_out = torch.where(hit, q_tab, q_cf)
            # each touched slot's writer: the largest cell index mapping
            # to it; it changes the slot only if it missed
            cell = torch.arange(n, device=slot.device)
            win = torch.full((self.capacity,), -1, dtype=torch.int64,
                             device=slot.device).scatter_reduce(
                0, slot, cell, "amax")
            touched = win >= 0
            w = torch.clamp(win, min=0)
            upd = touched & miss[w]
            table2 = {
                "keys": torch.where(upd[None, :], key[:, w], table["keys"]),
                "valid": table["valid"] | touched,
                "rr": torch.where(upd[None, :], rr_cf[:, w], table["rr"]),
                "q": torch.where(upd, q_cf[w], table["q"]),
            }
        else:
            # every cell hit: the batched integration is skipped, the
            # table is unchanged
            rr_out, q_out = rr_tab, q_tab
            table2 = {k: table[k] for k in ("keys", "valid", "rr", "q")}
        table2.update(
            hits=table["hits"] + hit.sum(),
            lookups=table["lookups"] + n,
            evictions=table["evictions"]
            + (miss & table["valid"][slot]).sum())
        return ((tuple(rr_out[i].reshape(shape)
                       for i in range(rr_out.shape[0])),
                 q_out.reshape(shape)), table2)
