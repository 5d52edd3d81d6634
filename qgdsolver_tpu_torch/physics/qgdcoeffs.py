"""tau-regularization coefficient models (PyTorch port of
`qgdsolver_tpu.physics.qgdcoeffs`: the constScPrModel1 family, constTau,
the QHD models HbyUQHD, H2bynuQHD and T0byGr, and the varScModel5/6/7
shock sensors).

A model is a frozen dataclass; `correct()` maps the current thermo state to a
`Coeffs` record.  varScModel5's relaxed sensor is carried in the solver state.
tau_f is interpolated per model exactly as the reference does (model1
interpolates alpha/c then multiplies by h_f; varScModel5 takes
alpha/interp(c)*h_f).
"""
from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from ..core import bc as bcm
from ..core.mesh import Mesh
from ..core.registry import register
from ..ops import fvsc
from ..parallel import spmd


def _zg(ndim):
    return bcm.FieldBCs.uniform(bcm.ZeroGradient(), ndim)


def _interp_zg(field, mesh):
    """linearInterpolate of a coefficient field (zero-gradient extrapolation
    at uncoupled boundaries, like `calculated` patches)."""
    return fvsc.interpolate(field, _zg(mesh.ndim), mesh)


@dataclasses.dataclass(frozen=True)
class Coeffs:
    """Per-step regularization coefficients: cell tau, per-axis face tau,
    QGD viscosity and thermal-diffusivity add-ins, and the ScQGD field."""

    tau: tp.Any
    tau_f: tp.Any
    mu_qgd: tp.Any
    alphau_qgd: tp.Any
    sc: tp.Any


def _finish(mesh, tau, tau_f, p, sc, pr):
    """muQGD = p*Sc*tau, alphauQGD = muQGD/Pr."""
    mu_qgd = p * sc * tau
    return Coeffs(tau=tau, tau_f=tau_f, mu_qgd=mu_qgd, alphau_qgd=mu_qgd / pr,
                  sc=sc)


class TauModel:
    """Base marker. Subclasses implement correct(mesh, **state) -> Coeffs."""


@register("tau", "constScPrModel1")
@dataclasses.dataclass(frozen=True)
class ConstScPrModel1(TauModel):
    """Compressible default: tau = alpha*h/c; tau_f = interp(alpha/c)*h_f;
    muQGD = p*Sc*tau; alphauQGD = muQGD/Pr."""

    alpha: float = 0.5
    Sc: float = 1.0
    Pr: float = 1.0

    def correct(self, mesh: Mesh, *, c, p, **_):
        tau = self.alpha * mesh.h_cell / c
        aoc_f = _interp_zg(self.alpha / c, mesh)
        tau_f = tuple(aoc_f[a] * mesh.h_face(a) for a in range(mesh.ndim))
        return _finish(mesh, tau, tau_f, p, torch.full_like(tau, self.Sc),
                       self.Pr)


@register("tau", "constScPrModel1n")
@dataclasses.dataclass(frozen=True)
class ConstScPrModel1n(ConstScPrModel1):
    """Variant of model1 for a per-cell ScQGD field (reference
    constScPrModel1n); with the constant Sc it computes what model1 does."""


@register("tau", "constScPrModel2")
@dataclasses.dataclass(frozen=True)
class ConstScPrModel2(ConstScPrModel1):
    """Same tau as model1 with fixed Sc/Pr handling (reference
    constScPrModel2)."""


def _no_qgd(tau, tau_f):
    """Coeffs without QGD viscosity or heat-flux add-ins (Sc = 0)."""
    z = torch.zeros_like(tau)
    return Coeffs(tau=tau, tau_f=tau_f, mu_qgd=z, alphau_qgd=z, sc=z)


def _uniform(mesh: Mesh, value, like):
    """tau = value on every cell and face, in `like`'s dtype and device."""
    kw = dict(dtype=like.dtype, device=like.device)
    return _no_qgd(torch.full(mesh.shape, value, **kw),
                   tuple(torch.full(mesh.face_shape(a), value, **kw)
                         for a in range(mesh.ndim)))


@register("tau", "constTau")
@dataclasses.dataclass(frozen=True)
class ConstTau(TauModel):
    """tau = tau0 from the config, Sc = 0: no QGD viscosity or heat
    flux."""

    tau0: float = 0.0

    def correct(self, mesh: Mesh, *, p=None, ref=None, **_):
        return _uniform(mesh, self.tau0, ref if ref is not None else p)


@register("tau", "HbyUQHD")
@dataclasses.dataclass(frozen=True)
class HbyUQHD(TauModel):
    """QHD: tau = alpha*h/U0, tau_f = interp(tau)."""

    alpha: float = 0.5
    U0: float = 1.0

    def correct(self, mesh: Mesh, *, p=None, T=None, ref=None, **_):
        ref = ref if ref is not None else (p if p is not None else T)
        tau = torch.broadcast_to(self.alpha * mesh.h_cell / self.U0,
                                 mesh.shape).to(ref.dtype)
        return _no_qgd(tau, _interp_zg(tau, mesh))


@register("tau", "H2bynuQHD")
@dataclasses.dataclass(frozen=True)
class H2bynuQHD(TauModel):
    """QHD: tau = alpha*h^2/nu, nu = mu/rho."""

    alpha: float = 0.5

    def correct(self, mesh: Mesh, *, mu, rho, **_):
        tau = self.alpha * torch.square(mesh.h_cell) / (mu / rho)
        return _no_qgd(tau, _interp_zg(tau, mesh))


@register("tau", "T0byGr")
@dataclasses.dataclass(frozen=True)
class T0byGr(TauModel):
    """QHD: tau = T0/Gr, a constant."""

    T0: float = 1.0
    Gr: float = 1.0

    def correct(self, mesh: Mesh, *, p=None, T=None, ref=None, **_):
        ref = ref if ref is not None else (p if p is not None else T)
        return _uniform(mesh, self.T0 / self.Gr, ref)


def _neighbour_max(field):
    """Max over the face neighbours of each cell (edge-replicated at the
    boundaries, a no-op for the smoothing update).  Under an spmd context
    the neighbours across a partition edge come from the neighbour rank
    (the FaceCellWave crossing processor patches)."""
    ctx = spmd.current()
    nb = field
    for a in range(field.ndim):
        n = field.shape[a]
        first = field.narrow(a, 0, 1)
        last = field.narrow(a, n - 1, 1)
        if ctx is not None and ctx.sharded(a):
            prev_l, next_l, is_lo, is_hi = spmd.halo_layers(field, a, a)
            first = first if is_lo else prev_l
            last = last if is_hi else next_l
        lo = torch.cat([first, field.narrow(a, 0, n - 1)], dim=a)
        hi = torch.cat([field.narrow(a, 1, n - 1), last], dim=a)
        nb = torch.maximum(nb, torch.maximum(lo, hi))
    return nb


def smooth_ratio(coeff, like):
    """maxRatio = 1 + coeff as a 0-dim tensor of `like`'s dtype on its
    device.  The smoothing rings divide by it: PyTorch's CUDA division by a
    Python scalar multiplies by the scalar's reciprocal, which moves about
    one ring value in six by an ulp; by a tensor it divides.  Filled on the
    device: a tensor copied from the host would wait for the stream."""
    return torch.full((), 1.0 + coeff, dtype=like.dtype, device=like.device)


def fvc_smooth(field, coeff, max_iters: int = 10_000):
    """OpenFOAM fvc::smooth: the fixed point of
    field <- max(field, nbr_max(field)/maxRatio), maxRatio = 1 + coeff, so a
    peak decays by at most maxRatio per cell ring.

    The first test runs after one ring, so an already-smooth field costs one
    ring; then four rings per test.  Each test reads a flag back to the host
    (one device sync per four rings); the iteration is monotone and
    idempotent at the fixed point, so the chunking changes no value.  Under
    an spmd context the test is global (one collective per test), so every
    rank runs the same rings.  maxRatio divides as a tensor on the field's
    device (`smooth_ratio`), so each ring is a correctly rounded division
    on the card as on the CPU.
    """
    max_ratio = smooth_ratio(coeff, field)
    f = torch.maximum(field, _neighbour_max(field) / max_ratio)
    changed = bool(spmd.all_any(torch.any(f > field)))
    it = 1
    while changed and it < max_iters:
        fn = f
        for _ in range(4):
            fn = torch.maximum(fn, _neighbour_max(fn) / max_ratio)
        changed = bool(spmd.all_any(torch.any(fn > f)))
        f = fn
        it += 4
    return f


def fvc_smooth_continue(f1, changed, coeff, max_iters: int = 10_000):
    """Continue the `fvc_smooth` fixed point from a supplied FIRST ring
    f1 = max(f, nbr_max(f)/maxRatio) and its change flag (any(f1 > f);
    a flag that is true when nothing changed only costs a no-op sweep, the
    iteration being idempotent at the fixed point).  `changed` may be a
    bool or a tensor, read once.  Bitwise `fvc_smooth(f)`: it starts at
    it = 1 and runs four rings per host test, as `fvc_smooth` does after
    its first ring.  Every ring it runs adds one to
    `fvc_smooth_continue.rings`."""
    max_ratio = smooth_ratio(coeff, f1)
    f = f1
    changed = bool(changed)
    it = 1
    while changed and it < max_iters:
        fn = f
        for _ in range(4):
            fn = torch.maximum(fn, _neighbour_max(fn) / max_ratio)
        fvc_smooth_continue.rings += 4
        changed = bool(spmd.all_any(torch.any(fn > f)))
        f = fn
        it += 4
    return f


fvc_smooth_continue.rings = 0


@register("tau", "varScModel5")
@dataclasses.dataclass(frozen=True)
class VarScModel5(TauModel):
    """Relaxed density-gradient shock sensor:
      Sc <- rC*(|grad rho|*h/rho) + (1-rC)*Sc_prev, clamp [minSc, maxSc],
      floor cqSc, fvc::smooth, then muQGD = p*Sc*tau as model1,
    with tau_f = alpha/interp(c)*h_f."""

    alpha: float = 0.5
    Pr: float = 1.0
    rC: float = 0.5
    minSc: float = 0.05
    maxSc: float = 1.0
    cqSc: tp.Any = 0.0  # scalar or per-cell bad-quality floor
    smoothCoeff: float = 0.1
    # optional const-Sc cellSet: cells where the 0/1 mask is set keep
    # const_sc_value instead of the sensor value
    const_sc_mask: tp.Any = None
    const_sc_value: float = 1.0

    def sc_raw_update(self, mesh: Mesh, rho, sc_prev):
        """The sensor update before fvc::smooth: relaxation, clamp, the
        cqSc floor and the const-Sc cellSet, in the reference's order."""
        grad_rho = fvsc.grad_cell(rho, _zg(mesh.ndim), mesh)
        mag_grad = torch.sqrt(torch.sum(torch.square(grad_rho), dim=0))
        sc = self.rC * (mag_grad * mesh.h_cell / rho) \
            + (1.0 - self.rC) * sc_prev
        sc = torch.clamp(sc, self.minSc, self.maxSc)
        sc = torch.maximum(
            sc, bcm.as_value(spmd.localize_cells(self.cqSc, mesh.ndim), sc))
        if self.const_sc_mask is not None:
            mask = bcm.as_value(
                spmd.localize_cells(np.asarray(self.const_sc_mask),
                                    mesh.ndim), sc)
            sc = torch.where(mask > 0, self.const_sc_value, sc)
        return sc

    def sc_update(self, mesh: Mesh, rho, sc_prev):
        """The full relaxed sensor update (raw + fvc::smooth), shared by
        `correct()` and the fused step's pre-pass."""
        return fvc_smooth(self.sc_raw_update(mesh, rho, sc_prev),
                          self.smoothCoeff)

    def correct(self, mesh: Mesh, *, c, p, rho, sc_prev, **_):
        tau = self.alpha * mesh.h_cell / c
        c_f = _interp_zg(c, mesh)
        tau_f = tuple(self.alpha / c_f[a] * mesh.h_face(a)
                      for a in range(mesh.ndim))
        sc = self.sc_update(mesh, rho, sc_prev)
        return _finish(mesh, tau, tau_f, p, sc, self.Pr)


def _pressure_jump_sensor(mesh: Mesh, p, bc_p=None, t=0.0):
    """Per-cell |sum_faces +-dp_f| / mean(p_f), the varScModel6/7 sensor.

    Internal faces contribute the signed jump +-(p_nei - p_own), which
    telescopes to the per-axis second difference; a boundary face
    contributes p_face - p_cell = (p_ghost - p_cell)/2 with a positive
    sign, p_face from the p BCs (zero-gradient without them)."""
    from ..ops.pad import ghost_pad

    nd = mesh.ndim
    pe_full = ghost_pad(p, _zg(nd) if bc_p is None else bc_p, mesh, t=t)
    total = torch.zeros_like(p)
    sum_pf = torch.zeros_like(p)
    for a in range(nd):
        # keep only the axis-a ghosts
        sl = [slice(1, pe_full.shape[b] - 1) for b in range(nd)]
        sl[a] = slice(None)
        pe = pe_full[tuple(sl)]
        dp = torch.diff(pe, dim=a)  # n + 1 face deltas (ghosts at the ends)
        n = dp.shape[a]
        dp = torch.cat([dp.narrow(a, 0, 1) * 0.5, dp.narrow(a, 1, n - 2),
                        dp.narrow(a, n - 1, 1) * 0.5], dim=a)
        total = total + dp.narrow(a, 1, n - 1) - dp.narrow(a, 0, n - 1)
        pf = 0.5 * (pe.narrow(a, 0, n) + pe.narrow(a, 1, n))
        sum_pf = sum_pf + pf.narrow(a, 0, n - 1) + pf.narrow(a, 1, n - 1)
    return torch.abs(total) / (sum_pf / (2.0 * nd))


@register("tau", "varScModel6")
@dataclasses.dataclass(frozen=True)
class VarScModel6(TauModel):
    """Pressure-jump sensor: Sc = |sum +-dp_f|/mean(p_f), tau_f as
    model1's."""

    alpha: float = 0.5
    Pr: float = 1.0

    def correct(self, mesh: Mesh, *, c, p, bc_p=None, t=0.0, **_):
        tau = self.alpha * mesh.h_cell / c
        aoc_f = _interp_zg(self.alpha / c, mesh)
        tau_f = tuple(aoc_f[a] * mesh.h_face(a) for a in range(mesh.ndim))
        sc = _pressure_jump_sensor(mesh, p, bc_p=bc_p, t=t)
        return _finish(mesh, tau, tau_f, p, sc, self.Pr)


@register("tau", "varScModel7")
@dataclasses.dataclass(frozen=True)
class VarScModel7(TauModel):
    """varScModel6 scaled by cSc1, with optional clamps (a negative minSc
    or maxSc disables it, as in the reference)."""

    alpha: float = 0.5
    Pr: float = 1.0
    cSc1: float = 1.0
    minSc: float = -1.0
    maxSc: float = -1.0

    def correct(self, mesh: Mesh, *, c, p, bc_p=None, t=0.0, **_):
        tau = self.alpha * mesh.h_cell / c
        aoc_f = _interp_zg(self.alpha / c, mesh)
        tau_f = tuple(aoc_f[a] * mesh.h_face(a) for a in range(mesh.ndim))
        sc = self.cSc1 * _pressure_jump_sensor(mesh, p, bc_p=bc_p, t=t)
        if self.minSc >= 0:
            sc = torch.clamp(sc, min=self.minSc)
        if self.maxSc >= 0:
            sc = torch.clamp(sc, max=self.maxSc)
        return _finish(mesh, tau, tau_f, p, sc, self.Pr)
