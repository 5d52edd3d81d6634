"""Boundary conditions over structured block faces (PyTorch port of
`qgdsolver_tpu.core.bc`, the BCs of QGDFoam and the QHD family).

A BC is a small frozen dataclass that maps the first interior cell layer to a
ghost cell layer; ops/pad.py applies it.  Ghost conventions (ghost center
mirrored across the face, distance dx_edge from the interior center):
  FixedValue v     : G = 2 v - I
  ZeroGradient     : G = I
  FixedGradient g  : G = I + g dx_edge  (g = outward-normal gradient)
  Symmetry scalar  : G = I;  vector: normal component negated
  Periodic         : G = opposite-side interior layer
  Extrapolated     : G = 2 I - I2
  Mixed v, f       : G = 2 (f v + (1 - f) I) - I
  Segmented        : each segment's ghost on its own face rectangles

BC `value`/`grad` entries may be a scalar (or a per-component vector for
vector fields), an array or tensor broadcastable against the boundary layer,
or a callable `f(t, coords)` over torch coordinate tensors of the ghost layer
(how time-dependent BCs such as cosVelocity are written).

State-coupled BCs are markers the solver substitutes each step: QGDFluxP by a
FixedGradient of the lagged dp/dn, QHDFluxP by a FixedGradient of the
step's own dp/dn, WaveTransmissive by a Mixed condition of the carried face
value.
"""
from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch


class BC:
    """Base class for boundary conditions (marker)."""


@dataclasses.dataclass(frozen=True)
class FixedValue(BC):
    value: tp.Any


@dataclasses.dataclass(frozen=True)
class ZeroGradient(BC):
    pass


@dataclasses.dataclass(frozen=True)
class FixedGradient(BC):
    grad: tp.Any  # outward-normal gradient


@dataclasses.dataclass(frozen=True)
class Symmetry(BC):
    """Symmetry plane / slip wall. Scalars: zero gradient; vectors: mirror."""


@dataclasses.dataclass(frozen=True)
class Periodic(BC):
    """Cyclic boundary; both sides of the axis must be Periodic."""


@dataclasses.dataclass(frozen=True)
class Extrapolated(BC):
    """Linear extrapolation from the two interior layers (outflow-ish)."""


@dataclasses.dataclass(frozen=True)
class Mixed(BC):
    """OpenFOAM mixed BC with zero refGrad: face value =
    fraction*value + (1 - fraction)*interior-cell value.  fraction=1 is
    FixedValue, fraction=0 ZeroGradient.  The waveTransmissive substitution
    builds it each step."""

    value: tp.Any
    fraction: tp.Any


@dataclasses.dataclass(frozen=True)
class InletOutlet(BC):
    """OpenFOAM inletOutlet: zeroGradient where flow leaves the domain,
    fixedValue `inlet_value` where it enters.  A marker: solvers resolve it
    each step into `FluxSwitched` with `resolve_inlet_outlet`, switching on
    the interior-cell outward normal velocity."""

    inlet_value: tp.Any = 0.0


@dataclasses.dataclass(frozen=True)
class FluxSwitched(BC):
    """Resolved inletOutlet: `outflow` is a boolean boundary-layer tensor
    (True -> zeroGradient ghost, False -> fixedValue(value) ghost)."""

    value: tp.Any
    outflow: tp.Any


@dataclasses.dataclass(frozen=True)
class Segmented(BC):
    """A mesh side shared by several patches with different BCs (a jet
    inlet strip inside a far-field patch on one boundary plane).

    segments: ordered tuple of (rects, bc).  Each `rects` is a tuple of
    rectangles; a rectangle is a tuple of (lo, hi) half-open global
    cell-index ranges, one per tangential axis in ascending axis order.
    Ghost cells past the domain's corners take the nearest segment
    (indices clamp).  Later segments win on overlap; ingestion checks that
    every boundary cell is covered."""

    segments: tp.Tuple[tp.Tuple[tp.Any, BC], ...]


@dataclasses.dataclass(frozen=True)
class QGDFluxP(BC):
    """qgdFlux pressure BC marker: the solver substitutes a FixedGradient
    with dp/dn = -phiwStar/(tau_f*|Sf|) from the previous step."""


@dataclasses.dataclass(frozen=True)
class QHDFluxP(BC):
    """qhdFlux pressure BC marker: QHDFoam substitutes a FixedGradient with
    dp/dn = -phiwStar*rho_f/(tau_f*|Sf|) from the same step's regularizer
    flux before its pressure solve."""


@dataclasses.dataclass(frozen=True)
class WaveTransmissive(BC):
    """OpenFOAM waveTransmissive outflow marker.  The solver carries the
    patch face value v in its State and advances it each step with the
    implicit-upwind advective update at the outgoing wave speed
    w = max(Un, 0) + c:

        v_new = (v + alpha*phi_cell + k*field_inf) / (1 + alpha + k),
        alpha = w dt / delta,  k = w dt / l_inf  (0 when l_inf == 0),

    delta the cell-centre-to-face distance (advectiveFvPatchField with the
    Euler ddt).  During a step the BC acts as the Mixed condition of the
    carried value."""

    field_inf: float = 0.0
    l_inf: float = 0.0


def noslip(ndim: int) -> FixedValue:
    """noSlip wall: U fixed at zero."""
    return FixedValue([0.0] * ndim)


def cos_velocity(amplitude, omega0, phi0, height, ndim, flow_axis=0,
                 profile_axis=1):
    """Time-periodic velocity BC (reference cosVelocity):
    U_flow = A*cos(pi*z/H)*(-omega0)*sin(omega0*t + phi0), z the
    coordinate along `profile_axis`."""

    def value(t, coords):
        z = coords[profile_axis]
        t = torch.as_tensor(t, dtype=z.dtype, device=z.device)
        u = amplitude * torch.cos(math.pi * z / height) * (-omega0) \
            * torch.sin(omega0 * t + phi0)
        comps = [torch.zeros_like(u + 0.0 * t) for _ in range(ndim)]
        comps[flow_axis] = u + 0.0 * comps[flow_axis]
        return torch.stack(torch.broadcast_tensors(*comps), dim=0)

    return FixedValue(value)


def homogeneous(bc: BC) -> BC:
    """The BC with its inhomogeneous part zeroed: the linear part of an
    implicit operator (the CG's matvec is a linear map)."""
    if isinstance(bc, FixedValue):
        return FixedValue(0.0)
    if isinstance(bc, FixedGradient):
        return FixedGradient(0.0)
    if isinstance(bc, Mixed):
        return Mixed(0.0, bc.fraction)
    if isinstance(bc, FluxSwitched):
        return FluxSwitched(0.0, bc.outflow)
    if isinstance(bc, InletOutlet):
        return InletOutlet(0.0)
    return bc


def resolve_inlet_outlet(bcs: "FieldBCs", U, ndim: int) -> "FieldBCs":
    """Replace InletOutlet markers with FluxSwitched from the current cell
    velocity U (d, *cells), inside Segmented sides too.  No-op when no
    marker is present."""

    def has_io(b):
        if isinstance(b, Segmented):
            return any(has_io(x) for _, x in b.segments)
        return isinstance(b, InletOutlet)

    out = bcs
    for a in range(ndim):
        for side in (0, 1):
            b = out[a, side]
            if not has_io(b):
                continue
            idx = 0 if side == 0 else U.shape[1 + a] - 1
            un = U[a].narrow(a, idx, 1)
            outflow = (un < 0) if side == 0 else (un > 0)

            def resolve(x):
                if isinstance(x, InletOutlet):
                    return FluxSwitched(x.inlet_value, outflow)
                if isinstance(x, Segmented):
                    return Segmented(tuple((r, resolve(y))
                                           for r, y in x.segments))
                return x

            out = out.replace(a, side, resolve(b))
    return out


class FieldBCs:
    """Per-field boundary set: one BC per (axis, side), side 0=low, 1=high."""

    def __init__(self, bcs):
        self.bcs = tuple(tuple(b) for b in bcs)

    @staticmethod
    def uniform(bc: BC, ndim: int) -> "FieldBCs":
        return FieldBCs(tuple((bc, bc) for _ in range(ndim)))

    def __getitem__(self, key):
        axis, side = key
        return self.bcs[axis][side]

    def replace(self, axis: int, side: int, bc: BC) -> "FieldBCs":
        bcs = [list(b) for b in self.bcs]
        bcs[axis][side] = bc
        return FieldBCs(bcs)

    def map(self, fn) -> "FieldBCs":
        """fn applied to every leaf BC, inside Segmented sides too (fn
        never sees the Segmented wrapper)."""

        def one(b):
            if isinstance(b, Segmented):
                return Segmented(tuple((r, one(x)) for r, x in b.segments))
            return fn(b)

        return FieldBCs(tuple(tuple(one(b) for b in row)
                              for row in self.bcs))


def as_value(v, like: torch.Tensor) -> torch.Tensor:
    """A non-callable BC value as a tensor in `like`'s dtype and device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)
