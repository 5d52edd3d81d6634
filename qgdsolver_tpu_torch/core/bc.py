"""Boundary conditions over structured block faces (PyTorch port of
`qgdsolver_tpu.core.bc`, the subset the QGDFoam slices use).

A BC is a small frozen dataclass that maps the first interior cell layer to a
ghost cell layer; ops/pad.py applies it.  Ghost conventions (ghost center
mirrored across the face, distance dx_edge from the interior center):
  FixedValue v     : G = 2 v - I
  ZeroGradient     : G = I
  FixedGradient g  : G = I + g dx_edge  (g = outward-normal gradient)
  Symmetry scalar  : G = I;  vector: normal component negated
  Periodic         : G = opposite-side interior layer
  Extrapolated     : G = 2 I - I2

BC `value`/`grad` entries may be a scalar (or a per-component vector for
vector fields), an array or tensor broadcastable against the boundary layer,
or a callable `f(t, coords)` over torch coordinate tensors of the ghost layer.
"""
from __future__ import annotations

import dataclasses
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
class QGDFluxP(BC):
    """qgdFlux pressure BC marker: the solver substitutes a FixedGradient
    with dp/dn = -phiwStar/(tau_f*|Sf|) from the previous step."""


def noslip(ndim: int) -> FixedValue:
    """noSlip wall: U fixed at zero."""
    return FixedValue([0.0] * ndim)


def resolve_inlet_outlet(bcs: "FieldBCs", U, ndim: int) -> "FieldBCs":
    """Replace InletOutlet markers with FluxSwitched from the current cell
    velocity U (d, *cells).  No-op when no marker is present."""
    out = bcs
    for a in range(ndim):
        for side in (0, 1):
            b = out[a, side]
            if not isinstance(b, InletOutlet):
                continue
            idx = 0 if side == 0 else U.shape[1 + a] - 1
            un = U[a].narrow(a, idx, 1)
            outflow = (un < 0) if side == 0 else (un > 0)
            out = out.replace(a, side, FluxSwitched(b.inlet_value, outflow))
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


def as_value(v, like: torch.Tensor) -> torch.Tensor:
    """A non-callable BC value as a tensor in `like`'s dtype and device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)
