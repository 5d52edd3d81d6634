"""Carry meshes and solver state between the JAX package and this port.

Both packages build the same solver from the same `cases` arguments, so with
equal states they compute the same thing.  Data crosses as numpy arrays:
`state_from_numpy` takes a `qgdsolver_tpu` State whose leaves were converted
with `np.asarray` (its pbc and waveTransmissive wt tuples included),
`state_to_numpy` gives this package's State back with numpy leaves,
`mesh_from` rebuilds a mesh of either package (its face coordinates, solid
mask and wedge kind) as this port's, and `solver_from` a QGDFoam config
with plain BC values.  None of them imports JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import bc as bcm
from .core.mesh import AxisymmetricMesh, Mesh
from .solvers.qgd import State


def state_from_numpy(s, device="cpu", dtype=torch.float32) -> State:
    """A State with numpy (or array-like) leaves -> this port's State of
    tensors in `dtype` on `device`."""

    def conv(x):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return State(rho=conv(s.rho), rhoU=conv(s.rhoU), rhoE=conv(s.rhoE),
                 sc=conv(s.sc), t=conv(s.t), dt=conv(s.dt),
                 pbc=tuple(conv(g) for g in s.pbc),
                 wt=tuple(conv(w) for w in getattr(s, "wt", ())))


def state_to_numpy(s: State) -> State:
    """This port's State -> the same State with numpy leaves (on the host)."""

    def conv(x):
        return x.detach().cpu().numpy()

    return State(rho=conv(s.rho), rhoU=conv(s.rhoU), rhoE=conv(s.rhoE),
                 sc=conv(s.sc), t=conv(s.t), dt=conv(s.dt),
                 pbc=tuple(conv(g) for g in s.pbc),
                 wt=tuple(conv(w) for w in s.wt))


def mesh_from(m, device="cpu", dtype=torch.float32) -> Mesh:
    """The port's mesh of a mesh `m` of either package: its face
    coordinates, its solid mask (a numpy copy) and, for a wedge, an
    `AxisymmetricMesh`, in `dtype` on `device`."""
    faces = tuple(np.asarray(f, dtype=np.float64) for f in m.x_faces)
    if getattr(m, "axisymmetric", False):
        return AxisymmetricMesh(x_faces=faces, dtype=dtype, device=device)
    solid = getattr(m, "solid", None)
    return Mesh(x_faces=faces, dtype=dtype, device=device,
                solid=None if solid is None else np.array(solid, dtype=bool))


def _plain(v):
    """A BC or model parameter of either package as plain Python/numpy:
    numbers stay numbers, arrays (numpy, JAX, torch) become float64 numpy
    copies; a callable value cannot cross and raises."""
    if callable(v):
        raise ValueError("a callable BC value cannot be carried across; "
                         "build it in the port")
    if isinstance(v, (bool, int, float)) or v is None:
        return v
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    return np.array(v, dtype=np.float64)


def _bc_from(b):
    cls = getattr(bcm, type(b).__name__)
    if cls is bcm.Segmented:
        return bcm.Segmented(tuple((rects, _bc_from(x))
                                   for rects, x in b.segments))
    return cls(**{f.name: _plain(getattr(b, f.name))
                  for f in dataclasses.fields(b)})


def solver_from(s, device="cpu", dtype=torch.float32):
    """The port's QGDFoam of a QGDFoam config of the JAX package (or of
    this one): its mesh (`mesh_from`: solid mask and wedge included), its
    perfect-gas thermo and transport, tau model (the const-Sc cellSet and
    a per-cell cqSc as numpy arrays), BCs with plain values, time
    controls and the solver switches, so that a test builds both packages'
    solvers from one config.  Reads the other package's objects by their
    class and field names; imports nothing of it."""
    from .physics import qgdcoeffs, thermo
    from .solvers.common import TimeControls
    from .solvers.qgd import QGDFoam

    def same(mod, obj, **over):
        cls = getattr(mod, type(obj).__name__)
        kw = {f.name: _plain(getattr(obj, f.name))
              for f in dataclasses.fields(obj) if f.name not in over}
        return cls(**kw, **over)

    th = s.thermo
    kw = dict(
        mesh=mesh_from(s.mesh, device=device, dtype=dtype),
        thermo=same(thermo, th, transport=same(thermo, th.transport)),
        tau_model=same(qgdcoeffs, s.tau_model),
        time=TimeControls(**dataclasses.asdict(s.time)))
    for name in ("bc_U", "bc_p", "bc_T"):
        bcs = getattr(s, name)
        if bcs is not None:
            kw[name] = bcm.FieldBCs(tuple(tuple(_bc_from(b) for b in row)
                                          for row in bcs.bcs))
    for name in ("implicit_diffusion", "cg_tol", "cg_maxiter", "fvsc_scheme",
                 "qgdflux_limit", "qgdflux_relax"):
        kw[name] = getattr(s, name)
    return QGDFoam(**kw)
