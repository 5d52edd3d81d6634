"""Carry meshes, solver configs and state between the JAX package and this
port.

Both packages build the same solver from the same `cases` arguments, so with
equal states they compute the same thing.  Data crosses as numpy arrays:
`state_from_numpy` takes a `qgdsolver_tpu` State (QGD, QHD or scalar
transport, told apart by its field names) whose leaves were converted with
`np.asarray` (a QGD State's pbc and waveTransmissive wt tuples included),
`state_to_numpy` gives this package's State back with numpy leaves,
`mesh_from` rebuilds a mesh of either package (its face coordinates, solid
mask and wedge kind) as this port's, and `solver_from` a QGDFoam,
rhoQGDFoam, zQGDFoam, QHDFoam (SRF, MULES and QHDDyMFoam variants
included, the motion callables given in torch), ScalarTransportQHD,
InterQHDFoam, ReactingQGDFoam or Lagrangian (ParticlesQGDFoam,
ParticlesQHDFoam, ReactingLagrangianQGDFoam) config with plain BC values.
The Lagrangian States (`PState` of a fluid State and a `CloudState`) and
the reacting State with its DeviceISAT table dict (the JAX package's
two-limb uint32 counters become int64 counts) cross too.  None of them
imports JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import bc as bcm
from .core.mesh import AxisymmetricMesh, Mesh
from .solvers import (inter_qhd, particles, qgd, qhd, reacting,
                      scalar_transport)

# a State's class by its first field names
_STATES = {cls._fields[:4]: cls for cls in (qgd.State, qhd.State,
                                            scalar_transport.State,
                                            inter_qhd.State, reacting.State)}
# a moving mesh's motion callables: they belong to their array library
_MOTION = ("mesh_velocity", "mesh_scale", "mesh_faces")
_TUPLES = ("pbc", "wt")


def _state_class(s):
    cls = _STATES.get(tuple(s._fields[:4]))
    if cls is None:
        raise TypeError(f"no State with fields {s._fields}")
    return cls


# a DeviceISAT table's integer and flag entries; its rr and q take the
# state's dtype
_TABLE_DTYPES = {"keys": torch.int32, "valid": torch.bool}
_COUNTERS = ("hits", "lookups", "evictions")


def _table_from(tab, conv, device):
    """A DeviceISAT table dict of either package as the port's: a counter
    given as two uint32 limbs [lo, hi] becomes one int64 count."""
    out = {}
    for k, v in tab.items():
        v = np.array(v)
        if k in _COUNTERS:
            v = np.asarray(v, dtype=np.uint64).reshape(-1)
            n = int(v[0]) + (int(v[1]) << 32 if v.size > 1 else 0)
            out[k] = torch.tensor(n, dtype=torch.int64, device=device)
        elif k in _TABLE_DTYPES:
            out[k] = torch.as_tensor(v, dtype=_TABLE_DTYPES[k],
                                     device=device)
        else:
            out[k] = conv(v)
    return out


def state_from_numpy(s, device="cpu", dtype=torch.float32):
    """A State with numpy (or array-like) leaves -> this port's State of
    the same kind, tensors in `dtype` on `device` (a PState's fluid and
    cloud each so; a cloud's dropped count stays None or an int64
    tensor)."""

    def conv(x):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    if hasattr(s, "cloud"):
        c = s.cloud
        dropped = getattr(c, "dropped", None)
        return particles.PState(
            fluid=state_from_numpy(s.fluid, device=device, dtype=dtype),
            cloud=particles.CloudState(
                *(conv(getattr(c, f)) for f in ("x", "u", "Tp", "dp",
                                                 "active")),
                dropped=None if dropped is None else torch.as_tensor(
                    np.asarray(dropped), dtype=torch.int64, device=device)))
    cls = _state_class(s)

    def field(f):
        v = getattr(s, f, ())
        if f in _TUPLES:
            return tuple(conv(g) for g in v)
        if f == "tab":
            return None if v is None else _table_from(v, conv, device)
        return conv(v)

    return cls(**{f: field(f) for f in cls._fields})


def state_to_numpy(s):
    """This port's State -> the same State with numpy leaves (on the
    host), nested States, tuples and table dicts included."""

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if hasattr(x, "_fields"):
            return state_to_numpy(x)
        if isinstance(x, tuple):
            return tuple(conv(g) for g in x)
        return x.detach().cpu().numpy()

    return type(s)(**{f: conv(v) for f, v in zip(s._fields, s)})


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
    if isinstance(v, (bool, int, float, str)) or v is None:
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


def _same(mod, obj, **over):
    """`obj` rebuilt as the class of the same name in module `mod`, its
    dataclass fields as plain values (`over` replaces some)."""
    cls = getattr(mod, type(obj).__name__)
    kw = {f.name: _plain(getattr(obj, f.name))
          for f in dataclasses.fields(obj) if f.name not in over}
    return cls(**kw, **over)


def _thermo_from(th):
    """A thermo of either package as the port's: its transport, equation
    of state and JANAF tables rebuilt by class name."""
    from .physics import thermo

    over = {}
    for name in ("transport", "eos", "janaf"):
        if hasattr(th, name):
            sub = getattr(th, name)
            over[name] = (_same(thermo, sub, low=tuple(sub.low),
                                high=tuple(sub.high))
                          if name == "janaf" else _same(thermo, sub))
    return _same(thermo, th, **over)


def _carried(v):
    """A model object of either package as the port's: dataclasses rebuilt
    by class name from the port's physics and cloud modules, field by
    field (tuples of them included), arrays as numpy, the host ISAT as a
    new empty one of the same tolerance and size."""
    from .physics import chemistry, species, thermo

    if type(v).__name__ == "ISAT":
        return chemistry.ISAT(tol=v.tol, max_size=v.max_size)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        cls = next(getattr(m, type(v).__name__) for m in
                   (chemistry, species, thermo, particles)
                   if hasattr(m, type(v).__name__))
        return cls(**{f.name: _carried(getattr(v, f.name))
                      for f in dataclasses.fields(v) if f.init})
    if isinstance(v, tuple):
        return tuple(_carried(x) for x in v)
    return _plain(v)


def _bcs_from(v):
    """FieldBCs, or a per-specie tuple of them, as the port's."""
    if isinstance(v, tuple):
        return tuple(_bcs_from(b) for b in v)
    return bcm.FieldBCs(tuple(tuple(_bc_from(b) for b in row)
                              for row in v.bcs))


def solver_from(s, device="cpu", dtype=torch.float32, **over):
    """The port's solver of a config of the JAX package (or of this one):
    QGDFoam (and so rhoQGDFoam), ZQGDFoam, QHDFoam (with g, omega,
    t_equation, p_ref_value and QHDDyMFoam's check_mesh_courant),
    ScalarTransportQHD or InterQHDFoam (its TwoPhaseProperties, contact
    angles, alpha smoothing flags and alpha field name), of the same class
    name, and ReactingQGDFoam (its mixture, combustion model, chemistry
    solver and tabulation carried as plain values, `_carried`) and the
    Lagrangian solvers (their fluid so, and their cloud constants).  It
    carries the mesh (`mesh_from`: solid mask and wedge
    included), the thermo (perfect gas, rhoConst, RhoThermo with its
    equation of state, JANAF with its coefficient tuples) and its
    transport, the tau model (the const-Sc cellSet and a per-cell cqSc as
    numpy arrays), the BCs with plain values, the time controls and the
    solver switches, so that a test builds both packages' solvers from one
    config.  A motion callable (QHDDyMFoam's mesh_velocity, mesh_scale,
    mesh_faces) is a function of its own array library and cannot be
    carried: pass its torch counterpart in `over` (which sets any field);
    a moving config without one raises.  Reads the other package's objects
    by their class and field names; imports nothing of it."""
    from .physics import qgdcoeffs, twophase
    from .solvers import zqgd
    from .solvers.common import TimeControls

    wrappers = {c.__name__: c for c in (
        particles.ParticlesQGDFoam, particles.ParticlesQHDFoam,
        particles.ReactingLagrangianQGDFoam)}
    if type(s).__name__ in wrappers:
        return wrappers[type(s).__name__](
            fluid=solver_from(s.fluid, device=device, dtype=dtype, **over),
            cloud=_carried(s.cloud))
    cls = {c.__name__: c for c in (qgd.QGDFoam, zqgd.ZQGDFoam, qhd.QHDFoam,
                                   scalar_transport.ScalarTransportQHD,
                                   inter_qhd.InterQHDFoam,
                                   reacting.ReactingQGDFoam)
           }[type(s).__name__]
    kw = dict(mesh=mesh_from(s.mesh, device=device, dtype=dtype),
              time=TimeControls(**dataclasses.asdict(s.time)))
    if hasattr(s, "thermo"):
        kw["thermo"] = _thermo_from(s.thermo)
    if hasattr(s, "tau_model"):
        kw["tau_model"] = _same(qgdcoeffs, s.tau_model)
    if hasattr(s, "props"):
        kw["props"] = _same(twophase, s.props)
    for f in dataclasses.fields(cls):
        if f.name in kw or f.name in over or not hasattr(s, f.name):
            continue
        v = getattr(s, f.name)
        if f.name.startswith("bc_"):
            if v is not None:
                kw[f.name] = _bcs_from(v)
        elif f.name in ("mixture", "combustion", "chemistry_solver",
                        "tabulation"):
            kw[f.name] = _carried(v)
        elif f.name in ("g", "omega"):
            kw[f.name] = None if v is None else tuple(float(x) for x in v)
        elif f.name in _MOTION:
            if v is not None:
                raise ValueError(
                    f"{f.name} is a callable of the other package: pass "
                    f"its torch counterpart as solver_from(..., "
                    f"{f.name}=...)")
        elif f.name == "contact_angles" and v:
            kw[f.name] = {k: _same(twophase, ca) for k, ca in v.items()}
        else:
            kw[f.name] = v
    return cls(**kw, **over)
