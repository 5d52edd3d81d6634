"""Typed case configuration: the dictionary/run-time-selection system
(PyTorch port of `qgdsolver_tpu.core.config`: QGDFoam, rhoQGDFoam,
zQGDFoam, the QHD family with QHDDyMFoam, scalarTransportQHDFoam and
interQHDFoam; the Lagrangian and reacting solvers are built from case
directories or the Python API, as in the JAX package).  Two keys go beyond the JAX package's configs: a
QHDDyMFoam config's motion is a `dynamicMesh` dict of the dynamicMeshDict
words `foam_case` reads, and an interQHDFoam config's phases a `props`
dict of `TwoPhaseProperties` fields.

A case is a plain JSON-able dict with the reference's four selection points
(fvsc scheme, tau model, thermo combination, BC types per field file) plus
the controlDict time controls, resolved through `core.registry` into the
frozen solver dataclass.  `build_solver(cfg)` is the solver-main startup
equivalent.

The BC registry holds the field-file `type` words whose BC classes the port
has.  BC values stay plain floats and lists (tensors are made on the mesh's
device when the BCs are applied), so one config builds on any device.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from . import bc as bcm
from .mesh import Mesh, checked_device
from .registry import create, register
# imported for the words they register
from ..physics import chemistry, qgdcoeffs, thermo  # noqa: F401
from ..solvers.common import TimeControls

# ---------------------------------------------------------------------------
# BC registry (field-file "type" words)
# ---------------------------------------------------------------------------

register("bc", "fixedValue")(lambda value=0.0, **_: bcm.FixedValue(value))
register("bc", "zeroGradient")(lambda **_: bcm.ZeroGradient())
register("bc", "fixedGradient")(
    lambda gradient=0.0, **_: bcm.FixedGradient(gradient))
register("bc", "symmetry")(lambda **_: bcm.Symmetry())
register("bc", "slip")(lambda **_: bcm.Symmetry())
register("bc", "cyclic")(lambda **_: bcm.Periodic())
register("bc", "periodic")(lambda **_: bcm.Periodic())
register("bc", "inletOutlet")(
    lambda inletValue=0.0, **_: bcm.InletOutlet(inletValue))
register("bc", "extrapolated")(lambda **_: bcm.Extrapolated())
register("bc", "noSlip")(lambda ndim=3, **_: bcm.noslip(ndim))
register("bc", "qgdFlux")(lambda **_: bcm.QGDFluxP())
register("bc", "waveTransmissive")(
    lambda fieldInf=0.0, lInf=0.0, **_: bcm.WaveTransmissive(
        field_inf=float(fieldInf), l_inf=float(lInf)))
register("bc", "cosVelocity")(
    lambda amplitude, omega0, phi0, height, ndim, **kw: bcm.cos_velocity(
        amplitude, omega0, phi0, height, ndim,
        **{k: kw[k] for k in ("flow_axis", "profile_axis") if k in kw}))
register("bc", "qhdFlux")(lambda **_: bcm.QHDFluxP())
# interQHDFoam's mixture qhdFlux: the same marker, substituted per step by
# the mixture gradient
register("bc", "mQhdFlux")(lambda **_: bcm.QHDFluxP())

# solvers this config format does not describe (a cloud, a mixture, a
# mechanism): built from a case directory or the Python API, as in the JAX
# package, whose build_solver does not build them either
_CASE_ONLY_SOLVERS = ("particlesQGDFoam", "particlesQHDFoam",
                      "reactingLagrangianQGDFoam")


def _dtype(word) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[str(word)]


def build_mesh(cfg: dict, device="cuda") -> Mesh:
    """The mesh of a config on `device` (the card unless the caller asks
    for the CPU; raises without a card, see `mesh.checked_device`)."""
    device = checked_device(device)
    dtype = _dtype(cfg.get("dtype", "float32"))
    if "x_faces" in cfg:
        return Mesh(x_faces=tuple(np.asarray(f) for f in cfg["x_faces"]),
                    dtype=dtype, device=device)
    return Mesh.uniform(
        tuple(cfg["shape"]), lengths=tuple(cfg.get("lengths") or []) or None,
        origin=tuple(cfg.get("origin") or []) or None, dtype=dtype,
        device=device)


def build_bcs(cfg: dict, ndim: int):
    """boundary sub-dict {axis_side: {"type": word, ...params}} per field;
    sides named x_lo/x_hi/y_lo/y_hi/z_lo/z_hi (axis order x,y,z)."""
    names = ["x", "y", "z"][:ndim]
    rows = []
    for nm in names:
        row = []
        for suffix in ("_lo", "_hi"):
            entry = cfg.get(nm + suffix, {"type": "zeroGradient"})
            kw = {k: v for k, v in entry.items() if k != "type"}
            kw.setdefault("ndim", ndim)
            row.append(create("bc", entry["type"], **kw))
        rows.append(tuple(row))
    return bcm.FieldBCs(tuple(rows))


def build_thermo(cfg: dict):
    """thermo sub-dict -> thermo: a `type` word of the thermo registry,
    with its `transport` and `eos` sub-dicts (words of their registries)
    and a `janaf` sub-dict of coefficient lists."""
    from ..physics.thermo import JanafThermo

    kw = {k: v for k, v in cfg.items()
          if k not in ("type", "transport", "eos", "janaf")}
    if "janaf" in cfg:
        j = cfg["janaf"]
        kw["janaf"] = JanafThermo(R=j["R"], low=tuple(j["low"]),
                                  high=tuple(j["high"]),
                                  Tcommon=j.get("Tcommon", 1000.0))
    for key, kind in (("transport", "transport"), ("eos", "eos")):
        if key in cfg:
            sub = cfg[key]
            kw[key] = create(kind, sub["type"],
                             **{k: v for k, v in sub.items() if k != "type"})
    return create("thermo", cfg["type"], **kw)


def build_tau_model(cfg: dict):
    return create("tau", cfg["type"],
                  **{k: v for k, v in cfg.items() if k != "type"})


def build_time_controls(cfg: dict) -> TimeControls:
    """controlDict equivalents (adjustTimeStep/maxCo/maxDeltaT/cTau)."""
    return TimeControls(
        adjust_time_step=cfg.get("adjustTimeStep", True),
        max_co=cfg.get("maxCo", 0.5),
        max_dt=cfg.get("maxDeltaT", 1.0),
        c_tau=cfg.get("cTau", 0.75),
        dt0=cfg.get("deltaT", 1e-6),
    )


def build_solver(cfg: dict, device="cuda"):
    """Top-level case builder (the solver-main startup equivalent) on
    `device` (the card by default; pass device="cpu" to build on the CPU):
    QGDFoam, rhoQGDFoam, zQGDFoam, the QHD family (QHDFoam, SRFQHDFoam with
    `omega`, mulesQHDFoam, QHDDyMFoam with its `dynamicMesh` dict),
    scalarTransportQHDFoam and interQHDFoam (its `props` dict and the
    `alpha1` BCs).  The Lagrangian and reacting solvers raise
    NotImplementedError: a config does not describe their cloud or
    mixture (build them from a case directory or the Python API)."""
    from ..io.foam_case import dynamic_mesh_kwargs
    from ..physics.twophase import TwoPhaseProperties
    from ..solvers.inter_qhd import InterQHDFoam
    from ..solvers.qgd import QGDFoam
    from ..solvers.qhd import QHDFoam
    from ..solvers.scalar_transport import ScalarTransportQHD
    from ..solvers.zqgd import ZQGDFoam

    solvers = {
        "QGDFoam": QGDFoam, "rhoQGDFoam": QGDFoam, "zQGDFoam": ZQGDFoam,
        "QHDFoam": QHDFoam, "SRFQHDFoam": QHDFoam, "mulesQHDFoam": QHDFoam,
        "QHDDyMFoam": QHDFoam,
        "scalarTransportQHDFoam": ScalarTransportQHD,
        "interQHDFoam": InterQHDFoam,
    }
    name = cfg["solver"]
    if name in _CASE_ONLY_SOLVERS:
        raise NotImplementedError(
            f"solver {name!r} is not built from a config: build it from an "
            "OpenFOAM case directory (io.foam_case.build_case) or the "
            "Python API (solvers.particles, solvers.reacting)")
    if name not in solvers:
        raise KeyError(f"unknown solver {name!r}")
    cls = solvers[name]
    fields = cls.__dataclass_fields__
    mesh = build_mesh(cfg["mesh"], device=device)
    nd = mesh.ndim

    kw = dict(mesh=mesh)
    if "thermo" in cfg and "thermo" in fields:
        kw["thermo"] = build_thermo(cfg["thermo"])
    if "tau" in cfg and "tau_model" in fields:
        kw["tau_model"] = build_tau_model(cfg["tau"])
    if "controlDict" in cfg:
        kw["time"] = build_time_controls(cfg["controlDict"])
    if "fvsc" in cfg and "fvsc_scheme" in fields:
        kw["fvsc_scheme"] = cfg["fvsc"]
    bnd = cfg.get("boundary", {})
    for field, attr in (("U", "bc_U"), ("p", "bc_p"), ("T", "bc_T"),
                        ("alpha1", "bc_alpha")):
        if field in bnd and attr in fields:
            kw[attr] = build_bcs(bnd[field], nd)
    for extra in ("g", "omega", "implicit_diffusion", "p_ref_value"):
        if extra in cfg and extra in fields:
            v = cfg[extra]
            kw[extra] = tuple(v) if isinstance(v, list) else v
    if name == "mulesQHDFoam":
        kw["t_equation"] = "mules"
    if name == "QHDDyMFoam":
        kw.update(dynamic_mesh_kwargs(cfg.get("dynamicMesh", {}), nd))
    if name == "interQHDFoam":
        if "props" not in cfg:
            raise ValueError("an interQHDFoam config needs a `props` dict "
                             "(the TwoPhaseProperties fields)")
        kw["props"] = TwoPhaseProperties(**cfg["props"])
    return cls(**kw)


def load_case(path: str, device="cuda"):
    """Load a JSON case file and build its solver on `device` (as
    `build_solver`)."""
    with open(path) as f:
        return build_solver(json.load(f), device=device)

