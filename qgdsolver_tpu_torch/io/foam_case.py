"""Map OpenFOAM case dictionaries onto the solver config (PyTorch port of
`qgdsolver_tpu.io.foam_case`, the QGDFoam subset).

Mirrors the reference's startup reads:
  * system/controlDict: adjustTimeStep, maxCo, maxDeltaT, cTau, deltaT
    (setDeltaT-QGDQHD.H), startFrom/startTime;
  * system/fvSchemes `fvsc` sub-dict: per-term stencil scheme with `default`
    fallback — leastSquares/GaussVolPoint map to the structured-mesh "full"
    vertex stencil, `reduced` to face-normal-only;
  * constant/thermophysicalProperties: the thermoType/mixture dicts and the
    `QGD` sub-dict (QGDCoeffs model word + its coefficients +
    implicitDiffusion).

`build_case` takes `application QGDFoam` (and rhoQGDFoam with a psi
thermo) in 2D and 3D, with const, sutherland, polynomial (read as powerLaw,
as the JAX package does) or powerLaw transport, on wedge meshes and on
multi-block unions with dead cells (stairstep solids); the other
applications and the janaf/rhoConst/heRho thermo words raise
NotImplementedError naming the ROADMAP item they wait for.
"""
from __future__ import annotations

import os

import torch

from . import foamdict
from ..core.mesh import checked_device
from ..core.registry import create
from ..physics import qgdcoeffs as _qgdcoeffs  # noqa: F401 — registers tau
from ..solvers.common import TimeControls

# reference scheme words -> structured-mesh stencils
_SCHEME_MAP = {
    "leastSquares": "full",
    "leastSquaresOpt": "full",
    "GaussVolPoint": "full",
    "reduced": "reduced",
}

# QGDCoeffs dict keys -> tau-model constructor kwargs
_TAU_KEYS = {
    "aQGD": "alpha",
    "ScQGD": "Sc",
    "PrQGD": "Pr",
    "Tau": "tau0",
    "UQGD": "U0",
    "rC": "rC",
    "minSc": "minSc",
    "maxSc": "maxSc",
    "cqSc": "cqSc",
    "cSc1": "cSc1",
    "smoothCoeff": "smoothCoeff",
    "T0": "T0",
    "Gr": "Gr",
}

# applications of the JAX package that the port does not run yet
_NOT_PORTED_APPS = {
    "zQGDFoam": "ROADMAP queue 1, item 7 (zQGDFoam and rhoQGDFoam's "
                "RhoThermo)",
    "QHDFoam": "ROADMAP queue 1, item 8",
    "SRFQHDFoam": "ROADMAP queue 1, item 8",
    "mulesQHDFoam": "ROADMAP queue 1, item 8",
    "QHDDyMFoam": "ROADMAP queue 1, item 8",
    "scalarTransportQHDFoam": "ROADMAP queue 1, item 8",
    "interQHDFoam": "ROADMAP queue 1, item 9",
    "particlesQGDFoam": "ROADMAP queue 1, item 10",
    "particlesQHDFoam": "ROADMAP queue 1, item 10",
    "reactingLagrangianQGDFoam": "ROADMAP queue 1, item 10",
}


def time_controls(control_dict: dict) -> TimeControls:
    """controlDict -> TimeControls (reference setDeltaT-QGDQHD.H reads)."""
    d = control_dict
    return TimeControls(
        adjust_time_step=bool(d.get("adjustTimeStep", False)),
        max_co=float(d.get("maxCo", 0.5)),
        max_dt=float(d.get("maxDeltaT", 1.0)),
        c_tau=float(d.get("cTau", 0.75)),
        dt0=float(d.get("deltaT", 1e-6)),
    )


def fvsc_scheme(fv_schemes: dict, term: str = "default") -> str:
    """fvSchemes.fvsc lookup with `default` fallback."""
    sub = fv_schemes.get("fvsc", {})
    word = sub.get(term, sub.get("default", "GaussVolPoint"))
    if isinstance(word, list):
        word = word[0]
    return _SCHEME_MAP.get(str(word), "full")


def fvsc_schemes(fv_schemes: dict):
    """Whole fvSchemes.fvsc sub-dict -> per-term {term: scheme} mapping with
    a `default` entry (solvers consume it via ops.fvsc.scheme_for)."""
    sub = fv_schemes.get("fvsc", {})
    out = {}
    for term, word in sub.items():
        if isinstance(word, list):
            word = word[0]
        out[term] = _SCHEME_MAP.get(str(word), "full")
    out.setdefault("default", "full")
    return out


def tau_model(thermo_props: dict):
    """thermophysicalProperties.QGD -> tau model instance (QGDCoeffs::New
    word dispatch)."""
    qgd = thermo_props.get("QGD", {})
    name = qgd.get("QGDCoeffs", "constScPrModel1")
    if isinstance(name, list):
        name = name[0]
    kwargs = {}
    for k, v in qgd.items():
        if k in _TAU_KEYS:
            kwargs[_TAU_KEYS[k]] = float(v) if not isinstance(v, list) else float(v[-1])
    return create("tau", str(name), **kwargs)


def implicit_diffusion(thermo_props: dict) -> bool:
    """QGD.implicitDiffusion, default true (the reference's default)."""
    qgd = thermo_props.get("QGD", {})
    return bool(qgd.get("implicitDiffusion", True))


_RR = 8314.462618  # universal gas constant [J/(kmol K)], OpenFOAM's RR


def build_foam_thermo(thermo_props: dict):
    """constant/thermophysicalProperties thermoType + mixture dicts -> a
    thermo instance: hePsiQGDThermo with hConst and perfectGas, and const,
    sutherland or powerLaw transport."""
    from ..physics import thermo as tm

    tt = thermo_props.get("thermoType", {})
    word = str(tt.get("type", "hePsiQGDThermo"))
    caloric = str(tt.get("thermo", "hConst"))
    transport_word = str(tt.get("transport", "const"))
    eos_word = str(tt.get("equationOfState", "perfectGas"))
    mix = thermo_props.get("mixture", {})
    spec = mix.get("specie", {})
    thermodyn = mix.get("thermodynamics", {})
    transp = mix.get("transport", {})

    if caloric == "janaf":
        raise NotImplementedError(
            "janaf thermo is not in the PyTorch port yet: ROADMAP queue 1, "
            "item 7 (janaf, rhoConst and heRho thermo)")
    if (word.startswith("heRho") or word.startswith("rho")
            or eos_word != "perfectGas"):
        raise NotImplementedError(
            f"{word} with {eos_word} is not in the PyTorch port yet: "
            "ROADMAP queue 1, item 7 (RhoThermo, rhoConst and stiffened gas)")
    if transport_word == "sutherland":
        transport = tm.SutherlandTransport(
            As=float(transp.get("As", 1.458e-6)),
            Ts=float(transp.get("Ts", 110.4)))
    elif transport_word in ("polynomial", "powerLaw"):
        transport = tm.PowerLawTransport(mu0=float(transp.get("mu0", 1.8e-5)),
                                         T0=float(transp.get("T0", 273.0)),
                                         k=float(transp.get("k", 0.7)))
    else:
        transport = tm.ConstTransport(mu0=float(transp.get("mu", 0.0)))
    W = float(spec.get("molWeight", 28.96))
    return tm.PerfectGasThermo(
        R=_RR / W, Cp=float(thermodyn.get("Cp", 1004.5)),
        transport=transport,
        Pr=float(transp.get("Pr", 1.0)))


def build_case(case_dir: str, device="cuda", dtype=torch.float32):
    """Full case ingestion: blockMeshDict + system/constant dicts + `0/`
    (or the start time's) field files -> (solver, initial state), with the
    mesh and state in `dtype` on `device`: the card by default (a
    RuntimeError where there is none; pass device="cpu" for the CPU).
    Dispatches on controlDict `application`."""
    from .foam_fields import load_block_mesh, load_initial_fields
    from ..solvers.qgd import QGDFoam

    device = checked_device(device)
    cfg = load_case(case_dir)
    control = cfg.get("controlDict", {})
    app = str(control.get("application", "QGDFoam"))
    if app in _NOT_PORTED_APPS:
        raise NotImplementedError(
            f"application {app!r} is not in the PyTorch port yet: "
            f"{_NOT_PORTED_APPS[app]}")
    if app not in ("QGDFoam", "rhoQGDFoam"):
        raise ValueError(f"unsupported application {app!r}")
    mesh, patch_map, kept_axes = load_block_mesh(case_dir, dtype=dtype,
                                                 device=device)
    time_name, t0 = start_time(case_dir, control)
    fields = load_initial_fields(case_dir, mesh, patch_map, kept_axes,
                                 time_name=time_name)
    if time_name != "0":
        # resume semantics: fields absent from the restart directory fall
        # back to their 0/ definitions
        base = load_initial_fields(case_dir, mesh, patch_map, kept_axes)
        for k, v in base.items():
            fields.setdefault(k, v)
    if mesh.solid is not None and app != "QGDFoam":
        # as the JAX package: the stairstep walls are QGDFoam's (and the
        # QHD family's), not rhoQGDFoam's
        raise NotImplementedError(
            "dead-cell (L-shaped multi-block) meshes are supported by the "
            "stairstep-wall QGD/QHD families only; got " + app)

    def fld(name):
        if name not in fields:
            raise ValueError(f"case {case_dir} is missing 0/{name}")
        arr, bcs = fields[name]
        return mesh.tensor(arr), bcs

    U0, bc_U = fld("U")
    p0, bc_p = fld("p")
    T0, bc_T = fld("T")
    kw = dict(mesh=mesh, bc_U=bc_U, bc_p=bc_p, bc_T=bc_T,
              time=cfg.get("time_controls", TimeControls()),
              implicit_diffusion=cfg.get("implicit_diffusion", False),
              fvsc_scheme=fvsc_schemes(cfg.get("fvSchemes", {})))
    if "thermophysicalProperties" in cfg:
        kw["thermo"] = build_foam_thermo(cfg["thermophysicalProperties"])
        kw["tau_model"] = cfg["tau_model"]
    solver = QGDFoam(**kw)
    return solver, solver.init(p0=p0, T0=T0, U0=U0, t0=t0)


def start_time(case_dir: str, control: dict):
    """controlDict startFrom semantics -> (time directory name, t0).

    `latestTime` scans the case for numeric time directories and resumes
    from the largest; `startTime` / `firstTime` read the named start time
    (default 0).
    """
    mode = str(control.get("startFrom", "startTime"))
    if isinstance(mode, list):
        mode = str(mode[0])
    if mode == "latestTime":
        best = None
        for name in os.listdir(case_dir):
            if not os.path.isdir(os.path.join(case_dir, name)):
                continue
            try:
                tval = float(name)
            except ValueError:
                continue
            if best is None or tval > best[1]:
                best = (name, tval)
        if best is not None:
            return best
        return "0", 0.0
    if mode == "firstTime":
        return "0", 0.0
    t0 = float(control.get("startTime", 0.0))
    # OpenFOAM writes integral times without a trailing .0
    name = str(int(t0)) if t0 == int(t0) else repr(t0)
    return name, t0


def load_case(case_dir: str) -> dict:
    """Read the standard case files that exist under `case_dir` and return
    {controlDict, fvSchemes, thermophysicalProperties, time_controls, fvsc,
    tau_model, implicit_diffusion}."""
    out = {}
    paths = {
        "controlDict": "system/controlDict",
        "fvSchemes": "system/fvSchemes",
        "thermophysicalProperties": "constant/thermophysicalProperties",
    }
    for key, rel in paths.items():
        p = os.path.join(case_dir, rel)
        if os.path.exists(p):
            out[key] = foamdict.parse_file(p)
    if "controlDict" in out:
        out["time_controls"] = time_controls(out["controlDict"])
    if "fvSchemes" in out:
        out["fvsc"] = fvsc_scheme(out["fvSchemes"])
    if "thermophysicalProperties" in out:
        out["tau_model"] = tau_model(out["thermophysicalProperties"])
        out["implicit_diffusion"] = implicit_diffusion(
            out["thermophysicalProperties"])
    return out
