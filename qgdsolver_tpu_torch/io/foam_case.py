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

`build_case` takes `application` QGDFoam, rhoQGDFoam and zQGDFoam, the QHD
family (QHDFoam, SRFQHDFoam with constant/SRFProperties, mulesQHDFoam;
constant/g for the gravity) and scalarTransportQHDFoam, in 2D and 3D, with
the hePsi (perfect gas, hConst or janaf) and heRho (perfectGas,
stiffenedGas or rhoConst) thermo words and const, sutherland, polynomial
(read as powerLaw, as the JAX package does) or powerLaw transport, on
wedge meshes and on multi-block unions with dead cells (stairstep solids)
where the JAX package takes them; QHDDyMFoam, interQHDFoam and the
Lagrangian and reacting applications raise NotImplementedError naming the
ROADMAP item they wait for.
"""
from __future__ import annotations

import math
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
    "QHDDyMFoam": "ROADMAP queue 1, item 8b (QHDDyMFoam: moving meshes)",
    "interQHDFoam": "ROADMAP queue 1, item 9",
    "particlesQGDFoam": "ROADMAP queue 1, item 10",
    "particlesQHDFoam": "ROADMAP queue 1, item 10",
    "reactingLagrangianQGDFoam": "ROADMAP queue 1, item 10",
}
_QGD_APPS = ("QGDFoam", "rhoQGDFoam", "zQGDFoam")
_QHD_APPS = ("QHDFoam", "SRFQHDFoam", "mulesQHDFoam")
# the applications that take stairstep solids and wedges (their solvers
# carry the mirror walls and the hoop sources), as in the JAX package
_SOLID_APPS = ("QGDFoam",) + _QHD_APPS
_WEDGE_APPS = ("QGDFoam", "rhoQGDFoam", "scalarTransportQHDFoam") \
    + _QHD_APPS


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
    thermo instance: hePsiQGDThermo with hConst (`PerfectGasThermo`) or
    janaf (`JanafPerfectGasThermo`), heRhoQGDThermo with rhoConst
    (`RhoConstThermo`, beta from the top level or the transport dict) or a
    `RhoThermo` of perfectGas or stiffenedGas (p = rho*R*T - pInf, pInf
    from the equationOfState dict), each with const, sutherland or
    powerLaw transport.  (The JAX package reads stiffenedGas as
    perfectGas.)"""
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
    eosd = mix.get("equationOfState", {})

    R = _RR / float(spec.get("molWeight", 28.96))
    Pr = float(transp.get("Pr", 1.0))
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

    if caloric == "janaf":
        j = tm.JanafThermo(
            R=R, low=tuple(float(x) for x in thermodyn.get("lowCpCoeffs", [])),
            high=tuple(float(x)
                       for x in thermodyn.get("highCpCoeffs", [])),
            Tcommon=float(thermodyn.get("Tcommon", 1000.0)))
        return tm.JanafPerfectGasThermo(janaf=j, transport=transport, Pr=Pr)

    Cp = float(thermodyn.get("Cp", 1004.5))
    if word.startswith("heRho") or word.startswith("rho"):
        if eos_word == "rhoConst":
            beta = thermo_props.get("beta", transp.get("beta", 0.0))
            return tm.RhoConstThermo(
                rho0=float(eosd.get("rho", eosd.get("rho0", 1000.0))), Cp=Cp,
                mu0=float(transp.get("mu", 1e-3)), Pr=Pr,
                beta=float(beta or 0.0))
        if eos_word == "stiffenedGas":
            eos = tm.StiffenedGasEoS(
                R=R, p_inf=float(eosd.get("pInf", eosd.get("p_inf", 0.0))))
        else:
            eos = tm.PerfectGasEoS(R=R)
        return tm.RhoThermo(eos=eos, Cp=Cp, R=R, transport=transport, Pr=Pr)
    return tm.PerfectGasThermo(R=R, Cp=Cp, transport=transport, Pr=Pr)


def build_case(case_dir: str, device="cuda", dtype=None):
    """Full case ingestion: blockMeshDict + system/constant dicts + `0/`
    (or the start time's) field files -> (solver, initial state), with the
    mesh and state in `dtype` on `device`: the card by default (a
    RuntimeError where there is none; pass device="cpu" for the CPU).
    dtype None is float32 for the QGD solvers and float64 for the QHD
    family and scalar transport, whose CG solves stop at cg_tol 1e-8 of
    the rhs, below float32's resolution.  Dispatches on controlDict
    `application`."""
    from .foam_fields import load_block_mesh, load_initial_fields

    device = checked_device(device)
    cfg = load_case(case_dir)
    control = cfg.get("controlDict", {})
    app = str(control.get("application", "QGDFoam"))
    if app in _NOT_PORTED_APPS:
        raise NotImplementedError(
            f"application {app!r} is not in the PyTorch port yet: "
            f"{_NOT_PORTED_APPS[app]}")
    if app not in _QGD_APPS + _QHD_APPS + ("scalarTransportQHDFoam",):
        raise ValueError(f"unsupported application {app!r}")
    if dtype is None:
        dtype = torch.float32 if app in _QGD_APPS else torch.float64
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
    if mesh.solid is not None and app not in _SOLID_APPS:
        raise NotImplementedError(
            "dead-cell (L-shaped multi-block) meshes are supported by the "
            "stairstep-wall QGD/QHD families only; got " + app)
    if mesh.axisymmetric and app not in _WEDGE_APPS:
        # only solvers with the radial hoop sources may run wedges
        raise NotImplementedError(
            f"wedge (axisymmetric) meshes are not supported by {app}")

    def fld(name):
        if name not in fields:
            raise ValueError(f"case {case_dir} is missing 0/{name}")
        arr, bcs = fields[name]
        return mesh.tensor(arr), bcs

    kw = dict(mesh=mesh, time=cfg.get("time_controls", TimeControls()))
    if "thermophysicalProperties" in cfg:
        kw["thermo"] = build_foam_thermo(cfg["thermophysicalProperties"])
        kw["tau_model"] = cfg["tau_model"]
    U0, bc_U = fld("U")
    T0, bc_T = fld("T")
    if app == "scalarTransportQHDFoam":
        from ..solvers.scalar_transport import ScalarTransportQHD

        solver = ScalarTransportQHD(bc_T=bc_T, bc_U=bc_U, **kw)
        return solver, solver.init(T0=T0, U0=U0, t0=t0)

    fvsc = fvsc_schemes(cfg.get("fvSchemes", {}))
    if app in _QHD_APPS:
        from ..solvers.qhd import QHDFoam

        kw.update(bc_U=bc_U, bc_T=bc_T, fvsc_scheme=fvsc,
                  implicit_diffusion=cfg.get("implicit_diffusion", True))
        p0 = None
        if "p" in fields:
            p0, kw["bc_p"] = fld("p")
        g = _read_gravity(case_dir, kept_axes)
        if g is not None:
            kw["g"] = g
        if app == "mulesQHDFoam":
            kw["t_equation"] = "mules"
        if app == "SRFQHDFoam":
            omega = _read_srf_omega(case_dir)
            if omega is not None:
                kw["omega"] = omega
        solver = QHDFoam(**kw)
        return solver, solver.init(U0=U0, T0=T0, p0=p0, t0=t0)

    from ..solvers.qgd import QGDFoam
    from ..solvers.zqgd import ZQGDFoam

    p0, bc_p = fld("p")
    cls = ZQGDFoam if app == "zQGDFoam" else QGDFoam
    solver = cls(bc_U=bc_U, bc_p=bc_p, bc_T=bc_T, fvsc_scheme=fvsc,
                 implicit_diffusion=cfg.get("implicit_diffusion", False),
                 **kw)
    return solver, solver.init(p0=p0, T0=T0, U0=U0, t0=t0)


def _read_gravity(case_dir: str, kept_axes):
    """constant/g's value on the mesh's kept axes, or None without the
    file."""
    p = os.path.join(case_dir, "constant", "g")
    if not os.path.exists(p):
        return None
    v = foamdict.parse_file(p).get("value", [0.0, 0.0, 0.0])
    return tuple(float(v[ax]) for ax in kept_axes)


def _read_srf_omega(case_dir: str):
    """constant/SRFProperties -> the rotation vector: rpmCoeffs.rpm about
    `axis`, or an `omega` vector (or scalar about z); None without the
    file or either entry."""
    p = os.path.join(case_dir, "constant", "SRFProperties")
    if not os.path.exists(p):
        return None
    d = foamdict.parse_file(p)
    sub = d.get("rpmCoeffs", {})
    if "rpm" in sub:
        w = float(sub["rpm"]) * 2.0 * math.pi / 60.0
        return tuple(w * float(a) for a in d.get("axis", [0.0, 0.0, 1.0]))
    if "omega" in d:
        v = d["omega"]
        if isinstance(v, list):
            return tuple(float(x) for x in v)
        return (0.0, 0.0, float(v))
    return None


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
