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
family (QHDFoam, SRFQHDFoam with constant/SRFProperties, mulesQHDFoam,
QHDDyMFoam with constant/dynamicMeshDict; constant/g for the gravity),
scalarTransportQHDFoam and interQHDFoam (constant/transportProperties, the
alpha.<phase1> field and its contact-angle walls, cAlpha from
system/fvSolution), particlesQGDFoam and particlesQHDFoam (a cloud from
constant/thermoCloud1Properties), and reactingLagrangianQGDFoam (the
species list, per-specie dicts and ScNumbers of thermophysicalProperties,
the reactions and the TDAC/ISATDevice words of chemistryProperties,
combustionProperties, per-specie 0/ fields with the Ydefault fallback, and
an evaporating cloud from reactingCloud1Properties), in 2D and 3D, with the
hePsi (perfect gas, hConst or janaf) and heRho (perfectGas, stiffenedGas
or rhoConst) thermo words and const, sutherland, polynomial (read as
powerLaw, as the JAX package does) or powerLaw transport, on wedge meshes
and on multi-block unions with dead cells (stairstep solids) where the JAX
package takes them.
"""
from __future__ import annotations

import math
import os

import numpy as np
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

_QGD_APPS = ("QGDFoam", "rhoQGDFoam", "zQGDFoam")
_QHD_APPS = ("QHDFoam", "SRFQHDFoam", "mulesQHDFoam")
_CLOUD_APPS = ("particlesQGDFoam", "particlesQHDFoam")
_APPS = _QGD_APPS + _QHD_APPS + _CLOUD_APPS + (
    "QHDDyMFoam", "interQHDFoam", "scalarTransportQHDFoam",
    "reactingLagrangianQGDFoam")
# the applications that take stairstep solids and wedges (their solvers
# carry the mirror walls and the hoop sources), as in the JAX package
_SOLID_APPS = ("QGDFoam", "particlesQGDFoam") + _QHD_APPS
_WEDGE_APPS = ("QGDFoam", "rhoQGDFoam", "scalarTransportQHDFoam",
               "QHDDyMFoam", "interQHDFoam") + _QHD_APPS + _CLOUD_APPS


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
    dtype None is float32 for the QGD solvers (particlesQGDFoam
    included) and float64 for the QHD family (QHDDyMFoam, interQHDFoam
    and particlesQHDFoam included) and scalar transport, whose CG solves
    stop at cg_tol 1e-8 of the rhs, below float32's resolution, and for
    reactingLagrangianQGDFoam, whose DeviceISAT keys quantize log T, log p
    and Y to the table's tolerance (float32's rounding of a log moves a
    key across a quantum between devices).  Dispatches on controlDict
    `application`."""
    from .foam_fields import load_block_mesh, load_initial_fields

    device = checked_device(device)
    cfg = load_case(case_dir)
    control = cfg.get("controlDict", {})
    app = str(control.get("application", "QGDFoam"))
    if app not in _APPS:
        raise ValueError(f"unsupported application {app!r}")
    if dtype is None:
        dtype = (torch.float32 if app in _QGD_APPS + ("particlesQGDFoam",)
                 else torch.float64)
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
    fvsc = fvsc_schemes(cfg.get("fvSchemes", {}))
    U0, bc_U = fld("U")
    g = _read_gravity(case_dir, kept_axes)
    if app == "interQHDFoam":
        from ..solvers.inter_qhd import InterQHDFoam

        props, phase1 = _read_two_phase(cfg.get("transportProperties", {}),
                                        case_dir)
        alpha_name = next((n for n in (f"alpha.{phase1}", "alpha1",
                                       "alpha.water", "alpha")
                           if n in fields), None)
        if alpha_name is None:
            raise ValueError(
                f"case {case_dir} has no alpha field for phase {phase1!r}")
        a0, bc_a = fld(alpha_name)
        kw.update(props=props, bc_U=bc_U, bc_alpha=bc_a, fvsc_scheme=fvsc,
                  implicit_diffusion=cfg.get("implicit_diffusion", True),
                  alpha_field=alpha_name)
        if g is not None:
            kw["g"] = g
        p0 = None
        if "p" in fields or "p_rgh" in fields:
            p0, kw["bc_p"] = fld("p" if "p" in fields else "p_rgh")
        angles = _read_contact_angles(case_dir, time_name, alpha_name,
                                      patch_map)
        if angles:
            kw["contact_angles"] = angles
        solver = InterQHDFoam(**kw)
        return solver, solver.init(U0=U0, alpha0=a0, p0=p0, t0=t0)

    if app == "reactingLagrangianQGDFoam":
        return _build_reacting(case_dir, cfg, fields, fld, kw, fvsc, U0,
                               bc_U, kept_axes, t0)

    if "thermophysicalProperties" in cfg:
        kw["thermo"] = build_foam_thermo(cfg["thermophysicalProperties"])
        kw["tau_model"] = cfg["tau_model"]
    T0, bc_T = fld("T")
    if app in _CLOUD_APPS:
        return _build_cloud_app(app, case_dir, cfg, fields, fld, kw, fvsc,
                                U0, bc_U, T0, bc_T, g, kept_axes, t0)
    if app == "scalarTransportQHDFoam":
        from ..solvers.scalar_transport import ScalarTransportQHD

        solver = ScalarTransportQHD(bc_T=bc_T, bc_U=bc_U, **kw)
        return solver, solver.init(T0=T0, U0=U0, t0=t0)

    if app in _QHD_APPS + ("QHDDyMFoam",):
        from ..solvers.qhd import QHDFoam

        kw.update(bc_U=bc_U, bc_T=bc_T, fvsc_scheme=fvsc,
                  implicit_diffusion=cfg.get("implicit_diffusion", True))
        p0 = None
        if "p" in fields:
            p0, kw["bc_p"] = fld("p")
        if g is not None:
            kw["g"] = g
        if app == "mulesQHDFoam":
            kw["t_equation"] = "mules"
        if app == "SRFQHDFoam":
            omega = _read_srf_omega(case_dir)
            if omega is not None:
                kw["omega"] = omega
        if app == "QHDDyMFoam":
            kw.update(_read_dynamic_mesh(case_dir, mesh.ndim))
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


def _inactive_placeholder(st, has_parcels):
    """A case without an injection block holds one placeholder parcel,
    deactivated here (or a two-way cloud would deposit phantom drag and
    heat into its cell)."""
    if has_parcels:
        return st
    return st._replace(cloud=st.cloud._replace(active=st.cloud.active * 0))


def _build_cloud_app(app, case_dir, cfg, fields, fld, kw, fvsc, U0, bc_U,
                     T0, bc_T, g, kept_axes, t0):
    """particlesQGDFoam (QGDFoam with a two-way cloud) or
    particlesQHDFoam (QHDFoam with a one-way cloud)."""
    from ..solvers.particles import (ParticlesQGDFoam, ParticlesQHDFoam,
                                     ThermoCloud)

    cloud_kw, parcels, has_parcels, _ = _read_cloud(case_dir, kept_axes)
    kw.update(bc_U=bc_U, bc_T=bc_T, fvsc_scheme=fvsc)
    if app == "particlesQGDFoam":
        from ..solvers.qgd import QGDFoam

        p0, bc_p = fld("p")
        fluid = QGDFoam(bc_p=bc_p, implicit_diffusion=cfg.get(
            "implicit_diffusion", False), **kw)
        solver = ParticlesQGDFoam(fluid=fluid, cloud=ThermoCloud(
            two_way=True, **cloud_kw))
        st = solver.init(p0=p0, T0=T0, U0=U0, t0=t0, **parcels)
        return solver, _inactive_placeholder(st, has_parcels)
    from ..solvers.qhd import QHDFoam

    if "p" in fields:
        kw["bc_p"] = fields["p"][1]
    if g is not None:
        kw["g"] = g
    fluid = QHDFoam(implicit_diffusion=cfg.get("implicit_diffusion", True),
                    **kw)
    solver = ParticlesQHDFoam(fluid=fluid, cloud=ThermoCloud(
        two_way=False, **cloud_kw))
    st = solver.init(U0=U0, T0=T0, t0=t0, **parcels)
    return solver, _inactive_placeholder(st, has_parcels)


def _build_reacting(case_dir, cfg, fields, fld, kw, fvsc, U0, bc_U,
                    kept_axes, t0):
    """reactingLagrangianQGDFoam: the reacting QGD solver, with the
    reacting cloud when the case has a cloud dictionary (the reacting
    cloud's first; the reference's createClouds.H reads
    reactingCloud1Properties for this solver), without one the Eulerian
    core alone."""
    from ..solvers.reacting import ReactingQGDFoam

    mesh = kw["mesh"]
    thermo_props = cfg.get("thermophysicalProperties", {})
    mix = build_reaction_thermo(thermo_props, case_dir)
    combustion, chem_solver, tabulation = _read_chemistry(case_dir, mix)
    p0, bc_p = fld("p")
    T0, bc_T = fld("T")
    Y0, bc_Y = _species_fields(fields, mix)
    if "tau_model" in cfg:
        kw["tau_model"] = cfg["tau_model"]
    fluid = ReactingQGDFoam(
        mixture=mix, combustion=combustion, chemistry_solver=chem_solver,
        tabulation=tabulation, bc_U=bc_U, bc_p=bc_p, bc_T=bc_T, bc_Y=bc_Y,
        implicit_diffusion=cfg.get("implicit_diffusion", False),
        fvsc_scheme=fvsc, **kw)
    Y0 = mesh.tensor(Y0)
    cloud_kw, parcels, has_parcels, cloud_props = _read_cloud(
        case_dir, kept_axes,
        names=("reactingCloud1Properties", "reactingCloudProperties",
               "cloudProperties", "thermoCloud1Properties",
               "thermoCloudProperties"))
    if not cloud_props:
        return fluid, fluid.init(p0=p0, T0=T0, U0=U0, Y0=Y0, t0=t0)
    from ..solvers.particles import ReactingCloud, ReactingLagrangianQGDFoam

    # evaporation maps onto the d^2-law
    evap = cloud_props.get("evaporation", {})
    sp_word = str(evap.get("specie", mix.species[0].name))
    names = [sp.name for sp in mix.species]
    cloud = ReactingCloud(
        two_way=True,
        evap_specie=names.index(sp_word) if sp_word in names else 0,
        K_evap=float(evap.get("K", 0.0)),
        latent_heat=float(evap.get("latentHeat", 0.0)), **cloud_kw)
    solver = ReactingLagrangianQGDFoam(fluid=fluid, cloud=cloud)
    st = solver.init(p0=p0, T0=T0, U0=U0, Y0=Y0, t0=t0, **parcels)
    return solver, _inactive_placeholder(st, has_parcels)


def _read_cloud(case_dir: str, kept_axes,
                names=("thermoCloud1Properties", "thermoCloudProperties",
                       "cloudProperties", "reactingCloud1Properties")):
    """constant/*CloudProperties (the first of `names` present) ->
    (ThermoCloud kwargs, initial parcels as numpy arrays,
    has_real_parcels, the raw dict).  Read: constantProperties {rho0;
    Cp0;} and a manual-injection block `initialParcels { positions
    ((x y z) ...); U0 (ux uy uz); T0; d0; }`.  Without an injection block
    the parcels are one placeholder the caller deactivates."""
    props = {}
    for name in names:
        p = os.path.join(case_dir, "constant", name)
        if os.path.exists(p):
            props = foamdict.parse_file(p)
            break
    const = props.get("constantProperties", {})
    kw = {}
    if "rho0" in const:
        kw["rho_p"] = float(const["rho0"])
    if "Cp0" in const:
        kw["Cp_p"] = float(const["Cp0"])
    inj = props.get("initialParcels", {})
    pos = inj.get("positions", [])
    if pos and not isinstance(pos[0], list):
        pos = [pos]
    n = max(len(pos), 1)
    xyz = (np.asarray([[float(c) for c in q] for q in pos]) if pos
           else np.zeros((1, 3)))
    u0 = inj.get("U0", [0.0, 0.0, 0.0])
    parcels = {
        "x_p": np.stack([xyz[:, ax] for ax in kept_axes]),
        "u_p": np.stack([np.full(n, float(u0[ax])) for ax in kept_axes]),
        "T_p": np.full(n, float(inj.get("T0", 300.0))),
        "d_p": np.full(n, float(inj.get("d0", 1e-4)))}
    return kw, parcels, bool(pos), props


def build_reaction_thermo(thermo_props: dict, case_dir: str):
    """thermophysicalProperties (psiQGDReactionThermo style) ->
    MixtureThermo: the `species` word list, per-specie {specie,
    thermodynamics, transport} sub-dicts (hConst Cp and Hf, or janaf
    coefficients), `inertSpecie` and the `ScNumbers` list of (name Sc)
    pairs; the first specie's transport `mu` and `Pr` for the mixture."""
    from ..physics import thermo as tm
    from ..physics.species import MixtureThermo, Specie

    d = thermo_props
    names = [str(sp) for sp in d.get("species", [])]
    if not names:
        raise ValueError(f"reacting case {case_dir}: thermophysicalProperties"
                         " has no `species` list")
    inert = str(d.get("inertSpecie", names[-1]))
    sc_map = {str(pair[0]): float(pair[1])
              for pair in d.get("ScNumbers", [])
              if isinstance(pair, list) and len(pair) == 2}
    mix_transport = None
    mix_pr = 0.7
    species = []
    for name in names:
        sub = d.get(name, {})
        spec = sub.get("specie", {})
        thermodyn = sub.get("thermodynamics", {})
        transp = sub.get("transport", {})
        W = float(spec.get("molWeight", 28.96))
        janaf = None
        if "highCpCoeffs" in thermodyn:
            janaf = tm.JanafThermo(
                R=_RR / W,
                low=tuple(float(x) for x in thermodyn.get("lowCpCoeffs", [])),
                high=tuple(float(x)
                           for x in thermodyn.get("highCpCoeffs", [])),
                Tcommon=float(thermodyn.get("Tcommon", 1000.0)))
        species.append(Specie(
            name=name, W=W, Cp=float(thermodyn.get("Cp", 1000.0)),
            hf=float(thermodyn.get("Hf", thermodyn.get("hf", 0.0))),
            janaf=janaf, Sc=sc_map.get(name, 1.0)))
        if mix_transport is None and "mu" in transp:
            mix_transport = tm.ConstTransport(mu0=float(transp["mu"]))
            mix_pr = float(transp.get("Pr", 0.7))
    return MixtureThermo(
        species=tuple(species),
        inert_index=names.index(inert) if inert in names else -1,
        transport=mix_transport or tm.ConstTransport(1.8e-5), Pr=mix_pr)


def _parse_reaction_side(side: str, name_to_idx: dict):
    """'F + 2O2' -> ((index of F, 1.0), (index of O2, 2.0)); words that
    name no specie (a third body's M) are dropped."""
    out = []
    for term in side.split("+"):
        term = term.strip()
        if not term:
            continue
        i = 0
        while i < len(term) and (term[i].isdigit() or term[i] == "."):
            i += 1
        coeff = float(term[:i]) if i else 1.0
        sp = term[i:].strip()
        if sp in name_to_idx:
            out.append((name_to_idx[sp], coeff))
    return tuple(out)


def _read_reactions(src: dict, name_to_idx: dict) -> list:
    """A `reactions` dict -> Reactions: the [ir]reversible[ThirdBody]
    ArrheniusReaction words, `reaction "lhs = rhs"`, A, beta, Ta and the
    third-body `coeffs ((name eff) ...)` list."""
    from ..physics.chemistry import Reaction

    out = []
    for sub in src.values():
        if not isinstance(sub, dict) or "reaction" not in sub:
            continue
        eq = sub["reaction"]
        if isinstance(eq, list):
            eq = " ".join(str(x) for x in eq)
        lhs_s, _, rhs_s = str(eq).strip('"').partition("=")
        word = sub.get("type", "irreversibleArrheniusReaction")
        word = str(word[0] if isinstance(word, list) else word)
        effs = []
        raw_eff = sub.get("coeffs", sub.get("efficiencies", []))
        if isinstance(raw_eff, list):
            pairs = (raw_eff if raw_eff and isinstance(raw_eff[0], list)
                     else [raw_eff])
            effs = [(name_to_idx[str(pr[0])], float(pr[1])) for pr in pairs
                    if isinstance(pr, list) and len(pr) == 2
                    and str(pr[0]) in name_to_idx]
        out.append(Reaction(
            lhs=_parse_reaction_side(lhs_s, name_to_idx),
            rhs=_parse_reaction_side(rhs_s, name_to_idx),
            A=float(sub.get("A", 1.0)), beta=float(sub.get("beta", 0.0)),
            Ta=float(sub.get("Ta", 0.0)),
            reversible=word.lower().startswith("reversible"),
            third_body="thirdbody" in word.lower(),
            efficiencies=tuple(effs)))
    return out


def _read_chemistry(case_dir: str, mix):
    """constant/chemistryProperties (and constant/reactions) with
    constant/combustionProperties -> (combustion model, chemistry solver,
    DeviceISAT or None).  A TDAC method (or an active reduction or
    tabulation sub-dict) builds a TDACChemistrySolver around the named
    base solver, with DRG for an active reduction; an active tabulation is
    a DeviceISAT (`method ISATDevice`, and the reference's ISAT word
    too)."""
    from ..physics import chemistry as chem

    name_to_idx = {sp.name: i for i, sp in enumerate(mix.species)}
    chem_props = {}
    p = os.path.join(case_dir, "constant", "chemistryProperties")
    if os.path.exists(p):
        chem_props = foamdict.parse_file(p)
    reactions = _read_reactions(chem_props.get("reactions", {}),
                                name_to_idx)
    rp = os.path.join(case_dir, "constant", "reactions")
    if os.path.exists(rp):
        reactions += _read_reactions(
            foamdict.parse_file(rp).get("reactions", {}), name_to_idx)

    comb_word = "laminar" if reactions else "none"
    cp = os.path.join(case_dir, "constant", "combustionProperties")
    if os.path.exists(cp):
        cd = foamdict.parse_file(cp)
        w = cd.get("combustionModel", comb_word)
        comb_word = str(w[0] if isinstance(w, list) else w).split("<")[0]
        if not bool(cd.get("active", True)):
            comb_word = "none"
    comb_kw = {}
    if comb_word in ("laminar", "PaSR", "EDC", "zoneCombustion",
                     "infinitelyFastChemistry"):
        comb_kw["reactions"] = tuple(reactions)
    try:
        combustion = create("combustion", comb_word, **comb_kw)
    except TypeError:
        # a family whose constructor takes no reaction list
        combustion = create("combustion", comb_word)
    if not bool(chem_props.get("chemistry", True)):
        combustion = chem.NoCombustion()

    ctype = chem_props.get("chemistryType", {})
    solver_word = str(ctype.get("solver", "EulerImplicit"))
    method = str(ctype.get("method", "standard"))
    base = create("chemistrySolver",
                  solver_word if solver_word != "TDAC" else "EulerImplicit")
    tab_sub = chem_props.get("tabulation", {})
    red_sub = chem_props.get("reduction", {})
    if not (method == "TDAC" or tab_sub or red_sub):
        return combustion, base, None
    reduction = tabulation = None
    if bool(red_sub.get("active", False)):
        targets = [str(sp) for sp in red_sub.get("targetSpecies",
                                                 red_sub.get("species", []))]
        tgt = tuple(name_to_idx[sp] for sp in targets if sp in name_to_idx)
        if tgt:
            reduction = chem.DRG(
                targets=tgt, threshold=float(red_sub.get("tolerance", 0.01)))
    if bool(tab_sub.get("active", False)):
        tabulation = chem.DeviceISAT(tol=float(tab_sub.get("tolerance",
                                                           1e-3)))
    return (combustion, chem.TDACChemistrySolver(base=base,
                                                 reduction=reduction),
            tabulation)


def _species_fields(fields: dict, mix):
    """Per-specie 0/<name> fields, 0/Ydefault for the rest -> (Y0 as a
    (n_species, *cells) numpy stack, per-specie BC tuple)."""
    default = fields.get("Ydefault")
    arrs, bcs = [], []
    for sp in mix.species:
        if sp.name in fields:
            a, b = fields[sp.name]
        elif default is not None:
            a, b = default
        else:
            raise ValueError(f"missing 0/{sp.name} field (and no Ydefault)")
        arrs.append(np.asarray(a))
        bcs.append(b)
    return np.stack(arrs), tuple(bcs)


def dynamic_mesh_kwargs(d: dict, ndim: int) -> dict:
    """QHDDyMFoam's motion from a dynamicMeshDict (its words at the top
    level or in a coeffs sub-dict), as QHDFoam fields with torch motion
    callables (the contract of `solvers.qhd_dym`):
      solver uniformVelocity;  velocity (ux uy uz);   // mesh_velocity
      solver uniformDilation;  rate (rx ry rz);       // s_a(t) = 1 + r_a t
      oscillatingLinearMotionCoeffs { amplitude (ax ay az); omega w; }
        // x(t) = A sin(w t): mesh_velocity = A w cos(w t)
      checkMeshCourantNo yes;                         // check_mesh_courant
    velocity and rate may appear together; {} without a motion word."""
    sub = {}
    for k, v in d.items():
        if isinstance(v, dict):
            sub.update(v)
    sub.update({k: v for k, v in d.items() if not isinstance(v, dict)})
    kw = {}
    if "amplitude" in sub and "omega" in sub:
        amp = tuple(float(x) for x in sub["amplitude"])[:ndim]
        om = float(sub["omega"])

        def mesh_velocity_osc(t, _a=amp, _w=om):
            c = _w * torch.cos(_w * torch.as_tensor(t))
            return tuple(a * c for a in _a)

        kw["mesh_velocity"] = mesh_velocity_osc
    if "velocity" in sub:
        vel = tuple(float(x) for x in sub["velocity"])[:ndim]
        kw["mesh_velocity"] = lambda t, _v=vel: _v
    if "rate" in sub:
        rate = tuple(float(x) for x in sub["rate"])[:ndim]
        kw["mesh_scale"] = lambda t, _r=rate: tuple(1.0 + r * t for r in _r)
    if kw:
        kw["check_mesh_courant"] = bool(sub.get("checkMeshCourantNo", False))
    return kw


def _read_dynamic_mesh(case_dir: str, ndim: int) -> dict:
    """constant/dynamicMeshDict -> QHDFoam motion fields
    (`dynamic_mesh_kwargs`), {} without the file."""
    p = os.path.join(case_dir, "constant", "dynamicMeshDict")
    if not os.path.exists(p):
        return {}
    return dynamic_mesh_kwargs(foamdict.parse_file(p), ndim)


def _read_contact_angles(case_dir: str, time_name: str, alpha_name: str,
                         patch_map) -> dict:
    """The wall contact angles of the alpha field's boundaryField
    (constant/dynamicAlphaContactAngle words, degrees in the dict, radians
    in `ContactAngle`): {(axis, side): ContactAngle}.  (The field reader
    maps these words to zeroGradient, so the file is read again here for
    their parameters.)"""
    from ..physics.twophase import ContactAngle

    path = os.path.join(case_dir, time_name, alpha_name)
    if not os.path.exists(path):
        path = os.path.join(case_dir, "0", alpha_name)
        if not os.path.exists(path):
            return {}
    out = {}
    for name, entry in foamdict.parse_file(path).get(
            "boundaryField", {}).items():
        if name not in patch_map or not isinstance(entry, dict):
            continue
        word = entry.get("type", "")
        if isinstance(word, list):
            word = word[0]
        if "AlphaContactAngle" not in str(word):
            continue
        rad = math.radians
        ca = ContactAngle(theta0=rad(float(entry.get("theta0", 90.0))),
                          uTheta=float(entry.get("uTheta", 0.0)),
                          thetaA=rad(float(entry.get("thetaA", 0.0))),
                          thetaR=rad(float(entry.get("thetaR", 0.0))))
        for axis, side in patch_map[name][1]:
            out[(axis, side)] = ca
    return out


def _read_two_phase(transport_props: dict, case_dir: str):
    """constant/transportProperties -> (TwoPhaseProperties, phase1 name):
    the phase pair (`phases (water air)`), each phase's nu/rho sub-dict,
    the per-phase relaxation times tau<phase> (or Tau<phase>), sigma, and
    cAlpha from system/fvSolution's alpha solver dict."""
    from ..physics.twophase import TwoPhaseProperties

    d = transport_props
    phases = d.get("phases", ["water", "air"])
    if not isinstance(phases, list):
        phases = [str(phases), "air"]
    if len(phases) < 2:
        raise ValueError(
            f"case {case_dir}: transportProperties `phases {tuple(phases)}` "
            "must name two phases (e.g. `phases (water air);`)")
    p1, p2 = str(phases[0]), str(phases[1])

    def last(v):
        # dimensionedScalar entries parse as [word, dims..., value]
        return float(v[-1] if isinstance(v, list) else v)

    def phase(name, default_nu, default_rho):
        sub = d.get(name, {})
        return (last(sub.get("nu", default_nu)),
                last(sub.get("rho", default_rho)))

    nu1, rho1 = phase(p1, 1e-6, 1000.0)
    nu2, rho2 = phase(p2, 1.48e-5, 1.0)
    tau1 = last(d.get("tau" + p1, d.get("Tau" + p1, 1e-5)))
    tau2 = last(d.get("tau" + p2, d.get("Tau" + p2, tau1)))
    c_alpha = 1.0
    fvsol = os.path.join(case_dir, "system", "fvSolution")
    if os.path.exists(fvsol):
        for key, sub in foamdict.parse_file(fvsol).get("solvers",
                                                       {}).items():
            if key.startswith("alpha") and isinstance(sub, dict) \
                    and "cAlpha" in sub:
                c_alpha = float(sub["cAlpha"])
    return TwoPhaseProperties(rho1=rho1, rho2=rho2, nu1=nu1, nu2=nu2,
                              tau1=tau1, tau2=tau2,
                              sigma=last(d.get("sigma", 0.0)),
                              c_alpha=c_alpha), p1


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
        "transportProperties": "constant/transportProperties",
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
