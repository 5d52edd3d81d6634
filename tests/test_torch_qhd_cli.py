"""The port's case ingestion and CLI for the QHD family and scalar
transport: generated OpenFOAM case directories of `application` QHDFoam
(the buoyant cavity, with constant/g), SRFQHDFoam (constant/SRFProperties),
mulesQHDFoam and scalarTransportQHDFoam (a cyclic box), run with
`python -m qgdsolver_tpu_torch <case> --device cpu` (`cli.run_case`): time
directories written, resumed from latestTime, `--devices 2x1` against one
rank.  And the applications and config words still to come raise
NotImplementedError naming their ROADMAP item.

Bounds: the port's CLI against the JAX package's on the QHDFoam case, and
two ranks against one, each field within 2*n*cg_tol of its max after n
steps (every step solves p, U and T to |r| <= cg_tol*|b|; the free
trajectories of the two runs may part by one CG iteration where a stop
test falls within round-off of its threshold).  Written fields carry
12 significant digits.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from qgdsolver_tpu import cli as jcli
from qgdsolver_tpu.io import foam_case as jfc
from qgdsolver_tpu_torch import cases, cli, interop
from qgdsolver_tpu_torch.core import config
from qgdsolver_tpu_torch.io import foam_case
from qgdsolver_tpu_torch.solvers.qhd import QHDFoam
from qgdsolver_tpu_torch.solvers.scalar_transport import ScalarTransportQHD

HEADER = "FoamFile { version 2.0; format ascii; class %s; object %s; }\n"

BLOCK_MESH = """convertToMeters 1;
vertices ((0 0 0) (1 0 0) (1 1 0) (0 1 0) (0 0 0.1) (1 0 0.1) (1 1 0.1)
          (0 1 0.1));
blocks (hex (0 1 2 3 4 5 6 7) (%d %d 1) simpleGrading (1 1 1));
edges ();
boundary
(
    left   { type %s; faces ((0 4 7 3)); }
    right  { type %s; faces ((1 2 6 5)); }
    bottom { type %s; faces ((0 1 5 4)); }
    top    { type %s; faces ((3 7 6 2)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
mergePatchPairs ();
"""

THERMO = """thermoType
{
    type heRhoQGDThermo; mixture pureMixture; transport const;
    thermo hConst; equationOfState rhoConst; specie specie;
    energy sensibleInternalEnergy;
}
mixture
{
    specie { molWeight 18.0; }
    equationOfState { rho 1; }
    thermodynamics { Cp 1000; Hf 0; }
    transport { mu %g; Pr %g; }
}
beta %g;
QGD { QGDCoeffs %s; %s }
"""


def _field(cls, name, internal, patches):
    body = "\n".join("    %s { %s }" % kv for kv in patches.items())
    return (HEADER % (cls, name) + "dimensions [0 0 0 0 0 0 0];\n"
            "internalField %s;\nboundaryField\n{\n%s\n"
            "    frontAndBack { type empty; }\n}\n" % (internal, body))


def _scalar_list(arr):
    flat = np.asarray(arr, dtype=np.float64).reshape(-1, order="F")
    return "nonuniform List<scalar>\n%d\n(\n%s\n)" % (
        flat.size, "\n".join("%.12g" % v for v in flat))


def write_case(root, app, shape=(16, 16)):
    """An OpenFOAM case directory of `app`: QHDFoam, SRFQHDFoam and
    mulesQHDFoam get the buoyant cavity of cases.buoyant_cavity (hot
    left and cold right walls at T = +-1, adiabatic no-slip y walls,
    constant/g = (0 -9.81 0), H2bynuQHD), scalarTransportQHDFoam a cyclic
    box with cases.scalar_box's Gaussian blob carried at U = (1, 0, 0).
    Writes every 10 steps."""
    case = os.path.join(root, app)
    for d in ("system", "constant", "0"):
        os.makedirs(os.path.join(case, d))

    def put(rel, text):
        with open(os.path.join(case, rel), "w") as f:
            f.write(text)

    scalar = app == "scalarTransportQHDFoam"
    walls = ("cyclic",) * 4 if scalar else ("wall",) * 4
    put("system/blockMeshDict", HEADER % ("dictionary", "blockMeshDict")
        + BLOCK_MESH % (shape + walls))
    put("system/controlDict", HEADER % ("dictionary", "controlDict")
        + "application %s;\nstartFrom startTime;\nstartTime 0;\n"
          "endTime 10;\ndeltaT %g;\nwriteControl timeStep;\n"
          "writeInterval 10;\nadjustTimeStep yes;\nmaxCo %g;\n"
          "maxDeltaT %g;\n" % ((app, 1e-4, 0.4, 0.01) if scalar
                               else (app, 1e-3, 0.3, 0.05)))
    put("system/fvSchemes", HEADER % ("dictionary", "fvSchemes")
        + "fvsc { default GaussVolPoint; }\n")
    if scalar:
        put("constant/thermophysicalProperties",
            HEADER % ("dictionary", "thermophysicalProperties")
            + THERMO % (1e-3, 1.0, 0.0, "HbyUQHD", "aQGD 0.2; UQGD 1;"))
        per = {p: "type cyclic;" for p in ("left", "right", "bottom", "top")}
        x = (np.arange(shape[0]) + 0.5) / shape[0]
        y = (np.arange(shape[1]) + 0.5) / shape[1]
        blob = np.exp(-((x[:, None] - 0.5) ** 2 + (y[None, :] - 0.5) ** 2)
                      / 0.01)
        put("0/T", _field("volScalarField", "T", _scalar_list(blob), per))
        put("0/U", _field("volVectorField", "U", "uniform (1 0 0)", per))
        return case
    put("constant/thermophysicalProperties",
        HEADER % ("dictionary", "thermophysicalProperties")
        + THERMO % (1e-2, 0.71, -3e-3, "H2bynuQHD", "aQGD 0.3;"))
    put("constant/g", HEADER % ("uniformDimensionedVectorField", "g")
        + "dimensions [0 1 -2 0 0 0 0];\nvalue (0 -9.81 0);\n")
    if app == "SRFQHDFoam":
        put("constant/SRFProperties", HEADER % ("dictionary", "SRFProperties")
            + "SRFModel rpm;\norigin (0 0 0);\naxis (0 0 1);\n"
              "rpmCoeffs { rpm 9.5492965855; }\n")  # omega_z = 1 rad/s
    noslip = {p: "type noSlip;" for p in ("left", "right", "bottom", "top")}
    put("0/U", _field("volVectorField", "U", "uniform (0 0 0)", noslip))
    put("0/T", _field("volScalarField", "T", "uniform 0", {
        "left": "type fixedValue; value uniform 1;",
        "right": "type fixedValue; value uniform -1;",
        "bottom": "type zeroGradient;", "top": "type zeroGradient;"}))
    put("0/p", _field("volScalarField", "p", "uniform 0", {
        p: "type zeroGradient;" for p in ("left", "right", "bottom",
                                          "top")}))
    return case


def _latest(case):
    """(solver, State) of the case resumed from its latest time."""
    path = os.path.join(case, "system", "controlDict")
    text = open(path).read()
    with open(path, "w") as f:
        f.write(text.replace("startFrom startTime;", "startFrom latestTime;"))
    try:
        return foam_case.build_case(case, device="cpu")
    finally:
        with open(path, "w") as f:
            f.write(text)


def _time_dirs(case):
    return sorted(float(d) for d in os.listdir(case) if d not in (
        "0", "system", "constant") and os.path.isdir(os.path.join(case, d)))


@pytest.mark.parametrize("app", ["QHDFoam", "SRFQHDFoam", "mulesQHDFoam",
                                 "scalarTransportQHDFoam"])
def test_case_builds_the_solver(app, tmp_path):
    """build_case reads each application as the port's solver (float64 by
    default for these, on the CPU): the cavity's solver is the one
    cases.buoyant_cavity builds, the box's the one of cases.scalar_box;
    constant/g, SRFProperties (omega from rpm) and the MULES T equation
    reach it."""
    case = write_case(str(tmp_path), app)
    solver, state = foam_case.build_case(case, device="cpu")
    if app == "scalarTransportQHDFoam":
        ref, ref_state = cases.scalar_box((16, 16), device="cpu")
        assert isinstance(solver, ScalarTransportQHD)
    else:
        ref, ref_state = cases.buoyant_cavity((16, 16), device="cpu")
        assert isinstance(solver, QHDFoam)
        assert solver.g == (0.0, -9.81)
        assert solver.t_equation == ("mules" if app == "mulesQHDFoam"
                                     else "standard")
        assert solver.implicit_diffusion
        if app == "SRFQHDFoam":
            np.testing.assert_allclose(solver.omega, (0.0, 0.0, 1.0),
                                       rtol=1e-10)
        else:
            assert solver.omega is None
    assert solver.mesh.dtype == torch.float64
    assert solver.thermo == ref.thermo and solver.tau_model == ref.tau_model
    for f in state._fields:
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   getattr(ref_state, f).numpy(), rtol=1e-11,
                                   atol=1e-12, err_msg=f)


@pytest.mark.parametrize("app", ["QHDFoam", "scalarTransportQHDFoam"])
def test_cli_runs_writes_and_resumes(app, tmp_path, capsys):
    """`python -m qgdsolver_tpu_torch <case> --device cpu --max-steps 20`:
    the composable step, a time directory every 10 steps with the
    application's fields, and a resume from the latest one."""
    case = write_case(str(tmp_path), app)
    assert cli.main([case, "--device", "cpu", "--max-steps", "20",
                     "--chunk", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "composable step engaged: make_step"
    tdirs = _time_dirs(case)
    assert len(tdirs) == 2
    written = sorted(os.listdir(os.path.join(case, "%g" % tdirs[-1])))
    assert written == (["T", "U"] if app == "scalarTransportQHDFoam"
                       else ["T", "U", "p"])
    solver, state = _latest(case)
    assert float(state.t) == pytest.approx(tdirs[-1], rel=1e-6)
    assert all(bool(torch.isfinite(x).all()) for x in state)
    # and it runs on from there
    assert cli.run_case(case, max_steps=5, chunk=5, log=lambda *_: None,
                        device="cpu") == 5


def test_cli_logs_the_fused_gates_refusal(tmp_path, monkeypatch):
    """With the fused path asked for, the log says the gates refused the
    config and the composable step runs."""
    case = write_case(str(tmp_path), "QHDFoam")
    logs = []
    cli.run_case(case, max_steps=2, chunk=2, log=logs.append, device="cpu",
                 fused="always")
    assert logs[0] == ("composable step engaged: make_step (the fused "
                       "gates refuse this QHDFoam config)")


def test_cli_matches_jax_cli(tmp_path):
    """Both packages' CLIs on two copies of the QHDFoam case, 20 steps with
    a write every 10: the same time directories and fields within
    2*n*cg_tol of their max."""
    n = 20
    cases_ = [write_case(str(tmp_path / k), "QHDFoam") for k in ("j", "t")]
    jcli.run_case(cases_[0], max_steps=n, chunk=10, log=lambda *_: None,
                  fused="never")
    cli.run_case(cases_[1], max_steps=n, chunk=10, log=lambda *_: None,
                 device="cpu")
    assert _time_dirs(cases_[0]) == _time_dirs(cases_[1])
    solver, got = _latest(cases_[1])
    path = os.path.join(cases_[0], "system", "controlDict")
    text = open(path).read()
    with open(path, "w") as f:
        f.write(text.replace("startFrom startTime;", "startFrom latestTime;"))
    _, ref = jfc.build_case(cases_[0])
    ref = jax.tree.map(np.asarray, ref)
    tol = 2 * n * solver.cg_tol
    for f in ("U", "T", "p", "t"):
        a, b = getattr(ref, f), getattr(got, f).numpy()
        assert np.abs(a - b).max() <= tol * np.abs(a).max(), f


@pytest.mark.parametrize("app", ["QHDFoam", "mulesQHDFoam"])
def test_cli_devices_2x1_matches_one_rank(app, tmp_path):
    """--devices 2x1 (two gloo ranks, the decomposed composable step)
    against one rank: 20 steps, the same time directories, fields within
    2*n*cg_tol of their max."""
    n = 20
    one, two = (write_case(str(tmp_path / k), app) for k in ("1", "2"))
    cli.run_case(one, max_steps=n, chunk=10, log=lambda *_: None,
                 device="cpu")
    logs = []
    cli.run_case(two, max_steps=n, chunk=10, log=logs.append, device="cpu",
                 devices="2x1")
    assert any("build_spmd_step (2x1 ranks)" in ln for ln in logs), logs
    assert _time_dirs(one) == _time_dirs(two)
    solver, a = _latest(one)
    _, b = _latest(two)
    tol = 2 * n * solver.cg_tol
    for f in a._fields:
        x, y = getattr(a, f).numpy(), getattr(b, f).numpy()
        assert np.abs(x - y).max() <= tol * np.abs(x).max(), f


@pytest.mark.parametrize("app,item", [
    ("QHDDyMFoam", "item 8b"), ("interQHDFoam", "item 9"),
    ("particlesQGDFoam", "item 10"), ("particlesQHDFoam", "item 10"),
    ("reactingLagrangianQGDFoam", "item 10")])
def test_ported_apps_build_from_case_directories(app, item, tmp_path):
    """Every application of the ROADMAP items named builds from a case
    directory.  Those of items 8b (QHDDyMFoam) and 9 (interQHDFoam) build
    from their configs too, and a QHDFoam case directory renamed to them
    builds as the JAX package builds it (a static QHDFoam without a
    dynamicMeshDict; no alpha field, a ValueError).  Those of item 10 (the
    Lagrangian and reacting solvers) build from their fixture case
    directories (particlesQHDFoam from the renamed QHDFoam one, its
    placeholder parcel inactive), and core.config's build_solver refuses
    them, as the JAX package's does, pointing at the case directory or the
    Python API, without naming an item still to come."""
    cfg = {"solver": app, "mesh": {"shape": [4, 4]}}
    case = write_case(str(tmp_path), "QHDFoam")
    path = os.path.join(case, "system", "controlDict")
    text = open(path).read().replace("application QHDFoam;",
                                     f"application {app};")
    with open(path, "w") as f:
        f.write(text)
    if app == "QHDDyMFoam":
        solver = config.build_solver(
            dict(cfg, thermo={"type": "rhoConst", "rho0": 1.0, "Cp": 1000.0,
                              "mu0": 1e-2, "Pr": 0.71},
                 dynamicMesh={"velocity": [1.0, 0.0, 0.0],
                              "checkMeshCourantNo": True}),
            device="cpu")
        assert solver.mesh_velocity(0.0) == (1.0, 0.0)
        assert solver.check_mesh_courant
        solver, _ = foam_case.build_case(case, device="cpu")
        assert type(solver).__name__ == "QHDFoam"
        assert solver.mesh_velocity is None and solver.mesh_scale is None
        return
    if app == "interQHDFoam":
        solver = config.build_solver(
            dict(cfg, props={"rho1": 1000.0, "rho2": 1.0, "nu1": 1e-6,
                             "nu2": 1.5e-5, "tau1": 1e-4, "tau2": 1e-4}),
            device="cpu")
        assert type(solver).__name__ == "InterQHDFoam"
        with pytest.raises(ValueError, match="no alpha field"):
            foam_case.build_case(case, device="cpu")
        return
    with pytest.raises(NotImplementedError,
                       match="case directory .* or the Python API") as err:
        config.build_solver(cfg, device="cpu")
    assert "ROADMAP" not in str(err.value) and item not in str(err.value)
    fixture = {"particlesQGDFoam": "particles_case",
               "reactingLagrangianQGDFoam": "reacting_case"}.get(app)
    if fixture is not None:
        case = os.path.join(os.path.dirname(__file__), "fixtures", fixture)
    solver, state = foam_case.build_case(case, device="cpu")
    assert type(solver).__name__ == {
        "particlesQGDFoam": "ParticlesQGDFoam",
        "particlesQHDFoam": "ParticlesQHDFoam",
        "reactingLagrangianQGDFoam": "ReactingLagrangianQGDFoam"}[app]
    assert float(state.cloud.active.sum()) == (
        0.0 if app == "particlesQHDFoam" else state.cloud.x.shape[1])


def test_words_and_fields_still_to_come_raise():
    """The words and fields of items 8b and 9 are ported since: mQhdFlux
    (interQHDFoam's) builds the QHDFluxP marker qhdFlux builds, and
    QHDFoam's moving-mesh fields and the mesh Courant cap step."""
    for word in ("mQhdFlux", "qhdFlux"):
        assert type(config.build_bcs({"x_lo": {"type": word}}, 2)[0, 0]
                    ).__name__ == "QHDFluxP"
    solver, s = cases.buoyant_cavity((8, 8), device="cpu")
    faces = solver.mesh.x_faces
    for over in ({"mesh_velocity": lambda t: (0.0, 0.0)},
                 {"mesh_scale": lambda t: (1.0, 1.0)},
                 {"mesh_faces": lambda t: faces},
                 {"mesh_velocity": lambda t: (0.1, 0.0),
                  "check_mesh_courant": True}):
        out = dataclasses.replace(solver, **over).make_step()(s)
        assert bool(torch.isfinite(out.T).all()), over


def test_config_builds_every_ported_solver():
    """core.config.build_solver takes QGDFoam, rhoQGDFoam, zQGDFoam, the
    QHD family (mulesQHDFoam with its T equation, SRFQHDFoam with omega)
    and scalarTransportQHDFoam; a QHD config as the JAX package builds
    it."""
    from qgdsolver_tpu.core import config as jconfig

    base = {"mesh": {"shape": [8, 8], "dtype": "float64"},
            "thermo": {"type": "rhoConst", "rho0": 1.0, "Cp": 1000.0,
                       "mu0": 1e-2, "Pr": 0.71, "beta": -3e-3},
            "tau": {"type": "H2bynuQHD", "alpha": 0.3},
            "g": [0.0, -9.81], "omega": [0.0, 0.0, 1.0],
            "boundary": {"T": {"x_lo": {"type": "fixedValue", "value": 1.0},
                               "x_hi": {"type": "qhdFlux"}}}}
    for name in ("QHDFoam", "SRFQHDFoam", "mulesQHDFoam",
                 "scalarTransportQHDFoam"):
        cfg = dict(base, solver=name)
        solver = config.build_solver(cfg, device="cpu")
        ref = interop.solver_from(jconfig.build_solver(cfg),
                                  dtype=torch.float64)
        assert type(solver) is type(ref)
        for f in dataclasses.fields(solver):
            if f.name not in ("mesh", "bc_U", "bc_T", "bc_p"):
                assert getattr(solver, f.name) == getattr(ref, f.name), f
    gas = {"mesh": {"shape": [8, 8]},
           "thermo": {"type": "rhoThermo", "Cp": 1004.5, "R": 287.0,
                      "eos": {"type": "stiffenedGas", "R": 287.0,
                              "p_inf": 2e5}}}
    for name, cls in (("QGDFoam", "QGDFoam"), ("rhoQGDFoam", "QGDFoam"),
                      ("zQGDFoam", "ZQGDFoam")):
        solver = config.build_solver(dict(gas, solver=name), device="cpu")
        assert type(solver).__name__ == cls
