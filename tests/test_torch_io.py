"""OpenFOAM case ingestion and output of the port (`qgdsolver_tpu_torch.io`)
against the JAX package (`qgdsolver_tpu.io`).

Mirrors tests/test_foam_case_e2e.py (block mesh, graded faces, field files,
config reads, resume from the latest time, multi-block composition, 2D and
3D write round trips, split sides, the 3D flagship on the fused step),
tests/test_foamdict.py, and the ingested-jet case of
tests/test_fused_qgd2d.py.  The fixture `tests/fixtures/jet_case` goes
through both packages' `build_case`: the same mesh, BCs and initial State
(f32 rounding of the JAX x64 arrays: rtol 1e-7), then 10 composable steps
within 1e-5 of each field's max and dt rtol 1e-6.  Write round trips hold
rho to rtol 1e-6: the port's state is f32, and rho comes back through
p*(1/(R*T)).
"""
import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from qgdsolver_tpu.io import foam_case as jfc
from qgdsolver_tpu.io import foamdict as jfoamdict
from qgdsolver_tpu_torch import interop
from qgdsolver_tpu_torch.core import bc as bcm
from qgdsolver_tpu_torch.io import foam_case, foam_fields, foam_write, foamdict
from qgdsolver_tpu_torch.io.foam_fields import (_graded_faces,
                                                load_block_mesh,
                                                parse_block_mesh,
                                                parse_field_file)
from qgdsolver_tpu_torch.ops import fused_qgd2d, fused_qgd3d
from qgdsolver_tpu_torch.physics.qgdcoeffs import VarScModel5
from qgdsolver_tpu_torch.solvers import common
from qgdsolver_tpu_torch.solvers.qgd import QGDFoam

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
CASE = os.path.join(FIX, "jet_case")
BOX3D = """
FoamFile { version 2.0; format ascii; class dictionary; object blockMeshDict; }
convertToMeters 1;
vertices
(
    (0 0 0) (1 0 0) (1 0.5 0) (0 0.5 0)
    (0 0 0.5) (1 0 0.5) (1 0.5 0.5) (0 0.5 0.5)
);
blocks ( hex (0 1 2 3 4 5 6 7) (%d %d %d) simpleGrading (1 1 1) );
edges ();
boundary
(
    inlet  { type patch; faces ((0 4 7 3)); }
    outlet { type patch; faces ((1 2 6 5)); }
    bottom { type wall;  faces ((0 1 5 4)); }
    top    { type wall;  faces ((3 7 6 2)); }
    back   { type wall;  faces ((0 3 2 1)); }
    front  { type wall;  faces ((4 5 6 7)); }
);
mergePatchPairs ();
"""


def _copy(tmp_path, name="jet", src=CASE):
    case = tmp_path / name
    shutil.copytree(src, case)
    return case


def _latest(case):
    ctrl = (case / "system" / "controlDict").read_text().replace(
        "startFrom       startTime;", "startFrom       latestTime;")
    (case / "system" / "controlDict").write_text(ctrl)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30)


def test_block_mesh_parsing():
    mesh, patch_map, kept = load_block_mesh(CASE)
    assert kept == (0, 1)  # z collapsed by the empty patch
    assert mesh.ndim == 2 and mesh.shape == (64, 32)
    assert mesh.dtype == torch.float32
    np.testing.assert_allclose(mesh.x_faces[0][[0, -1]], [0.0, 2.0])
    np.testing.assert_allclose(mesh.x_faces[1][[0, -1]], [0.0, 1.0])
    assert patch_map["inlet"][1] == ((0, 0),)
    assert patch_map["outlet"][1] == ((0, 1),)
    assert patch_map["bottom"][1] == ((1, 0),)
    assert patch_map["top"][1] == ((1, 1),)
    assert "frontAndBack" not in patch_map


def test_graded_faces_geometric():
    f = _graded_faces(0.0, 1.0, 10, 4.0)
    sizes = np.diff(f)
    np.testing.assert_allclose(sizes[-1] / sizes[0], 4.0, rtol=1e-12)
    np.testing.assert_allclose(f[[0, -1]], [0.0, 1.0], atol=1e-14)
    assert (sizes > 0).all()


def test_field_file_bcs_and_internal():
    mesh, patch_map, kept = load_block_mesh(CASE)
    U0, bc_U = parse_field_file(os.path.join(CASE, "0", "U"),
                                mesh, patch_map, kept)
    assert U0.shape == (2, 64, 32)
    np.testing.assert_allclose(U0, 0.0)
    assert isinstance(bc_U[0, 0], bcm.FixedValue)
    np.testing.assert_allclose(np.asarray(bc_U[0, 0].value), [500.0, 0.0])
    assert isinstance(bc_U[0, 1], bcm.ZeroGradient)
    assert isinstance(bc_U[1, 0], bcm.Symmetry)  # slip
    assert isinstance(bc_U[1, 1], bcm.InletOutlet)
    p0, bc_p = parse_field_file(os.path.join(CASE, "0", "p"),
                                mesh, patch_map, kept)
    assert p0.shape == (64, 32)
    np.testing.assert_allclose(p0, 101325.0)
    assert isinstance(bc_p[0, 1], bcm.QGDFluxP)


def test_case_config_reads():
    cfg = foam_case.load_case(CASE)
    tc = cfg["time_controls"]
    assert tc.max_co == 0.2 and tc.c_tau == 0.75 and tc.dt0 == 1e-7
    schemes = foam_case.fvsc_schemes(cfg["fvSchemes"])
    assert schemes["default"] == "full" and schemes["grad(p)"] == "full"
    th = foam_case.build_foam_thermo(cfg["thermophysicalProperties"])
    np.testing.assert_allclose(th.R, 8314.462618 / 28.96, rtol=1e-12)
    assert th.Cp == 1004.5
    np.testing.assert_allclose(float(th.mu(1e5, torch.tensor(300.0))),
                               1.8e-5)
    assert cfg["implicit_diffusion"] is False
    assert cfg["tau_model"].alpha == 0.5 and cfg["tau_model"].Sc == 1.0


def test_build_case_matches_jax():
    """Same mesh, BCs and initial State as the JAX build_case, then 10
    composable steps of both."""
    js, jst = jfc.build_case(CASE)
    ts, tst = foam_case.build_case(CASE, device="cpu")
    assert isinstance(ts, QGDFoam)
    for a in range(2):
        np.testing.assert_array_equal(ts.mesh.x_faces[a], js.mesh.x_faces[a])
    for jb, tb in zip(js._bcs(), ts._bcs()):
        for a in range(2):
            for side in (0, 1):
                x, y = jb[a, side], tb[a, side]
                assert type(x).__name__ == type(y).__name__, (a, side)
                for attr in ("value", "grad", "inlet_value"):
                    if hasattr(x, attr):
                        np.testing.assert_array_equal(
                            np.asarray(getattr(x, attr), dtype=np.float64),
                            np.asarray(getattr(y, attr), dtype=np.float64))
    assert dataclasses.astuple(ts.time) == dataclasses.astuple(js.time)
    assert dataclasses.astuple(ts.tau_model) == dataclasses.astuple(
        js.tau_model)
    assert ts.thermo.R == js.thermo.R and ts.fvsc_scheme == js.fvsc_scheme
    a = jax.tree.map(np.asarray, jst)
    b = interop.state_to_numpy(tst)
    for name in ("rho", "rhoU", "rhoE", "sc", "t", "dt"):
        np.testing.assert_allclose(getattr(b, name), getattr(a, name),
                                   rtol=1e-7, err_msg=name)
    assert len(a.pbc) == len(b.pbc) == 1
    jstep, tstep = jax.jit(js.make_step()), ts.make_step()
    for _ in range(10):
        jst, tst = jstep(jst), tstep(tst)
    a = jax.tree.map(np.asarray, jst)
    b = interop.state_to_numpy(tst)
    np.testing.assert_allclose(b.dt, a.dt, rtol=1e-6)
    for name in ("rho", "rhoU", "rhoE"):
        assert _rel(getattr(a, name), getattr(b, name)) < 1e-5, name


def test_ingested_jet_rides_fused_step():
    """Mirror of test_fused_qgd2d.py::test_fused_matches_composable_ingested
    _case: the ingested jet (per-term fvsc dict, slip + inletOutlet +
    qgdFlux) runs on the fused step and tracks the composable step."""
    solver, state = foam_case.build_case(CASE, device="cpu")
    assert fused_qgd2d.supported(solver) and solver.fused_supported()
    step_ref = solver.make_step()
    fstep, to_fused, from_fused = solver.make_fused_step()
    s = step_ref(state)  # seed pbc (qgdFlux lagged gradient)
    fs = to_fused(s)
    for _ in range(10):
        s = step_ref(s)
        fs = fstep(fs)
    s2 = from_fused(fs)
    np.testing.assert_allclose(float(s.dt), float(s2.dt), rtol=1e-6)
    for name in ("rho", "rhoU", "rhoE"):
        assert _rel(getattr(s, name), getattr(s2, name)) < 1e-3, name


def test_build_case_resume_latest_time(tmp_path):
    case = _copy(tmp_path)
    td = case / "0.002"
    td.mkdir()
    (td / "T").write_text(
        "FoamFile { version 2.0; format ascii; class volScalarField; "
        "object T; }\n"
        "internalField uniform 450;\n"
        "boundaryField { inlet { type fixedValue; value uniform 400; } "
        "outlet { type zeroGradient; } bottom { type zeroGradient; } "
        "top { type zeroGradient; } frontAndBack { type empty; } }\n")
    _latest(case)
    solver, state = foam_case.build_case(str(case), device="cpu")
    U, e, T, p = solver.primitives(state)
    np.testing.assert_allclose(T.numpy(), 450.0, rtol=1e-6)
    np.testing.assert_allclose(p.numpy(), 101325.0, rtol=1e-6)
    np.testing.assert_allclose(float(state.t), 0.002, rtol=1e-7)


def test_multi_block_rectilinear_composition(tmp_path):
    def bmd_text(blocks):
        return f"""
FoamFile {{ version 2.0; format ascii; class dictionary; object blockMeshDict; }}
convertToMeters 1;
vertices
(
    (0 0 0) (2 0 0) (2 0.5 0) (0 0.5 0) (2 1 0) (0 1 0)
    (0 0 0.1) (2 0 0.1) (2 0.5 0.1) (0 0.5 0.1) (2 1 0.1) (0 1 0.1)
);
blocks ( {blocks} );
edges ();
boundary
(
    left  {{ type patch; faces ((0 6 9 3) (3 9 11 5)); }}
    right {{ type patch; faces ((1 2 8 7) (2 4 10 8)); }}
    bottom {{ type wall; faces ((0 1 7 6)); }}
    top    {{ type wall; faces ((5 11 10 4)); }}
    frontAndBack {{ type empty; faces ((0 3 2 1) (3 5 4 2) (6 7 8 9) (9 8 10 11)); }}
);
mergePatchPairs ();
"""

    good = ("hex (0 1 2 3 6 7 8 9) (16 8 1) simpleGrading (1 2 1) "
            "hex (3 2 4 5 9 8 10 11) (16 12 1) simpleGrading (1 0.5 1)")
    p = tmp_path / "bmd"
    p.write_text(bmd_text(good))
    mesh, patch_map, _ = parse_block_mesh(foamdict.parse_file(str(p)))
    assert mesh.shape == (16, 20)
    np.testing.assert_allclose(mesh.x_faces[1][[0, -1]], [0.0, 1.0])
    assert 0.5 in np.round(mesh.x_faces[1], 12)
    dy = np.diff(mesh.x_faces[1])
    np.testing.assert_allclose(dy[7] / dy[0], 2.0, rtol=1e-9)
    assert patch_map["left"][1] == ((0, 0),)
    assert patch_map["top"][1] == ((1, 1),)
    bad = ("hex (0 1 2 3 6 7 8 9) (16 8 1) simpleGrading (1 1 1) "
           "hex (3 2 4 5 9 8 10 11) (24 12 1) simpleGrading (1 1 1)")
    p.write_text(bmd_text(bad))
    with pytest.raises(ValueError, match="disagree"):
        parse_block_mesh(foamdict.parse_file(str(p)))


def test_dead_cell_and_wedge_meshes_raise():
    """The JAX L-shaped fixture layout parses into a mesh whose solid mask
    (the uncovered quarter) equals the JAX package's; the same blocks
    swept as a wedge are not bricks after the unrolling r = hypot(y, z)
    and raise ValueError, as in the JAX package."""
    from qgdsolver_tpu.io.foam_fields import parse_block_mesh as j_parse

    lshape = {
        "vertices": [[0, 0, 0], [1, 0, 0], [2, 0, 0], [0, 0.5, 0],
                     [1, 0.5, 0], [2, 0.5, 0], [0, 1, 0], [1, 1, 0],
                     [0, 0, 1], [1, 0, 1], [2, 0, 1], [0, 0.5, 1],
                     [1, 0.5, 1], [2, 0.5, 1], [0, 1, 1], [1, 1, 1]],
        "blocks": ["hex", [0, 1, 4, 3, 8, 9, 12, 11], [8, 8, 1],
                   "hex", [1, 2, 5, 4, 9, 10, 13, 12], [8, 8, 1],
                   "hex", [3, 4, 7, 6, 11, 12, 15, 14], [8, 8, 1]],
        "boundary": []}
    mesh, _, kept = parse_block_mesh(lshape)
    jmesh, _, jkept = j_parse(lshape)
    assert kept == jkept and mesh.shape == jmesh.shape == (16, 16, 1)
    np.testing.assert_array_equal(mesh.solid, jmesh.solid)
    assert int(mesh.solid.sum()) == 64 and bool(mesh.solid[8:, 8:].all())
    wedge = dict(lshape, boundary=["w", {"type": "wedge", "faces": []}])
    for parse in (parse_block_mesh, j_parse):
        with pytest.raises(ValueError, match="not an axis-aligned brick"):
            parse(wedge)


def test_write_time_dir_roundtrip(tmp_path):
    case = _copy(tmp_path)
    solver, state = foam_case.build_case(str(case), device="cpu")
    s = common.run_steps(solver.make_step(), state, 5)
    tdir = foam_write.write_state(str(case), solver, s)
    assert os.path.basename(tdir) == "%.6g" % float(s.t)
    _latest(case)
    _, s2 = foam_case.build_case(str(case), device="cpu")
    # the time directory's name holds t to six digits
    np.testing.assert_allclose(float(s2.t), float(s.t), rtol=1e-6)
    np.testing.assert_allclose(s2.rho.numpy(), s.rho.numpy(), rtol=1e-6)
    np.testing.assert_allclose(s2.rhoU.numpy(), s.rhoU.numpy(), rtol=1e-6,
                               atol=1e-4)
    s3 = common.run_steps(solver.make_step(), s2._replace(dt=s.dt), 3)
    assert bool(torch.isfinite(s3.rho).all())


def test_write_time_dir_roundtrip_3d(tmp_path):
    case = _copy(tmp_path, "box3d")
    (case / "system" / "blockMeshDict").write_text(BOX3D % (8, 4, 4))
    solver, state = foam_case.build_case(str(case), device="cpu")
    assert solver.mesh.ndim == 3 and state.rhoU.shape == (3, 8, 4, 4)
    s = common.run_steps(solver.make_step(), state, 4)
    foam_write.write_state(str(case), solver, s)
    _latest(case)
    _, s2 = foam_case.build_case(str(case), device="cpu")
    np.testing.assert_allclose(s2.rho.numpy(), s.rho.numpy(), rtol=1e-6)
    np.testing.assert_allclose(s2.rhoU.numpy(), s.rhoU.numpy(), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(float(s2.t), float(s.t), rtol=1e-6)


def test_nonuniform_lists_read_as_the_parser_reads_them(tmp_path):
    """The numpy reader of `nonuniform List<...>` gives the values the
    dictionary parser gives (scalar and vector files)."""
    case = _copy(tmp_path)
    solver, state = foam_case.build_case(str(case), device="cpu")
    s = common.run_steps(solver.make_step(), state, 3)
    tdir = foam_write.write_state(str(case), solver, s)
    mesh, patch_map, kept = load_block_mesh(str(case))
    for name in ("p", "U"):
        path = os.path.join(tdir, name)
        fast, _ = parse_field_file(path, mesh, patch_map, kept)
        d = foamdict.parse_file(path)
        counts3 = [64, 32, 1]
        slow = foam_fields._internal_field(d["internalField"], mesh, kept,
                                           counts3, name == "U")
        np.testing.assert_array_equal(fast, slow)


def test_split_sides(tmp_path):
    """Two patches claiming the same face rectangle is an overlap and is
    rejected; a proper split side (jet_coflow_case: a jet inlet and a
    coflow on the x-low plane) builds a Segmented BC, and 5 steps of the
    case equal the JAX package's in float64 to round-off (1e-12 of each
    field's max)."""
    case = _copy(tmp_path)
    bmd = (case / "system" / "blockMeshDict").read_text().replace(
        "inlet        { type patch; faces ((0 4 7 3)); }",
        "inlet        { type patch; faces ((0 4 7 3)); }\n"
        "    inlet2       { type wall; faces ((0 4 7 3)); }")
    (case / "system" / "blockMeshDict").write_text(bmd)
    u = (case / "0" / "U").read_text().replace(
        "inlet        { type fixedValue; value uniform (500 0 0); }",
        "inlet        { type fixedValue; value uniform (500 0 0); }\n"
        "    inlet2       { type fixedValue; value uniform (0 0 0); }")
    (case / "0" / "U").write_text(u)
    with pytest.raises(ValueError, match="several patches"):
        foam_case.build_case(str(case), device="cpu")
    path = os.path.join(FIX, "jet_coflow_case")
    solver, state = foam_case.build_case(path, device="cpu",
                                         dtype=torch.float64)
    assert isinstance(solver.bc_U[0, 0], bcm.Segmented)
    assert not solver.fused_supported()
    jsolver, js = jfc.build_case(path)
    jsolver = dataclasses.replace(
        jsolver, mesh=dataclasses.replace(jsolver.mesh, dtype=np.float64))
    js = jax.tree.map(lambda x: np.asarray(x, np.float64), js)
    np.testing.assert_allclose(state.rho.numpy(), js.rho, rtol=1e-12)
    out = interop.state_to_numpy(common.run_steps(solver.make_step(), state,
                                                  5))
    jstep = jax.jit(jsolver.make_step())
    for _ in range(5):
        js = jstep(js)
    for f in ("rho", "rhoU", "rhoE", "t", "dt"):
        a, b = np.asarray(getattr(js, f)), getattr(out, f)
        assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(a)), f


def test_build_case_3d_flagship_rides_fused_kernel(tmp_path):
    """An ingested 3D case with varScModel5 + qgdFlux is a config the 3D
    fused step takes, and it runs (plain versions on the CPU)."""
    case = _copy(tmp_path, "duct3d")
    (case / "system" / "blockMeshDict").write_text(BOX3D % (16, 6, 6))
    th = (case / "constant" / "thermophysicalProperties").read_text()
    th = th[:th.index("QGD\n")] + (
        "QGD\n{\n    implicitDiffusion false;\n"
        "    QGDCoeffs       varScModel5;\n    aQGD 0.5;\n"
        "    PrQGD 1.0;\n    rC 0.5;\n    minSc 0.05;\n"
        "    maxSc 1.0;\n    smoothCoeff 0.1;\n}\n")
    (case / "constant" / "thermophysicalProperties").write_text(th)
    sides = ("inlet", "outlet", "bottom", "top", "back", "front")

    def field(cls, name, internal, special):
        body = "".join(f"    {s} {{ {special.get(s, 'type zeroGradient;')} }}\n"
                       for s in sides)
        (case / "0" / name).write_text(
            f"FoamFile {{ version 2.0; format ascii; class {cls}; "
            f"object {name}; }}\ninternalField uniform {internal};\n"
            f"boundaryField\n{{\n{body}}}\n")

    field("volScalarField", "p", "101325",
          {"outlet": "type qgdFlux; value uniform 101325;"})
    field("volVectorField", "U", "(0 0 0)",
          {"inlet": "type fixedValue; value uniform (500 0 0);"})
    field("volScalarField", "T", "300",
          {"inlet": "type fixedValue; value uniform 300;"})
    solver, state = foam_case.build_case(str(case), device="cpu")
    assert solver.mesh.ndim == 3
    assert isinstance(solver.tau_model, VarScModel5)
    assert solver._flux_sides() == ((0, 1),)
    assert fused_qgd3d.supported(solver) and solver.fused_supported()
    fstep, to_f, from_f = solver.make_fused_step()
    out = from_f(common.run_steps(fstep, to_f(state), 3))
    assert bool(torch.isfinite(out.rho).all()) and float(out.rho.min()) > 0


def test_unported_words_raise(tmp_path):
    """Words of the JAX package map as the JAX package maps them, those of
    items 8b and 9 (mQhdFlux, QHDDyMFoam) included since they are
    ported."""
    assert isinstance(foam_fields._bc_from_entry({"type": "mQhdFlux"}, 2,
                                                 (0, 1), False), bcm.QHDFluxP)
    # words ported since: they map as the JAX package maps them
    assert foam_case.tau_model({"QGD": {"QGDCoeffs": "constTau",
                                        "Tau": 1e-3}}).tau0 == 1e-3
    for tt, cls in (({"thermo": "janaf"}, "JanafPerfectGasThermo"),
                    ({"type": "heRhoQGDThermo",
                      "equationOfState": "rhoConst"}, "RhoConstThermo")):
        th = foam_case.build_foam_thermo({"thermoType": tt})
        assert type(th).__name__ == cls
    th = foam_case.build_foam_thermo(
        {"thermoType": {"transport": "sutherland"}})
    assert type(th.transport).__name__ == "SutherlandTransport"
    b = foam_fields._bc_from_entry({"type": "waveTransmissive",
                                    "fieldInf": 1e5}, 2, (0, 1), False)
    assert isinstance(b, bcm.WaveTransmissive) and b.field_inf == 1e5
    assert isinstance(foam_fields._bc_from_entry({"type": "qhdFlux"}, 2,
                                                 (0, 1), False), bcm.QHDFluxP)
    with pytest.raises(ValueError, match="unsupported boundary"):
        foam_fields._bc_from_entry({"type": "noSuchWord"}, 2, (0, 1), False)
    case = _copy(tmp_path)
    ctrl = (case / "system" / "controlDict").read_text().replace(
        "application     QGDFoam;", "application     QHDDyMFoam;")
    (case / "system" / "controlDict").write_text(ctrl)
    # the QGDFoam jet has no T-equation QHD fields: QHDDyMFoam reads it as
    # the JAX package does, as a QHD case
    solver, _ = foam_case.build_case(str(case), device="cpu")
    assert type(solver).__name__ == "QHDFoam"


# ---------------------------------------------------------------------------
# foamdict (mirror of tests/test_foamdict.py)
# ---------------------------------------------------------------------------

CONTROL_DICT = """
FoamFile
{
    version     2.0;
    format      ascii;
    class       dictionary;
    object      controlDict;
}
// * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * //

application     QGDFoam;
startTime       0;
endTime         0.03;
deltaT          1e-08;
adjustTimeStep  yes;
maxCo           0.2;
maxDeltaT       0.001;
cTau            0.5;
writeControl    adjustableRunTime;
functions
{
    fieldAverage1
    {
        type            fieldAverage;
        fields          ( U p );
    }
}
"""

FV_SCHEMES = """
fvsc
{
    default GaussVolPoint;
    grad(p) leastSquares;
}
divSchemes
{
    default         none;
}
"""

THERMO = """
thermoType
{
    type            hePsiQGDThermo;
    transport       const;
    thermo          hConst;
    equationOfState perfectGas;
}
QGD
{
    implicitDiffusion false;
    QGDCoeffs varScModel5;
    aQGD   0.3;
    rC     0.05;
    minSc  0.0;
    maxSc  2.0;
}
mixture
{
    specie      { nMoles 1; molWeight 28.96; }
    thermodynamics { Cp 1005; Hf 0; }
    transport   { mu 1.8e-05; Pr 0.7; beta [0 0 0 -1 0 0 0] 3e-03; }
}
"""


@pytest.mark.parametrize("use_native", [True, False])
def test_parse_control_dict(use_native):
    if use_native and not foamdict.native_available():
        pytest.skip("no native parser")
    d = (foamdict.parse(CONTROL_DICT) if use_native
         else foamdict._parse_py(CONTROL_DICT))
    assert d["application"] == "QGDFoam"
    assert d["adjustTimeStep"] is True
    assert float(d["maxCo"]) == 0.2 and float(d["deltaT"]) == 1e-8
    assert d["functions"]["fieldAverage1"]["fields"] == ["U", "p"]


def test_native_matches_python():
    if not foamdict.native_available():
        pytest.skip("no native parser")
    import json

    for text in (CONTROL_DICT, FV_SCHEMES, THERMO):
        a = foamdict.parse(text)
        b = foamdict._parse_py(text)
        assert json.loads(json.dumps(a)) == json.loads(json.dumps(b))


def test_case_mapping():
    tc = foam_case.time_controls(foamdict._parse_py(CONTROL_DICT))
    assert tc.adjust_time_step and tc.max_co == 0.2 and tc.c_tau == 0.5
    assert foam_case.fvsc_scheme(foamdict._parse_py(FV_SCHEMES)) == "full"
    th = foamdict._parse_py(THERMO)
    tau = foam_case.tau_model(th)
    assert isinstance(tau, VarScModel5)
    assert np.isclose(tau.alpha, 0.3) and np.isclose(tau.rC, 0.05)
    assert foam_case.implicit_diffusion(th) is False
    beta = th["mixture"]["transport"]["beta"]
    assert beta[0]["__dims__"] == [0, 0, 0, -1, 0, 0, 0]
    assert float(beta[1]) == 3e-3


# ---------------------------------------------------------------------------
# the port's own native parser: built from io/csrc/foamdict.cpp into
# build/foamdict/, never from or into the JAX package's native/ directory
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.realpath(os.path.join(ROOT, "native"))

# a fresh build into the build root argv[1] under an audit hook that
# records every file opened, renamed, removed or loaded and every command
# run, then a parse of argv[2]
_AUDITED_BUILD = r"""
import json, os, pathlib, sys
from qgdsolver_tpu_torch.io import foamdict as fd

seen = []
EVENTS = ("open", "os.rename", "os.remove", "os.mkdir", "os.listdir",
          "os.scandir", "os.chmod", "os.truncate", "shutil.copyfile",
          "shutil.rmtree", "ctypes.dlopen", "subprocess.Popen", "os.exec",
          "os.posix_spawn", "os.system")

def flat(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from flat(a)
        elif isinstance(a, (str, bytes, os.PathLike)):
            yield os.fsdecode(a)

def hook(event, args):
    if event in EVENTS:
        seen.append([event, list(flat(args))])

sys.addaudithook(hook)
fd.BUILD_DIR = pathlib.Path(sys.argv[1])
ok = fd.native_available()
d = fd.parse_file(sys.argv[2])
print(json.dumps({"ok": ok, "lib": fd._LIB._name, "seen": seen, "d": d}))
"""


def _run(code, *args):
    return subprocess.run([sys.executable, "-c", code, *map(str, args)],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)


def test_native_parser_builds_under_its_own_build_dir(tmp_path):
    """The port's parser builds its own copy of the source into its build
    directory (a fresh, temporary root here) and loads it from there: no
    file under the repository's native/ is opened, written, renamed,
    loaded or passed to a command."""
    assert foamdict.SOURCE.parent.name == "csrc"
    assert foamdict.BUILD_DIR == foamdict.SOURCE.parents[3] / "build" \
        / "foamdict"
    root = tmp_path / "build"
    out = _run(_AUDITED_BUILD, root,
               os.path.join(CASE, "system", "controlDict"))
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["ok"]
    lib = os.path.realpath(rep["lib"])
    assert os.path.dirname(lib) == os.path.realpath(root)
    assert os.path.basename(lib).startswith("libfoamdict_")
    events = {e for e, _ in rep["seen"]}
    assert {"subprocess.Popen", "os.rename", "ctypes.dlopen"} <= events
    for event, paths in rep["seen"]:
        for p in paths:
            real = os.path.realpath(os.path.join(ROOT, p))
            assert real != NATIVE and not real.startswith(NATIVE + os.sep), \
                (event, p)
    assert rep["d"] == json.loads(json.dumps(jfoamdict.parse_file(
        os.path.join(CASE, "system", "controlDict"))))


def test_library_key_hashes_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "foamdict.cpp"
    src.write_bytes(foamdict.SOURCE.read_bytes())
    monkeypatch.setattr(foamdict, "SOURCE", src)
    key = foamdict.library_path()
    assert key.parent == foamdict.BUILD_DIR
    src.write_bytes(src.read_bytes() + b"// edited\n")
    assert foamdict.library_path() != key
    src.write_bytes(foamdict.SOURCE.read_bytes()[:-len(b"// edited\n")])
    assert foamdict.library_path() == key
    monkeypatch.setattr(foamdict, "CXX_FLAGS", foamdict.CXX_FLAGS + ("-g",))
    assert foamdict.library_path() != key


def _fixture_dicts(case):
    return sorted(p for p in glob.glob(os.path.join(FIX, case, "**", "*"),
                                       recursive=True) if os.path.isfile(p))


@pytest.mark.parametrize("case", sorted(os.listdir(FIX)))
def test_three_parsers_agree_on_every_fixture_dictionary(case):
    """The port's native parser, its Python grammar and the JAX package's
    parser give equal dicts on every file of every fixture case."""
    assert foamdict.native_available()
    files = _fixture_dicts(case)
    assert any(p.endswith("controlDict") for p in files)
    for p in files:
        with open(p) as f:
            text = f.read()
        native = json.loads(json.dumps(foamdict.parse(text)))
        py = json.loads(json.dumps(foamdict._parse_py(text)))
        ref = json.loads(json.dumps(jfoamdict.parse(text)))
        assert native == ref, p
        assert py == ref, p


_RACE = r"""
import json, os, pathlib, sys, time
from qgdsolver_tpu_torch.io import foamdict as fd

fd.BUILD_DIR = pathlib.Path(sys.argv[1])
go = pathlib.Path(sys.argv[2])
pathlib.Path(f"{go}.{os.getpid()}.ready").touch()
while not go.exists():
    time.sleep(0.005)
ok = fd.native_available()
print(json.dumps({"ok": ok, "lib": fd._LIB._name if ok else None,
                  "d": fd.parse_file(sys.argv[3])}))
"""


def test_two_processes_building_at_once_both_load_a_whole_library(
        tmp_path):
    """Two processes started on an empty build root, released together:
    each builds beside the target and renames, so both load a whole
    library (no Python fallback) and parse alike, and no partial file is
    left behind."""
    root, go = tmp_path / "build", tmp_path / "go"
    blockmesh = os.path.join(CASE, "system", "blockMeshDict")
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(root),
                               str(go), blockmesh], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(2)]
    try:
        deadline = time.monotonic() + 120
        while len(glob.glob(f"{go}.*.ready")) < 2:
            assert time.monotonic() < deadline, "the processes did not start"
            assert all(p.poll() is None for p in procs)
            time.sleep(0.01)
        go.touch()
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    reps = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        reps.append(json.loads(out))
    assert all(r["ok"] for r in reps)
    assert reps[0]["lib"] == reps[1]["lib"]
    assert reps[0]["d"] == reps[1]["d"] == json.loads(json.dumps(
        jfoamdict.parse_file(blockmesh)))
    assert os.listdir(root) == [os.path.basename(reps[0]["lib"])]
