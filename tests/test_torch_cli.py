"""The port's case runner (`qgdsolver_tpu_torch.cli`), checkpoints, the
checked runner's crash dump, observability and the JSON config builder.

Mirrors tests/test_cli.py (runs, writes and resumes; stops at endTime;
adjustableRunTime lands on the write instants) with `--device cpu`, where
the composable step runs.  The JAX CLI (`fused="never"`) and the port's
run two copies of the fixture for 20 steps: the same time directories,
fields within 1e-4 of their max (f32 port against the JAX x64 state).
Checkpoints cross between the packages leaf for leaf (bitwise).
"""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from qgdsolver_tpu import cli as jcli
from qgdsolver_tpu.io import foam_case as jfc
from qgdsolver_tpu.utils import checkpoint as jcheckpoint
from qgdsolver_tpu_torch import cases, cli, interop
from qgdsolver_tpu_torch.core import config
from qgdsolver_tpu_torch.io import foam_case
from qgdsolver_tpu_torch.solvers import common
from qgdsolver_tpu_torch.utils import checkpoint, observability

CASE = os.path.join(os.path.dirname(__file__), "fixtures", "jet_case")


def _copy(tmp_path, name="jet"):
    case = tmp_path / name
    shutil.copytree(CASE, case)
    return case


def _edit(case, *pairs):
    p = case / "system" / "controlDict"
    text = p.read_text()
    for old, new in pairs:
        assert old in text
        text = text.replace(old, new)
    p.write_text(text)


def _time_dirs(case):
    return sorted(d for d in os.listdir(case)
                  if d not in ("0", "system", "constant")
                  and os.path.isdir(case / d))


def test_cli_runs_writes_and_resumes(tmp_path):
    case = _copy(tmp_path)
    _edit(case, ("endTime         0.01;", "endTime         1.0;"),
          ("writeControl    adjustableRunTime;", "writeControl    timeStep;"),
          ("writeInterval   0.001;", "writeInterval   10;"))
    logs = []
    n = cli.run_case(str(case), max_steps=20, chunk=10, log=logs.append,
                     device="cpu")
    assert n == 20
    assert logs[0] == "composable step engaged: make_step"
    assert any("writing fields" in ln for ln in logs)
    assert _time_dirs(case), "no time directory written"
    _edit(case, ("startFrom       startTime;", "startFrom       latestTime;"))
    _, state = foam_case.build_case(str(case), device="cpu")
    assert float(state.t) > 0.0
    assert bool(torch.isfinite(state.rho).all())


def test_cli_stops_at_end_time(tmp_path):
    case = _copy(tmp_path)
    end_time = 2e-6
    _edit(case, ("endTime         0.01;", "endTime         %g;" % end_time))
    logs = []
    n = cli.run_case(str(case), chunk=50, log=logs.append, device="cpu")
    times = [float(ln.split("Time = ")[1].split()[0])
             for ln in logs if ln.startswith("Time = ")]
    assert times and times[-1] >= end_time
    assert times[-1] < end_time + 2e-4
    assert 0 < n < 50 * 5


def test_cli_adjustable_run_time_lands_on_write_instants(tmp_path):
    case = _copy(tmp_path)
    w, end = 1.5e-6, 4.5e-6
    _edit(case, ("endTime         0.01;", "endTime         %g;" % end),
          ("writeInterval   0.001;", "writeInterval   %g;" % w))
    cli.run_case(str(case), chunk=10, log=lambda *_: None, device="cpu")
    tdirs = sorted(float(d) for d in _time_dirs(case))
    assert len(tdirs) >= 3, tdirs
    for tv in tdirs:
        k = round(tv / w)
        assert abs(tv - k * w) < 5e-6 * w + 1e-11, (tv, k * w)
    assert abs(tdirs[-1] - end) < 5e-6 * end, tdirs[-1]


def test_cli_matches_jax_cli(tmp_path):
    """Both packages' CLIs on two copies of the fixture, 20 steps with a
    write every 10: the same time directories and fields."""
    dirs = {}
    for name, run in (("jax", lambda c: jcli.run_case(
            c, max_steps=20, chunk=10, log=lambda *_: None, fused="never")),
                      ("port", lambda c: cli.run_case(
                          c, max_steps=20, chunk=10, log=lambda *_: None,
                          device="cpu"))):
        case = _copy(tmp_path, name)
        _edit(case, ("writeControl    adjustableRunTime;",
                     "writeControl    timeStep;"),
              ("writeInterval   0.001;", "writeInterval   10;"))
        assert run(str(case)) == 20
        dirs[name] = (case, _time_dirs(case))
    (jcase, jdirs), (tcase, tdirs) = dirs["jax"], dirs["port"]
    assert len(jdirs) == len(tdirs) == 2
    for a, b in zip(jdirs, tdirs):
        np.testing.assert_allclose(float(b), float(a), rtol=1e-5)
    for case in (jcase, tcase):
        _edit(case, ("startFrom       startTime;",
                     "startFrom       latestTime;"))
    _, a = jfc.build_case(str(jcase))
    _, b = foam_case.build_case(str(tcase), device="cpu")
    b = interop.state_to_numpy(b)
    for name in ("rho", "rhoU", "rhoE"):
        x = np.asarray(getattr(a, name), dtype=np.float64)
        y = np.asarray(getattr(b, name), dtype=np.float64)
        assert np.max(np.abs(x - y)) / np.max(np.abs(x)) < 1e-4, name


def _varsc(case):
    p = case / "constant" / "thermophysicalProperties"
    text = p.read_text()
    p.write_text(text[:text.index("QGD\n")] + (
        "QGD\n{\n    implicitDiffusion false;\n"
        "    QGDCoeffs       varScModel5;\n    aQGD 0.5;\n    PrQGD 1.0;\n"
        "    rC 0.5;\n    minSc 0.05;\n    maxSc 1.0;\n"
        "    smoothCoeff 0.1;\n}\n"))


def test_cli_fused_path_tracks_composable(tmp_path):
    """fused="always" drives the kernel path's wrappers on any device (their
    plain versions on the CPU): the case made varScModel5 takes K2's
    builder, its carried dt is trimmed to land on the write instants, and
    it writes what the composable run writes (2e-3 of each field's max,
    the varsc fused bound)."""
    w, end = 1.5e-6, 3e-6
    states = []
    for fused in ("always", "never"):
        case = _copy(tmp_path, fused)
        _varsc(case)
        _edit(case, ("endTime         0.01;", "endTime         %g;" % end),
              ("writeInterval   0.001;", "writeInterval   %g;" % w))
        logs = []
        cli.run_case(str(case), chunk=10, log=logs.append, fused=fused,
                     device="cpu")
        want = ("fused kernel path engaged: build_tiled_fused_step"
                if fused == "always" else "composable step engaged: "
                "make_step")
        assert logs[0] == want
        tdirs = [float(d) for d in _time_dirs(case)]
        assert len(tdirs) == 2
        np.testing.assert_allclose(tdirs, [w, end], rtol=5e-6)
        _edit(case, ("startFrom       startTime;",
                     "startFrom       latestTime;"))
        states.append(foam_case.build_case(str(case), device="cpu")[1])
    a, b = states
    for name in ("rho", "rhoU", "rhoE"):
        x, y = getattr(b, name), getattr(a, name)
        assert float((x - y).abs().max() / x.abs().max()) < 2e-3, name


def test_cli_main_and_device_errors(tmp_path, monkeypatch, capsys):
    case = _copy(tmp_path)
    assert cli.main([str(case), "--max-steps", "2", "--device", "cpu",
                     "--chunk", "1"]) == 0
    out = capsys.readouterr().out
    assert "composable step engaged: make_step" in out
    assert "End." in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main([str(case), "--max-steps", "1"])
    with pytest.raises(SystemExit):
        cli.main([str(case), "--devices", "2x2"])


@pytest.mark.parametrize("entry", [
    "supersonic_jet", "supersonic_jet_varsc", "supersonic_duct_3d",
    "supersonic_jet_3d_varsc", "buoyant_cavity", "scalar_box",
    "build_case"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """The case builders and case ingestion run on the card unless asked
    for the CPU: without a card their default raises, never falling back."""
    def build(**kw):
        if entry == "build_case":
            return foam_case.build_case(CASE, **kw)
        shape = (8, 4, 4) if "3d" in entry else (8, 4)
        return getattr(cases, entry)(shape=shape, **kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    _, state = build(device="cpu")
    assert state[0].device.type == "cpu"


@pytest.mark.parametrize("entry", ["build_mesh", "build_solver",
                                   "load_case"])
def test_config_entry_points_default_to_the_card(entry, tmp_path,
                                                 monkeypatch):
    """`core.config`'s builders run on the card unless asked for the CPU:
    without a card the default raises (`mesh.checked_device`), and
    device="cpu" builds there."""
    cfg = {"solver": "QGDFoam", "mesh": {"shape": [8, 4]},
           "thermo": {"type": "psiPerfectGas", "R": 287.0, "Cp": 1004.5}}
    path = tmp_path / "case.json"
    path.write_text(json.dumps(cfg))

    def build(**kw):
        if entry == "build_mesh":
            return config.build_mesh(cfg["mesh"], **kw)
        if entry == "build_solver":
            return config.build_solver(cfg, **kw).mesh
        return config.load_case(str(path), **kw).mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    mesh = build(device="cpu")
    assert mesh.device.type == "cpu" and mesh.shape == (8, 4)


def test_checkpoint_crosses_packages(tmp_path):
    """A checkpoint written by either package restores into the other."""
    js, jst = jfc.build_case(CASE)
    jst = jax.jit(js.make_step())(jst)
    ts, tst = foam_case.build_case(CASE, device="cpu")
    tst = ts.make_step()(tst)
    jcheckpoint.save(jst, str(tmp_path / "jax"), 7)
    got, step = checkpoint.restore_latest(tst, str(tmp_path / "jax"))
    assert step == 7
    want = jax.tree.map(np.asarray, jst)
    for name in ("rho", "rhoU", "rhoE", "sc", "t", "dt"):
        x = getattr(got, name)
        assert x.dtype == getattr(tst, name).dtype
        np.testing.assert_array_equal(
            x.numpy(), getattr(want, name).astype(np.float32))
    np.testing.assert_array_equal(got.pbc[0].numpy(),
                                  want.pbc[0].astype(np.float32))
    checkpoint.save(tst, str(tmp_path / "port"), 3)
    back = jcheckpoint.restore(jst, str(tmp_path / "port"), 3)
    for name in ("rho", "rhoU", "rhoE", "sc", "t", "dt"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      getattr(tst, name).numpy())
    with open(tmp_path / "port" / "step_000000000003.json") as f:
        assert json.load(f) == {"step": 3, "n_leaves": 7}


def test_run_steps_dumps_nonphysical_state(tmp_path):
    """The checked runner writes the bad state before it raises, and the
    dump restores to the planted state."""
    solver, state = cases.supersonic_jet(shape=(16, 8), device="cpu")
    rho = state.rho.clone()
    rho[3, 4] = -1.0
    planted = state._replace(rho=rho)
    dump = str(tmp_path / "dump")
    with pytest.raises(common.NonphysicalStateError) as exc:
        common.run_steps(lambda s: s, planted, 5, check_every=2,
                         dump_dir=dump)
    assert exc.value.dump_path is not None
    assert os.path.exists(exc.value.dump_path)
    assert "rho" in str(exc.value)
    restored, step = checkpoint.restore_latest(state, dump)
    assert step == 2
    for x, y in zip(checkpoint._flatten(restored),
                    checkpoint._flatten(planted)):
        assert torch.equal(x, y)


def test_observability(tmp_path):
    solver, state = cases.supersonic_jet(shape=(16, 8), device="cpu")
    lines = []
    log = observability.StepLogger(solver.mesh.shape, every=1,
                                   fields=("rho",), out=lines.append)
    log(1, state)
    assert lines[0].startswith("step=1") and "max/min rho" in lines[0]
    assert observability.nonphysical_dump(state) == {}
    bad = state._replace(rhoE=-state.rhoE)
    assert observability.nonphysical_dump(bad, out=lines.append) == {
        "rhoE": 16 * 8}
    with observability.trace(str(tmp_path / "prof")) as prof:
        solver.make_step()(state)
        common.run_steps(solver.make_step(), state, 2)
    assert prof.key_averages()
    assert (tmp_path / "prof" / "trace.json").exists()
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert [s["steps"] for s in spans] == [2]
    assert spans[0]["flag_reads"] == 0 and spans[0]["host_ns"] > 0


def test_config_builds_solver(tmp_path):
    """The JSON case config: BC words, tau and thermo through the
    registries; words the port lacks name their ROADMAP item."""
    cfg = {"solver": "QGDFoam", "mesh": {"shape": [8, 4]},
           "thermo": {"type": "psiPerfectGas", "R": 287.0, "Cp": 1004.5,
                      "transport": {"type": "const", "mu0": 1e-5}},
           "tau": {"type": "varScModel5", "rC": 0.4},
           "controlDict": {"maxCo": 0.3},
           "boundary": {"U": {"x_lo": {"type": "fixedValue",
                                       "value": [10.0, 0.0]},
                              "y_hi": {"type": "noSlip"}},
                        "p": {"x_hi": {"type": "qgdFlux"}}}}
    path = tmp_path / "case.json"
    path.write_text(json.dumps(cfg))
    solver = config.load_case(str(path), device="cpu")
    assert solver.tau_model.rC == 0.4 and solver.time.max_co == 0.3
    assert solver.bc_U[1, 1].value == [0.0, 0.0]
    assert solver._flux_sides() == ((0, 1),)
    common.run_steps(solver.make_step(), solver.init(
        p0=torch.full((8, 4), 1e5), T0=torch.full((8, 4), 300.0),
        U0=torch.zeros((2, 8, 4))), 2)
    # the waveTransmissive and cosVelocity words build and run
    wt = dict(cfg, boundary={
        "p": {"x_hi": {"type": "waveTransmissive", "fieldInf": 1e5,
                       "lInf": 0.5}},
        "U": {"x_lo": {"type": "cosVelocity", "amplitude": 2.0,
                       "omega0": 100.0, "phi0": 0.3, "height": 1.0}}})
    solver = config.build_solver(wt, device="cpu")
    assert [w[0] for w in solver._wt_sides()] == ["p"]
    s = common.run_steps(solver.make_step(), solver.init(
        p0=torch.full((8, 4), 1e5), T0=torch.full((8, 4), 300.0),
        U0=torch.zeros((2, 8, 4))), 2)
    assert len(s.wt) == 1 and bool(torch.isfinite(s.rhoU).all())
    assert float(s.rhoU[0].abs().max()) > 0.0
    # interQHDFoam (item 9) is ported since: its config needs its phases
    with pytest.raises(ValueError, match="props"):
        config.build_solver(dict(cfg, solver="interQHDFoam"), device="cpu")
    # the JANAF thermo word is ported since: it builds its thermo
    janaf = {"type": "janafPerfectGas", "janaf": {
        "R": 296.8, "low": [3.3, 1.4e-3, -4e-6, 5.6e-9, -2.4e-12, -1e3, 4.0],
        "high": [2.9, 1.5e-3, -5.7e-7, 1e-10, -6.8e-15, -923.0, 6.0]}}
    solver = config.build_solver(dict(cfg, thermo=janaf), device="cpu")
    assert type(solver.thermo).__name__ == "JanafPerfectGasThermo"
