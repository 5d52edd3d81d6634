"""The 2D cell (`jet2d_varsc.shocked`: the fused 2D family, K2) and the calm
3D jet (`jet3d_varsc.calm`) at a mesh a CPU test holds, through the
program's plain path: a run end to end, the reference's constants and the
traffic's fields against the case builder's, `correct` failing where it
should, the 2D kernels' byte counts and the readers of the 2D metrics.
The 2D mesh stays one cell deep, so its z extent and the inlet's z centre
are those of the configuration at any (nx, ny)."""
import json
import subprocess
import sys
import types

import pytest
import torch
from qgdsolver_tpu_torch import cases
from qgdsolver_tpu_torch.ops import fused_qgd2d, smoothing

from qgdbench import calibrate, generator, harness, roofline, roofline2d
from qgdbench.reference import qgd2d

from . import _tiny

SHAPE2D = [64, 32, 1]
CELLS2D = ("jet2d_varsc.shocked",)
CALM = "jet3d_varsc.calm"
SEEDS = (1, 2**32 + 3, 2**40 + 5)


def _cell(name, shape=None):
    if name in CELLS2D:
        return _tiny.cell(name, shape or SHAPE2D)
    return _tiny.cell(name, shape or _tiny.SHAPE)


def _run(name, seconds=0.0):
    cell = _cell(name)
    run = harness.measure(cell, 2**35 + 9, seconds, device="cpu", plain=True)
    return run, harness.correct(run)


@pytest.mark.parametrize("name", CELLS2D + (CALM,))
def test_window_and_check_run_end_to_end(name):
    run, ok = _run(name, 0.2)
    assert run.segments >= 1 and run.steps == run.segments * 20
    assert run.failed == 0 and set(run.gaps) == set(run.limits)
    assert ok, run.gaps
    reads = run.counters["smoothing.smooth_sensor.reads"]
    if name == CALM:
        # the emitted ring 1 is the fixed point: one flag read a step, no
        # ring continued
        assert reads == run.steps
        assert run.counters["smoothing.smooth_sensor.rings"] == 0
    else:
        assert reads > run.steps
        assert run.counters["smoothing.smooth_sensor.rings"] > 0


@pytest.mark.parametrize("name", CELLS2D + (CALM,))
def test_the_sound_run_is_bitwise_the_reference_on_the_cpu(name):
    """On the CPU the program's plain path and the frozen reference are the
    same torch operations: every gap is 0."""
    run, ok = _run(name)
    assert ok and all(v == 0.0 for v in run.gaps.values()), run.gaps


@pytest.mark.parametrize("name", CELLS2D + (CALM,))
@pytest.mark.parametrize("seed", SEEDS)
def test_the_bfloat16_control_fails(name, seed):
    cell = _cell(name)
    gaps = calibrate.control_gaps(cell, seed, "cpu")
    assert any(gaps[k] > cell.limits[k] for k in cell.limits), gaps


def test_the_cell_runs_k2():
    """The configuration's solver is sent to K2 by `make_fused_step`."""
    cfg = _cell(CELLS2D[0]).cfg
    solver, _ = getattr(cases, cfg["case"])(shape=tuple(cfg["shape"][:2]),
                                            mach=cfg["mach"], device="cpu")
    assert solver.fused_builder() is fused_qgd2d.build_tiled_fused_step
    assert fused_qgd2d.folds_sensor(solver)


def test_reference_constants_are_the_programs():
    """The reference's constants and BC table, worked out from the
    configuration's file, equal those the program derives from its case
    builder (`fused_qgd2d.make_params`); the inlet slot's plane is equal
    bit for bit."""
    cfg = _cell(CELLS2D[0], [48, 20, 1]).cfg
    solver, _ = getattr(cases, cfg["case"])(shape=tuple(cfg["shape"][:2]),
                                            mach=cfg["mach"], device="cpu")
    prm, profiles = fused_qgd2d.make_params(solver)
    ref = qgd2d.params(cfg)
    for field in ("nx", "ny", "dx", "dy", "inv_dx", "inv_dy", "inv_2dx",
                  "inv_2dy", "hfx", "hfy", "inv_hfx", "inv_hfy", "inv_vol",
                  "R", "Cv", "inv_Cv", "CvR", "gammaR", "gamma", "alpha",
                  "k_mu", "k_muv", "Pr_tau", "inv_Pr_tau", "Pr_th", "mu0",
                  "max_co", "max_dt", "c_tau", "h_cell", "rC", "one_m_rC",
                  "minSc", "maxSc", "cqSc", "smooth_ratio"):
        assert getattr(prm, field) == getattr(ref, field), field
    assert (bool(prm.varsc), bool(prm.mu_const0), bool(prm.adjust_dt)) == \
        (ref.varsc, ref.mu_const0, ref.adjust_dt)
    tc = solver.time
    assert (tc.adjust_time_step, tc.max_co, tc.max_dt, tc.c_tau, tc.dt0) == \
        tuple(cfg["time"][k] for k in ("adjust_time_step", "max_co",
                                       "max_dt", "c_tau", "dt0"))
    kinds = {v: k for k, v in fused_qgd2d.KINDS.items()}
    planes = 0
    for f in range(4):
        for a in range(2):
            for side in (0, 1):
                e, r = prm.bc[f][a][side], ref.bc[f][a][side]
                assert kinds[e.kind] == r.kind, (f, a, side)
                if e.prof >= 0:  # a plane; the reference may hold a number
                    n = cfg["shape"][1 - a]
                    plane = torch.as_tensor(profiles[e.prof, 1:n + 1])
                    assert torch.equal(plane, torch.as_tensor(
                        r.value, dtype=plane.dtype).expand_as(plane)), \
                        (f, a, side)
                    planes += 1
                elif r.kind == "fixed":
                    assert e.value == r.value, (f, a, side)
    assert planes == 2  # the slot's ux and uy


def test_the_traffics_fields_are_the_builders():
    """The generator's one-cell-deep fields, through `solver.init`, give the
    case builder's own initial State: rho and sc bit for bit, rhoU and rhoE
    within two float32 roundings (the builder's velocity is itself the
    round trip (rho*ux0)/rho of its slot profile)."""
    cfg = _cell(CELLS2D[0], [48, 20, 1]).cfg
    solver, state = getattr(cases, cfg["case"])(
        shape=tuple(cfg["shape"][:2]), mach=cfg["mach"], device="cpu")
    fields = generator.fields(cfg, {"segment_steps": 1}, 3, "cpu")
    assert fields["p"].shape == (48, 20, 1)
    assert fields["U"].shape == (3, 48, 20, 1)
    assert not bool(fields["U"][1:].any())
    p, T, U = qgd2d.plane_fields(fields)
    got = solver.init(p0=p, T0=T, U0=U, sc0=fields["sc"][..., 0])
    assert torch.equal(got.rho, state.rho) and torch.equal(got.sc, state.sc)
    eps = torch.finfo(torch.float32).eps
    for k in ("rhoU", "rhoE"):
        a, b = getattr(got, k), getattr(state, k)
        assert bool(((a - b).abs() <= 2 * eps * b.abs()).all()), k


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    build = fused_qgd2d.build_tiled_fused_step

    def unchanged(solver, plain=False):
        _, to_f, from_f = build(solver, plain=plain)
        return (lambda ts: ts), to_f, from_f

    monkeypatch.setattr(fused_qgd2d, "build_tiled_fused_step", unchanged)
    run, ok = _run(CELLS2D[0])
    assert not ok and run.gaps["dt_gap"] > run.limits["dt_gap"]


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    update = fused_qgd2d.update_reference

    def altered(prm, *args):
        frames, side = update(prm, *args)
        frames[0][prm.nx // 2, prm.ny // 2] *= 1.01
        return frames, side

    monkeypatch.setattr(fused_qgd2d, "update_reference", altered)
    run, ok = _run(CELLS2D[0])
    assert not ok and run.gaps["fields_gap"] > run.limits["fields_gap"]


def test_the_smoothing_continuation_left_out(monkeypatch):
    """The sensor frame is ring 1 framed, not carried to the fixed
    point."""
    monkeypatch.setattr(
        fused_qgd2d, "smooth_sensor",
        lambda prm, s1, chg, smooth, k, cache=None: smoothing._edge_frame(s1))
    run, ok = _run(CELLS2D[0])
    assert not ok and run.gaps["sensor_gap"] > run.limits["sensor_gap"]


@pytest.mark.parametrize("seed", (0, 7, 2**31 + 5, 2**40 + 123))
def test_same_seed_same_fields_other_seed_other_fields(seed):
    cell = _cell(CELLS2D[0])
    a = generator.fields(cell.cfg, cell.mix, seed, "cpu")
    b = generator.fields(cell.cfg, cell.mix, seed, "cpu")
    c = generator.fields(cell.cfg, cell.mix, seed + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["p"], c["p"])
    assert all(x.dtype == torch.float32 and bool(torch.isfinite(x).all())
               for x in a.values())


@pytest.mark.parametrize("name", ("qgd2d_dt", "qgd2d_dt_fold", "qgd2d_update",
                                  "qgd2d_ghosts", "qgd2d_emit",
                                  "qgd2d_smooth"))
@pytest.mark.parametrize("shape", ((64, 32), (8192, 4096), (1024, 512)))
@pytest.mark.parametrize("varsc", (False, True))
def test_the_2d_byte_counts_are_chip_smokes(name, shape, varsc):
    import chip_smoke

    assert roofline2d.work_bytes(name, shape, varsc) == \
        chip_smoke.work_bytes(name, shape, varsc)


def test_the_2d_rooflines_read_the_trace_and_the_counters():
    """Each 2D roofline is its least time over the mean device time of a
    launch (the emit's two device operations together); no kernel in the
    trace, no reading."""
    cell = harness.resolve(harness.load_benchmark(), CELLS2D[0])
    read = {m["name"]: harness.reader(m) for m in cell.per_layer}
    mod = {n: harness.load_module(harness.HERE / "metrics" / f"{n}.py")
           for n in ("qgd2d_update_roofline", "qgd2d_emit_roofline",
                     "qgd2d_smooth_roofline")}
    trace = types.SimpleNamespace(kernels={
        "qgd2d_update": [2e-3, 4e-3], "qgd2d_emit_partial": [1e-3, 1e-3],
        "qgd2d_emit_final": [1e-5, 3e-5], "qgd2d_smooth": [1e-3] * 3},
        busy_s=1.0)
    run = types.SimpleNamespace(
        cfg=cell.cfg, trace=trace, steps=2, window_s=2.0,
        counters={"fused_qgd2d.qgd2d_smooth.launches": 3,
                  "fused_qgd2d.qgd2d_smooth.rings": 32})
    upd = mod["qgd2d_update_roofline"].least_ms(cell.cfg)
    assert read["qgd2d_update_roofline"](run) == pytest.approx(
        100.0 * upd * 1e-3 / 3e-3)
    emit = mod["qgd2d_emit_roofline"].least_ms(cell.cfg)
    assert read["qgd2d_emit_roofline"](run) == pytest.approx(
        100.0 * emit * 1e-3 / 1.02e-3)
    sm = mod["qgd2d_smooth_roofline"].least_ms(cell.cfg, 11)
    assert read["qgd2d_smooth_roofline"](run) == pytest.approx(
        100.0 * sm * 1e-3 / 1e-3)
    assert read["smooth2d.rings_per_step"](run) == 16.0
    # each bound is the frozen bytes' (the kernels are bandwidth-bound)
    shape = cell.cfg["shape"][:2]
    assert upd == pytest.approx(roofline.bound(
        roofline2d.work_bytes("qgd2d_update", shape, True), 0)[0])
    run.trace = None
    assert all(read[n](run) is None for n in mod)


@pytest.mark.parametrize("name", CELLS2D + (CALM,))
def test_the_shared_readers_read_the_new_cells(name):
    """The step loop's and the smoothing's readers listed for the new cells
    find their family's least step and the shared counters; the calm jet
    continues no ring."""
    run, _ = _run(name)
    cell = harness.resolve(harness.load_benchmark(), name)
    listed = {m["name"] for m in cell.per_layer}
    shared = {"step_roofline", "smooth.flag_reads_per_step"}
    assert shared <= listed
    assert ("smooth.rings_per_step" in listed) == (name == CALM)
    run.trace = types.SimpleNamespace(kernels={}, busy_s=1.0)
    got = {n: harness.reader({"name": n})(run)
           for n in shared | {"smooth.rings_per_step"}}
    assert 0.0 < got["step_roofline"] < 100.0
    assert got["smooth.flag_reads_per_step"] == pytest.approx(
        run.counters["smoothing.smooth_sensor.reads"] / run.steps)
    if name == CALM:
        assert got["smooth.flag_reads_per_step"] == 1.0
        assert got["smooth.rings_per_step"] == 0.0
    else:
        assert got["smooth.flag_reads_per_step"] > 1.0
        assert got["smooth.rings_per_step"] is None


def test_the_2d_reference_loads_nothing_of_the_program():
    code = ("import sys, json\n"
            "from qgdbench import generator\n"
            "from qgdbench.reference import qgd2d\n"
            "cfg = json.load(open('qgdbench/configs/jet2d_varsc.json'))\n"
            "cfg['shape'] = [16, 8, 1]\n"
            "mix = json.load(open('qgdbench/traffic/shocked.json'))\n"
            "qgd2d.run(cfg, generator.fields(cfg, mix, 1, 'cpu'), 2)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().splitlines()[-1]
                         .replace("'", '"')))
    assert "torch" in top
    assert not top & (set(harness.FORBIDDEN) | {"qgdsolver_tpu_torch"})


def _card_run(name, shape, trace) -> dict:
    """One run of a cell at `shape` on the card in a fresh interpreter, as
    the benchmark makes each run: a process that has already traced a
    window or two can lose the profiler's marker in every session."""
    code = ("import json\n"
            "from qgdbench import harness\n"
            f"cell = harness.resolve(harness.load_benchmark(), {name!r})\n"
            f"cell.cfg['shape'] = {list(shape)!r}\n"
            f"run = harness.measure(cell, 2**34 + 1, 0.5, trace={trace})\n"
            "print(json.dumps({'line': harness.result(run, cell, "
            f"{trace}), 'counters': run.counters, 'steps': run.steps}}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS2D + (CALM,))
@pytest.mark.parametrize("trace", (False, True))
def test_a_small_cell_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = _cell(name)
    got = _card_run(name, [256, 128, 1] if name in CELLS2D else [64, 30, 30],
                    trace)
    line = got["line"]
    assert line["correct"], line["checks"]
    want = cell.per_layer if trace else cell.end_to_end
    assert {m["name"] for m in want} >= set(line["metrics"])
    if name in CELLS2D:
        c, steps = got["counters"], got["steps"]
        assert c["fused_qgd2d.qgd2d_update.launches"] == steps
        assert c["fused_qgd2d.qgd2d_emit.launches"] >= steps
        assert c["fused_qgd2d.qgd2d_dt.launches"] == 0
        assert c["fused_qgd2d.qgd2d_smooth.rings"] > 0
        if trace:
            assert set(line["metrics"]) == {m["name"] for m in want}
