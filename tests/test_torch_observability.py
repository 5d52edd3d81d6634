"""The port's spans (`utils.observability`): off while no `torch.profiler`
session is open (no profiler range entered, nothing logged); under a
session on the CPU, `qgd.run_steps` > `qgd.step` > `qgd.smooth_sensor` >
`qgd.flag_read` nested in time in the profiler's events, and a summary a
`run_steps` call that counts its steps and flag reads, for the 3D step and
the 2D K2 step; `StepLogger`'s rate over finished work; and the
benchmark's two readers of the summaries on made-up runs."""
import time
import types

import numpy as np
import pytest
import torch

from qgdsolver_tpu_torch import cases
from qgdsolver_tpu_torch.ops import fused_qgd2d, fused_qgd3d, smoothing
from qgdsolver_tpu_torch.solvers import common
from qgdsolver_tpu_torch.utils import observability

STEPS = 4


def _bumped(solver, state):
    """A density jump in x, so the sensor's smoothing runs rings past the
    emitted first one and reads more than one flag a step."""
    x = torch.as_tensor(np.asarray(solver.mesh.centers[0]))
    bump = 1.0 + 0.4 * (torch.abs(x - x[len(x) // 2]) < 0.1).to(
        state.rho.dtype)
    bump = bump.reshape((-1,) + (1,) * (state.rho.ndim - 1))
    return state._replace(rho=state.rho * bump, rhoE=state.rhoE * bump)


def _run_3d():
    """(step, carry) of the 3D varScModel5 jet's plain fused step."""
    solver, state = cases.supersonic_jet_3d_varsc(shape=(24, 6, 8),
                                                  device="cpu")
    step, to_f, _ = fused_qgd3d.build_fused_step_3d(solver, plain=True)
    return step, to_f(_bumped(solver, state))


def _run_2d():
    """(step, carry) of the 2D varScModel5 jet's K2 step (plain)."""
    solver, state = cases.supersonic_jet_varsc(shape=(48, 16), device="cpu")
    step, to_f, _ = fused_qgd2d.build_tiled_fused_step(solver, plain=True)
    return step, to_f(_bumped(solver, state))


def test_no_profiler_no_span(monkeypatch):
    """Untraced, a run records nothing and enters no profiler range."""
    calls = []

    def counted(real):
        def enter(*a, **kw):
            calls.append(a)
            return real(*a, **kw)
        return enter

    monkeypatch.setattr(observability, "span", counted(observability.span))
    for mod in (torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function",
                            counted(mod.record_function))
    step, fs = _run_3d()
    before = observability.segment_log()
    reads = smoothing.smooth_sensor.reads
    common.run_steps(step, fs, STEPS)
    assert smoothing.smooth_sensor.reads - reads >= STEPS
    assert observability.segment_log() == before
    assert observability.active is None
    assert calls == []


def _inside(inner, outer):
    return outer.time_range.start <= inner.time_range.start and \
        inner.time_range.end <= outer.time_range.end


@pytest.mark.parametrize("build", [_run_3d, _run_2d], ids=["3d", "2d_k2"])
def test_spans_nest_and_count_under_the_profiler(build):
    from torch.profiler import ProfilerActivity, profile

    step, fs = build()
    fs = step(fs)  # the first frame of the sensor, untraced
    reads = smoothing.smooth_sensor.reads
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        common.run_steps(step, fs, STEPS)
    reads = smoothing.smooth_sensor.reads - reads
    assert reads > STEPS  # the bump runs rings past the emitted one
    by = {}
    for e in prof.events():
        if e.name.startswith("qgd."):
            by.setdefault(e.name, []).append(e)
    assert len(by["qgd.run_steps"]) == 1
    assert len(by["qgd.step"]) == STEPS
    assert len(by["qgd.smooth_sensor"]) == STEPS
    assert len(by["qgd.flag_read"]) == reads
    for inner, outer in (("qgd.step", "qgd.run_steps"),
                         ("qgd.smooth_sensor", "qgd.step"),
                         ("qgd.flag_read", "qgd.smooth_sensor")):
        for e in by[inner]:
            assert any(_inside(e, o) for o in by[outer]), (inner, outer)
    seg = observability.segment_log()[-1]
    assert seg["steps"] == STEPS and seg["flag_reads"] == reads
    assert seg["refills"] == 0 and seg["refill_us"] == 0.0  # no card
    assert 0 < seg["flag_read_ns"] < seg["host_ns"]
    assert 0 < seg["step_self_ns"] < seg["host_ns"]
    assert observability.active is None


def test_trace_writes_the_spans_of_its_block(tmp_path):
    import json

    step, fs = _run_3d()
    with observability.trace(str(tmp_path / "prof")):
        common.run_steps(step, fs, 2)
        common.run_steps(step, fs, 3)
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert [s["steps"] for s in spans] == [2, 3]


def test_step_logger_rate_spans_the_wait_for_the_device():
    """Reading t waits for the device; the rate's clock is read after it."""

    class SlowT:
        def __float__(self):
            time.sleep(0.05)
            return 1.0

    lines = []
    log = observability.StepLogger((100, 10), every=1, out=lines.append)
    state = types.SimpleNamespace(t=SlowT(), dt=torch.tensor(1e-3))
    log(1, state)
    rate = float(lines[0].split("points/s=")[1].split()[0])
    assert rate <= 1000 / 0.05


def _reader(name):
    from qgdbench import harness

    return harness.reader({"name": name})


def _summary(steps, refills, refill_us, step_self_ns):
    return {"steps": steps, "host_ns": 0, "step_self_ns": step_self_ns,
            "flag_reads": refills, "flag_read_ns": 0, "refills": refills,
            "refill_us": refill_us}


@pytest.mark.parametrize("name,want", [("smooth.refill_us", 1000.0 / 10),
                                       ("step.host_self_ms", 0.25)])
def test_readers_take_the_window_segments(name, want, monkeypatch):
    """The last `segments` summaries, each of `seg_steps` steps: an earlier
    one is left out; untraced, too few or a wrong step count read None."""
    log = [_summary(7, 99, 9e9, 9e12),  # not the window's
           _summary(20, 4, 400.0, 4_000_000),
           _summary(20, 6, 600.0, 6_000_000)]
    monkeypatch.setattr(observability, "segment_log", lambda: list(log))
    read = _reader(name)
    run = types.SimpleNamespace(trace=object(), segments=2, seg_steps=20)
    assert read(run) == pytest.approx(want)
    assert read(types.SimpleNamespace(trace=None, segments=2,
                                      seg_steps=20)) is None
    assert read(types.SimpleNamespace(trace=object(), segments=4,
                                      seg_steps=20)) is None
    assert read(types.SimpleNamespace(trace=object(), segments=3,
                                      seg_steps=20)) is None
    monkeypatch.delattr(observability, "segment_log")
    assert read(run) is None  # a program that keeps no log
