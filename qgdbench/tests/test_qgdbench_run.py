"""A run end to end at a tiny mesh on the CPU, through the program's plain
path: the window, the check against the reference, the counters; and the
measuring entry's refusal to run without a card."""
import json
import os
import subprocess
import sys

import pytest

from qgdbench import harness

from . import _tiny


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_window_and_check_run_end_to_end(name):
    cell = _tiny.cell(name)
    run = harness.measure(cell, 2**33 + 1, 0.2, device="cpu", plain=True)
    assert run.segments >= 1 and run.steps == run.segments * 20
    assert run.failed == 0 and set(run.gaps) == set(cell.limits)
    assert harness.correct(run), run.gaps
    assert run.window_s >= 0.2 and run.setup_s > 0 and run.trace is None
    assert run.memory_peak_bytes is None
    reads = run.counters["smoothing.smooth_sensor.reads"]
    if "sensor_gap" in cell.limits:
        assert reads >= run.steps  # one flag read a step at least
    else:
        assert reads == 0


def test_a_cpu_run_writes_no_device_metric():
    cell = _tiny.cell("duct3d.steady")
    run = harness.measure(cell, 5, 0.0, device="cpu", plain=True)
    with pytest.raises(RuntimeError, match="off the card"):
        harness.result(run, cell, trace=False)


@pytest.mark.parametrize("trace", ("0", "1"))
def test_the_entry_refuses_without_a_card(trace):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "qgdbench", "--workload", "duct3d.steady",
         "--seed", "3", "--seconds", "1", "--trace", trace],
        cwd=harness.ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 3, out.stderr
    assert out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr


def test_the_entry_needs_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the harness, a run fails
    and prints no result."""
    import shutil

    shutil.copytree(harness.HERE, tmp_path / "qgdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "qgdbench", "--workload", "duct3d.steady",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.stdout or "x")
