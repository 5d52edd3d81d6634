"""`correct` fails where it should: with the timed path broken underneath a
run (the harness's look for a card skipped, the program on its plain path
at a tiny mesh on the CPU), and for the control, the plain reference in
bfloat16 in the program's place.  The faults a cell of one chip and no
batch can have: a step that returns its state unchanged, an answer altered
where it is produced, and, where the cell's layer is the smoothing, its
continuation left out."""
import pytest
from qgdsolver_tpu_torch.ops import fused_qgd3d

from qgdbench import calibrate, harness

from . import _tiny


def _run(name):
    cell = _tiny.cell(name)
    run = harness.measure(cell, 2**35 + 9, 0.0, device="cpu", plain=True)
    return run, harness.correct(run)


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_a_step_that_returns_its_state_unchanged(name, monkeypatch):
    build = fused_qgd3d.build_fused_step_3d

    def unchanged(solver, plain=False):
        _, to_f, from_f = build(solver, plain=plain)
        return (lambda fs: fs), to_f, from_f

    monkeypatch.setattr(fused_qgd3d, "build_fused_step_3d", unchanged)
    run, ok = _run(name)
    assert not ok and run.gaps["dt_gap"] > run.limits["dt_gap"]


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_an_answer_altered_where_it_is_produced(name, monkeypatch):
    update = fused_qgd3d.update_reference_3d

    def altered(prm, *args):
        frames, side = update(prm, *args)
        frames[0][prm.nx // 2, prm.ny // 2, prm.nz // 2] *= 1.01
        return frames, side

    monkeypatch.setattr(fused_qgd3d, "update_reference_3d", altered)
    run, ok = _run(name)
    assert not ok and run.gaps["fields_gap"] > run.limits["fields_gap"]


def test_the_smoothing_continuation_left_out(monkeypatch):
    monkeypatch.setattr(fused_qgd3d, "smooth_sensor",
                        lambda prm, s1, chg, smooth, k, cache=None: s1)
    run, ok = _run("jet3d_varsc.shocked")
    assert not ok and run.gaps["sensor_gap"] > run.limits["sensor_gap"]


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_the_sound_run_is_correct(name):
    assert _run(name)[1]


@pytest.mark.parametrize("name", _tiny.CELLS)
@pytest.mark.parametrize("seed", (1, 2**32 + 3, 2**40 + 5))
def test_the_bfloat16_control_fails(name, seed):
    cell = _tiny.cell(name)
    gaps = calibrate.control_gaps(cell, seed, "cpu")
    assert any(gaps[k] > cell.limits[k] for k in cell.limits), gaps
