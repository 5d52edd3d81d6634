"""On a card: a cell's run through the kernels at a small mesh, correct,
with its metrics, and the bfloat16 control failing there too.  Skips
without a card (decided inside the test)."""
import pytest
import torch

from qgdbench import generator, harness

from . import _tiny


@pytest.mark.gpu
@pytest.mark.parametrize("name", _tiny.CELLS)
@pytest.mark.parametrize("trace", (False, True))
def test_a_small_cell_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = _tiny.cell(name, shape=(64, 30, 30))
    run = harness.measure(cell, 2**34 + 1, 0.5, trace=trace)
    line = harness.result(run, cell, trace)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    want = cell.per_layer if trace else cell.end_to_end
    assert {m["name"] for m in want} >= set(line["metrics"])
    assert list(line)[-1] == "checks"
    fam, n = cell.family, cell.mix["segment_steps"]
    ref = fam.reference(cell.cfg, generator.fields(cell.cfg, cell.mix, 5,
                                                   "cuda"), n)
    low = fam.reference(cell.cfg, generator.fields(cell.cfg, cell.mix, 5,
                                                   "cuda"), n,
                        dtype=torch.bfloat16)
    gaps = fam.gaps(low, ref)
    assert any(gaps[k] > cell.limits[k] for k in cell.limits), gaps
