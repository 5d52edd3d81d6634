"""The traffic generator: a seed gives the same fields every time, another
seed other fields, and every seed the same sizes of disturbance."""
import numpy as np
import pytest
import torch

from qgdbench import generator

from . import _tiny

SEEDS = (0, 7, 2**31 + 5, 2**40 + 123)


@pytest.mark.parametrize("name", _tiny.CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_fields_other_seed_other_fields(name, seed):
    cell = _tiny.cell(name)
    a = generator.fields(cell.cfg, cell.mix, seed, "cpu")
    b = generator.fields(cell.cfg, cell.mix, seed, "cpu")
    c = generator.fields(cell.cfg, cell.mix, seed + 1, "cpu")
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["p"], c["p"])
    nx, ny, nz = cell.cfg["shape"]
    assert a["p"].shape == (nx, ny, nz) and a["U"].shape == (3, nx, ny, nz)
    assert all(x.dtype == torch.float32 and bool(torch.isfinite(x).all())
               for x in a.values())
    assert ("sc" in a) == (cell.cfg["tau_model"]["name"] == "varScModel5")


@pytest.mark.parametrize("seed", SEEDS)
def test_slabs_keep_their_sizes_and_gaps(seed):
    mix = _tiny.cell("jet3d_varsc.shocked").mix
    slabs = mix["density_factor"]["slabs"]
    drawn = generator.draws(mix, seed)["slabs"]
    centres = [x for x, _ in drawn]
    assert sorted(a for _, a in drawn) == sorted(slabs["amplitudes"])
    assert np.all(np.diff(centres) >= slabs["min_gap"])
    lo, hi = slabs["x_range"]
    assert all(lo <= x <= hi for x in centres)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_density_factor_multiplies_p_alone(seed):
    """rho and rhoE times one factor is p times it, with T and U as the
    configuration's base fields."""
    cell = _tiny.cell("duct3d.steady")
    got = generator.fields(cell.cfg, cell.mix, seed, "cpu")
    calm = generator.fields(cell.cfg, {"segment_steps": 1}, seed, "cpu")
    f = generator.density_factor(cell.cfg, cell.mix, seed, "cpu",
                                 torch.float32)
    assert torch.equal(got["T"], calm["T"]) and torch.equal(got["U"],
                                                            calm["U"])
    assert torch.equal(got["p"], calm["p"] * f)
    assert 0.995 < float(f.min()) and float(f.max()) < 1.005
