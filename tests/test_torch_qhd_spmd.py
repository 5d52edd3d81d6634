"""The port's decomposed QHD family and scalar transport on two gloo ranks
on the CPU, against the serial port.  Mirrors tests/test_spmd.py's
test_qhd_cavity_parity_cg and test_scalar_box_periodic_wraparound, which
hold the JAX package's decomposed step to its serial one.

The ranks run `parallel.sharding.build_spmd_step` (rank bodies in
tests/_torch_rank_bodies.py, which imports no JAX): the buoyant cavity
(the singular pressure solve, its mean projection and the pRef fix through
`spmd.first_shard_value`, implicit U and T) split along x, the cavity with
the MULES T equation split along y, the MULES box with its top hat's front on
the partition edge (the limiter's upwind donors and ratios from the
neighbour rank, global bounds) split along x, and the periodic scalar box
(the periodic wrap across ranks) split along x.  Bound: each field within
2*n*cg_tol of its max after n steps, the CG's dots being all-reduced sums
in another order than the serial sums.
"""
import numpy as np
import pytest
import torch

import _torch_rank_bodies as bodies
from qgdsolver_tpu_torch import cases, interop
from qgdsolver_tpu_torch.parallel import distributed, spmd
from qgdsolver_tpu_torch.solvers import common

F64 = torch.float64
# key: (case, shape, (px, py), steps)
CASES = {
    "cavity_2x1": ("buoyant_cavity", (32, 32), (2, 1), 8),
    "mules_cavity_1x2": ("mules_cavity", (32, 32), (1, 2), 8),
    "mules_box_2x1": ("mules_box", (64, 8), (2, 1), 10),
    "scalar_box_2x1": ("scalar_box", (32, 32), (2, 1), 10),
}


def _initial(name, shape):
    if name == "mules_box":
        return bodies.mules_box(shape, F64, "cpu")[1]
    base = "buoyant_cavity" if name == "mules_cavity" else name
    return getattr(cases, base)(shape=shape, device="cpu")[1]


@pytest.fixture(scope="module")
def world():
    """Every case on one 2-rank world: {key: per-rank gathered States}."""
    jobs = [("spmd", name, shape, "float64", grid, steps,
             interop.state_to_numpy(_initial(name, shape)))
            for name, shape, grid, steps in CASES.values()]
    per_rank = distributed.spawn(bodies.run_jobs, 2, jobs, "cpu",
                                 device="cpu", timeout=120)
    return {key: [r[i][0] for r in per_rank] for i, key in enumerate(CASES)}


@pytest.mark.parametrize("key", list(CASES))
def test_two_ranks_match_serial_port(world, key):
    name, shape, _, steps = CASES[key]
    solver = bodies.port_case(name, shape, F64)
    s = common.run_steps(solver.make_step(), _initial(name, shape), steps)
    ref = interop.state_to_numpy(s)
    tol = 2 * steps * solver.cg_tol
    for got in world[key]:
        assert type(got).__name__ == type(ref).__name__ == "State"
        for f in ref._fields:
            a, b = getattr(ref, f), getattr(got, f)
            assert np.abs(a - b).max() <= tol * max(np.abs(a).max(),
                                                    1e-300), (key, f)
    start = interop.state_to_numpy(_initial(name, shape))
    assert max(np.abs(getattr(ref, f) - getattr(start, f)).max()
               for f in ("U", "T")) > 1e-8, "the state must evolve"


def test_first_shard_value_is_a_noop_serially():
    v = torch.tensor(3.0)
    assert spmd.first_shard_value(v) is v
