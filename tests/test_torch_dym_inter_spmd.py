"""The port's decomposed QHDDyMFoam and interQHDFoam on gloo ranks on the
CPU, against the serial port.  Mirrors tests/test_spmd.py's
test_dym_deforming_spmd_parity_2x2 and
test_general_mesh_motion_spmd_parity_2x2, which hold the JAX package's
decomposed step to its serial one, and decomposes interQHDFoam.

The ranks run `parallel.sharding.build_spmd_step` (rank bodies in
tests/_torch_rank_bodies.py, no JAX).  A 4-rank world runs the dilating
mesh (with a rigid velocity and the mesh Courant cap) and the general face
motion (each block windows the step's moved geometry, `TracedShardMesh`)
on 2x2 blocks.  A 2-rank world runs a graded two-phase drop on 1x2 blocks
(split along y: its floor's contact angle, its graded spacing and its
interface all meet the partition face), with surface tension, gravity,
the alpha smoothing and a pure-Neumann p.  The JAX package's shard body
does not compute that drop as its serial step does: at a partition face
it takes the block's own edge cell as the compression flux's upwind donor,
zeroes the compression flux, subtracts each block's own corner pressure as
pRef, takes deltaN from the block's mean cell volume and applies the
floor's contact angle at the block's edge.  The port repairs each, and the
world runs the drop once more with each of those faults put back
(`_torch_rank_bodies._fault_patches`): each such run must part from the
serial one.  Bound: each field within 2*n*cg_tol of its max after n steps.
"""
import numpy as np
import pytest
import torch

import _torch_rank_bodies as bodies
from qgdsolver_tpu_torch import interop
from qgdsolver_tpu_torch.parallel import distributed, sharding
from qgdsolver_tpu_torch.solvers import common

F64 = torch.float64
# key: (case, shape, steps)
DYM = {"dilation_2x2": ("dym_dilation", (24, 24), 6),
       "general_2x2": ("dym_general", (24, 24), 6)}
FAULTS = ("upwind", "pref", "compression", "delta_n", "contact")
DROP = {"drop": ("graded_drop", (16, 16), 3),
        **{f"drop!{f}": (f"graded_drop!{f}", (16, 16), 1) for f in FAULTS}}


def _build(name, shape):
    return getattr(bodies, name.partition("!")[0])(shape, F64, "cpu")


def _world(cases, grid):
    jobs = [("spmd", name, shape, "float64", grid, steps,
             interop.state_to_numpy(_build(name, shape)[1]))
            for name, shape, steps in cases.values()]
    per_rank = distributed.spawn(bodies.run_jobs, grid[0] * grid[1], jobs,
                                 "cpu", device="cpu", timeout=240)
    return {key: [r[i][0] for r in per_rank] for i, key in enumerate(cases)}


@pytest.fixture(scope="module")
def dym_world():
    """The moving meshes on one 4-rank world (2x2 blocks)."""
    return _world(DYM, (2, 2))


@pytest.fixture(scope="module")
def drop_world():
    """The drop and its fault runs on one 2-rank world (1x2 blocks)."""
    return _world(DROP, (1, 2))


def _gaps(name, shape, steps, ranks):
    """(max over the ranks and fields of |serial - gathered| / max|serial|,
    the bound 2*n*cg_tol, the serial solver and State)."""
    solver, s0 = _build(name, shape)
    ref = interop.state_to_numpy(common.run_steps(solver.make_step(), s0,
                                                  steps))
    gap = max(np.abs(getattr(ref, f) - getattr(got, f)).max()
              / max(np.abs(getattr(ref, f)).max(), 1e-300)
              for got in ranks for f in ref._fields)
    return gap, 2 * steps * solver.cg_tol, solver, ref


@pytest.mark.parametrize("key", list(DYM))
def test_moving_mesh_ranks_match_serial_port(dym_world, key):
    """Both motion classes decompose: every rank's gathered State within
    2*n*cg_tol of the serial port's, the fields evolving."""
    name, shape, steps = DYM[key]
    gap, tol, solver, ref = _gaps(name, shape, steps, dym_world[key])
    assert sharding.spmd_supported(solver) is None
    assert gap <= tol, (key, gap)
    start = interop.state_to_numpy(_build(name, shape)[1])
    assert np.abs(ref.T - start.T).max() > 1e-6
    assert float(ref.t) > 0.0


def test_drop_ranks_match_serial_port(drop_world):
    """The decomposed drop is the serial drop within 2*n*cg_tol, and it
    moved (a falling drop with surface tension)."""
    name, shape, steps = DROP["drop"]
    gap, tol, _, ref = _gaps(name, shape, steps, drop_world["drop"])
    assert gap <= tol, gap
    assert np.abs(ref.U).max() > 1e-4
    assert ref.alpha1.min() >= 0.0 and ref.alpha1.max() <= 1.0


@pytest.mark.parametrize("fault", FAULTS)
def test_each_reference_fault_parts_from_serial(drop_world, fault):
    """With one of the JAX package's decomposition faults put back, one
    step of the decomposed drop parts from the serial step by far more than
    the bound: the repair is what keeps it there."""
    key = f"drop!{fault}"
    name, shape, steps = DROP[key]
    gap, tol, _, _ = _gaps(name, shape, steps, drop_world[key])
    assert gap > 10 * tol, (fault, gap)
