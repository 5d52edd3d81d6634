"""waveTransmissive on a segment of a split side (a Segmented BC) in the
port's QGDFoam: the segment carries its face values in `State.wt` (a
whole-side layer, the boundary cells' values outside the segment) and
each step substitutes the Mixed condition into that segment alone.

The BC is local to each face, so the oracle is the same case with the
whole side waveTransmissive: after a step, the carried values and the
next step's ghosts on the segment's faces equal the whole-side case's,
bit for bit, on every face whose stencil does not reach across the
segment's border.  The JAX package pads such a segment as a linear
extrapolation without its carried value; the port no longer lets a
waveTransmissive segment reach that extrapolation (`ops.pad`).  The
decomposed runs are in tests/test_torch_spmd.py (`wt_split_outlet_*`).
"""
import os
import re
import shutil

import numpy as np
import pytest
import torch

import _torch_rank_bodies as bodies
from qgdsolver_tpu_torch import cases, cli
from qgdsolver_tpu_torch.core import bc as bcm
from qgdsolver_tpu_torch.core.mesh import Mesh
from qgdsolver_tpu_torch.io import foam_case
from qgdsolver_tpu_torch.ops.pad import ghost_pad
from qgdsolver_tpu_torch.solvers import common, qgd

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
F64 = torch.float64
SHAPE = (32, 16)
K = 3 * SHAPE[1] // 8  # the segment's rows [0, K)


def _perturbed(solver):
    """The jet's initial fields with seeded perturbations of p, T and U
    (so the outlet faces differ from each other), as a State of solver."""
    _, s = cases.supersonic_jet(shape=SHAPE, dtype=F64, device="cpu")
    U, _, T, p = solver.primitives(s)
    rng = np.random.default_rng(3)

    def noise(x, scale):
        return scale * torch.as_tensor(rng.standard_normal(x.shape))

    return solver.init(p * (1.0 + noise(p, 0.02)),
                       T * (1.0 + noise(T, 0.02)), U + noise(U, 20.0))


def _two_steps(solver, monkeypatch):
    """(State after one step, the outlet ghost rows of p, T, U padded in
    the second step, State after two)."""
    pads = []

    def recorded(f, bcs, mesh, **kw):
        out = ghost_pad(f, bcs, mesh, **kw)
        pads.append(out)
        return out

    monkeypatch.setattr(qgd, "ghost_pad", recorded)
    step = solver.make_step()
    s1 = step(_perturbed(solver))
    pads.clear()
    s2 = step(s1)
    return s1, [x[..., -1, 1:-1] for x in pads[:3]], s2


def test_wt_segment_carries_as_the_whole_side(monkeypatch):
    """p and T waveTransmissive on rows [0, K) of the outlet side, the
    jet's fixed p and zero-gradient T on the rest, against the same BCs on
    the whole side: the carried values after one step and the p, T, U
    ghosts of the second step on rows [0, K-1) equal, bit for bit (row
    K-1's stencil reaches the other segment); the carried values there
    are not the boundary cells' (the value is carried), and outside the
    segment the layer holds the boundary cells."""
    whole = bodies.wt_segmented_jet(SHAPE, F64, "cpu")
    split = bodies.wt_split_outlet(SHAPE, F64, "cpu")
    assert [w[4] for w in whole._wt_sides()] == [None, None]
    assert [w[:3] + (w[4],) for w in split._wt_sides()] == [
        ("p", 0, 1, 0), ("T", 0, 1, 0)]
    w1, wg, _ = _two_steps(whole, monkeypatch)
    s1, sg, s2 = _two_steps(split, monkeypatch)
    rows = slice(0, K - 1)
    assert len(s1.wt) == len(w1.wt) == 2
    for a, b in zip(w1.wt, s1.wt):
        assert a.shape == b.shape == (1, SHAPE[1])
        assert torch.equal(a[0, rows], b[0, rows])
    for a, b in zip(wg, sg):
        assert torch.equal(a[..., rows], b[..., rows])
    U, _, T, p = split.primitives(s1)
    for carried, cell in zip(s1.wt, (p[-1], T[-1])):
        assert float((carried[0, :K] - cell[:K]).abs().min()) > 0.0
        assert torch.equal(carried[0, K:], cell[K:])
    assert all(bool(torch.isfinite(x).all()) for x in s2[:3])


def test_pad_refuses_a_wt_segment_and_extrapolates_a_whole_side():
    """Outside QGDFoam's step nothing carries the value: a
    waveTransmissive segment of a split side raises in ghost_pad, while a
    whole waveTransmissive side stays the JAX package's linear
    extrapolation."""
    mesh = Mesh.uniform((6, 4), dtype=F64)
    f = torch.as_tensor(np.random.default_rng(1).standard_normal((6, 4)))
    zg = bcm.ZeroGradient()
    seg = bcm.Segmented(((((((0, 2),),), bcm.WaveTransmissive(1.0)),
                          ((((2, 4),),), zg))))
    with pytest.raises(TypeError, match="waveTransmissive segment"):
        ghost_pad(f, bcm.FieldBCs(((zg, seg), (zg, zg))), mesh)
    out = ghost_pad(f, bcm.FieldBCs(((zg, bcm.WaveTransmissive(1.0)),
                                     (zg, zg))), mesh)
    assert torch.equal(out[-1, 1:-1], 2.0 * f[-1] - f[-2])


def test_wt_segment_case_writes_and_resumes(tmp_path):
    """tests/fixtures/jet_coflow_case with its outlet split into two
    patches, the lower waveTransmissive for p and T: ingestion builds a
    Segmented outlet side with a waveTransmissive segment and its carry;
    the CLI runs 10 steps and writes; a latestTime resume reads the
    written fields back with the same carries (the boundary cells of the
    read-back fields outside the segment) and runs 5 more finite steps."""
    case = tmp_path / "coflow_split"
    shutil.copytree(os.path.join(FIX, "jet_coflow_case"), case)

    def edit(rel, old, new):
        path = case / rel
        text, n = re.subn(old, new, path.read_text())
        assert n == 1, (rel, old)
        path.write_text(text)

    edit("system/blockMeshDict",
         r"outlet\s*\{ type patch; faces \(\(1 2 6 5\) \(2 9 11 6\)\); \}",
         "outletLow { type patch; faces ((1 2 6 5)); }\n"
         "    outletHigh { type patch; faces ((2 9 11 6)); }")
    for field, wt in (("p", "fieldInf 101325; lInf 0.5; "
                       "value uniform 101325;"),
                      ("T", "fieldInf 300; value uniform 300;")):
        edit(f"0/{field}", r"outlet\s*\{[^}]*\}",
             f"outletLow {{ type waveTransmissive; {wt} }}\n"
             "    outletHigh { type zeroGradient; }")
    edit("system/controlDict", r"endTime\s+0.01;", "endTime 1.0;")
    edit("system/controlDict", r"writeControl\s+adjustableRunTime;",
         "writeControl timeStep;")
    edit("system/controlDict", r"writeInterval\s+0.001;",
         "writeInterval 10;")
    solver, state = foam_case.build_case(str(case), device="cpu")
    assert isinstance(solver.bc_p[0, 1], bcm.Segmented)
    assert [w[:3] for w in solver._wt_sides()] == [("p", 0, 1), ("T", 0, 1)]
    assert [w[4] is not None for w in solver._wt_sides()] == [True, True]
    assert len(state.wt) == 2 and not solver.fused_supported()
    n = cli.run_case(str(case), max_steps=10, chunk=5, log=lambda *_: None,
                     device="cpu")
    assert n == 10
    edit("system/controlDict", r"startFrom\s+startTime;",
         "startFrom latestTime;")
    solver2, back = foam_case.build_case(str(case), device="cpu")
    assert float(back.t) > 0.0 and len(back.wt) == 2
    U, _, T, p = solver2.primitives(back)
    ny = solver2.mesh.shape[1]
    for carried, cell in zip(back.wt, (p[-1], T[-1])):
        assert carried.shape == (1, ny)
        assert torch.equal(carried[0], cell)
    s = common.run_steps(solver2.make_step(), back, 5)
    assert all(bool(torch.isfinite(x).all()) for x in s[:3] + s.wt)
