"""The port's mesh-quality screening (`qgdsolver_tpu_torch.utils.badcells`)
against the JAX package's `qgdsolver_tpu.utils.badcells` on the same meshes.

The port's mesh is `interop.mesh_from` of the JAX one, in float32: the
screening reads the float64 face widths whatever the mesh's dtype.  Both
compute the same float64 quotients and maxima, so the masks are held equal
and the maxima to rtol 1e-15 (float64 round-off; they come out equal).
Every mesh is also screened with each threshold set one float64 step
either side of its maximum, so each mask flips between empty and not.
"""
import os

import numpy as np
import pytest
import torch

from qgdsolver_tpu.core.mesh import Mesh as JMesh
from qgdsolver_tpu.io import foam_case as jfc
from qgdsolver_tpu.utils import badcells as jbad
from qgdsolver_tpu_torch import interop, utils
from qgdsolver_tpu_torch.core.mesh import AxisymmetricMesh
from qgdsolver_tpu_torch.utils import badcells

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _graded(n, ratio):
    x = np.concatenate([[0.0], np.cumsum(ratio ** np.arange(n))])
    return x / x[-1]


def _stretched():
    """tests/test_utils_config.py::test_badcells_flags_stretched_mesh's
    mesh: graded in x, a tiny dy."""
    return JMesh(x_faces=(_graded(20, 1.2), np.linspace(0, 0.001, 5)),
                 dtype=np.float64)


def _wedge():
    solver, _ = jfc.build_case(os.path.join(FIX, "wedge_case"))
    return solver.mesh


MESHES = {
    "stretched": _stretched,
    "uniform": lambda: JMesh.uniform((8, 8)),
    "graded_3d": lambda: JMesh(x_faces=(_graded(12, 1.3), _graded(6, 0.7),
                                        np.linspace(0.0, 0.02, 5)),
                               dtype=np.float64),
    "wedge_case": _wedge,
    "graded_1d": lambda: JMesh(x_faces=(_graded(16, 1.5),),
                               dtype=np.float64),
}
# thresholds of the stretched mesh's own test, then the defaults
THRESHOLDS = {"stretched": (50.0, 1.15)}


def _held(jmesh, tmesh, max_ar, max_ex):
    ref = jbad.select_bad_cells(jmesh, max_aspect_ratio=max_ar,
                                max_expansion=max_ex)
    got = badcells.select_bad_cells(tmesh, max_aspect_ratio=max_ar,
                                    max_expansion=max_ex)
    for mask in ("high_aspect_ratio", "high_expansion"):
        t = getattr(got, mask)
        assert t.dtype == torch.bool and t.device == tmesh.device
        np.testing.assert_array_equal(t.numpy(), getattr(ref, mask),
                                      err_msg=mask)
    for top in ("max_aspect_ratio", "max_expansion"):
        assert isinstance(getattr(got, top), float)
        np.testing.assert_allclose(getattr(got, top), getattr(ref, top),
                                   rtol=1e-15, atol=0.0, err_msg=top)
    assert isinstance(got.n_bad, int) and got.n_bad == ref.n_bad
    return got


@pytest.mark.parametrize("name", list(MESHES))
def test_matches_jax(name):
    jmesh = MESHES[name]()
    tmesh = interop.mesh_from(jmesh)
    assert tmesh.dtype == torch.float32
    assert isinstance(tmesh, AxisymmetricMesh) == (name == "wedge_case")
    rep = _held(jmesh, tmesh, *THRESHOLDS.get(name, (100.0, 3.0)))
    if name == "stretched":
        assert rep.n_bad > 0 and rep.max_expansion > 1.15
    if name == "uniform":
        assert rep.n_bad == 0
    if name == "graded_1d":
        assert rep.max_aspect_ratio == 1.0


@pytest.mark.parametrize("name", list(MESHES))
def test_thresholds_either_side_of_each_maximum(name):
    jmesh = MESHES[name]()
    tmesh = interop.mesh_from(jmesh)
    top = badcells.select_bad_cells(tmesh)
    for side in (-np.inf, np.inf):
        ar = float(np.nextafter(top.max_aspect_ratio, side))
        ex = float(np.nextafter(top.max_expansion, side))
        got = _held(jmesh, tmesh, ar, np.inf)
        assert bool(got.high_aspect_ratio.any()) == (side < 0)
        assert not got.high_expansion.any()
        got = _held(jmesh, tmesh, np.inf, ex)
        assert bool(got.high_expansion.any()) == (side < 0)
        assert not got.high_aspect_ratio.any()


def test_exported_from_utils():
    assert utils.badcells.select_bad_cells is badcells.select_bad_cells
