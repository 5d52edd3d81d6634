"""The port's mesh, padding and fvsc operators against the JAX package.

Inputs are float64 fields from a numpy seed; the formulas and their order are
the same in both packages, so they agree to 1e-12 relative.
"""
import ast
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.core.mesh import Mesh as JMesh
from qgdsolver_tpu.ops import fvsc as jfvsc
from qgdsolver_tpu.ops.pad import ghost_pad as j_ghost_pad
from qgdsolver_tpu_torch.core import bc as tbc
from qgdsolver_tpu_torch.core.mesh import Mesh as TMesh
from qgdsolver_tpu_torch.ops import fvsc as tfvsc
from qgdsolver_tpu_torch.ops.pad import ghost_pad as t_ghost_pad

F64 = torch.float64
RTOL = 1e-12


def _meshes(graded):
    if graded:
        rng = np.random.default_rng(3)
        faces = tuple(np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 1.5, n))])
                      for n in (9, 7))
        return (JMesh(x_faces=faces, dtype=np.float64),
                TMesh(x_faces=faces, dtype=F64))
    return (JMesh.uniform((9, 7), lengths=(2.0, 1.0), dtype=np.float64),
            TMesh.uniform((9, 7), lengths=(2.0, 1.0), dtype=F64))


def _close(a, b, rtol=RTOL):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.max(np.abs(a)), 1e-300)
    assert np.max(np.abs(a - b)) <= rtol * scale, np.max(np.abs(a - b)) / scale


@pytest.mark.parametrize("graded", [False, True])
def test_mesh_geometry(graded):
    jm, tm = _meshes(graded)
    assert tm.shape == jm.shape and tm.ndim == 2
    for a in range(2):
        np.testing.assert_array_equal(tm.x_faces[a], jm.x_faces[a])
        np.testing.assert_array_equal(tm.dx[a], jm.dx[a])
        np.testing.assert_array_equal(tm.centers[a], jm.centers[a])
        _close(jm.h_face(a), tm.h_face(a))
        _close(jm.face_area(a), tm.face_area(a))
    _close(jm.h_cell, tm.h_cell)
    _close(jm.cell_volume, tm.cell_volume)
    assert tm.h_cell.dtype == F64 and tm.h_cell.shape == jm.h_cell.shape


def _bc_pair(kind, a, side, vector, mesh_shape):
    """(jax BC, torch BC) of one kind on side (a, side)."""
    n_t = mesh_shape[1 - a]
    prof = np.linspace(0.5, 1.5, n_t).reshape((n_t, 1) if a == 1 else (1, n_t))
    if kind == "fixed":
        v = np.array([3.0, -2.0]) if vector else 7.0
        return jbc.FixedValue(v), tbc.FixedValue(v)
    if kind == "fixed_array":
        v = np.stack([prof, -prof]) if vector else prof
        return jbc.FixedValue(jnp.asarray(v)), tbc.FixedValue(v)
    if kind == "fixed_callable":
        def jf(t, c):
            return jnp.sin(c[1 - a]) * (1.0 + c[a]) + 0.0 * t

        def tf(t, c):
            return torch.sin(c[1 - a]) * (1.0 + c[a]) + 0.0 * t

        return jbc.FixedValue(jf), tbc.FixedValue(tf)
    if kind == "zg":
        return jbc.ZeroGradient(), tbc.ZeroGradient()
    if kind == "grad":
        return jbc.FixedGradient(-4.0), tbc.FixedGradient(-4.0)
    if kind == "sym":
        return jbc.Symmetry(), tbc.Symmetry()
    if kind == "extrap":
        return jbc.Extrapolated(), tbc.Extrapolated()
    if kind == "io":
        v = np.array([1.0, 2.0]) if vector else 5.0
        return jbc.InletOutlet(v), tbc.InletOutlet(v)
    raise ValueError(kind)


BC_KINDS = ["fixed", "fixed_array", "fixed_callable", "zg", "grad", "sym",
            "extrap", "io"]


@pytest.mark.parametrize("kind,vector", [
    (k, v) for k in BC_KINDS for v in (False, True)
    if not (k == "fixed_callable" and v)])  # the callables are scalar-valued
def test_ghost_pad_every_kind(kind, vector):
    """Each BC kind on every side (the other sides mixed), corners included;
    inletOutlet resolved against a velocity field of both signs."""
    jm, tm = _meshes(False)
    rng = np.random.default_rng(11)
    shape = ((2,) if vector else ()) + jm.shape
    f = rng.standard_normal(shape)
    U = rng.standard_normal((2,) + jm.shape)
    others = ["zg", "extrap", "fixed", "grad"]
    for a in range(2):
        for side in (0, 1):
            jrows, trows = [[None, None], [None, None]], [[None, None],
                                                          [None, None]]
            for b in range(2):
                for s2 in (0, 1):
                    k = kind if (b, s2) == (a, side) else others[2 * b + s2]
                    jrows[b][s2], trows[b][s2] = _bc_pair(k, b, s2, vector,
                                                          jm.shape)
            jb = jbc.resolve_inlet_outlet(jbc.FieldBCs(jrows), jnp.asarray(U),
                                          2)
            tb = tbc.resolve_inlet_outlet(tbc.FieldBCs(trows),
                                          torch.as_tensor(U), 2)
            jp = j_ghost_pad(jnp.asarray(f), jb, jm, t=0.25, vector=vector)
            tp = t_ghost_pad(torch.as_tensor(f), tb, tm, t=0.25,
                             vector=vector)
            _close(jp, tp)


def test_ghost_pad_rejects_unported_and_unresolved():
    _, tm = _meshes(False)
    f = torch.zeros(tm.shape, dtype=F64)

    class Unported(tbc.BC):
        pass

    with pytest.raises(NotImplementedError):
        t_ghost_pad(f, tbc.FieldBCs.uniform(Unported(), 2), tm)
    with pytest.raises(TypeError):
        t_ghost_pad(f, tbc.FieldBCs.uniform(tbc.InletOutlet(1.0), 2), tm)


def _padded_pair(graded, vector=False, seed=5):
    jm, tm = _meshes(graded)
    rng = np.random.default_rng(seed)
    shape = ((2,) if vector else ()) + tuple(n + 2 for n in jm.shape)
    fp = rng.standard_normal(shape)
    return jm, tm, fp


@pytest.mark.parametrize("graded", [False, True])
def test_interpolations(graded):
    jm, tm, fp = _padded_pair(graded, vector=True)
    for ja, ta in zip(jfvsc.interp_from_padded(jnp.asarray(fp), jm),
                      tfvsc.interp_from_padded(torch.as_tensor(fp), tm)):
        _close(ja, ta)
    for a in range(2):
        _close(jfvsc.interp_axis_from_padded(jnp.asarray(fp[0]), jm, a),
               tfvsc.interp_axis_from_padded(torch.as_tensor(fp[0]), tm, a))
    f = np.random.default_rng(2).standard_normal(jm.shape)
    jb = jbc.FieldBCs(((jbc.FixedValue(1.0), jbc.Extrapolated()),
                       (jbc.ZeroGradient(), jbc.FixedGradient(2.0))))
    tb = tbc.FieldBCs(((tbc.FixedValue(1.0), tbc.Extrapolated()),
                       (tbc.ZeroGradient(), tbc.FixedGradient(2.0))))
    for ja, ta in zip(jfvsc.interpolate(jnp.asarray(f), jb, jm),
                      tfvsc.interpolate(torch.as_tensor(f), tb, tm)):
        _close(ja, ta)


@pytest.mark.parametrize("graded", [False, True])
@pytest.mark.parametrize("vector", [False, True])
def test_grad_full(graded, vector):
    jm, tm, fp = _padded_pair(graded, vector=vector)
    jg = jfvsc.grad_from_padded(jnp.asarray(fp), jm, scheme="full")
    tg = tfvsc.grad_from_padded(torch.as_tensor(fp), tm, scheme="full")
    for ja, ta in zip(jg, tg):
        _close(ja, ta)
    # the reduced scheme (nf*snGrad only) matches too
    jg = jfvsc.grad_from_padded(jnp.asarray(fp), jm, scheme="reduced")
    tg = tfvsc.grad_from_padded(torch.as_tensor(fp), tm, scheme="reduced")
    for ja, ta in zip(jg, tg):
        _close(ja, ta)


@pytest.mark.parametrize("graded", [False, True])
def test_grad_cell_and_div_flux(graded):
    jm, tm = _meshes(graded)
    rng = np.random.default_rng(9)
    f = rng.standard_normal(jm.shape)
    zg_j = jbc.FieldBCs.uniform(jbc.ZeroGradient(), 2)
    zg_t = tbc.FieldBCs.uniform(tbc.ZeroGradient(), 2)
    _close(jfvsc.grad_cell(jnp.asarray(f), zg_j, jm),
           tfvsc.grad_cell(torch.as_tensor(f), zg_t, tm))
    phi = (rng.standard_normal((2, jm.shape[0] + 1, jm.shape[1])),
           rng.standard_normal((2, jm.shape[0], jm.shape[1] + 1)))
    _close(jfvsc.div_flux(tuple(jnp.asarray(p) for p in phi), jm),
           tfvsc.div_flux(tuple(torch.as_tensor(p) for p in phi), tm))


def test_scheme_for():
    spec = {"grad(U)": "reduced", "default": "GaussVolPoint"}
    for term in ("grad(U)", "grad(p)"):
        assert tfvsc.scheme_for(spec, term) == jfvsc.scheme_for(spec, term)
    assert tfvsc.scheme_for("full", "grad(e)") == "full"


def test_port_imports_no_jax():
    """Importing the port (kernel modules included) pulls in no JAX and needs
    neither nvcc nor triton: kernels build at first CUDA use."""
    code = ("import qgdsolver_tpu_torch, qgdsolver_tpu_torch.cases, "
            "qgdsolver_tpu_torch.ops.fused_qgd2d, "
            "qgdsolver_tpu_torch.ops.fused_qgd3d, qgdsolver_tpu_torch.cli, "
            "qgdsolver_tpu_torch.io.foam_write, qgdsolver_tpu_torch.utils, "
            "qgdsolver_tpu_torch.utils.badcells, "
            "qgdsolver_tpu_torch.graft_entry, "
            "qgdsolver_tpu_torch.core.config, qgdsolver_tpu_torch.__main__; "
            "import sys; assert 'jax' not in sys.modules")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


ROOT = pathlib.Path(__file__).resolve().parents[1]
# a citation of the reference's code, `path:line` or `path:line-line`
_CITATION = re.compile(r"[\w./]+\.\w+:\d+(-\d+)?")


def _port_sources():
    return sorted((ROOT / "qgdsolver_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _docstrings(tree):
    """The string constants that are docstrings (not code)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                out.add(id(first.value))
    return out


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_reference_and_names_no_native_dir(path):
    """Every module of the port and chip_smoke.py: no import of `jax` or
    of `qgdsolver_tpu` (static, relative beyond the package, or by a
    string passed to an import function), and no string in code that
    names the repository's native/ directory; docstrings, and strings
    that cite the reference's file:line, are allowed."""
    tree = ast.parse(path.read_text(), filename=str(path))
    depth = len(path.relative_to(ROOT).parts) - 1  # package levels
    refs = ("jax", "qgdsolver_tpu")

    def banned(name):
        return name is not None and name.split(".")[0] in refs

    docs = _docstrings(tree)
    for node in ast.walk(tree):
        where = f"{path.name}:{getattr(node, 'lineno', '?')}"
        if isinstance(node, ast.Import):
            for alias in node.names:
                assert not banned(alias.name), where
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0 or node.level <= depth, where
            assert not banned(node.module), where
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                assert not (isinstance(arg, ast.Constant)
                            and banned(str(arg.value))), where
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            text = _CITATION.sub("", node.value)
            assert not re.search(r"(^|[/\\])native([/\\]|$)", text), where
