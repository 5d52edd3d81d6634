"""OpenFOAM-format time-directory output: the runTime.write() equivalent
(PyTorch port of `qgdsolver_tpu.io.foam_write`).

`write_time_dir` re-emits each field's ORIGINAL 0/ dictionary (header,
dimensions, boundaryField — boundary conditions do not change across a run)
with the internalField replaced by the current cell values in OpenFOAM cell
order (x fastest), as `%.12g` ASCII: both packages write the same files,
readable by `build_case` (startFrom latestTime) and by OpenFOAM tooling.
"""
from __future__ import annotations

import os
import re

import numpy as np


def _format_internal(arr, kept_axes, counts3, vector: bool) -> str:
    """Cell values -> `nonuniform List<...>` body in x-fastest order."""
    if vector:
        ncomp, *_ = arr.shape
        full = np.zeros((3, *counts3), dtype=np.float64)
        for i, ax in enumerate(kept_axes):
            shape = [counts3[0], counts3[1], counts3[2]]
            comp = np.asarray(arr[i], dtype=np.float64)
            # re-expand collapsed axes
            exp = comp.reshape([counts3[a] if a in kept_axes else 1
                                for a in range(3)])
            full[ax] = np.broadcast_to(exp, shape)
        flat = full.reshape(3, -1, order="F").T  # (ncells, 3)
        rows = "\n".join("(%.12g %.12g %.12g)" % tuple(r)
                          for r in flat.tolist())
        return ("nonuniform List<vector>\n%d\n(\n%s\n)" %
                (flat.shape[0], rows))
    comp = np.asarray(arr, dtype=np.float64)
    exp = comp.reshape([counts3[a] if a in kept_axes else 1
                       for a in range(3)])
    flat = np.broadcast_to(exp, counts3).reshape(-1, order="F")
    rows = "\n".join("%.12g" % v for v in flat.tolist())
    return "nonuniform List<scalar>\n%d\n(\n%s\n)" % (flat.shape[0], rows)


_INTERNAL_RE = re.compile(
    r"internalField\s+.*?;", re.DOTALL)
_LOCATION_RE = re.compile(r'location\s+"[^"]*"\s*;')
_OBJECT_RE = re.compile(r"object\s+[^;\s]+\s*;")


def write_field_file(src_path: str, dst_path: str, arr, kept_axes, counts3,
                     time_name: str, object_name: str = None):
    """Copy the field dictionary at `src_path`, replacing internalField
    with `arr` and the FoamFile location with the new time.  `object_name`
    additionally rewrites the header's object word (used when a field is
    templated from another file, e.g. a specie from Ydefault)."""
    text = open(src_path).read()
    cls = "volVectorField" if "volVectorField" in text else "volScalarField"
    vector = cls == "volVectorField"
    body = _format_internal(arr, kept_axes, counts3, vector)
    new, n = _INTERNAL_RE.subn("internalField   %s;" % body, text, count=1)
    if n != 1:
        raise ValueError(f"{src_path}: no internalField entry to replace")
    new = _LOCATION_RE.sub('location "%s";' % time_name, new)
    if object_name is not None:
        new = _OBJECT_RE.sub("object %s;" % object_name, new, count=1)
    with open(dst_path, "w") as f:
        f.write(new)


_MESH_CACHE: dict = {}


def _mesh_info(case_dir: str):
    """(shape, kept_axes) of the case's block mesh, cached per
    (blockMeshDict path, mtime) so repeated checkpoint writes don't
    re-parse the mesh."""
    from .foam_fields import load_block_mesh

    key = None
    for rel in ("system/blockMeshDict", "constant/polyMesh/blockMeshDict"):
        p = os.path.join(case_dir, rel)
        if os.path.exists(p):
            key = (p, os.path.getmtime(p))
            break
    if key in _MESH_CACHE:
        return _MESH_CACHE[key]
    mesh, _, kept = load_block_mesh(case_dir)
    out = (mesh.shape, kept)
    if key is not None:
        _MESH_CACHE[key] = out
    return out


def write_time_dir(case_dir: str, time_name: str, fields: dict,
                   kept_axes=None):
    """Write `fields` ({name: cell array, vectors with leading component
    axis}) into `<case_dir>/<time_name>/`, cloning each field's dictionary
    from the case's `0/` directory (BCs are run constants); a field with no
    0/ file of its own falls back to the 0/Ydefault template (the
    reference's Ydefault semantics for species) with the object word
    rewritten.

    Returns the directory written.  Fields with neither template raise a
    KeyError listing them, so a caller can't silently drop prognostic
    state.
    """
    shape, kept = _mesh_info(case_dir)
    kept_axes = kept if kept_axes is None else kept_axes
    counts3 = [1, 1, 1]
    for i, ax in enumerate(kept_axes):
        counts3[ax] = shape[i]

    def template(name):
        p = os.path.join(case_dir, "0", name)
        if os.path.exists(p):
            return p, None
        pd = os.path.join(case_dir, "0", "Ydefault")
        if os.path.exists(pd):
            return pd, name
        return None, None

    tdir = os.path.join(case_dir, time_name)
    os.makedirs(tdir, exist_ok=True)
    missing = [n for n in fields if template(n)[0] is None]
    if missing:
        raise KeyError(f"no 0/ template for fields {missing} in {case_dir}")
    for name, arr in fields.items():
        src, obj = template(name)
        write_field_file(src, os.path.join(tdir, name),
                         np.asarray(arr), kept_axes, counts3, time_name,
                         object_name=obj)
    return tdir


def state_fields(solver, state) -> dict:
    """A solver state's prognostic field files as float64 numpy cell arrays
    (the AUTO_WRITE set of the reference application): U, p and T of the
    QGD solvers (from the conservative State) and of the QHD family
    (QHDDyMFoam's too: its solver is a QHDFoam), T and the carried U of
    scalar transport, U, p and the phase fraction of interQHDFoam,
    whose file is named after the case's first phase
    (`solver.alpha_field`), and U, p, T and one file per specie of the
    reacting solver (a specie without a 0/ file of its own is templated
    from 0/Ydefault).  The Lagrangian solvers write their fluid's fields
    (the parcels live in a checkpoint, not in lagrangian/ directories)."""
    from ..solvers import (inter_qhd, particles, qgd, qhd, reacting,
                           scalar_transport, zqgd)

    if isinstance(solver, (particles.ParticlesQGDFoam,
                           particles.ParticlesQHDFoam,
                           particles.ReactingLagrangianQGDFoam)):
        return state_fields(solver.fluid, state.fluid)
    if isinstance(solver, reacting.ReactingQGDFoam):
        U, e, T, p = solver.primitives(state)
        fields = (("U", U), ("p", p), ("T", T)) + tuple(
            (sp.name, state.Y[i])
            for i, sp in enumerate(solver.mixture.species))
    elif isinstance(solver, (qgd.QGDFoam, zqgd.ZQGDFoam)):
        U, e, T, p = solver.primitives(state)
        fields = (("U", U), ("p", p), ("T", T))
    elif isinstance(solver, qhd.QHDFoam):
        fields = (("U", state.U), ("T", state.T), ("p", state.p))
    elif isinstance(solver, scalar_transport.ScalarTransportQHD):
        fields = (("T", state.T), ("U", state.U))
    elif isinstance(solver, inter_qhd.InterQHDFoam):
        fields = (("U", state.U), ("p", state.p),
                  (solver.alpha_field, state.alpha1))
    else:
        raise TypeError(f"no field mapping for {type(solver).__name__}")
    return {name: x.detach().cpu().double().numpy() for name, x in fields}


def write_state(case_dir: str, solver, state, time_name=None) -> str:
    """runTime.write(): dump the solver state's prognostic fields into a
    time directory named after the current solution time."""
    if time_name is None:
        t = float(getattr(state, "fluid", state).t)
        time_name = ("%d" % int(t)) if t == int(t) else ("%.6g" % t)
    return write_time_dir(case_dir, time_name, state_fields(solver, state))
