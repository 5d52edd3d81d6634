"""OpenFOAM mesh + field-file ingestion: blockMeshDict and `0/` directories
(PyTorch port of `qgdsolver_tpu.io.foam_fields`).

Scope — the structured-brick subset:
  * blockMeshDict with one hex block or several that compose a rectilinear
    brick (per-axis segments that every covering block subdivides alike),
    optional simpleGrading/edgeGrading (geometric per-axis expansion),
    named boundary patches; `empty` patches collapse the normal axis
    (OpenFOAM's 2D convention) so a 2D case yields a 2D Mesh.  A union
    that leaves segments of the bounding box uncovered gives a Mesh whose
    `solid` mask marks those dead cells (stairstep walls); a `wedge` pair
    gives an AxisymmetricMesh over (x, r = hypot(y, z)).
  * `0/<field>` files: `internalField uniform ...` or
    `nonuniform List<...> (...)` (OpenFOAM cell ordering: x fastest), and
    `boundaryField` entries mapped onto (axis, side) through the
    blockMeshDict patch planes; several patches with different BCs on one
    side become a Segmented BC over their face rectangles.

BC type words resolve through the `core.registry` "bc" table the JSON
config path uses.  Field arrays come back as float64 numpy arrays; the
caller puts them on its device.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from . import foamdict
from ..core.mesh import AxisymmetricMesh, Mesh
from ..core import bc as bcm
from ..core import config as _config  # noqa: F401 — registers the BC words
from ..core.registry import create


# ---------------------------------------------------------------------------
# blockMeshDict -> Mesh
# ---------------------------------------------------------------------------


def _graded_faces(x0, x1, n, ratio):
    """Face coordinates for n cells over [x0, x1] with simpleGrading `ratio`
    (OpenFOAM: size(last cell)/size(first cell); geometric progression)."""
    if n == 1 or abs(ratio - 1.0) < 1e-12:
        return np.linspace(x0, x1, n + 1, dtype=np.float64)
    k = ratio ** (1.0 / (n - 1))  # adjacent-cell size ratio
    first = (x1 - x0) * (1.0 - k) / (1.0 - k**n)
    sizes = first * k ** np.arange(n)
    return x0 + np.concatenate([[0.0], np.cumsum(sizes)])


def _as_float_list(v):
    return [float(x) for x in v]


def _block_specs(blocks):
    """[hex (v0..v7) (nx ny nz) [simpleGrading (gx gy gz)]] token runs ->
    [(hex_verts, counts, grading)]."""
    if not isinstance(blocks, list) or "hex" not in blocks:
        raise ValueError("blockMeshDict has no hex blocks")
    specs = []
    i = 0
    while i < len(blocks):
        if blocks[i] != "hex":
            i += 1
            continue
        hex_verts = [int(j) for j in blocks[i + 1]]
        counts = [int(n) for n in blocks[i + 2]]
        grading = [1.0, 1.0, 1.0]
        j = i + 3
        while j < len(blocks) and not isinstance(blocks[j], list) \
                and blocks[j] != "hex":
            if blocks[j] in ("simpleGrading", "edgeGrading"):
                g = blocks[j + 1]
                if blocks[j] == "edgeGrading":
                    # per-edge grading: first edge of each axis group
                    grading = [float(g[0]), float(g[4]), float(g[8])]
                else:
                    grading = [float(x) for x in g]
                j += 2
            else:
                j += 1
        specs.append((hex_verts, counts, grading))
        i = j
    return specs


def _patch_pairs(patch_entries):
    """The parser gives [name, {..}, name, {..}] or [[name, {...}], ...]."""
    pairs = []
    i = 0
    while i < len(patch_entries):
        e = patch_entries[i]
        if isinstance(e, str) and i + 1 < len(patch_entries) and \
                isinstance(patch_entries[i + 1], dict):
            pairs.append((e, patch_entries[i + 1]))
            i += 2
        elif isinstance(e, list) and len(e) == 2:
            pairs.append((e[0], e[1]))
            i += 1
        else:
            i += 1
    return pairs


def parse_block_mesh(bmd: dict, dtype=torch.float32, device="cpu"):
    """blockMeshDict dict -> (Mesh, patch_map, kept_axes).

    patch_map: {patch_name: (type, ((mesh_axis, side), ...), ranges)} for
    the non-collapsed axes, where `ranges[(mesh_axis, side)]` holds the
    patch's tangential cell-index rectangles on that plane; kept_axes: the
    original xyz axes retained in the Mesh (2D cases drop the `empty`-patch
    axis).
    """
    scale = float(bmd.get("convertToMeters", bmd.get("scale", 1.0)) or 1.0)
    verts = [np.asarray(_as_float_list(v)) * scale for v in bmd["vertices"]]
    specs = _block_specs(bmd["blocks"])
    pairs = _patch_pairs(bmd.get("boundary", []))
    # a wedge (a one-cell sector about the x axis, vertices rotated by
    # +-theta/2) unrolls to the (x, r) half-plane: r = hypot(y, z), and the
    # swept axis z collapses as an `empty` pair would
    wedge = any(e.get("type") == "wedge" for _, e in pairs)
    if wedge:
        verts = [np.asarray([v[0], float(np.hypot(v[1], v[2])), 0.0])
                 for v in verts]

    # per-block brick validation + extents
    block_ext = []  # (lo3, hi3, counts, grading) per block
    for hv, cnt, grd in specs:
        vs = np.stack([verts[i] for i in hv])  # (8, 3)
        for ax in range(3):
            vals = np.unique(np.round(vs[:, ax], 12))
            if len(vals) != 2 and not (wedge and ax == 2 and len(vals) == 1):
                raise ValueError(
                    "blockMeshDict hex is not an axis-aligned brick "
                    f"(axis {ax} vertex coords {vals})")
        block_ext.append((vs.min(axis=0), vs.max(axis=0), cnt, grd))
    lo = np.min([b[0] for b in block_ext], axis=0)
    hi = np.max([b[1] for b in block_ext], axis=0)

    # multi-block rectilinear composition: per axis, the union splits into
    # segments at the block extents; every block covering a segment must
    # subdivide it identically, and every cell of the segment grid must be
    # covered by at most one block (uncovered ones are dead cells)
    seg_pts = []
    seg_faces = []  # per axis: list of per-segment face arrays
    seg_counts = []
    tol = 1e-12 + 1e-9 * np.max(np.abs(hi - lo))

    def _seg_index(pts, v):
        k = int(np.argmin(np.abs(pts - v)))
        if abs(pts[k] - v) > tol:
            raise ValueError(
                "multi-block blockMeshDict: block extents do not tile "
                f"(coordinate {v} not on the segment grid {pts})")
        return k

    counts = [0, 0, 0]
    for ax in range(3):
        pts = np.unique(np.round(
            [b[0][ax] for b in block_ext] + [b[1][ax] for b in block_ext],
            12))
        seg_pts.append(pts)
        faces_ax = [None] * (len(pts) - 1)
        counts_ax = [None] * (len(pts) - 1)
        for blo, bhi, cnt, grd in block_ext:
            if wedge and ax == 2:
                continue  # the collapsed swept axis has no face grid
            k0 = _seg_index(pts, blo[ax])
            k1 = _seg_index(pts, bhi[ax])
            if k1 - k0 != 1:
                raise ValueError(
                    "multi-block blockMeshDict: a block spans several "
                    f"segments on axis {ax}; split it at the shared planes")
            f = _graded_faces(blo[ax], bhi[ax], cnt[ax], grd[ax])
            if faces_ax[k0] is None:
                faces_ax[k0] = f
                counts_ax[k0] = cnt[ax]
            elif (counts_ax[k0] != cnt[ax]
                  or not np.allclose(faces_ax[k0], f, atol=tol)):
                raise ValueError(
                    "multi-block blockMeshDict: blocks sharing axis-"
                    f"{ax} segment [{pts[k0]}, {pts[k0 + 1]}] disagree on "
                    "its subdivision")
        if any(f is None for f in faces_ax):
            raise ValueError(
                f"multi-block blockMeshDict: axis-{ax} segment grid has "
                "uncovered intervals")
        seg_faces.append(faces_ax)
        seg_counts.append(counts_ax)
        counts[ax] = int(sum(counts_ax)) if counts_ax else 1

    solid = None
    if len(block_ext) > 1:
        # coverage of the segment grid (the collapsed wedge axis counts as
        # one segment); uncovered segments are dead cells, run as
        # stairstep walls
        covered = np.zeros([max(len(p) - 1, 1) for p in seg_pts], dtype=int)
        for blo, bhi, _, _ in block_ext:
            covered[tuple(
                slice(0, 1) if wedge and ax == 2 else
                slice(_seg_index(seg_pts[ax], blo[ax]),
                      _seg_index(seg_pts[ax], bhi[ax]))
                for ax in range(3))] += 1
        if (covered > 1).any():
            raise ValueError("multi-block blockMeshDict: blocks overlap")
        if (covered == 0).any():
            if wedge:
                raise NotImplementedError(
                    "dead-cell regions on wedge meshes are not supported")
            solid = covered == 0
            for ax in range(3):
                solid = np.repeat(solid, seg_counts[ax], axis=ax)

    empty_axes = set()
    raw_patch_plane = {}
    raw_rects = {}  # name -> {(ax, side): [ {global axis b: (lo, hi)} ]}
    for name, entry in pairs:
        ptype = entry.get("type", "patch")
        faces = entry.get("faces", [])
        if faces and not isinstance(faces[0], list):
            faces = [faces]
        axes_sides = set()
        rects = {}
        for quad in faces:
            pts = np.stack([verts[int(i)] for i in quad])
            for ax in range(3):
                if np.ptp(pts[:, ax]) < 1e-9:
                    key = None
                    if abs(pts[0, ax] - hi[ax]) < 1e-9:
                        key = (ax, 1)
                    elif abs(pts[0, ax] - lo[ax]) < 1e-9:
                        key = (ax, 0)
                    if key is not None:
                        axes_sides.add(key)
                        # the face rectangle this patch owns on the plane
                        rects.setdefault(key, []).append({
                            b: (float(pts[:, b].min()),
                                float(pts[:, b].max()))
                            for b in range(3) if b != ax
                        })
                    break
            else:
                raise ValueError(f"patch {name}: face {quad} is not axis-aligned")
        raw_patch_plane[name] = (ptype, axes_sides)
        raw_rects[name] = rects
        # on a wedge only the swept axis collapses: an `empty` patch at
        # r = 0 must not take the radial axis
        if ptype == "empty" and not wedge:
            empty_axes.update(ax for ax, _ in axes_sides)
    if wedge:
        # both unrolled wedge planes land on z = 0
        empty_axes.add(2)
        if 0 in empty_axes or 1 in empty_axes:
            raise ValueError("wedge mesh must sweep about the x axis with "
                             "the radius along y")

    kept_axes = [ax for ax in range(3) if counts[ax] > 0 and ax not in empty_axes]
    # OpenFOAM 2D: the empty axis has one cell
    for ax in empty_axes:
        if counts[ax] != 1:
            raise ValueError(f"empty axis {ax} must have 1 cell, got {counts[ax]}")

    def _axis_faces(ax):
        parts = [seg_faces[ax][0]] + [f[1:] for f in seg_faces[ax][1:]]
        return np.concatenate(parts)

    x_faces = tuple(_axis_faces(ax) for ax in kept_axes)
    if wedge:
        mesh = AxisymmetricMesh(x_faces=x_faces, dtype=dtype, device=device)
    else:
        mesh = Mesh(x_faces=x_faces, dtype=dtype, device=device,
                    solid=(None if solid is None
                           else _squeeze_to(solid, kept_axes)))
    axis_of = {ax: i for i, ax in enumerate(kept_axes)}

    def _cell_index(mesh_axis, coord):
        faces = np.asarray(mesh.x_faces[mesh_axis], dtype=float)
        k = int(np.argmin(np.abs(faces - coord)))
        if abs(faces[k] - coord) > tol:
            raise ValueError(
                f"patch rectangle coordinate {coord} is not on the axis-"
                f"{mesh_axis} face grid")
        return k

    patch_map = {}
    for name, (ptype, axes_sides) in raw_patch_plane.items():
        if ptype in ("empty", "wedge"):
            continue
        mapped = {(axis_of[ax], side) for ax, side in axes_sides
                  if ax in axis_of}
        if not mapped:
            continue
        # tangential cell-index rectangles per mapped side: rect = ((lo, hi)
        # half-open cell ranges) per tangential kept axis in mesh-axis order
        ranges = {}
        for ax, side in axes_sides:
            if ax not in axis_of:
                continue
            rect_list = []
            for rc in raw_rects[name].get((ax, side), []):
                rect = []
                for b in sorted(axis_of):
                    if b == ax:
                        continue
                    mb = axis_of[b]
                    if b in rc:
                        lo_c, hi_c = rc[b]
                        rect.append((_cell_index(mb, lo_c),
                                     _cell_index(mb, hi_c)))
                    else:
                        rect.append((0, mesh.shape[mb]))
                rect_list.append(tuple(rect))
            ranges[(axis_of[ax], side)] = tuple(rect_list)
        patch_map[name] = (ptype, tuple(sorted(mapped)), ranges)
    return mesh, patch_map, tuple(kept_axes)


def load_block_mesh(case_dir: str, dtype=torch.float32, device="cpu"):
    """Read system/blockMeshDict (or constant/polyMesh/blockMeshDict)."""
    for rel in ("system/blockMeshDict", "constant/polyMesh/blockMeshDict"):
        p = os.path.join(case_dir, rel)
        if os.path.exists(p):
            return parse_block_mesh(foamdict.parse_file(p), dtype=dtype,
                                    device=device)
    raise FileNotFoundError(f"no blockMeshDict under {case_dir}")


# ---------------------------------------------------------------------------
# 0/<field> files
# ---------------------------------------------------------------------------


def _uniform_value(tokens, kept_axes=None, vector=False):
    """`uniform 300` / `uniform (1 2 3)` token list -> scalar or component
    list (vector components restricted to the kept axes)."""
    if isinstance(tokens, list) and tokens and tokens[0] == "uniform":
        v = tokens[1]
    else:
        v = tokens
    if isinstance(v, list):
        if vector and kept_axes is not None:
            return [float(v[ax]) for ax in kept_axes]
        return [float(x) for x in v]
    return float(v)


def _squeeze_to(arr3, kept_axes):
    """Drop the collapsed (empty) axes of a (nx, ny, nz) array."""
    drop = tuple(ax for ax in range(3) if ax not in kept_axes)
    return np.squeeze(arr3, axis=drop) if drop else arr3


def _from_cell_list(arr, mesh: Mesh, kept_axes, counts3, vector):
    """(ncells[, 3]) values in x-fastest order -> array over mesh.shape
    (leading component axis for vectors)."""
    if vector:
        return np.stack([
            _squeeze_to(arr[:, ax].reshape(tuple(counts3), order="F"),
                        kept_axes) for ax in kept_axes], axis=0)
    return _squeeze_to(arr.reshape(tuple(counts3), order="F"), kept_axes)


def _internal_field(tokens, mesh: Mesh, kept_axes, counts3, vector):
    """internalField entry -> ndarray over mesh.shape (leading component axis
    for vectors).  Handles `uniform ...` and `nonuniform List<T> n (...)`
    with OpenFOAM cell ordering (x fastest, then y, then z)."""
    if isinstance(tokens, list) and tokens and tokens[0] == "nonuniform":
        arr = np.asarray(tokens[-1], dtype=np.float64)
        return _from_cell_list(arr, mesh, kept_axes, counts3, vector)
    v = _uniform_value(tokens, kept_axes, vector)
    if vector:
        return np.stack([np.full(mesh.shape, c) for c in v], axis=0)
    return np.full(mesh.shape, v)


# `internalField nonuniform List<T> n ( ... );` — the list body is read with
# numpy instead of the dictionary parser: a written 4096x2048 field holds
# 8.4M values (25M for a vector), which the token-by-token parsers turn into
# Python lists at several seconds per million.
_NONUNIFORM_RE = re.compile(
    r"internalField\s+nonuniform\s+List<\s*(\w+)\s*>\s*(\d+)\s*\((.*?)\)\s*;",
    re.DOTALL)


def _read_nonuniform(text: str):
    """(text with the nonuniform list replaced by a placeholder, values as
    (n,) or (n, 3) float64) — or (text, None) for any other internalField."""
    m = _NONUNIFORM_RE.search(text)
    if m is None:
        return text, None
    n = int(m.group(2))
    body = m.group(3).replace("(", " ").replace(")", " ")
    vals = np.array(body.split(), dtype=np.float64)
    ncomp = vals.size // n if n else 1
    if vals.size != n * ncomp or ncomp not in (1, 3):
        raise ValueError(f"nonuniform List<{m.group(1)}> of {n} entries "
                         f"holds {vals.size} numbers")
    if ncomp == 3:
        vals = vals.reshape(n, 3)
    placeholder = "internalField uniform 0;"
    return text[:m.start()] + placeholder + text[m.end():], vals


def _bc_from_entry(entry: dict, ndim: int, kept_axes, vector: bool) -> bcm.BC:
    """boundaryField patch entry -> BC via the registry (field-file `type`
    word dispatch, the OpenFOAM fvPatchField RTS equivalent)."""
    word = entry.get("type", "zeroGradient")
    if isinstance(word, list):
        word = word[0]
    kw = {"ndim": ndim}
    if "value" in entry:
        kw["value"] = _uniform_value(entry["value"], kept_axes, vector)
    if "inletValue" in entry:
        kw["inletValue"] = _uniform_value(entry["inletValue"], kept_axes, vector)
    if "gradient" in entry:
        kw["gradient"] = _uniform_value(entry["gradient"], kept_axes, vector)
    for extra in ("amplitude", "omega0", "phi0", "height", "fieldInf",
                  "lInf"):
        if extra in entry:
            kw[extra] = float(entry[extra])
    word_map = {
        "empty": "zeroGradient",
        "calculated": "zeroGradient",
        "symmetryPlane": "symmetry",
        "constantAlphaContactAngle": "zeroGradient",
        "dynamicAlphaContactAngle": "zeroGradient",
    }
    word = word_map.get(str(word), str(word))
    try:
        return create("bc", word, **kw)
    except KeyError:
        raise ValueError(f"unsupported boundary type word {word!r}")


def _bc_equal(a, b) -> bool:
    """Equality of two parsed BCs, tolerant of array-valued fields."""
    if type(a) is not type(b):
        return False
    try:
        return bool(a == b)
    except Exception:  # noqa: BLE001 — array-valued specs
        return repr(a) == repr(b)


def parse_field_file(path: str, mesh: Mesh, patch_map, kept_axes,
                     counts3=None, default_bc=None):
    """0/<field> file -> (internal float64 ndarray, FieldBCs).

    The field class word (volScalarField / volVectorField) decides vector
    handling; vector components are restricted to the kept mesh axes.
    """
    with open(path) as f:
        text, listed = _read_nonuniform(f.read())
    d = foamdict.parse(text)
    cls = str(d.get("FoamFile", {}).get("class", "volScalarField"))
    vector = "Vector" in cls
    nd = mesh.ndim
    if counts3 is None:
        counts3 = [1, 1, 1]
        for i, ax in enumerate(kept_axes):
            counts3[ax] = mesh.shape[i]

    if listed is not None:
        internal = _from_cell_list(listed, mesh, kept_axes, counts3, vector)
    else:
        internal = _internal_field(d.get("internalField", 0.0), mesh,
                                   kept_axes, counts3, vector)

    default = default_bc or bcm.ZeroGradient()
    rows = [[default, default] for _ in range(nd)]
    # claims[axis][side] = ordered [(patch name, bc, rects)]
    claims = [[[], []] for _ in range(nd)]
    for name, entry in d.get("boundaryField", {}).items():
        if name not in patch_map or not isinstance(entry, dict):
            continue
        _, sides, ranges = patch_map[name]
        bc = _bc_from_entry(entry, nd, kept_axes, vector)
        for axis, side in sides:
            claims[axis][side].append(
                (name, bc, ranges.get((axis, side), ())))
    for axis in range(nd):
        for side in (0, 1):
            cl = claims[axis][side]
            if not cl:
                continue
            if len(cl) == 1 or all(_bc_equal(cl[0][1], b) for _, b, _ in cl):
                rows[axis][side] = cl[0][1]
                continue
            # several patches with different BCs share this plane: a
            # Segmented BC over their face rectangles
            _validate_side_coverage(cl, axis, mesh, path)
            for nm, b, _ in cl:
                if isinstance(b, bcm.QGDFluxP):
                    raise NotImplementedError(
                        f"patch {nm!r}: qgdFlux inside a split side (axis "
                        f"{axis}, side {side}) of {path} is not supported "
                        "(the lagged-gradient state is whole-side)")
            rows[axis][side] = bcm.Segmented(
                tuple((rects, b) for _, b, rects in cl))
    # cyclic patches declared in blockMeshDict apply even if boundaryField
    # names them with type cyclic
    for ptype, sides, _ in patch_map.values():
        if ptype == "cyclic":
            for axis, side in sides:
                rows[axis][side] = bcm.Periodic()
    return internal, bcm.FieldBCs(tuple(tuple(r) for r in rows))


def _validate_side_coverage(claims, axis, mesh, path):
    """Every tangential cell of the side must be covered exactly once by
    the claiming patches' rectangles."""
    tang = [b for b in range(mesh.ndim) if b != axis]
    cover = np.zeros(tuple(mesh.shape[b] for b in tang), dtype=int)
    for name, _, rects in claims:
        if not rects:
            raise ValueError(
                f"patch {name!r} claims a split side of {path} but has no "
                "face rectangles (blockMeshDict boundary faces missing)")
        for rect in rects:
            cover[tuple(slice(lo, hi) for lo, hi in rect)] += 1
    if (cover == 0).any():
        raise ValueError(
            f"split side (axis {axis}) of {path}: boundary cells "
            f"{np.argwhere(cover == 0)[:5].tolist()} are covered by no "
            "patch")
    if (cover > 1).any():
        raise ValueError(
            f"split side (axis {axis}) of {path}: boundary cells "
            f"{np.argwhere(cover > 1)[:5].tolist()} are claimed by "
            "several patches")


def load_initial_fields(case_dir: str, mesh: Mesh, patch_map, kept_axes,
                        time_name: str = "0"):
    """Read every field file in `<case>/<time_name>/` ->
    {name: (array, FieldBCs)}."""
    tdir = os.path.join(case_dir, time_name)
    out = {}
    if not os.path.isdir(tdir):
        return out
    counts3 = [1, 1, 1]
    for i, ax in enumerate(kept_axes):
        counts3[ax] = mesh.shape[i]
    for fn in sorted(os.listdir(tdir)):
        p = os.path.join(tdir, fn)
        if not os.path.isfile(p) or fn.startswith("."):
            continue
        try:
            out[fn] = parse_field_file(p, mesh, patch_map, kept_axes, counts3)
        except NotImplementedError:
            raise
        except Exception as e:
            raise ValueError(f"failed to parse field file {p}: {e}") from e
    return out
