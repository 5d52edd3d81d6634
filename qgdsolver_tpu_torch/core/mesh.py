"""Structured rectilinear block mesh (PyTorch port of `qgdsolver_tpu.core.mesh`).

Per-axis geometry stays as 1-D float64 numpy arrays, exactly as in the JAX
package, so both packages derive identical face weights and length scales.
What a solver consumes as a broadcastable field (`h_cell`, `h_face`,
`face_area`, `cell_volume`) is a torch tensor in the mesh's dtype on the
mesh's device, built once and cached on the (frozen) mesh.

A mesh may carry a dead-cell (`solid`) mask: True where a cell lies outside
the flow domain (multi-block unions with dead cells), honoured by QGDFoam's
stairstep walls (`core.solid`).  `AxisymmetricMesh` is the (x, r) wedge mesh
with r-weighted volumes and face areas.

Geometry quantities mirror the reference definitions:
  * QGD face length scale  h_f = 2*min(|C_own-C_f|, |C_nei-C_f|)
    (boundary faces: h_f = 2*|C_own-C_f|);
  * QGD cell length scale  h = sum_faces(h_f*|S_f|)/sum_faces(|S_f|).
"""
from __future__ import annotations

import dataclasses
import typing as tp
from functools import cached_property

import numpy as np
import torch


def _reshape_axis(arr: np.ndarray, axis: int, ndim: int) -> np.ndarray:
    """Reshape 1-D `arr` so it broadcasts along `axis` of an ndim-D field."""
    shape = [1] * ndim
    shape[axis] = arr.shape[0]
    return arr.reshape(shape)


def checked_device(device) -> torch.device:
    """`device` as a torch.device; raises when it names a CUDA device and
    none is available (the entry points default to the card and never
    fall back to the CPU by themselves)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Rectilinear structured mesh in 1, 2 or 3 dimensions.

    x_faces: one strictly increasing 1-D array of face coordinates per axis
    (length n_i + 1).  dtype/device: where the mesh's tensor geometry lives.
    solid: an optional boolean numpy mask over the cells, True outside the
    flow domain.
    """

    x_faces: tuple
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")
    solid: tp.Any = dataclasses.field(default=None, compare=False,
                                      repr=False)
    axisymmetric = False

    @staticmethod
    def uniform(shape, lengths=None, origin=None, dtype=torch.float32,
                device="cpu") -> "Mesh":
        """Uniform mesh with `shape` cells spanning `lengths` (default unit box)."""
        ndim = len(shape)
        lengths = lengths if lengths is not None else (1.0,) * ndim
        origin = origin if origin is not None else (0.0,) * ndim
        faces = tuple(
            np.linspace(origin[a], origin[a] + lengths[a], shape[a] + 1,
                        dtype=np.float64)
            for a in range(ndim)
        )
        return Mesh(x_faces=faces, dtype=dtype, device=torch.device(device))

    def __post_init__(self):
        object.__setattr__(
            self, "x_faces",
            tuple(np.asarray(xf, dtype=np.float64) for xf in self.x_faces))
        object.__setattr__(self, "device", torch.device(self.device))

    # -- basic topology --------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.x_faces)

    @cached_property
    def shape(self) -> tuple:
        return tuple(xf.shape[0] - 1 for xf in self.x_faces)

    def face_shape(self, axis: int) -> tuple:
        s = list(self.shape)
        s[axis] += 1
        return tuple(s)

    # -- 1-D geometry (float64 numpy) -------------------------------------------
    @cached_property
    def dx(self) -> tuple:
        """Cell widths per axis, shape (n_a,)."""
        return tuple(np.diff(xf) for xf in self.x_faces)

    @cached_property
    def centers(self) -> tuple:
        """Cell center coordinates per axis, shape (n_a,)."""
        return tuple(0.5 * (xf[:-1] + xf[1:]) for xf in self.x_faces)

    @cached_property
    def _pdx(self) -> tuple:
        """Cell widths padded with mirrored ghost widths, shape (n_a+2,)."""
        return tuple(np.concatenate([[d[0]], d, [d[-1]]]) for d in self.dx)

    @cached_property
    def d_centers(self) -> tuple:
        """Center-to-center distance across each face (ghosts mirrored)."""
        return tuple(0.5 * (p[:-1] + p[1:]) for p in self._pdx)

    @cached_property
    def w_face(self) -> tuple:
        """Linear interpolation weight of the LEFT cell at each face,
        shape (n_a+1,): f_face = w*f_left + (1-w)*f_right."""
        return tuple(p[1:] / (p[:-1] + p[1:]) for p in self._pdx)

    @property
    def w_vertex(self) -> tuple:
        """Weights interpolating cell lines to vertex planes (vertices sit on
        face coordinates, so the formula is the face one)."""
        return self.w_face

    @cached_property
    def h_face_1d(self) -> tuple:
        """Per-axis face QGD length, shape (n_a+1,): min(dx_l, dx_r) inside,
        the edge cell width on boundary faces."""
        out = []
        for d in self.dx:
            h = np.empty(d.shape[0] + 1)
            h[1:-1] = np.minimum(d[:-1], d[1:])
            h[0] = d[0]
            h[-1] = d[-1]
            out.append(h)
        return tuple(out)

    @cached_property
    def ext_centers(self) -> tuple:
        """Cell centers extended with mirrored ghost centers, shape (n_a+2,)."""
        out = []
        for a in range(self.ndim):
            c = self.centers[a]
            xf = self.x_faces[a]
            out.append(np.concatenate([[2 * xf[0] - c[0]], c,
                                       [2 * xf[-1] - c[-1]]]))
        return tuple(out)

    # -- tensor geometry ---------------------------------------------------------
    def tensor(self, arr) -> torch.Tensor:
        """numpy array -> tensor in the mesh's dtype on the mesh's device."""
        return torch.as_tensor(np.array(arr), dtype=self.dtype,
                               device=self.device)

    def bcast(self, arr_1d, axis: int) -> torch.Tensor:
        """1-D array -> tensor broadcastable along `axis` of a cell field."""
        return self.tensor(_reshape_axis(np.asarray(arr_1d), axis, self.ndim))

    def cell_coords(self, axis: int) -> torch.Tensor:
        """Cell-centre coordinates along `axis`, broadcastable."""
        return self.bcast(self.centers[axis], axis)

    @cached_property
    def _h_cell_np(self) -> np.ndarray:
        num = 0.0
        den = 0.0
        for a in range(self.ndim):
            hf = self.h_face_1d[a]
            h_lo = _reshape_axis(hf[:-1], a, self.ndim)
            h_hi = _reshape_axis(hf[1:], a, self.ndim)
            area = np.ones([1] * self.ndim)
            for b in range(self.ndim):
                if b != a:
                    area = area * _reshape_axis(self.dx[b], b, self.ndim)
            num = num + area * (h_lo + h_hi)
            den = den + 2.0 * area
        return np.ascontiguousarray(np.broadcast_to(num / den, self.shape))

    @cached_property
    def h_cell(self) -> torch.Tensor:
        """QGD cell length scale: area-weighted mean of the cell's face h_f,
        as a full cell-shaped tensor."""
        return self.tensor(self._h_cell_np)

    @cached_property
    def _h_face_t(self) -> tuple:
        return tuple(self.bcast(h, a) for a, h in enumerate(self.h_face_1d))

    def h_face(self, axis: int) -> torch.Tensor:
        """QGD face length scale h_f, broadcastable to axis-face fields."""
        return self._h_face_t[axis]

    @cached_property
    def _face_area_t(self) -> tuple:
        out = []
        for axis in range(self.ndim):
            a_ = np.ones([1] * self.ndim)
            for b in range(self.ndim):
                if b != axis:
                    a_ = a_ * _reshape_axis(self.dx[b], b, self.ndim)
            out.append(self.tensor(a_))
        return tuple(out)

    def face_area(self, axis: int) -> torch.Tensor:
        """|S_f| for faces normal to `axis`, broadcastable to the face shape."""
        return self._face_area_t[axis]

    @cached_property
    def cell_volume(self) -> torch.Tensor:
        """Cell volumes, broadcastable to the cell shape."""
        v = _reshape_axis(self.dx[0], 0, self.ndim)
        for a in range(1, self.ndim):
            v = v * _reshape_axis(self.dx[a], a, self.ndim)
        return self.tensor(v)

    def face_coords(self, axis: int) -> torch.Tensor:
        """Face coordinates along `axis`, broadcastable to axis-face
        fields."""
        return self.bcast(self.x_faces[axis], axis)

    @cached_property
    def uniform_volume(self) -> bool:
        """True when every cell has one volume by construction: each axis's
        widths equal to round-off, and not a wedge.  Read from the host
        geometry, so deciding it reads nothing from the device; the CG
        then needs no volume weight (`ops.linsolve`)."""
        if self.axisymmetric:
            return False
        return all(float(np.ptp(d)) <= 1e-9 * float(np.max(np.abs(d)))
                   for d in self.dx)

    @cached_property
    def faces_f64(self) -> tuple:
        """The face coordinates per axis as float64 1-D tensors on the
        mesh's device, moved there once (the parcels' cell search compares
        positions with them in float64)."""
        return tuple(torch.as_tensor(xf, dtype=torch.float64,
                                     device=self.device)
                     for xf in self.x_faces)


class TracedMesh:
    """The geometry of a mesh whose per-axis face coordinates are tensors
    on the state's device: the post-motion mesh of one step of a moving
    mesh (QHDDyMFoam's `mesh_faces`, the counterpart of OpenFOAM's
    mesh.update()).

    Every geometry quantity is recomputed from the face tensors with the
    formulas of `Mesh`, in torch ops on the device, so a step on a moving
    mesh reads no geometry back to the host.  An instance lives for one
    step; its quantities are cached on it.  It offers the `Mesh` surface
    the ops and solvers read (`dx`, `centers`, `w_face`, `d_centers`,
    `h_face_1d`, `ext_centers`, `bcast`, `tensor`, `cell_volume`,
    `face_area`, `h_face`, `h_cell`, `cell_coords`, `face_coords`)."""

    axisymmetric = False
    solid = None
    # general motion: the volumes are device tensors that may vary
    uniform_volume = False

    def __init__(self, x_faces, dtype=None, device=None):
        first = x_faces[0]
        self.dtype = dtype or (first.dtype if torch.is_tensor(first)
                               else torch.float64)
        self.device = torch.device(device if device is not None else
                                   first.device if torch.is_tensor(first)
                                   else "cpu")
        self.x_faces = tuple(torch.as_tensor(f, dtype=self.dtype,
                                             device=self.device)
                             for f in x_faces)
        self.shape = tuple(int(f.shape[0]) - 1 for f in self.x_faces)

    @property
    def ndim(self) -> int:
        return len(self.x_faces)

    def face_shape(self, axis: int) -> tuple:
        s = list(self.shape)
        s[axis] += 1
        return tuple(s)

    @cached_property
    def dx(self) -> tuple:
        return tuple(torch.diff(f) for f in self.x_faces)

    @cached_property
    def centers(self) -> tuple:
        return tuple(0.5 * (f[:-1] + f[1:]) for f in self.x_faces)

    @cached_property
    def _pdx(self) -> tuple:
        return tuple(torch.cat([d[:1], d, d[-1:]]) for d in self.dx)

    @cached_property
    def d_centers(self) -> tuple:
        return tuple(0.5 * (p[:-1] + p[1:]) for p in self._pdx)

    @cached_property
    def w_face(self) -> tuple:
        return tuple(p[1:] / (p[:-1] + p[1:]) for p in self._pdx)

    @property
    def w_vertex(self) -> tuple:
        return self.w_face

    @cached_property
    def h_face_1d(self) -> tuple:
        return tuple(torch.cat([d[:1], torch.minimum(d[:-1], d[1:]),
                                d[-1:]]) for d in self.dx)

    @cached_property
    def ext_centers(self) -> tuple:
        return tuple(torch.cat([2 * f[:1] - c[:1], c, 2 * f[-1:] - c[-1:]])
                     for f, c in zip(self.x_faces, self.centers))

    def tensor(self, arr) -> torch.Tensor:
        """A tensor (or number) in the mesh's dtype on its device; no
        host copy of a tensor already there."""
        return torch.as_tensor(arr, dtype=self.dtype, device=self.device)

    def bcast(self, arr_1d, axis: int) -> torch.Tensor:
        return _reshape_axis(self.tensor(arr_1d), axis, self.ndim)

    def cell_coords(self, axis: int) -> torch.Tensor:
        return self.bcast(self.centers[axis], axis)

    def face_coords(self, axis: int) -> torch.Tensor:
        return self.bcast(self.x_faces[axis], axis)

    def _area(self, axis: int):
        a_ = None
        for b in range(self.ndim):
            if b != axis:
                d = _reshape_axis(self.dx[b], b, self.ndim)
                a_ = d if a_ is None else a_ * d
        if a_ is None:  # a 1D mesh: unit face areas
            return torch.ones((1,), dtype=self.dtype, device=self.device)
        return a_

    def face_area(self, axis: int) -> torch.Tensor:
        return self._face_area_t[axis]

    @cached_property
    def _face_area_t(self) -> tuple:
        return tuple(self._area(a) for a in range(self.ndim))

    def h_face(self, axis: int) -> torch.Tensor:
        return self.bcast(self.h_face_1d[axis], axis)

    @cached_property
    def h_cell(self) -> torch.Tensor:
        num = den = 0.0
        for a in range(self.ndim):
            hf = self.h_face_1d[a]
            h_lo = _reshape_axis(hf[:-1], a, self.ndim)
            h_hi = _reshape_axis(hf[1:], a, self.ndim)
            area = self._area(a)
            num = num + area * (h_lo + h_hi)
            den = den + 2.0 * area
        return torch.broadcast_to(num / den, self.shape).contiguous()

    @cached_property
    def cell_volume(self) -> torch.Tensor:
        v = _reshape_axis(self.dx[0], 0, self.ndim)
        for a in range(1, self.ndim):
            v = v * _reshape_axis(self.dx[a], a, self.ndim)
        return v


@dataclasses.dataclass(frozen=True)
class AxisymmetricMesh(Mesh):
    """2D axisymmetric (x, r) mesh, the structured counterpart of an
    OpenFOAM wedge (a one-cell sector swept about the x axis).  Metrics are
    per unit swept angle:

      V      = dx * dr * r_c
      |S_x|  = dr * r_c        (axial faces)
      |S_r|  = dx * r_f        (radial faces; zero on the axis r = 0)

    so the face-flux divergence is the cylindrical (1/r) d(r .)/dr, and
    (|S_r|_hi - |S_r|_lo)/V = 1/r_c balances the solvers' p/r hoop source
    to rounding.  Axis 0 is x, axis 1 the radius r >= 0; the stencil
    operators (coordinate derivatives) are those of `Mesh`."""

    axisymmetric = True

    def __post_init__(self):
        super().__post_init__()
        if self.ndim != 2:
            raise ValueError("axisymmetric meshes are 2D (x, r)")
        if self.x_faces[1][0] < -1e-12:
            raise ValueError("the radius must be non-negative")

    @cached_property
    def r_cell(self) -> np.ndarray:
        """Cell-centre radii, shape (n_r,)."""
        return self.centers[1]

    @cached_property
    def cell_volume(self) -> torch.Tensor:
        v = _reshape_axis(self.dx[0], 0, 2) * _reshape_axis(self.dx[1], 1, 2)
        return self.tensor(v * _reshape_axis(self.r_cell, 1, 2))

    @cached_property
    def _face_area_t(self) -> tuple:
        ax = (_reshape_axis(self.dx[1], 1, 2)
              * _reshape_axis(self.r_cell, 1, 2))
        ar = (_reshape_axis(self.dx[0], 0, 2)
              * _reshape_axis(self.x_faces[1], 1, 2))
        return self.tensor(ax), self.tensor(ar)
