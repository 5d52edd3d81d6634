"""A block's window of the global mesh geometry (PyTorch port of
`qgdsolver_tpu.parallel.shardmesh`).

The reference's decomposition is mesh-agnostic: decomposePar hands every
rank its own cell geometry, graded spacings included.  Here the global
`core.mesh.Mesh` holds every separable 1-D geometry array in float64 numpy,
and a `ShardMesh` is a `Mesh` over the block's faces whose arrays that reach
past the block (ghost widths, face weights, centre distances, QGD face
lengths, mirrored ghost centres) are windows of the global ones.  At a
partition face they therefore carry the true neighbour-side spacings, the
same numbers the serial mesh has for that interior face, so the decomposed
step is the serial discretization with no geometry exchange.  Each process
is one block, so the windows start at plain integer offsets.  A block of an
`AxisymmetricMesh` is an `AxisymmetricShardMesh`: its r-weighted volumes
and face areas need only the block's own faces and centres.  A block of a
`TracedMesh` (a moving mesh's geometry of one step, face tensors on the
device) is a `TracedShardMesh`, which windows the global tensors the same
way.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

from ..core.mesh import AxisymmetricMesh, Mesh, TracedMesh


@dataclasses.dataclass(frozen=True)
class ShardMesh(Mesh):
    """The block of `global_mesh` whose first cell along axis a is
    `starts[a]`; x_faces are the block's own face coordinates."""

    global_mesh: Mesh = None
    starts: tuple = ()

    @staticmethod
    def window(global_mesh: Mesh, starts, shape) -> "ShardMesh":
        faces = tuple(xf[s:s + n + 1] for xf, s, n
                      in zip(global_mesh.x_faces, starts, shape))
        cls = (AxisymmetricShardMesh if global_mesh.axisymmetric
               else ShardMesh)
        return cls(x_faces=faces, dtype=global_mesh.dtype,
                         device=global_mesh.device, global_mesh=global_mesh,
                         starts=tuple(int(s) for s in starts))

    def _win(self, arrs, extra: int) -> tuple:
        return tuple(arr[s:s + n + extra] for arr, s, n
                     in zip(arrs, self.starts, self.shape))

    @cached_property
    def _pdx(self) -> tuple:
        return self._win(self.global_mesh._pdx, 2)

    @cached_property
    def ext_centers(self) -> tuple:
        return self._win(self.global_mesh.ext_centers, 2)

    @cached_property
    def h_face_1d(self) -> tuple:
        return self._win(self.global_mesh.h_face_1d, 1)

    @cached_property
    def uniform_volume(self) -> bool:
        # the global mesh's, so every rank's CG takes the same inner product
        return self.global_mesh.uniform_volume


@dataclasses.dataclass(frozen=True)
class AxisymmetricShardMesh(ShardMesh, AxisymmetricMesh):
    """A block of an `AxisymmetricMesh`: ShardMesh's windows, and the
    r-weighted metrics of the block's cells."""


class TracedShardMesh(TracedMesh):
    """A block of a `TracedMesh` (a moving mesh's post-motion geometry
    under a decomposition): the block's own face tensors, and windows of
    the global tensors for what reaches past the block (ghost widths, so
    face weights and centre distances; QGD face lengths; mirrored ghost
    centres).  Its partition faces see the neighbour block's spacing, as
    `ShardMesh`'s do, and nothing leaves the device."""

    def __init__(self, global_mesh: TracedMesh, starts, shape):
        self.global_mesh = global_mesh
        self.starts = tuple(int(s) for s in starts)
        super().__init__(tuple(f[s:s + n + 1] for f, s, n
                               in zip(global_mesh.x_faces, self.starts,
                                      shape)),
                         dtype=global_mesh.dtype, device=global_mesh.device)

    def _win(self, arrs, extra: int) -> tuple:
        return tuple(arr[s:s + n + extra] for arr, s, n
                     in zip(arrs, self.starts, self.shape))

    @cached_property
    def _pdx(self) -> tuple:
        return self._win(self.global_mesh._pdx, 2)

    @cached_property
    def ext_centers(self) -> tuple:
        return self._win(self.global_mesh.ext_centers, 2)

    @cached_property
    def h_face_1d(self) -> tuple:
        return self._win(self.global_mesh.h_face_1d, 1)
