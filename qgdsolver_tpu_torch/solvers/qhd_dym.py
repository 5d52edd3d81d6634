"""QHDDyMFoam — QHD on a moving or deforming mesh (PyTorch port of
`qgdsolver_tpu.solvers.qhd_dym`).

The reference constructs a dynamicFvMesh, calls mesh.update() each step and
makes the flux relative to the mesh motion (fvc::makeRelative), with an
optional mesh Courant check.  On the structured mesh three prescribed
motion classes run, all in the shared QHD step (`solvers.qhd`):

* rigid translation, `mesh_velocity`: t -> (ndim,) mesh velocity;
* per-axis dilation, `mesh_scale`: t -> (ndim,) scale factors, physical
  faces x_a(t) = s_a(t)*xi_a (may be combined with `mesh_velocity`);
* general per-axis face motion, `mesh_faces`: t -> tuple of (n_a + 1,)
  strictly increasing face coordinates (pistons, oscillating walls, moving
  refinement zones; alone).

`check_mesh_courant` folds the mesh face speed's Courant number into the dt
controller.

The motion callables' contract.  The step calls them with the simulation
time `t` as a 0-dim tensor on the state's device (t, t + dt, ...), and
never reads `t` back to the host; nor may a callable (no `float(t)`, no
`t.item()`).  A callable returns numbers, tensors, or numpy arrays, or a
tuple of them: numbers are filled on the device, tensors are moved to the
state's device and dtype (a no-op when they are there already), and numpy
arrays are copied from the host, a copy that waits for the device's queue
each step, so give array constants as tensors on the state's device.  Write
arithmetic with the tensor on the left of a numpy operand
(`(1.0 - left) * x0` with `left` a tensor works on the CPU, while
`x0 * left` raises) or, better, make x0 a tensor; on a CUDA device a numpy
operand raises either way.  Use torch functions (`torch.sin(w * t)`), not
numpy's or math's, of `t`.
"""
from __future__ import annotations

from .qhd import QHDFoam, State, motion_value  # noqa: F401


def QHDDyMFoam(*, mesh_velocity=None, mesh_scale=None, mesh_faces=None,
               **kwargs) -> QHDFoam:
    """A QHDFoam with its motion set: mesh_velocity t -> (ndim,) rigid mesh
    velocity; mesh_scale t -> (ndim,) per-axis dilation factors; mesh_faces
    t -> tuple of per-axis face-coordinate arrays (the general motion
    spec, exclusive with the other two).  At least one must be given."""
    if mesh_velocity is None and mesh_scale is None and mesh_faces is None:
        raise ValueError("QHDDyMFoam needs mesh_velocity, mesh_scale or "
                         "mesh_faces")
    return QHDFoam(mesh_velocity=mesh_velocity, mesh_scale=mesh_scale,
                   mesh_faces=mesh_faces, **kwargs)
