"""SRFQHDFoam — QHD in a single rotating frame (PyTorch port of
`qgdsolver_tpu.solvers.srf_qhd`).

The p/U/T sequence of QHDFoam solving the relative velocity, with the body
force gaining the Coriolis term BdFrc = beta*T*g - 2*Omega x U (reference
SRFQHDFoam updateFields.H); the centrifugal part is absorbed into the
reduced pressure.  A configuration of the QHD step with `omega` set.
"""
from __future__ import annotations

from .qhd import QHDFoam, State  # noqa: F401 — re-exported State


def SRFQHDFoam(*, omega, **kwargs) -> QHDFoam:
    """QHDFoam with the rotation vector `omega` (a 3-tuple; in 2D only
    omega_z acts)."""
    return QHDFoam(omega=tuple(omega), **kwargs)
