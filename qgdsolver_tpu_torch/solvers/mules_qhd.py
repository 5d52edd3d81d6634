"""mulesQHDFoam — QHD with MULES-bounded temperature transport (PyTorch
port of `qgdsolver_tpu.solvers.mules_qhd`).

The p/U sequence of QHDFoam with the T equation replaced by bounded
explicit advection (`ops.mules.explicit_solve`, global bounds) and an
implicit diffusion correction (reference MULESTEqn.H): the QHD step with
t_equation="mules".
"""
from __future__ import annotations

from .qhd import QHDFoam, State  # noqa: F401 — re-exported State


def MulesQHDFoam(**kwargs) -> QHDFoam:
    kwargs.setdefault("t_equation", "mules")
    return QHDFoam(**kwargs)
