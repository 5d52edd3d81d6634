"""rhoQGDFoam — the compressible QGD solver with an arbitrary equation of
state (PyTorch port of `qgdsolver_tpu.solvers.rho_qgd`).

The QGD step takes any thermo with the uniform interface (T_from_e,
p_from_rho_T, rho_from_p_T, c_from_pT, mu, alphah, gamma_of), so rhoQGDFoam
is QGDFoam configured with a `RhoThermo` (perfect or stiffened gas).  The
fused kernels take only `PerfectGasThermo`: this solver runs on the
composable step.
"""
from __future__ import annotations

from ..physics.thermo import RhoThermo
from .qgd import QGDFoam, State  # noqa: F401 — re-exported State


def RhoQGDFoam(*, thermo: RhoThermo, **kwargs) -> QGDFoam:
    """QGDFoam with the rho-based thermo `thermo`."""
    if not isinstance(thermo, RhoThermo):
        raise TypeError(f"rhoQGDFoam takes a RhoThermo, got "
                        f"{type(thermo).__name__}")
    return QGDFoam(thermo=thermo, **kwargs)
