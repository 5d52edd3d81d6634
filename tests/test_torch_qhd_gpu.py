"""The QHD family of the port on the card (marked `gpu`: they skip where no
CUDA device exists; run them there with
`python -m pytest tests/test_torch_qhd_gpu.py -m gpu -q`).

* The de Vahl Davis cavity at Ra = 1e3 (tests/test_validation.py's
  32x32 case) run to a stationary hot-wall Nusselt number on the card:
  within 10% of 1.118.
* The buoyant cavity decomposed over two ranks that share cuda:0 (gloo,
  halos through pinned host memory), with the singular pressure solve,
  the pRef fix through `spmd.first_shard_value` and the MULES T equation,
  against the serial port on the card: each field within 2*n*cg_tol of
  its max (the CG's dots are all-reduced sums, summed in another order).
"""

import numpy as np
import pytest
import torch

from qgdsolver_tpu_torch import cases, interop
from qgdsolver_tpu_torch.core import bc
from qgdsolver_tpu_torch.core.mesh import Mesh
from qgdsolver_tpu_torch.physics.qgdcoeffs import H2bynuQHD
from qgdsolver_tpu_torch.physics.thermo import RhoConstThermo
from qgdsolver_tpu_torch.solvers import common
from qgdsolver_tpu_torch.solvers.qhd import QHDFoam

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_cavity_nusselt_ra1e3_on_card(device):
    """Ra = 1e3, Pr = 0.71, 32x32, hot x-low wall: the mean hot-wall
    Nusselt number, once stationary (a change below 1e-3 over 400
    steps), within 10% of de Vahl Davis' 1.118."""
    n, Pr, nu, Ra = 32, 0.71, 0.02, 1.0e3
    g_beta = Ra * nu * nu / Pr  # L = dT = 1
    mesh = Mesh.uniform((n, n), lengths=(1.0, 1.0), dtype=torch.float64,
                        device=device)
    solver = QHDFoam(
        mesh=mesh, thermo=RhoConstThermo(rho0=1.0, Cp=1000.0, mu0=nu, Pr=Pr,
                                         beta=-g_beta / 9.81),
        tau_model=H2bynuQHD(alpha=0.3), g=(0.0, -9.81),
        bc_U=bc.FieldBCs.uniform(bc.FixedValue([0.0, 0.0]), 2),
        bc_T=bc.FieldBCs(((bc.FixedValue(0.5), bc.FixedValue(-0.5)),
                          (bc.ZeroGradient(), bc.ZeroGradient()))),
        bc_p=bc.FieldBCs.uniform(bc.ZeroGradient(), 2),
        time=common.TimeControls(max_co=0.4, max_dt=0.2, dt0=1e-3))
    s = solver.init(U0=torch.zeros((2, n, n), dtype=torch.float64,
                                   device=device),
                    T0=torch.zeros((n, n), dtype=torch.float64,
                                   device=device))
    step = solver.make_step()
    prev = None
    for _ in range(12):
        s = common.run_steps(step, s, 400)
        # Nu = -dT/dx at the hot wall: (T_wall - T_cell)/(h/2)
        nu_mean = float(torch.mean(-(s.T[0] - 0.5) / (0.5 / n)))
        if prev is not None and abs(nu_mean - prev) < 1e-3:
            break
        prev = nu_mean
    assert prev is not None and abs(nu_mean - prev) < 1e-3, "not stationary"
    assert abs(nu_mean - 1.118) / 1.118 < 0.10, nu_mean


@pytest.mark.parametrize("name,grid", [("buoyant_cavity", (2, 1)),
                                       ("mules_cavity", (1, 2))])
def test_decomposed_cavity_on_card_matches_serial(name, grid, device):
    """8 steps of the 128x128 cavity on two ranks sharing the card against
    the serial port on the card: every field within 2*n*cg_tol of its
    max."""
    import _torch_rank_bodies as bodies
    from qgdsolver_tpu_torch.parallel import distributed

    shape, steps = (128, 128), 8
    solver = bodies.port_case(name, shape, torch.float64, device)
    _, s0 = cases.buoyant_cavity(shape=shape, device="cpu")
    job = ("spmd", name, shape, "float64", grid, steps,
           interop.state_to_numpy(s0))
    ranks = distributed.spawn(bodies.run_jobs, 2, [job], "cuda",
                              device="cuda", timeout=600)
    s = common.run_steps(solver.make_step(), interop.state_from_numpy(
        interop.state_to_numpy(s0), device=device, dtype=torch.float64),
        steps)
    ref = interop.state_to_numpy(s)
    tol = 2 * steps * solver.cg_tol
    assert np.abs(ref.U).max() > 1e-8, "the cavity must move"
    for got, _ in (r[0] for r in ranks):
        for f in ref._fields:
            a, b = getattr(ref, f), getattr(got, f)
            scale = max(np.abs(a).max(), 1e-300)
            assert np.abs(a - b).max() <= tol * scale, f
