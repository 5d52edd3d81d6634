"""What each rank of the decomposed-run tests runs.

`parallel.distributed.spawn` starts fresh processes that import a rank's
function by name, so the bodies live here, in a module that imports the
port and no JAX (the JAX references run in the pytest process).  A job is
(kind, case, shape, dtype, (px, py), steps, initial State with numpy
leaves): kind "spmd" is the decomposed composable step, "k3" and "k5" the
decomposed fused steps, "scaling" a `measure_scaling` call (shape: its
base tile; no state).  The case is any solver of `port_case`: the QGD
jets, the QHD buoyant cavity (also with the MULES T equation), the scalar
box, QHDDyMFoam's dilating and general-motion meshes and interQHDFoam's
graded drop, whose States `interop` carries by their field names; a case
name "case!fault" runs it with one of the JAX package's decomposition
faults put back into the port (`_fault_patches`).  `run_jobs` runs the jobs in turn on this rank and
returns, per job, the gathered global State (numpy leaves) and the launch
counts of the flagged kernel wrappers over its steps.
"""
import dataclasses

import numpy as np
import torch

from qgdsolver_tpu_torch import cases, interop
from qgdsolver_tpu_torch.core import bc as bcm
from qgdsolver_tpu_torch.core.mesh import Mesh
from qgdsolver_tpu_torch.ops import fused_qgd2d as F
from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
from qgdsolver_tpu_torch.parallel import distributed, sharding
from qgdsolver_tpu_torch.physics.qgdcoeffs import ConstScPrModel1
from qgdsolver_tpu_torch.physics.thermo import PerfectGasThermo
from qgdsolver_tpu_torch.solvers.common import TimeControls
from qgdsolver_tpu_torch.solvers.qgd import QGDFoam

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def graded_faces(n, length, ratio, origin=0.0):
    """simpleGrading-style geometric spacing with total expansion `ratio`
    (tests/test_spmd.py's helper)."""
    r = ratio ** (1.0 / max(n - 1, 1))
    w = r ** np.arange(n)
    w = w / w.sum() * length
    return origin + np.concatenate([[0.0], np.cumsum(w)])


def periodic_y(solver, bcm_mod):
    """`solver` with Periodic y sides for U, p and T (either package)."""

    def per(b):
        return bcm_mod.FieldBCs((b.bcs[0],
                                 (bcm_mod.Periodic(), bcm_mod.Periodic())))

    return dataclasses.replace(solver, bc_U=per(solver.bc_U),
                               bc_p=per(solver.bc_p), bc_T=per(solver.bc_T))


def graded_jet(dtype, device):
    """The graded jet of tests/test_spmd.py::test_qgd_graded_jet_parity_2x2
    on the port (48x32 cells)."""
    nx, ny = 48, 32
    mesh = Mesh(x_faces=(graded_faces(nx, 4.0, 3.0),
                         graded_faces(ny, 2.0, 0.4)),
                dtype=dtype, device=device)
    th = PerfectGasThermo(R=287.0, Cp=1004.5)
    u_jet = 2.0 * float(th.c(torch.tensor(300.0, dtype=torch.float64)))
    delta = 3.0 * float(mesh.dx[1][0])

    def inlet_u(t, coords):
        yy = coords[1]
        ux = u_jet * 0.5 * (torch.tanh((0.3 - torch.abs(yy - 1.0)) / delta)
                            + 1.0) * torch.ones_like(yy)
        return torch.stack(torch.broadcast_tensors(ux, torch.zeros_like(ux)))

    solver = QGDFoam(
        mesh=mesh, thermo=th, tau_model=ConstScPrModel1(alpha=0.5, Sc=1.0),
        bc_U=bcm.FieldBCs(((bcm.FixedValue(inlet_u), bcm.ZeroGradient()),
                           (bcm.ZeroGradient(), bcm.ZeroGradient()))),
        bc_p=bcm.FieldBCs(((bcm.ZeroGradient(), bcm.FixedValue(1e5)),
                           (bcm.FixedValue(1e5), bcm.FixedValue(1e5)))),
        bc_T=bcm.FieldBCs(((bcm.FixedValue(300.0), bcm.ZeroGradient()),
                           (bcm.ZeroGradient(), bcm.ZeroGradient()))),
        time=TimeControls(max_co=0.3, max_dt=1e-4, dt0=1e-7))
    return solver


def wt_segmented_jet(shape, dtype, device):
    """The jet with waveTransmissive p and T outlets and a Segmented inlet
    side: the jet's inflow profile on the middle half of the rows, a slow
    fixed coflow on the rest."""
    solver, _ = cases.supersonic_jet(shape=shape, dtype=dtype, device=device)
    ny = shape[1]
    inlet = bcm.Segmented((
        ((((0, ny),),), bcm.FixedValue([50.0, 0.0])),
        ((((ny // 4, 3 * ny // 4),),), solver.bc_U[0, 0])))
    return dataclasses.replace(
        solver, bc_U=solver.bc_U.replace(0, 0, inlet),
        bc_p=solver.bc_p.replace(0, 1, bcm.WaveTransmissive(1e5, 0.5)),
        bc_T=solver.bc_T.replace(0, 1, bcm.WaveTransmissive(300.0)))


def wt_split_outlet(shape, dtype, device):
    """`wt_segmented_jet` with its outlet side split: waveTransmissive p
    and T on the rows [0, 3*ny/8) (the same BCs as the whole side there),
    the jet's own outlet BCs (fixed p, zero-gradient T) on the rest."""
    solver = wt_segmented_jet(shape, dtype, device)
    jet, _ = cases.supersonic_jet(shape=shape, dtype=dtype, device=device)
    k = 3 * shape[1] // 8

    def split(whole, rest):
        return bcm.Segmented(((((((0, k),),), whole),
                               ((((k, shape[1]),),), rest))))

    return dataclasses.replace(
        solver,
        bc_p=solver.bc_p.replace(0, 1, split(solver.bc_p[0, 1],
                                             jet.bc_p[0, 1])),
        bc_T=solver.bc_T.replace(0, 1, split(solver.bc_T[0, 1],
                                             jet.bc_T[0, 1])))


def mules_box(shape, dtype, device):
    """(solver, State): tests/test_solver_variants.py's MULES box (a
    periodic channel, explicit diffusion) with its top hat of T at
    0.2 < x < 0.5, its front on the middle of x, carried at U = (1, 0)."""
    from qgdsolver_tpu_torch.physics.qgdcoeffs import HbyUQHD
    from qgdsolver_tpu_torch.physics.thermo import RhoConstThermo
    from qgdsolver_tpu_torch.solvers.mules_qhd import MulesQHDFoam

    mesh = Mesh.uniform(shape, lengths=(1.0, 1.0), dtype=dtype,
                        device=device)
    per = bcm.FieldBCs.uniform(bcm.Periodic(), 2)
    solver = MulesQHDFoam(
        mesh=mesh, thermo=RhoConstThermo(rho0=1.0, Cp=1000.0, mu0=1e-6,
                                         Pr=1.0),
        tau_model=HbyUQHD(alpha=0.2, U0=1.0), g=(0.0, 0.0), bc_U=per,
        bc_T=per, bc_p=per, implicit_diffusion=False,
        time=TimeControls(max_co=0.3, max_dt=2e-3, dt0=5e-4))
    x = np.asarray(mesh.centers[0])[:, None] * np.ones(mesh.shape)
    T0 = mesh.tensor((np.abs(x - 0.35) < 0.15).astype(np.float64))
    U0 = torch.stack([torch.ones_like(T0), torch.zeros_like(T0)])
    return solver, solver.init(U0, T0)


def _blob(mesh, x0, y0, width):
    x = mesh.centers[0][:, None] * np.ones(mesh.shape)
    y = mesh.centers[1][None, :] * np.ones(mesh.shape)
    return mesh.tensor(np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / width))


def dym_dilation(shape, dtype, device):
    """(solver, State): tests/test_spmd.py's deforming QHDDyMFoam (an
    oscillating dilation with a rigid velocity and the mesh Courant cap)
    on the port, its motion in torch."""
    from qgdsolver_tpu_torch.physics.qgdcoeffs import ConstTau
    from qgdsolver_tpu_torch.physics.thermo import RhoConstThermo
    from qgdsolver_tpu_torch.solvers.qhd_dym import QHDDyMFoam

    mesh = Mesh.uniform(shape, dtype=dtype, device=device)
    zg = bcm.FieldBCs.uniform(bcm.ZeroGradient(), 2)
    solver = QHDDyMFoam(
        mesh_scale=lambda t: (1.0 + 0.15 * torch.sin(3.0 * t),
                              1.0 + 0.15 * torch.sin(5.1 * t + 0.5)),
        mesh_velocity=lambda t: (0.05, -0.02), check_mesh_courant=True,
        mesh=mesh, thermo=RhoConstThermo(rho0=1.0, Cp=1000.0, mu0=1e-3,
                                         Pr=1.0),
        tau_model=ConstTau(tau0=1e-4), bc_U=zg, bc_T=zg, bc_p=zg,
        time=TimeControls(max_co=0.3, max_dt=5e-3, dt0=1e-3), cg_tol=1e-12)
    T0 = _blob(mesh, 0.4, 0.6, 0.05)
    return solver, solver.init(torch.zeros((2,) + mesh.shape, dtype=dtype,
                                           device=device), T0)


def dym_general(shape, dtype, device):
    """(solver, State): tests/test_spmd.py's general-motion QHDDyMFoam
    (sloshing faces along x, breathing along y, the mesh Courant cap) on
    the port, its face trajectories torch tensors on `device`."""
    from qgdsolver_tpu_torch.physics.qgdcoeffs import ConstTau
    from qgdsolver_tpu_torch.physics.thermo import RhoConstThermo
    from qgdsolver_tpu_torch.solvers.qhd_dym import QHDDyMFoam

    mesh = Mesh.uniform(shape, dtype=dtype, device=device)
    x0, y0 = (torch.linspace(0.0, 1.0, n + 1, dtype=dtype, device=device)
              for n in shape)

    def faces(t):
        return (x0 + 0.06 * torch.sin(3.0 * t) * torch.sin(np.pi * x0),
                y0 + 0.04 * torch.sin(5.1 * t) * y0 * (1.0 - y0))

    zg = bcm.FieldBCs.uniform(bcm.ZeroGradient(), 2)
    solver = QHDDyMFoam(
        mesh_faces=faces, check_mesh_courant=True, mesh=mesh,
        thermo=RhoConstThermo(rho0=1.0, Cp=1000.0, mu0=1e-3, Pr=1.0),
        tau_model=ConstTau(tau0=1e-4), bc_U=zg, bc_T=zg, bc_p=zg,
        time=TimeControls(max_co=0.3, max_dt=5e-3, dt0=1e-3), cg_tol=1e-12)
    T0 = _blob(mesh, 0.45, 0.55, 0.05)
    return solver, solver.init(torch.zeros((2,) + mesh.shape, dtype=dtype,
                                           device=device), T0)


def graded_drop(shape, dtype, device):
    """(solver, State): a heavy drop with surface tension under gravity on
    a graded mesh (x expanding, y contracting: the blocks' mean cell
    volumes differ), a 60 degree contact angle on the floor, the alpha
    smoothing on, and a pure-Neumann p (the pRef fix).  Its interface
    crosses both partition lines of a 2x2 decomposition."""
    from qgdsolver_tpu_torch.physics.twophase import (ContactAngle,
                                                      TwoPhaseProperties)
    from qgdsolver_tpu_torch.solvers.inter_qhd import InterQHDFoam

    nx, ny = shape
    mesh = Mesh(x_faces=(graded_faces(nx, 1.0, 3.0),
                         graded_faces(ny, 1.0, 0.4)),
                dtype=dtype, device=device)
    props = TwoPhaseProperties(rho1=1000.0, rho2=1.0, nu1=1e-6, nu2=1.5e-5,
                               tau1=2e-4, tau2=2e-4, sigma=0.07,
                               c_alpha=1.0)
    solver = InterQHDFoam(
        mesh=mesh, props=props, g=(0.0, -9.81),
        contact_angles={(1, 0): ContactAngle(theta0=np.radians(60.0))},
        smooth_alpha=True,
        time=TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-4), cg_tol=1e-10)
    x = mesh.centers[0][:, None] * np.ones(mesh.shape)
    y = mesh.centers[1][None, :] * np.ones(mesh.shape)
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.45) ** 2)
    a0 = mesh.tensor(0.5 * (1.0 - np.tanh((r - 0.25) / 0.03)))
    return solver, solver.init(torch.zeros((2,) + mesh.shape, dtype=dtype,
                                           device=device), a0)


# the JAX package's decomposition faults of interQHDFoam, put back into
# the port's step by name: each makes a block use its own edges where the
# serial step sees the neighbour's
def _fault_patches():
    from qgdsolver_tpu_torch.ops import mules
    from qgdsolver_tpu_torch.physics import twophase
    from qgdsolver_tpu_torch.solvers import inter_qhd

    def own_edge_upwind(phi_a, fld, nd, a):
        ax = fld.ndim - nd + a
        n = fld.shape[ax]
        ext = torch.cat([fld.narrow(ax, 0, 1), fld,
                         fld.narrow(ax, n - 1, 1)], dim=ax)
        lo, hi = mules._pairs(ext, nd, a)
        return torch.where(phi_a >= 0, lo, hi) * phi_a

    def both_ends_zeroed(phic, nd, a):
        ax = phic.ndim - nd + a
        n = phic.shape[ax]
        mask = torch.ones(n, dtype=phic.dtype, device=phic.device)
        mask[0] = mask[n - 1] = 0.0
        shape = [1] * phic.ndim
        shape[ax] = n
        return phic * mask.reshape(shape)

    return {
        "upwind": (inter_qhd, "upwind_flux", own_edge_upwind),
        "pref": (inter_qhd, "pressure_reference",
                 lambda p, nd: p[(0,) * nd]),
        "compression": (inter_qhd, "uncoupled_zeroed", both_ends_zeroed),
        "delta_n": (inter_qhd, "_whole_mesh", lambda mesh: mesh),
        "contact": (twophase, "owns_wall", lambda a, side: True),
    }


def port_case(name, shape, dtype, device="cpu"):
    """The port's solver for a test case name."""
    if name in ("dym_dilation", "dym_general", "graded_drop"):
        return globals()[name](shape, dtype, device)[0]
    if name == "graded_jet":
        return graded_jet(dtype, device)
    if name == "implicit_jet":
        solver, _ = cases.supersonic_jet(shape=shape, dtype=dtype,
                                         device=device)
        return dataclasses.replace(solver, implicit_diffusion=True)
    if name == "implicit_wedge_blob":
        solver, _ = cases.wedge_blob(shape=shape, dtype=dtype, device=device)
        return dataclasses.replace(solver, implicit_diffusion=True)
    if name == "wt_segmented_jet":
        return wt_segmented_jet(shape, dtype, device)
    if name == "wt_split_outlet":
        return wt_split_outlet(shape, dtype, device)
    if name == "mules_box":
        return mules_box(shape, dtype, device)[0]
    if name == "mules_cavity":
        solver, _ = cases.buoyant_cavity(shape=shape, dtype=dtype,
                                         device=device)
        return dataclasses.replace(solver, t_equation="mules")
    base = {"periodic_jet": "supersonic_jet",
            "inlet_outlet_jet": "supersonic_jet"}.get(name, name)
    solver, _ = getattr(cases, base)(shape=shape, dtype=dtype, device=device)
    if name == "periodic_jet":
        solver = periodic_y(solver, bcm)
    elif name == "inlet_outlet_jet":
        solver = dataclasses.replace(
            solver,
            bc_U=solver.bc_U.replace(1, 1, bcm.InletOutlet(np.zeros(2))),
            bc_T=solver.bc_T.replace(0, 1, bcm.InletOutlet(300.0)))
    return solver


def builder(kind):
    return {"spmd": sharding.build_spmd_step,
            "k3": F.build_sharded_fused_step,
            "k5": F3.build_sharded_fused_step_3d}[kind]


def fail(msg):
    """A rank body that raises: a failing rank must fail `spawn`."""
    raise RuntimeError(msg)


def dryrun_rank_fails(grids, device, steps):
    """A dry-run rank body whose rank 1 raises while the others return at
    once (no collective, so no peer sees a reset connection first): the
    dry run must raise with rank 1's report."""
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("planted failure on rank 1")
    return {}


def run_jobs(jobs, device="cpu"):
    """Run each job on this rank; [(global State with numpy leaves,
    {wrapper: launches}), ...]."""
    dev = distributed.rank_device(device)
    kernels = F.SHARDED_KERNELS + F3.SHARDED_KERNELS
    out = []
    for kind, name, shape, dtype, (px, py), steps, state_np in jobs:
        dtype = DTYPES[dtype]
        if kind == "scaling":
            out.append((distributed.measure_scaling(
                lambda shp: getattr(cases, name)(shape=shp, dtype=dtype,
                                                 device=dev),
                sharding.ProcessGrid(px, py), n_steps=steps, repeats=1,
                base=shape), {}))
            continue
        # "case!fault": the case with one of the JAX package's
        # decomposition faults put back (`_fault_patches`)
        name, _, fault = name.partition("!")
        patch = _fault_patches()[fault] if fault else None
        if patch is not None:
            mod, attr, fn = patch
            saved = getattr(mod, attr)
            setattr(mod, attr, fn)
        try:
            solver = port_case(name, shape, dtype, dev)
            step, to_blocks, from_blocks = builder(kind)(
                solver, sharding.ProcessGrid(px, py))
            s = to_blocks(interop.state_from_numpy(state_np, device=dev,
                                                   dtype=dtype))
            for k in kernels:
                k.launches = 0
            for _ in range(steps):
                s = step(s)
        finally:
            if patch is not None:
                setattr(mod, attr, saved)
        launches = {k.__name__: k.launches for k in kernels if k.launches}
        out.append((interop.state_to_numpy(from_blocks(s)), launches))
    return out


# ---------------------------------------------------------------------------
# Lagrangian clouds decomposed (tests/test_torch_particles_spmd.py)
# ---------------------------------------------------------------------------


def cloud_case(name, shape, dtype, device="cpu"):
    """The port's particlesQGDFoam solver of a cloud test case: "cloud_jet"
    is the supersonic jet with particles_case's cloud constants (rho 2500,
    Cp 900), two-way, escaping walls; "cloud_periodic" a periodic box in a
    uniform 20 m/s stream with periodic cloud walls."""
    from qgdsolver_tpu_torch.solvers.particles import (ParticlesQGDFoam,
                                                       ThermoCloud)

    if name == "cloud_jet":
        fluid, _ = cases.supersonic_jet(shape=shape, dtype=dtype,
                                        device=device)
        return ParticlesQGDFoam(fluid=fluid, cloud=ThermoCloud(
            rho_p=2500.0, Cp_p=900.0, two_way=True))
    mesh = Mesh.uniform(shape, lengths=(1.0, 0.5), dtype=dtype,
                        device=device)
    per = bcm.FieldBCs.uniform(bcm.Periodic(), 2)
    fluid = QGDFoam(mesh=mesh, thermo=PerfectGasThermo(R=287.0, Cp=1004.5),
                    tau_model=ConstScPrModel1(alpha=0.5), bc_U=per,
                    bc_p=per, bc_T=per,
                    time=TimeControls(max_co=0.3, max_dt=1e-4, dt0=1e-6))
    return ParticlesQGDFoam(fluid=fluid, cloud=ThermoCloud(
        rho_p=800.0, two_way=True, wall="periodic"))


def long_way_round(xa, act, a, ctx):
    """The JAX package's migration rule (its `_migrate`): up past the
    block's high face, down below its low face, so a parcel that wrapped a
    periodic edge goes the long way round, a block a step."""
    mesh = ctx.global_mesh
    lo = float(mesh.x_faces[a][ctx.start(a)])
    hi = float(mesh.x_faces[a][ctx.start(a) + ctx.axes[a].n_local])
    up = act * (xa >= hi).to(act.dtype)
    down = act * (xa < lo).to(act.dtype)
    return up, down * (1.0 - up), torch.zeros_like(act)


def run_cloud_jobs(jobs, device="cpu"):
    """Run each cloud job on this rank: (case, shape, (px, py), steps,
    initial PState with numpy leaves, slot capacity or None, fault or
    None), the fault "long_way" putting the JAX package's migration rule
    back.  After the steps `particles.raise_dropped` reads the lost
    parcels, as the CLI does.  Per job ("ok", the gathered PState with
    numpy leaves) or ("error", exception class name, message)."""
    from qgdsolver_tpu_torch.solvers import particles

    dev = distributed.rank_device(device)
    out = []
    for name, shape, (px, py), steps, state_np, capacity, fault in jobs:
        saved = particles.hop_masks
        if fault == "long_way":
            particles.hop_masks = long_way_round
        try:
            solver = cloud_case(name, shape, torch.float64, dev)
            step, to_blocks, from_blocks = sharding.build_spmd_step(
                solver, sharding.ProcessGrid(px, py), capacity=capacity)
            s = to_blocks(interop.state_from_numpy(state_np, device=dev,
                                                   dtype=torch.float64))
            for _ in range(steps):
                s = step(s)
            particles.raise_dropped(s)
            out.append(("ok", interop.state_to_numpy(from_blocks(s))))
        except (ValueError, RuntimeError, NotImplementedError) as e:
            out.append(("error", type(e).__name__, str(e)))
        finally:
            particles.hop_masks = saved
    return out
