"""The port's QHDDyMFoam (moving and deforming meshes) against the JAX
package, and its oracles on the port.  Mirrors tests/test_dym.py (the GCL
on an oscillating grid, the diffusion decay rate on a scaled grid, the GCL
on general face motion, general motion reducing to dilation, the piston
channel), tests/test_solver_variants.py's Galilean invariance and mesh
Courant cap, and tests/test_foam_case_e2e.py's dynamicMeshDict cases.

Both packages build each config from one description: the JAX solver
carried across by `interop.solver_from`, its motion callables given in
torch through `over` (a callable belongs to its array library).  The JAX
package runs n steps; the port runs n one-step windows from its float64
States (`_torch_parity.run_both`), each held within 2*cg_tol of each
field's max with equal CG iteration counts.  `TracedMesh`, the geometry of
a moved mesh, is held to the JAX package's and, on static faces, to the
port's `Mesh`; and a moving step reads nothing back to the host but the
CG's stop tests.
"""
import dataclasses
import math
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.core.mesh import Mesh as JMesh
from qgdsolver_tpu.core.mesh import TracedMesh as JTracedMesh
from qgdsolver_tpu.io import foam_case as jfoam_case
from qgdsolver_tpu.physics.qgdcoeffs import ConstTau as JConstTau
from qgdsolver_tpu.physics.qgdcoeffs import HbyUQHD as JHbyUQHD
from qgdsolver_tpu.physics.thermo import RhoConstThermo as JRhoConst
from qgdsolver_tpu.solvers import common as jcommon
from qgdsolver_tpu.solvers.qhd_dym import QHDDyMFoam as JQHDDyMFoam
from qgdsolver_tpu_torch import cli
from qgdsolver_tpu_torch.core import bc
from qgdsolver_tpu_torch.core.mesh import Mesh, TracedMesh
from qgdsolver_tpu_torch.io import foam_case
from qgdsolver_tpu_torch.ops import linsolve
from qgdsolver_tpu_torch.parallel.shardmesh import ShardMesh, TracedShardMesh
from qgdsolver_tpu_torch.physics.qgdcoeffs import ConstTau
from qgdsolver_tpu_torch.physics.thermo import RhoConstThermo
from qgdsolver_tpu_torch.solvers import common
from qgdsolver_tpu_torch.solvers.qhd_dym import QHDDyMFoam, motion_value

from _torch_parity import F64, run_both

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
X64 = np.float64


def _graded(n, ratio, length=1.0):
    r = ratio ** (1.0 / (n - 1))
    w = r ** np.arange(n)
    return np.concatenate([[0.0], np.cumsum(w / w.sum() * length)])


# ---------------------------------------------------------------------------
# TracedMesh
# ---------------------------------------------------------------------------

_GEOMETRY_1D = ("dx", "centers", "_pdx", "d_centers", "w_face", "w_vertex",
                "h_face_1d", "ext_centers")


def _geometry(m):
    """Every geometry quantity of a mesh of either package, as float64
    numpy arrays."""

    def np_(x):
        return (x.detach().cpu().numpy() if torch.is_tensor(x)
                else np.asarray(x, dtype=np.float64))

    out = {}
    for name in _GEOMETRY_1D:
        for a, v in enumerate(getattr(m, name)):
            out[(name, a)] = np_(v)
    for a in range(m.ndim):
        for name in ("face_area", "h_face", "cell_coords", "face_coords"):
            out[(name, a)] = np_(getattr(m, name)(a))
        out[("bcast", a)] = np_(m.bcast(m.x_faces[a], a))
    out["cell_volume"] = np_(m.cell_volume)
    out["h_cell"] = np_(m.h_cell)
    return out


@pytest.mark.parametrize("nd", [2, 3])
def test_traced_mesh_matches_jax_and_static_mesh(nd):
    """TracedMesh over graded face tensors: each quantity equal to the JAX
    TracedMesh's over the same faces (round-off), and on static faces to
    the port's Mesh's; TracedShardMesh's windows equal ShardMesh's."""
    faces = (_graded(12, 3.0), _graded(8, 0.4, 2.0), _graded(6, 1.5))[:nd]
    tm = TracedMesh(tuple(torch.as_tensor(f) for f in faces))
    assert tm.shape == tuple(len(f) - 1 for f in faces)
    assert tm.dtype == torch.float64 and not tm.axisymmetric
    got = _geometry(tm)
    ref = _geometry(JTracedMesh(tuple(jnp.asarray(f) for f in faces),
                                dtype=X64))
    static = _geometry(Mesh(x_faces=faces, dtype=torch.float64))
    assert got.keys() == ref.keys() == static.keys()
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-14, atol=0,
                                   err_msg=str(k))
        np.testing.assert_allclose(got[k], static[k], rtol=1e-14, atol=0,
                                   err_msg=str(k))
    starts, shape = (4, 2, 1)[:nd], (5, 4, 3)[:nd]
    win = _geometry(TracedShardMesh(tm, starts, shape))
    swin = _geometry(ShardMesh.window(Mesh(x_faces=faces,
                                           dtype=torch.float64),
                                      starts, shape))
    for k in win:
        np.testing.assert_allclose(win[k], swin[k], rtol=1e-14, atol=0,
                                   err_msg=str(k))


def test_motion_value_stays_on_the_device():
    """A motion callable's numbers, tensors, numpy arrays and sequences of
    them become tensors of the state's dtype; a number is filled, not
    copied."""
    like = torch.zeros(3, dtype=torch.float64)
    assert motion_value(2.5, like).dtype == torch.float64
    v = motion_value((0.05, torch.tensor(-0.02, dtype=torch.float32)), like)
    assert v.dtype == torch.float64 and v.tolist() == pytest.approx(
        [0.05, -0.02])
    np.testing.assert_array_equal(
        motion_value(np.linspace(0, 1, 3), like).numpy(), [0.0, 0.5, 1.0])
    # a callable's numpy operand goes on the right of a tensor
    left = torch.tensor(0.1, dtype=torch.float64)
    x0 = np.linspace(0.0, 1.0, 5)
    assert torch.is_tensor((1.0 - left) * x0)
    with pytest.raises(TypeError):
        x0 * left


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _thermo(mu0=1e-3):
    return JRhoConst(rho0=1.0, Cp=1000.0, mu0=mu0, Pr=1.0)


def _blob(mesh, x0=0.4, y0=0.6, w=0.05):
    x = np.asarray(mesh.cell_coords(0)) * np.ones(mesh.shape)
    y = np.asarray(mesh.cell_coords(1)) * np.ones(mesh.shape)
    return jnp.asarray(np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / w))


def _oscillating(n=16, amp=0.15, omega=3.0):
    """tests/test_dym.py's oscillating compression: (JAX solver, torch
    mesh_scale)."""
    mesh = JMesh.uniform((n, n), dtype=X64)
    zg = jbc.FieldBCs.uniform(jbc.ZeroGradient(), 2)
    js = JQHDDyMFoam(
        mesh_scale=lambda t: (1.0 + amp * jnp.sin(omega * t),
                              1.0 + amp * jnp.sin(1.7 * omega * t + 0.5)),
        mesh=mesh, thermo=_thermo(), tau_model=JConstTau(tau0=1e-4),
        bc_U=zg, bc_T=zg, bc_p=zg,
        time=jcommon.TimeControls(adjust_time_step=False, dt0=5e-3),
        cg_tol=1e-12)
    return js, dict(mesh_scale=lambda t: (
        1.0 + amp * torch.sin(omega * t),
        1.0 + amp * torch.sin(1.7 * omega * t + 0.5)))


def _slosh(n, amp, omega, like=None):
    """tests/test_dym.py's sloshing faces, in jnp (like None) or torch."""
    x0 = np.linspace(0.0, 1.0, n + 1)
    if like is None:
        return lambda t: (x0 + amp * jnp.sin(omega * t) * jnp.sin(np.pi * x0)
                          + 0.05 * jnp.sin(1.7 * omega * t) * x0 * (1 - x0))
    x0 = torch.as_tensor(x0, dtype=like.dtype, device=like.device)
    return lambda t: (x0 + amp * torch.sin(omega * t)
                      * torch.sin(np.pi * x0)
                      + 0.05 * torch.sin(1.7 * omega * t) * x0 * (1 - x0))


def _case(name):
    """(JAX solver, JAX State, torch motion fields, steps) of a parity
    case."""
    zg = jbc.FieldBCs.uniform(jbc.ZeroGradient(), 2)
    if name == "dilation":
        js, over = _oscillating()
        return js, js.init(jnp.zeros((2, 16, 16)), _blob(js.mesh)), over, 4
    if name == "dilation_rigid_courant":
        js, over = _oscillating()
        js = dataclasses.replace(
            js, mesh_velocity=lambda t: (0.05, -0.02),
            check_mesh_courant=True,
            time=jcommon.TimeControls(max_co=0.3, max_dt=5e-3, dt0=1e-3))
        over["mesh_velocity"] = lambda t: (0.05, -0.02)
        return js, js.init(jnp.zeros((2, 16, 16)), _blob(js.mesh)), over, 4
    if name == "scaled_periodic":
        # tests/test_dym.py's decay-rate grid: s = 1.6, periodic
        mesh = JMesh.uniform((16, 16), lengths=(2 * np.pi, 2 * np.pi),
                             dtype=X64)
        per = jbc.FieldBCs.uniform(jbc.Periodic(), 2)
        js = JQHDDyMFoam(
            mesh_scale=lambda t: (1.6, 1.6), mesh=mesh,
            thermo=_thermo(0.05), tau_model=JConstTau(tau0=1e-5),
            bc_U=per, bc_T=per, bc_p=per,
            time=jcommon.TimeControls(adjust_time_step=False, dt0=2e-3))
        X = np.asarray(mesh.centers[0])[:, None] * np.ones((16, 16))
        return (js, js.init(jnp.zeros((2, 16, 16)), jnp.asarray(np.sin(X))),
                dict(mesh_scale=lambda t: (1.6, 1.6)), 3)
    if name == "slosh_courant":
        mesh = JMesh.uniform((16, 16), dtype=X64)
        fx, fy = _slosh(16, 0.08, 3.0), _slosh(16, 0.06, 4.1)
        js = JQHDDyMFoam(
            mesh_faces=lambda t: (fx(t), fy(t)), check_mesh_courant=True,
            mesh=mesh, thermo=_thermo(), tau_model=JConstTau(tau0=1e-4),
            bc_U=zg, bc_T=zg, bc_p=zg,
            time=jcommon.TimeControls(max_co=0.3, max_dt=5e-3, dt0=1e-3),
            cg_tol=1e-12)
        like = torch.zeros((), dtype=F64)
        tx, ty = _slosh(16, 0.08, 3.0, like), _slosh(16, 0.06, 4.1, like)
        return (js, js.init(jnp.zeros((2, 16, 16)), _blob(mesh, 0.45, 0.55)),
                dict(mesh_faces=lambda t: (tx(t), ty(t))), 4)
    if name == "piston":
        js, over = _piston_pair()
        return js, js.init(jnp.zeros((2, 32, 8)), jnp.zeros((32, 8))), \
            over, 4
    if name == "galilean":
        js, over = _galilean_pair()
        return js, _galilean_state(js, jnp), over, 3
    if name == "rigid_courant":
        mesh = JMesh.uniform((16, 16), dtype=X64)
        js = JQHDDyMFoam(
            mesh_velocity=lambda t: jnp.asarray([50.0, 0.0]),
            check_mesh_courant=True, mesh=mesh,
            thermo=JRhoConst(rho0=1.0, Cp=1000.0, mu0=1e-5, Pr=1.0,
                             beta=0.0),
            tau_model=JConstTau(tau0=1e-4), implicit_diffusion=False,
            time=jcommon.TimeControls(max_co=0.5, max_dt=1.0, dt0=1e-4))
        return (js, js.init(jnp.zeros((2, 16, 16)), _blob(mesh)),
                dict(mesh_velocity=lambda t: (50.0, 0.0)), 3)
    raise KeyError(name)


def _piston_pair(n=32):
    """tests/test_dym.py's piston channel: (JAX solver, torch
    mesh_faces)."""
    mesh = JMesh.uniform((n, 8), lengths=(1.0, 0.25), dtype=X64)
    x0 = np.linspace(0.0, 1.0, n + 1)
    y0 = np.linspace(0.0, 0.25, 9)
    v_p = 0.2

    def faces(t):
        left = v_p * t
        return (left + (1.0 - left) * x0, jnp.asarray(y0) + 0.0 * t)

    zg, slip = jbc.ZeroGradient(), jbc.Symmetry()
    js = JQHDDyMFoam(
        mesh_faces=faces, mesh=mesh, thermo=_thermo(1e-4),
        tau_model=JConstTau(tau0=2e-3),
        bc_U=jbc.FieldBCs(((jbc.FixedValue(jnp.asarray([v_p, 0.0])), zg),
                           (slip, slip))),
        bc_T=jbc.FieldBCs.uniform(zg, 2),
        bc_p=jbc.FieldBCs(((zg, jbc.FixedValue(0.0)), (zg, zg))),
        time=jcommon.TimeControls(max_co=0.3, max_dt=2e-3, dt0=1e-4),
        cg_tol=1e-12)
    tx0, ty0 = torch.as_tensor(x0), torch.as_tensor(y0)

    def tfaces(t):
        left = v_p * t
        return (left + (1.0 - left) * tx0, ty0)

    return js, dict(mesh_faces=tfaces)


def _galilean_pair():
    """tests/test_solver_variants.py's co-moving frame: (JAX solver, torch
    mesh_velocity)."""
    mesh = JMesh.uniform((32, 8), lengths=(1.0, 0.25), dtype=X64)
    per = jbc.FieldBCs.uniform(jbc.Periodic(), 2)
    js = JQHDDyMFoam(
        mesh_velocity=lambda t: jnp.asarray([1.0, 0.0]), mesh=mesh,
        thermo=JRhoConst(rho0=1.0, Cp=1000.0, mu0=1e-5, Pr=1.0, beta=0.0),
        tau_model=JHbyUQHD(alpha=0.2, U0=1.0), g=(0.0, 0.0),
        bc_U=per, bc_T=per, bc_p=per,
        time=jcommon.TimeControls(max_co=0.3, max_dt=5e-3, dt0=1e-3))
    return js, dict(mesh_velocity=lambda t: (1.0, 0.0))


def _galilean_state(solver, xp):
    x = np.asarray(solver.mesh.centers[0])[:, None] * np.ones((32, 8))
    T0 = np.exp(-((x - 0.5) / 0.1) ** 2)
    U0 = np.stack([np.ones((32, 8)), np.zeros((32, 8))])
    if xp is jnp:
        return solver.init(jnp.asarray(U0), jnp.asarray(T0))
    return solver.init(torch.as_tensor(U0), torch.as_tensor(T0))


@pytest.mark.parametrize("name", ["dilation", "dilation_rigid_courant",
                                  "scaled_periodic", "slosh_courant",
                                  "piston", "galilean", "rigid_courant"])
def test_motion_matches_jax(name, monkeypatch):
    """Each motion class against the JAX package, window by window: the
    oscillating dilation (also with a rigid velocity and the mesh Courant
    cap), a statically scaled periodic grid, sloshing general face motion
    with the cap, the piston channel's moving wall with adaptive dt, the
    co-moving frame, and a fast rigid mesh under the cap."""
    js, jst, over, n = _case(name)
    states, _, log = run_both(js, jst, n, 2 * js.cg_tol, monkeypatch,
                              floors={"p": 1e-3, "U": 1e-3}, over=over)
    assert float(states[-1].t) > float(states[0].t)
    # a pressure solve a step (a FixedValue p side makes it nonsingular)
    assert sum(k != "U" for k, _ in log) >= n


# ---------------------------------------------------------------------------
# oracles on the port (tests/test_dym.py, tests/test_solver_variants.py)
# ---------------------------------------------------------------------------


def _port(js, over):
    from qgdsolver_tpu_torch import interop

    return interop.solver_from(js, dtype=F64, **over)


def test_gcl_uniform_field_preserved():
    """A uniform T and U on the oscillating-compression grid stay uniform
    over 200 steps (the mesh fluxes telescope to (V' - V)/dt per cell, the
    moving-volume ddt cancels them)."""
    js, over = _oscillating(n=24)
    solver = _port(js, over)
    s = solver.init(torch.stack([torch.full((24, 24), 0.8, dtype=F64),
                                 torch.full((24, 24), -0.3, dtype=F64)]),
                    torch.full((24, 24), 3.7, dtype=F64))
    s = common.run_steps(solver.make_step(), s, 200)
    np.testing.assert_allclose(s.T.numpy(), 3.7, rtol=1e-9)
    np.testing.assert_allclose(s.U[0].numpy(), 0.8, atol=1e-8)
    np.testing.assert_allclose(s.U[1].numpy(), -0.3, atol=1e-8)
    assert float(s.t) > 0.9


def test_deforming_diffusion_decay_rate():
    """Diffusion of a Fourier mode on a statically scaled grid (s = 1.6)
    decays at the physical rate nu*(k/s)^2: the metric factors rescale
    the operators."""
    n, s_, nu = 32, 1.6, 0.05
    mesh = Mesh.uniform((n, n), lengths=(2 * np.pi, 2 * np.pi),
                        dtype=F64)
    per = bc.FieldBCs.uniform(bc.Periodic(), 2)
    solver = QHDDyMFoam(
        mesh_scale=lambda t: (s_, s_), mesh=mesh,
        thermo=RhoConstThermo(rho0=1.0, Cp=1000.0, mu0=nu, Pr=1.0),
        tau_model=ConstTau(tau0=1e-5), bc_U=per, bc_T=per, bc_p=per,
        time=common.TimeControls(adjust_time_step=False, dt0=2e-3))
    X = mesh.centers[0][:, None] * np.ones((n, n))
    st = solver.init(torch.zeros((2, n, n), dtype=F64),
                     torch.as_tensor(np.sin(X)))
    out = common.run_steps(solver.make_step(), st, 500)
    amp = float(out.T.abs().max())
    amp_exp = math.exp(-nu / s_ ** 2 * 1.0)
    assert abs(amp - amp_exp) / amp_exp < 0.02, (amp, amp_exp)


def test_general_motion_gcl_uniform_preserved():
    """A uniform field on a sloshing grid (general per-axis face motion)
    stays uniform: the Thomas-Lombard sweeps and the volume ratio are the
    discrete GCL."""
    like = torch.zeros((), dtype=F64)
    fx, fy = _slosh(24, 0.08, 3.0, like), _slosh(24, 0.06, 4.1, like)
    zg = bc.FieldBCs.uniform(bc.ZeroGradient(), 2)
    solver = QHDDyMFoam(
        mesh_faces=lambda t: (fx(t), fy(t)),
        mesh=Mesh.uniform((24, 24), dtype=F64),
        thermo=RhoConstThermo(rho0=1.0, Cp=1000.0, mu0=1e-3, Pr=1.0),
        tau_model=ConstTau(tau0=1e-4), bc_U=zg, bc_T=zg, bc_p=zg,
        time=common.TimeControls(adjust_time_step=False, dt0=5e-3),
        cg_tol=1e-12)
    s = solver.init(torch.full((2, 24, 24), 0.35, dtype=F64),
                    torch.full((24, 24), 7.25, dtype=F64))
    s = common.run_steps(solver.make_step(), s, 40)
    np.testing.assert_allclose(s.T.numpy(), 7.25, rtol=1e-9)
    np.testing.assert_allclose(s.U.numpy(), 0.35, rtol=1e-7)


def test_general_motion_reduces_to_dilation():
    """mesh_faces = s(t)*x0 agrees with the mesh_scale path to O(dt)."""
    n = 20
    x0 = torch.linspace(0.0, 1.0, n + 1, dtype=F64)

    def sx(t):
        return 1.0 + 0.1 * torch.sin(3.0 * t)

    def sy(t):
        return 1.0 + 0.07 * torch.sin(5.0 * t + 0.3)

    zg = bc.FieldBCs.uniform(bc.ZeroGradient(), 2)
    mesh = Mesh.uniform((n, n), dtype=F64)
    kw = dict(mesh=mesh,
              thermo=RhoConstThermo(rho0=1.0, Cp=1000.0, mu0=1e-3, Pr=1.0),
              tau_model=ConstTau(tau0=1e-4), bc_U=zg, bc_T=zg, bc_p=zg,
              time=common.TimeControls(adjust_time_step=False, dt0=2e-3),
              cg_tol=1e-12)
    s_dil = QHDDyMFoam(mesh_scale=lambda t: (sx(t), sy(t)), **kw)
    s_gen = QHDDyMFoam(mesh_faces=lambda t: (sx(t) * x0, sy(t) * x0), **kw)
    x = mesh.centers[0][:, None] * np.ones((n, n))
    y = mesh.centers[1][None, :] * np.ones((n, n))
    T0 = torch.as_tensor(np.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.04))
    U0 = torch.zeros((2, n, n), dtype=F64)
    st_d = common.run_steps(s_dil.make_step(), s_dil.init(U0, T0), 25)
    st_g = common.run_steps(s_gen.make_step(), s_gen.init(U0, T0), 25)
    np.testing.assert_allclose(float(st_g.t), float(st_d.t), rtol=1e-12)
    np.testing.assert_allclose(st_g.T.numpy(), st_d.T.numpy(), rtol=0.0,
                               atol=2e-3)
    assert float(st_d.T.abs().max()) > 0.1


def test_general_motion_piston_channel_physics():
    """A piston wall advancing into a channel pushes the incompressible
    fluid out at the piston speed."""
    js, over = _piston_pair()
    solver = _port(js, over)
    s = solver.init(torch.zeros((2, 32, 8), dtype=F64),
                    torch.zeros((32, 8), dtype=F64))
    s = common.run_steps(solver.make_step(), s, 150)
    U = s.U.numpy()
    assert np.isfinite(U).all()
    np.testing.assert_allclose(U[0, -1, :].mean(), 0.2, rtol=0.05)


def test_qhd_dym_galilean_invariance():
    """Advecting the frame at the flow speed makes the solution stationary
    in mesh coordinates (makeRelative)."""
    js, over = _galilean_pair()
    solver = _port(js, over)
    s = common.run_steps(solver.make_step(),
                         _galilean_state(solver, torch), 40)
    i0 = int(np.argmax(s.T.numpy()[:, 4]))
    assert abs(solver.mesh.centers[0][i0] - 0.5) < 0.05
    assert bool(torch.isfinite(s.U).all())


def test_qhd_dym_mesh_courant_cap():
    """check_mesh_courant folds |U_mesh|*dt/h into the dt controller."""
    js, jst, over, _ = _case("rigid_courant")
    solver = _port(js, over)
    st = solver.init(torch.zeros((2, 16, 16), dtype=F64),
                     torch.full((16, 16), 300.0, dtype=F64))
    a = solver.make_step()(st)
    b = dataclasses.replace(solver, check_mesh_courant=True).make_step()(st)
    c = dataclasses.replace(solver,
                            check_mesh_courant=False).make_step()(st)
    assert float(b.dt) <= float(c.dt) and float(a.dt) == float(b.dt)
    assert float(b.dt) * 50.0 / (1.0 / 16.0) < 0.5 * 1.3


def test_refusals_match_jax():
    """mesh_faces with mesh_velocity/mesh_scale, the MULES T equation on a
    deforming mesh, a moving solid-masked mesh and general motion on a
    wedge are refused."""
    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.core.mesh import AxisymmetricMesh

    solver, _ = cases.buoyant_cavity((8, 8), dtype=F64, device="cpu")
    faces = dict(mesh_faces=lambda t: solver.mesh.x_faces)
    with pytest.raises(ValueError, match="general motion"):
        dataclasses.replace(solver, mesh_velocity=lambda t: (0.0, 0.0),
                            **faces).make_step()
    for over in (dict(mesh_scale=lambda t: (1.0, 1.0)), faces):
        with pytest.raises(NotImplementedError, match="mules"):
            dataclasses.replace(solver, t_equation="mules",
                                **over).make_step()
    solid = np.zeros((8, 8), dtype=bool)
    solid[:2, :2] = True
    masked = dataclasses.replace(
        solver, mesh=Mesh(x_faces=solver.mesh.x_faces, dtype=F64,
                          solid=solid),
        mesh_velocity=lambda t: (0.0, 0.0))
    with pytest.raises(NotImplementedError, match="solid"):
        masked.make_step()
    wedge = dataclasses.replace(
        solver, mesh=AxisymmetricMesh(x_faces=solver.mesh.x_faces,
                                      dtype=F64), **faces)
    with pytest.raises(NotImplementedError, match="wedge"):
        wedge.make_step()
    with pytest.raises(ValueError):
        QHDDyMFoam(mesh=solver.mesh, thermo=solver.thermo)


def test_moving_step_reads_nothing_but_the_cg_stop_tests(monkeypatch):
    """A step on a dilating and on a general-motion mesh hands its motion
    callables a 0-dim tensor t and reads nothing back to the host but the
    CG's stop tests (`linsolve.cg.reads`)."""
    reads = {"bool": 0, "other": 0}
    orig_bool = torch.Tensor.__bool__

    def counted_bool(self):
        reads["bool"] += 1
        return orig_bool(self)

    def refused(name):
        def f(self, *a, **k):
            reads["other"] += 1
            raise AssertionError(f"host read {name}")
        return f

    seen = []
    like = torch.zeros((), dtype=F64)
    fx = _slosh(16, 0.08, 3.0, like)
    js, over = _oscillating()
    solvers = [_port(js, over)]
    solvers.append(dataclasses.replace(
        solvers[0], mesh_scale=None, check_mesh_courant=True,
        time=common.TimeControls(max_co=0.3, max_dt=5e-3, dt0=1e-3),
        mesh_faces=lambda t: (seen.append(t) or fx(t), fx(t))))
    for solver in solvers:
        st = solver.init(torch.zeros((2, 16, 16), dtype=F64),
                         torch.as_tensor(np.array(_blob(js.mesh))))
        step = solver.make_step()
        linsolve.reset_counts()
        monkeypatch.setattr(torch.Tensor, "__bool__", counted_bool)
        for name in ("item", "__float__", "__int__", "tolist", "numpy",
                     "cpu", "__index__"):
            monkeypatch.setattr(torch.Tensor, name, refused(name))
        reads["bool"] = 0
        st = step(step(st))
        monkeypatch.undo()
        assert reads == {"bool": linsolve.cg.reads, "other": 0}
        assert linsolve.cg.solves == 6
    assert seen and all(torch.is_tensor(t) and t.ndim == 0 for t in seen)


# ---------------------------------------------------------------------------
# case directories (tests/test_foam_case_e2e.py) and the CLI
# ---------------------------------------------------------------------------


def _dym_copy(tmp_path, dict_text=None):
    case = tmp_path / "dym"
    shutil.copytree(os.path.join(FIX, "dym_case"), case)
    if dict_text is not None:
        (case / "constant" / "dynamicMeshDict").write_text(dict_text)
    return case


_OSC = ("FoamFile { version 2.0; format ascii; class dictionary; "
        "object dynamicMeshDict; }\n"
        "dynamicFvMesh dynamicMotionSolverFvMesh;\n"
        "motionSolver oscillatingLinearMotion;\n"
        "oscillatingLinearMotionCoeffs { amplitude (0.02 0 0); "
        "omega 6.2832; }\n"
        "checkMeshCourantNo yes;\n")


@pytest.mark.parametrize("motion", ["uniformDilation",
                                    "oscillatingLinearMotion"])
def test_build_case_qhd_dym_matches_jax(motion, tmp_path, monkeypatch):
    """A dynamicMeshDict's motion (uniformDilation -> mesh_scale,
    oscillatingLinearMotion -> mesh_velocity = A*w*cos(w*t)) with
    checkMeshCourantNo builds torch callables equal to the JAX package's
    and runs 3 steps held to it."""
    case = _dym_copy(tmp_path, _OSC if motion != "uniformDilation"
                     else None)
    solver, state = foam_case.build_case(str(case), device="cpu")
    js, jst = jfoam_case.build_case(str(case))
    # the JAX package reads the mesh in float32: compare in float64
    js = dataclasses.replace(js, mesh=JMesh(x_faces=js.mesh.x_faces,
                                            dtype=X64))
    assert solver.check_mesh_courant and solver.implicit_diffusion
    assert solver.mesh.dtype == torch.float64
    if motion == "uniformDilation":
        scale = solver.mesh_scale(torch.tensor(2.0, dtype=F64))
        np.testing.assert_allclose([float(v) for v in scale], (1.1, 1.0))
        over = dict(mesh_scale=solver.mesh_scale)
    else:
        v0 = solver.mesh_velocity(torch.tensor(0.0, dtype=F64))
        np.testing.assert_allclose(float(v0[0]), 0.02 * 6.2832, rtol=1e-6)
        vq = solver.mesh_velocity(torch.tensor(np.pi / 6.2832, dtype=F64))
        np.testing.assert_allclose(float(vq[0]), -0.02 * 6.2832, rtol=1e-5)
        over = dict(mesh_velocity=solver.mesh_velocity)
    states, _, _ = run_both(js, jst, 3, 2 * js.cg_tol, monkeypatch,
                            floors={"p": 1e-3, "U": 1e-3}, over=over)
    assert np.isfinite(np.asarray(states[-1].T)).all()


def test_cli_runs_writes_and_resumes_dym_case(tmp_path):
    """The CLI runs the QHDDyMFoam case (a 0/p added for the write),
    writes U, T and p, and a resume from the written time reads them
    back."""
    case = _dym_copy(tmp_path)
    (case / "0" / "p").write_text(
        "FoamFile { version 2.0; format ascii; class volScalarField; "
        "object p; }\ndimensions [0 2 -2 0 0 0 0];\n"
        "internalField uniform 0;\nboundaryField { left { type "
        "zeroGradient; } right { type zeroGradient; } bottom { type "
        "zeroGradient; } top { type zeroGradient; } frontAndBack { type "
        "empty; } }\n")
    logs = []
    assert cli.run_case(str(case), max_steps=5, device="cpu",
                        log=logs.append) == 5
    assert any("composable step engaged: make_step" in ln for ln in logs)
    tdir = [ln for ln in logs if ln.startswith("End.")][0].split()[-1]
    assert sorted(os.listdir(tdir)) == ["T", "U", "p"]
    ctrl = (case / "system" / "controlDict").read_text().replace(
        "startFrom       startTime;", "startFrom       latestTime;")
    (case / "system" / "controlDict").write_text(ctrl)
    solver, state = foam_case.build_case(str(case), device="cpu")
    assert solver.mesh_scale is not None
    np.testing.assert_allclose(float(state.t), 0.005, rtol=1e-9)
    assert float(state.T.max()) > 300.0
