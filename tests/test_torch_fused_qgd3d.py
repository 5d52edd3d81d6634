"""The port's fused 3D step (ops.fused_qgd3d) against the JAX package.

On the CPU the kernel wrappers run their plain torch versions, so these
tests check the plain versions, the gate, the BC compiler and the State
conversions; the CUDA kernels are held against the same plain versions on
the card (tests/test_torch_gpu.py, chip_smoke.py).  The JAX fused 3D step
runs in interpret mode, as tests/test_fused_qgd3d.py runs it.  Bounds are
the JAX 3D fused tests' own: dt rtol 1e-6, rho/rhoU/rhoE/sc within 2e-5 of
their max over 10 steps, pbc within quant + 2e-3*scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgdsolver_tpu import cases as jcases
from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.ops import fused_qgd3d as JF
from qgdsolver_tpu.ops.pad import ghost_pad as j_ghost_pad
from qgdsolver_tpu.physics import qgdcoeffs as jcoeffs
from qgdsolver_tpu.physics import thermo as jthermo
from qgdsolver_tpu_torch import cases as tcases
from qgdsolver_tpu_torch import interop
from qgdsolver_tpu_torch.core import bc as tbc
from qgdsolver_tpu_torch.ops import fused_common as FC
from qgdsolver_tpu_torch.ops import fused_qgd3d as F
from qgdsolver_tpu_torch.ops import smoothing as S
from qgdsolver_tpu_torch.physics import qgdcoeffs as tcoeffs
from qgdsolver_tpu_torch.physics import thermo as tthermo

SHAPE = (8, 6, 6)
CASES = ["supersonic_duct_3d", "supersonic_jet_3d_varsc"]
C = (slice(1, -1),) * 3


def _flagship(pkg_cases, shape, dtype, xp, **device):
    """The varsc jet with the jet reaching the outlet and a pressure bump
    near it, so the qgdFlux dp/dn signal is far above f32 ulp(p) (mirrors
    tests/test_fused_qgd3d.py::_flagship_case)."""
    solver, _ = pkg_cases.supersonic_jet_3d_varsc(shape=shape, dtype=dtype,
                                                  **device)
    mesh = solver.mesh
    xc = np.asarray(mesh.centers[0])[:, None, None]
    yc = np.asarray(mesh.centers[1])[None, :, None]
    zc = np.asarray(mesh.centers[2])[None, None, :]
    rr = np.sqrt((yc - 1.0) ** 2 + (zc - 1.0) ** 2)
    prof = 0.5 * (np.tanh((0.3 - rr) / (3.0 * float(mesh.dx[1][0]))) + 1.0)
    u_jet = 2.0 * float(np.sqrt(solver.thermo.gamma * solver.thermo.R
                                * 300.0))
    p0 = 1e5 * (1.0 + 0.3 * np.exp(-((xc - 3.4) ** 2 + rr ** 2) / 0.3)) \
        * np.ones(mesh.shape)
    U0 = np.zeros((3,) + mesh.shape)
    U0[0] = u_jet * prof * np.exp(-(4.0 - xc) / 2.0)
    state = solver.init(p0=xp(p0.astype(np.float32)),
                        T0=xp(np.full(mesh.shape, 300.0, np.float32)),
                        U0=xp(U0.astype(np.float32)),
                        sc0=xp(np.full(mesh.shape, 0.05, np.float32)))
    return solver, state


def _bumped(state, mesh):
    """A density jump across x (as chip_smoke.with_bump), so that the
    sensor is active past its first smoothing ring."""
    x = np.asarray(mesh.centers[0])
    bump = 1.0 + 0.4 * (np.abs(x - x[len(x) // 2]) < 0.1)
    bump = jnp.asarray(bump.reshape(-1, 1, 1).astype(np.float32))
    return state._replace(rho=state.rho * bump, rhoE=state.rhoE * bump)


def _build(name, shape=SHAPE):
    """(jax solver, jax f32 state, port solver, port state from the JAX
    one)."""
    if name == "flagship_bump":
        js, jst, ts, _ = _build("flagship", shape)
        jst = _bumped(jst, js.mesh)
    elif name == "flagship":
        js, jst = _flagship(jcases, shape, np.float32, jnp.asarray)
        ts, _ = _flagship(tcases, shape, torch.float32, torch.as_tensor,
                          device="cpu")
    else:
        js, jst = getattr(jcases, name)(shape=shape, dtype=np.float32)
        ts, _ = getattr(tcases, name)(shape=shape, dtype=torch.float32,
                                      device="cpu")
    st = interop.state_from_numpy(jax.tree.map(np.asarray, jst),
                                  dtype=torch.float32)
    return js, jst, ts, st


def _f64(x):
    return np.asarray(x, dtype=np.float64)


def _rel(a, b):
    a = _f64(a)
    return np.max(np.abs(a - _f64(b))) / max(np.max(np.abs(a)), 1e-30)


@pytest.mark.parametrize("name", CASES)
def test_case_builders_match_jax(name):
    """Both packages build the same initial State, bit for bit, in f64."""
    _, js = getattr(jcases, name)(shape=SHAPE, dtype=np.float64)
    _, ts = getattr(tcases, name)(shape=SHAPE, dtype=torch.float64,
                                  device="cpu")
    out = interop.state_to_numpy(ts)
    for f in ("rho", "rhoU", "rhoE", "sc", "t", "dt"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(out, f), err_msg=f)


class _OtherTransport(tthermo.Transport):
    pass


def _variant(kind, pkg, cases_mod, bcm, coeffs, thermo, xp, **device):
    """A 3D config per gate case, built the same way in either package."""
    nx, ny, nz = SHAPE
    if kind in ("duct", "model1n", "model2", "transport", "y_array",
                "y_qgdflux"):
        solver, _ = cases_mod.supersonic_duct_3d(shape=SHAPE, **device)
    else:
        solver, _ = cases_mod.supersonic_jet_3d_varsc(shape=SHAPE, **device)
    if kind in ("model1n", "model2"):
        cls = (coeffs.ConstScPrModel1n if kind == "model1n"
               else coeffs.ConstScPrModel2)
        return dataclasses.replace(solver, tau_model=cls(alpha=0.5, Sc=1.0,
                                                         Pr=1.0))
    if kind == "cell_cqsc":
        tm = dataclasses.replace(solver.tau_model,
                                 cqSc=xp(np.full(SHAPE, 0.1)))
        return dataclasses.replace(solver, tau_model=tm)
    if kind == "transport":
        tr = (jthermo.SutherlandTransport(As=1.458e-6, Ts=110.4)
              if pkg == "jax"
              else _OtherTransport())
        return dataclasses.replace(
            solver, thermo=dataclasses.replace(solver.thermo, transport=tr))
    if kind == "y_array":
        bc_p = solver.bc_p.replace(
            1, 0, bcm.FixedValue(xp(np.full((nx, 1, nz), 1e5))))
        return dataclasses.replace(solver, bc_p=bc_p)
    if kind == "y_qgdflux":
        return dataclasses.replace(solver,
                                   bc_p=solver.bc_p.replace(1, 1,
                                                            bcm.QGDFluxP()))
    return solver


GATE = {"duct": True, "varsc_jet": True, "model1n": True, "model2": True,
        "cell_cqsc": False, "transport": False, "y_array": False,
        "y_qgdflux": False}


@pytest.mark.parametrize("kind", list(GATE))
def test_gate_agrees_with_jax(kind):
    js = _variant(kind, "jax", jcases, jbc, jcoeffs, jthermo, jnp.asarray)
    ts = _variant(kind, "torch", tcases, tbc, tcoeffs, tthermo,
                  torch.as_tensor, device="cpu")
    assert JF.supported(js) == GATE[kind]
    assert F.supported(ts) == GATE[kind]
    assert ts.fused_supported() == GATE[kind]
    if not GATE[kind]:
        with pytest.raises(ValueError):
            F.build_fused_step_3d(ts)


def test_gate_rejects_time_dependent_inlet():
    ts, _ = tcases.supersonic_duct_3d(shape=SHAPE, device="cpu")

    def pulsed(t, coords):
        yy = coords[1]
        return torch.stack(torch.broadcast_tensors(
            (300.0 + 10.0 * t) * torch.ones_like(yy), torch.zeros_like(yy),
            torch.zeros_like(yy)))

    static = dataclasses.replace(
        ts, bc_U=ts.bc_U.replace(0, 0, tbc.FixedValue(
            lambda t, c: pulsed(0.0, c))))
    assert F.supported(static)
    moving = dataclasses.replace(
        ts, bc_U=ts.bc_U.replace(0, 0, tbc.FixedValue(pulsed)))
    assert not F.supported(moving)


@pytest.mark.parametrize("name", CASES)
def test_roundtrip_state(name):
    ts, s = getattr(tcases, name)(shape=SHAPE, device="cpu")
    s = ts.make_step()(s)  # populate sc and pbc
    _, to_f, from_f = ts.make_fused_step()
    fs = to_f(s)
    s2 = from_f(fs)
    for f in ("rho", "rhoU", "rhoE", "sc"):
        torch.testing.assert_close(getattr(s2, f), getattr(s, f),
                                   rtol=1e-6, atol=0.0)
    assert s2.t is s.t and s2.dt is s.dt
    assert len(s2.pbc) == len(s.pbc)
    dx = float(ts.mesh.dx[0][0])
    quant = 4.0 * np.float32(1e5) * np.finfo(np.float32).eps / dx
    for ga, gb in zip(s.pbc, s2.pbc):
        torch.testing.assert_close(gb, ga, rtol=0.0, atol=quant)
    if F.make_params(ts)[0].varsc:
        assert fs.sc_s1.shape == fs.p.shape and fs.sc.shape == fs.p.shape
        assert fs.sc_chg.shape == () and fs.sc_raw is None


@pytest.mark.parametrize("name", ["supersonic_duct_3d", "flagship",
                                  "flagship_bump"])
def test_fused_step_matches_jax_fused_and_composable(name):
    """10 steps of the port's fused 3D step (the plain versions, on the CPU)
    against the JAX fused 3D kernel and the JAX composable step; with a
    density bump the smoothing continues past the emitted first ring.
    There the qgdFlux gradients are held to the composable step's: the JAX
    fused kernel's own stand 0.16 from its composable step's, most of the
    f32 quantization bound (~0.27)."""
    js, jst, ts, st = _build(name)
    fixed = F.qgd3d_smooth.fixed
    assert JF.supported(js) and F.supported(ts) and ts.fused_supported()
    jstep, jto, jfrom = JF.build_fused_step_3d(js, interpret=True)
    jstep = jax.jit(jstep)
    cstep = jax.jit(js.make_step())
    tstep, tto, tfrom = ts.make_fused_step()
    jfs, tfs, cs = jto(jst), tto(st), jst
    for _ in range(10):
        jfs, tfs, cs = jstep(jfs), tstep(tfs), cstep(cs)
    out = interop.state_to_numpy(tfrom(tfs))
    assert _rel(jst.rho, out.rho) > 1e-6, "the state must evolve"
    if name == "flagship_bump":
        assert F.qgd3d_smooth.fixed > fixed, "the smoothing must continue"
    for ref in (jfrom(jfs), cs):
        with_pbc = name != "flagship_bump" or ref is cs
        np.testing.assert_allclose(out.dt, _f64(ref.dt), rtol=1e-6)
        np.testing.assert_allclose(out.t, _f64(ref.t), rtol=1e-6)
        for f in ("rho", "rhoU", "rhoE", "sc"):
            assert _rel(getattr(ref, f), getattr(out, f)) < 2e-5, f
        assert len(ref.pbc) == len(out.pbc)
        quant = 8.0 * np.float32(1e5) * np.finfo(np.float32).eps / 0.5
        for ga, gb in zip(ref.pbc if with_pbc else (), out.pbc):
            scale = np.abs(_f64(ga)).max()
            if name.startswith("flagship"):
                assert scale > 50.0 * quant, "qgdFlux signal too small"
            np.testing.assert_allclose(gb, _f64(ga),
                                       atol=quant + 2e-3 * scale)


def test_every_bc_kind_matches_jax_composable():
    """Every BC kind the 3D kernels take, with a random velocity kick: 10
    steps of the port's fused 3D step against the JAX composable step.
    (The JAX fused 3D kernel itself drifts ~1e-4 of max rhoU from its
    composable step on this config: where a y side and a z side both carry
    inletOutlet on U, ROADMAP queue 3.  The port follows the composable.)"""
    from test_torch_gpu import every_bc_kind_3d

    js, jst = every_bc_kind_3d(jcases, jbc, SHAPE, np.float32, jnp.asarray)
    ts, _ = every_bc_kind_3d(tcases, tbc, SHAPE, torch.float32,
                             torch.as_tensor, device="cpu")
    assert JF.supported(js) and F.supported(ts)
    # the inlet velocity (3 planes) and the p gradient on x-low
    assert F.make_params(ts)[1].shape == (4,) + SHAPE[1:]
    rng = np.random.default_rng(0)
    kick = (20.0 * rng.standard_normal(jst.rhoU.shape)).astype(np.float32)
    jst = jst._replace(rhoU=jst.rhoU + kick * jst.rho[None])
    st = interop.state_from_numpy(jax.tree.map(np.asarray, jst),
                                  dtype=torch.float32)
    cstep = jax.jit(js.make_step())
    tstep, tto, tfrom = ts.make_fused_step()
    cs, tfs = jst, tto(st)
    for _ in range(10):
        cs, tfs = cstep(cs), tstep(tfs)
    out = interop.state_to_numpy(tfrom(tfs))
    np.testing.assert_allclose(out.dt, _f64(cs.dt), rtol=1e-6)
    for f in ("rho", "rhoU", "rhoE", "sc"):
        assert _rel(getattr(cs, f), getattr(out, f)) < 2e-5, f
    quant = 8.0 * np.float32(1e5) * np.finfo(np.float32).eps / 0.5
    for ga, gb in zip(cs.pbc, out.pbc):
        scale = np.abs(_f64(ga)).max()
        np.testing.assert_allclose(gb, _f64(ga), atol=quant + 2e-3 * scale)


@pytest.mark.parametrize("shape", [(7, 5, 6), (3, 9, 4)])
def test_face_tangential_difference_is_mean_of_cell_differences(shape):
    """The tangential difference update_reference_3d takes at a face, the
    central difference of the neighbouring faces' values (xi(Ap, Bp) -
    xi(Am, Bm)) / 2d, equals in exact arithmetic the mean of the central
    differences of the face's two cells, ghost planes, ghost rows and
    lanes, edges and corners included: checked in float64 within 1e-12 on
    the frames of every BC kind with a random velocity kick.  In float32
    the two forms round differently (on the duct the transverse velocities
    move by ~1e-4 of their max), so the CUDA update takes the reference's
    form: each face's values are published once and its tangential
    gradients are differences of its neighbours' values."""
    from test_torch_gpu import every_bc_kind_3d

    solver, state = every_bc_kind_3d(tcases, tbc, shape, torch.float32,
                                     torch.as_tensor, device="cpu")
    rng = np.random.default_rng(1)
    kick = torch.as_tensor(
        (20.0 * rng.standard_normal(state.rhoU.shape)).astype(np.float32))
    state = state._replace(rhoU=state.rhoU + kick * state.rho)
    _, to_f, _ = F.build_fused_step_3d(solver, plain=True)
    fs = to_f(state)  # the frames with every ghost filled by its BC
    prm, _ = F.make_params(solver)
    assert fs.p.shape == tuple(n + 2 for n in shape)
    p, T = fs.p.double(), fs.T.double()
    cells = {"p": p, "rho": p / (prm.R * T), "e": prm.Cv * T,
             "ux": fs.ux.double(), "uy": fs.uy.double(),
             "uz": fs.uz.double()}
    for name, x in cells.items():
        for a in range(3):
            for b in range(3):
                if b == a:
                    continue
                c = 3 - a - b
                faces = F._tan(F._aint(x, a), a, b, prm)
                h = prm.inv_2d[b]
                cd = (F._sl(x, b, slice(2, None))
                      - F._sl(x, b, slice(None, -2))) * h
                mean = F._sl(F._aint(cd, a), c, slice(1, -1))
                assert faces.shape == mean.shape
                scale = float(x.abs().max()) * h
                if name.startswith("u"):  # the kick: no vacuous check
                    assert float(faces.abs().max()) > 1e-3 * scale
                err = float((faces - mean).abs().max())
                assert err <= 1e-12 * scale, (name, a, b, err / scale)


def _one_jax_step(name):
    js, jst, ts, st = _build(name)
    return js, jst, jax.jit(js.make_step())(jst), ts, st


@pytest.mark.parametrize("name", ["supersonic_duct_3d", "flagship"])
def test_dt_reference_matches_jax_step(name):
    _, _, s1, ts, st = _one_jax_step(name)
    fs = ts.make_fused_step()[1](st)
    prm, _ = F.make_params(ts)
    dt = F.dt_reference_3d(prm, fs.T, fs.ux, fs.uy, fs.uz, fs.dt)
    np.testing.assert_allclose(float(dt), float(s1.dt), rtol=1e-6)


@pytest.mark.parametrize("name", ["supersonic_duct_3d", "flagship"])
def test_update_reference_matches_jax_step(name):
    """One step of the plain update from the JAX composable step's dt and
    sensor, against that step (f32 here, partly f64 there under x64)."""
    _, _, s1, ts, st = _one_jax_step(name)
    _, to_f, from_f = ts.make_fused_step()
    fs = to_f(st)
    prm, _ = F.make_params(ts)
    sc = F._edge_frame(torch.as_tensor(np.array(s1.sc, np.float32))) \
        if prm.varsc else None
    dt = torch.tensor(float(s1.dt), dtype=torch.float32)
    frames, side = F.update_reference_3d(prm, fs.p, fs.T, fs.ux, fs.uy,
                                         fs.uz, sc, dt)
    out = from_f(F.Fused3DState(*frames, t=fs.t, dt=dt, sc=sc))
    for f in ("rho", "rhoU", "rhoE"):
        assert _rel(getattr(s1, f), getattr(out, f).numpy()) < 1e-5, f
    for i, (_, sd) in enumerate(ts._flux_sides()):
        # pbc = +ws/tau_f on the low side, -ws/tau_f on the high side
        g = side[sd] if sd == 0 else -side[sd]
        np.testing.assert_allclose(g.numpy()[None], _f64(s1.pbc[i]),
                                   rtol=1e-4, atol=1e-3)


def test_sensor_reference_matches_jax_sc_raw_update():
    """The raw sensor of fresh frames against the JAX sc_raw_update on the
    same density, with a spiky density and a random previous sensor."""
    js, _, ts, _ = _build("supersonic_jet_3d_varsc")
    prm, _ = F.make_params(ts)
    rng = np.random.default_rng(3)
    rho = 1.2 * (1.0 + 0.05 * rng.standard_normal(SHAPE))
    rho[3:5, 2:4, 2:4] *= 2.0
    T = rng.uniform(280.0, 320.0, SHAPE)
    p = rho * ts.thermo.R * T
    sc_prev = rng.uniform(0.05, 0.5, SHAPE)
    pf = F._edge_frame(torch.as_tensor(p, dtype=torch.float32))
    Tf = F._edge_frame(torch.as_tensor(T, dtype=torch.float32))
    scf = F._edge_frame(torch.as_tensor(sc_prev, dtype=torch.float32))
    got = F.sensor_reference_3d(prm, pf, Tf, scf)
    rho32 = pf[C] * (1.0 / (prm.R * Tf[C]))
    ref = js.tau_model.sc_raw_update(js.mesh, jnp.asarray(rho32.numpy()),
                                     jnp.asarray(scf[C].numpy()))
    assert _rel(ref, got.numpy()) < 1e-5
    assert float(got.max()) > 0.3, "the spike must raise the sensor"


@pytest.mark.parametrize("name", ["supersonic_duct_3d", "flagship"])
def test_ghosts_reference_matches_jax_ghost_pad(name):
    """Ghost planes, rows and lanes (edges, array inlet, qgdFlux) of fresh
    frames against ghost_pad of the same interior under the JAX BCs."""
    js, _, s1, ts, _ = _one_jax_step(name)
    prm, planes = F.make_params(ts)
    U, _, T, p = js.primitives(s1)
    bc_U, bc_p, bc_T = js._bcs()
    for i, (a, side) in enumerate(js._flux_sides()):
        bc_p = bc_p.replace(a, side, jbc.FixedGradient(s1.pbc[i]))
    padded = [j_ghost_pad(p, jbc.resolve_inlet_outlet(bc_p, U, 3), js.mesh),
              j_ghost_pad(T, jbc.resolve_inlet_outlet(bc_T, U, 3), js.mesh)]
    Up = j_ghost_pad(U, jbc.resolve_inlet_outlet(bc_U, U, 3), js.mesh,
                     vector=True)
    padded += [Up[0], Up[1], Up[2]]
    frames = []
    for ref in padded:
        f = torch.zeros(ref.shape, dtype=torch.float32)
        f[C] = torch.as_tensor(np.asarray(ref[C], np.float32))
        frames.append(f)
    side = torch.zeros((2,) + SHAPE[1:], dtype=torch.float32)
    for i, (_, sd) in enumerate(js._flux_sides()):
        g = torch.as_tensor(np.asarray(s1.pbc[i], np.float32))[0]
        side[sd] = g if sd == 0 else -g
    F.ghosts_reference_3d(prm, frames, side, torch.as_tensor(planes))
    for k, ref in enumerate(padded):
        assert _rel(ref, frames[k].numpy()) < 1e-6, F.FIELDS[k]


@pytest.mark.parametrize("varsc", [False, True])
def test_sod_tube_vs_exact(varsc):
    """Physics through the port's fused 3D path: a quasi-1D Sod tube
    matches the exact Riemann solution (mirrors the JAX 3D Sod tests; the
    varsc variant adds the sensor and the qgdFlux outflow)."""
    from test_qgd import _sod_exact
    from qgdsolver_tpu_torch.core.mesh import Mesh
    from qgdsolver_tpu_torch.solvers import common
    from qgdsolver_tpu_torch.solvers.qgd import QGDFoam

    n = 128
    mesh = Mesh.uniform((n, 6, 6), lengths=(1.0, 6.0 / n, 6.0 / n))
    R, gamma = 1.0, 1.4
    th = tthermo.PerfectGasThermo(R=R, Cp=gamma * R / (gamma - 1))
    zg = tbc.FieldBCs.uniform(tbc.ZeroGradient(), 3)
    if varsc:
        tm = tcoeffs.VarScModel5(alpha=0.5, Pr=1.0, rC=0.5, minSc=0.05,
                                 maxSc=1.0, smoothCoeff=0.1)
        bc_p = zg.replace(0, 1, tbc.QGDFluxP())
    else:
        tm = tcoeffs.ConstScPrModel1(alpha=0.5, Sc=1.0, Pr=1.0)
        bc_p = zg
    solver = QGDFoam(
        mesh=mesh, thermo=th, tau_model=tm, bc_U=zg, bc_p=bc_p, bc_T=zg,
        time=common.TimeControls(max_co=0.3, max_dt=1e-3, dt0=1e-6))
    assert F.supported(solver)
    x = np.asarray(mesh.centers[0])
    p0 = np.where(x < 0.5, 1.0, 0.1)[:, None, None] * np.ones(mesh.shape)
    rho0 = np.where(x < 0.5, 1.0, 0.125)[:, None, None] * np.ones(mesh.shape)
    s = solver.init(p0=p0, T0=p0 / (R * rho0), U0=np.zeros((3,) + mesh.shape),
                    sc0=np.full(mesh.shape, 0.05) if varsc else None)
    step, to_f, from_f = solver.make_fused_step()
    fs = to_f(s)
    t_end = 0.12
    for _ in range(2000):
        fs = step(fs)
        if float(fs.t) >= t_end:
            break
    assert float(fs.t) >= t_end
    out = interop.state_to_numpy(from_f(fs))
    rho = out.rho
    assert np.max(np.std(rho, axis=(1, 2))) < 1e-3  # stays quasi-1D
    prof = rho[:, 3, 3]
    rho_ex, u_ex, _ = _sod_exact(x, float(out.t))
    assert np.mean(np.abs(prof - rho_ex)) < 0.04
    assert np.mean(np.abs(out.rhoU[0, :, 3, 3] / prof - u_ex)) < 0.08
    if varsc:
        sc = out.sc[:, 3, 3]
        assert sc.max() > 2.0 * 0.05 and sc[: n // 8].mean() < 0.08


def test_wrappers_check_their_inputs():
    ts, s = tcases.supersonic_jet_3d_varsc(shape=SHAPE, device="cpu")
    fs = ts.make_fused_step()[1](s)
    prm, planes = F.make_params(ts)
    with pytest.raises(TypeError):
        F.qgd3d_dt(prm, fs.T.double(), fs.ux, fs.uy, fs.uz, fs.dt)
    with pytest.raises(ValueError):
        F.qgd3d_dt(prm, fs.T[:-1], fs.ux, fs.uy, fs.uz, fs.dt)
    with pytest.raises(ValueError):
        F.qgd3d_dt(prm, fs.T.transpose(0, 2).contiguous().transpose(0, 2),
                   fs.ux, fs.uy, fs.uz, fs.dt)
    with pytest.raises(ValueError):
        F.qgd3d_ghosts(prm, [fs.p, fs.T, fs.ux, fs.uy, fs.uz],
                       torch.zeros((2, 6, 5)), torch.as_tensor(planes))
    duct, _ = tcases.supersonic_duct_3d(shape=SHAPE, device="cpu")
    with pytest.raises(ValueError):
        F.qgd3d_sensor(F.make_params(duct)[0], fs.p, fs.T, fs.sc)
    with pytest.raises(ValueError):
        F.qgd3d_emit(F.make_params(duct)[0], fs.p, fs.T, fs.sc)
    with pytest.raises(ValueError):
        F.qgd3d_emit(prm, fs.p, fs.T[:-1], fs.sc)
    slab = _build_params_copy(prm)
    slab.edge_hi = 0
    with pytest.raises(ValueError, match="physical"):
        F.qgd3d_emit(slab, fs.p, fs.T, fs.sc)
    kernels = F.KERNELS + (F.qgd3d_sensor,)
    launches = [k.launches for k in kernels]
    F.qgd3d_dt(prm, fs.T, fs.ux, fs.uy, fs.uz, fs.dt)
    F.qgd3d_sensor(prm, fs.p, fs.T, fs.sc)
    F.qgd3d_emit(prm, fs.p, fs.T, fs.sc, raw=True)
    assert [k.launches for k in kernels] == launches, \
        "the plain version on the CPU is not a launch"


RAGGED = (13, 9, 7)


def _smooth_field3(field):
    rng = np.random.default_rng(7)
    if field == "random":
        return rng.uniform(0.05, 1.0, size=RAGGED).astype(np.float32)
    raw = np.full(RAGGED, 0.05, dtype=np.float32)
    if field == "spike":
        raw[6, 2, 5] = 1.0
    return raw


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("field", ["random", "spike", "smooth"])
def test_grouped_smoothing_3d_is_bitwise_fvc_smooth(field, k):
    """The 3D step's smoothing (`smooth_sensor` from the raw sensor: ring 1
    alone, then k rings a call of `qgd3d_smooth`'s plain version, one host
    flag read a call) is the port's fvc_smooth edge-framed, bit for bit,
    whatever k, and so through the wrapper where k rings fit one launch;
    against the JAX package's fvc_smooth rtol 1e-6 (jit rounds the ring's
    division otherwise, as in tests/test_torch_tiled.py)."""
    raw = _smooth_field3(field)
    ts, _ = tcases.supersonic_jet_3d_varsc(shape=RAGGED, device="cpu")
    prm, _ = F.make_params(ts)
    f = torch.as_tensor(raw)
    ref = F._edge_frame(tcoeffs.fvc_smooth(f, 0.1))
    smooths = [S._smooth_plain]
    if k <= F.SMOOTH3_KMAX:
        smooths.append(F.qgd3d_smooth)
    for smooth in smooths:
        reads, rings = S.smooth_sensor.reads, S.smooth_sensor.rings
        out = S.smooth_sensor(prm, f, None, smooth, k)
        reads = S.smooth_sensor.reads - reads
        rings = S.smooth_sensor.rings - rings
        assert torch.equal(out, ref)
        # ring 1 alone, then k rings a call
        assert reads >= 1 and rings == 1 + k * (reads - 1)
        if field == "smooth":
            assert reads == 1, "a field at its fixed point takes one call"
    np.testing.assert_allclose(
        out[C].numpy(), np.asarray(jcoeffs.fvc_smooth(jnp.asarray(raw), 0.1)),
        rtol=1e-6)
    if field == "spike":
        assert float(out[C][6, 2, 0]) > 0.05, "the smoothing wave must spread"
    # one call of k rings: the plain loop's cells, ghosts and last flag
    for smooth in smooths:
        frame, last = smooth(prm, F._edge_frame(f), k,
                             torch.empty_like(ref), torch.empty(()))
        cells, ref_last = F.smooth_reference_3d(prm, f, k)
        assert torch.equal(frame, F._edge_frame(cells))
        assert float(last) == float(ref_last)


def test_3d_step_on_cpu_is_no_launch():
    """On CPU tensors the 3D varsc step's wrappers take their plain
    versions: no launch and no ring counted by any kernel, while the
    smoothing loop counts one host flag read a step (the carried flag) and
    one more where that flag is set, for the fixed point's call (no ring,
    no fallback on a sound sensor), and the step's sensor is fvc_smooth of
    the raw sensor the previous step emitted (to_fused's for the first),
    its carried ring 1 and flag those of that raw sensor.  `qgd3d_smooth`
    checks its inputs."""
    ts, s = tcases.supersonic_jet_3d_varsc(shape=RAGGED, device="cpu")
    prm, _ = F.make_params(ts)
    step, to_f, _ = ts.make_fused_step()
    s = ts.make_step()(s)
    x = torch.arange(RAGGED[0]).reshape(-1, 1, 1)
    bump = 1.0 + 0.4 * (x == RAGGED[0] // 2).to(s.rho.dtype)
    s = s._replace(rho=s.rho * bump, rhoE=s.rhoE * bump)
    fs = to_f(s)
    raw = F.raw_sensor(ts, fs.p, fs.T, s.sc)
    before = [k.launches for k in F.KERNELS] + [F.qgd3d_smooth.rings]
    reads, rings = S.smooth_sensor.reads, S.smooth_sensor.rings
    fixed, fallbacks = F.qgd3d_smooth.fixed, F.qgd3d_smooth.fallbacks
    active = 0
    for _ in range(3):
        active += float(fs.sc_chg) == 1.0
        new = step(fs)
        assert torch.equal(new.sc, F._edge_frame(
            tcoeffs.fvc_smooth(raw, ts.tau_model.smoothCoeff)))
        raw, s1, chg = F.qgd3d_emit(prm, new.p, new.T, new.sc, raw=True)
        cells, flag = F.smooth_reference_3d(prm, raw, 1)
        assert torch.equal(new.sc_s1, F._edge_frame(cells)) \
            and torch.equal(s1, new.sc_s1)
        assert float(new.sc_chg) == float(flag) == float(chg)
        fs = new
    assert [k.launches for k in F.KERNELS] + [F.qgd3d_smooth.rings] == before
    assert active >= 1, "the bump must set the carried flag"
    assert S.smooth_sensor.reads - reads == 3 + active
    assert S.smooth_sensor.rings == rings
    assert F.qgd3d_smooth.fixed - fixed == active
    assert F.qgd3d_smooth.fallbacks == fallbacks
    with pytest.raises(ValueError):
        F.qgd3d_smooth(prm, fs.sc_s1, F.SMOOTH3_KMAX + 1)
    with pytest.raises(ValueError):
        F.qgd3d_smooth(prm, fs.sc_s1[:-1], 1)
    with pytest.raises(TypeError):
        F.qgd3d_smooth(prm, fs.sc_s1.double(), 1)


@pytest.mark.parametrize("name", ["supersonic_duct_3d", "flagship"])
def test_nan_T_cell_gives_nan_dt_like_jax(name):
    """One cell's energy NaN, so its T in the frame: the port's plain dt
    and its dt quad are NaN, as are the JAX package's dt from its fused 3D
    step (the pre-pass folds with jnp.max; Pallas in interpret mode) and
    from its composable step.  The kernels' folds follow the plain
    versions (a `gpu` test)."""
    js, jst, ts, st = _build(name)
    idx = (3, 2, 4)
    jst = jst._replace(rhoE=jst.rhoE.at[idx].set(jnp.nan))
    rhoE = st.rhoE.clone()
    rhoE[idx] = float("nan")
    fs = ts.make_fused_step()[1](st._replace(rhoE=rhoE))
    assert bool(torch.isnan(fs.T[tuple(i + 1 for i in idx)]))
    assert int(torch.isnan(fs.T).sum()) == 1
    prm, _ = F.make_params(ts)
    assert bool(torch.isnan(F.dt_reference_3d(prm, fs.T, fs.ux, fs.uy,
                                              fs.uz, fs.dt)))
    assert bool(torch.isnan(F.dt_fold_reference_3d(prm, fs.T, fs.ux, fs.uy,
                                                   fs.uz)).any())
    jstep, jto, jfrom = JF.build_fused_step_3d(js, interpret=True)
    assert np.isnan(float(jfrom(jax.jit(jstep)(jto(jst))).dt))
    assert np.isnan(float(jax.jit(js.make_step())(jst).dt))


def _ghosts_one_launch_model(prm, frames, side, planes):
    """A model of `qgd3d_ghosts`' one launch: every ghost cell of copies of
    the frames computed by the kernel's composition from the input's
    interior cells (and a partition's halo plane) alone: an x-ghost from
    the interior, a y-ghost from two values after the x phase (x-ghosts
    computed on the spot at an x-ghost plane), a z-ghost from two values
    after the y phase.  No ghost of the input, and none that the model
    writes, is read."""
    nx, ny, nz = prm.nx, prm.ny, prm.nz
    src = [f.clone() for f in frames]
    out = [f.clone() for f in frames]
    ux, uy, uz = src[2], src[3], src[4]
    extrap = F.KINDS["extrap"]

    def clamp(v, n):
        return min(max(v, 1), n)

    def ghost(e, in1, in2, d, v, un, sd):
        # in2 is read only by an extrapolated ghost
        return FC.bc_ghost(e, in1, in2() if e.kind == extrap else None, d,
                           v, un, sd)

    def x_ghost(f, sd, s, t):
        e = prm.bc[f][0][sd]
        r1, r2 = (1, 2) if sd == 0 else (nx, nx - 1)
        in1 = src[f][r1, s, t]
        if e.kind == F.KINDS["qgdflux"]:
            q = side[sd, s - 1, t - 1] * prm.d[0]
            return in1 + q if sd == 0 else in1 - q
        v = planes[e.prof, s - 1, t - 1] if e.prof >= 0 else e.value
        return ghost(e, in1, lambda: src[f][r2, s, t], prm.d[0], v,
                     ux[r1, s, t], sd)

    def x_value(f, r, s, t):
        if r == 0 and prm.edge_lo:
            return x_ghost(f, 0, s, t)
        if r == nx + 1 and prm.edge_hi:
            return x_ghost(f, 1, s, t)
        return src[f][r, s, t]

    def y_ghost(f, sd, r, t):
        e = prm.bc[f][1][sd]
        l1, l2 = (1, 2) if sd == 0 else (ny, ny - 1)
        return ghost(e, x_value(f, r, l1, t), lambda: x_value(f, r, l2, t),
                     prm.d[1], e.value, uy[clamp(r, nx), l1, t], sd)

    def y_value(f, r, s, t):
        if s in (0, ny + 1):
            return y_ghost(f, int(s > 0), r, t)
        return x_value(f, r, s, t)

    def z_ghost(f, sd, r, s):
        e = prm.bc[f][2][sd]
        l1, l2 = (1, 2) if sd == 0 else (nz, nz - 1)
        return ghost(e, y_value(f, r, s, l1), lambda: y_value(f, r, s, l2),
                     prm.d[2], e.value, uz[clamp(r, nx), clamp(s, ny), l1],
                     sd)

    for f in range(5):
        for s in range(1, ny + 1):
            for t in range(1, nz + 1):
                if prm.edge_lo:
                    out[f][0, s, t] = x_ghost(f, 0, s, t)
                if prm.edge_hi:
                    out[f][nx + 1, s, t] = x_ghost(f, 1, s, t)
        for r in range(nx + 2):
            for t in range(1, nz + 1):
                out[f][r, 0, t] = y_ghost(f, 0, r, t)
                out[f][r, ny + 1, t] = y_ghost(f, 1, r, t)
            for s in range(ny + 2):
                out[f][r, s, 0] = z_ghost(f, 0, r, s)
                out[f][r, s, nz + 1] = z_ghost(f, 1, r, s)
    return out


@pytest.mark.parametrize("edges", [(1, 1), (0, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("kind", ["duct", "flagship", "zg", "fixed", "grad",
                                  "sym", "extrap", "io"])
def test_ghosts_one_launch_model_equals_ghosts_reference(kind, edges):
    """The one-launch composition of `qgd3d_ghosts` (each ghost from
    interior cells: `_ghosts_one_launch_model`) equals
    `ghosts_reference_3d` (x planes, then y rows, then z lanes) bit for
    bit, for the duct's and the varsc jet's BCs (qgdFlux, the array inlet)
    and for each BC kind on every side (the varsc jet's x sides keep theirs),
    under every (edge_lo, edge_hi).  The input's ghost cells hold NaN, and
    neither reads them: no NaN comes out."""
    from test_torch_gpu import one_kind_on_sides, random_frames

    shape = (3, 4, 5)
    base = "supersonic_duct_3d" if kind == "duct" else \
        "supersonic_jet_3d_varsc"
    ts, _ = getattr(tcases, base)(shape=shape, device="cpu")
    if kind not in ("duct", "flagship"):
        ts = one_kind_on_sides(ts, tbc, kind, (1, 2))
    prm, planes = F.make_params(ts)
    prm.edge_lo, prm.edge_hi = edges
    planes = torch.as_tensor(planes)
    frames = random_frames(shape, 9)
    rng = np.random.default_rng(9)
    side = torch.as_tensor(rng.uniform(-5.0, 5.0, (2,) + shape[1:])
                           .astype(np.float32))
    nx = shape[0]
    for f in frames:
        f[:, 0], f[:, -1], f[:, :, 0], f[:, :, -1] = (float("nan"),) * 4
        for r, phys in ((0, edges[0]), (nx + 1, edges[1])):
            if phys:
                f[r] = float("nan")
    model = _ghosts_one_launch_model(prm, frames, side, planes)
    ref = F.ghosts_reference_3d(prm, [f.clone() for f in frames], side,
                                planes)
    for k in range(5):
        assert not bool(torch.isnan(ref[k]).any()), F.FIELDS[k]
        assert torch.equal(model[k], ref[k]), F.FIELDS[k]


def test_ghosts_refuse_extrapolation_along_one_cell():
    """An extrapolated ghost reads the second interior layer; along an axis
    of one cell with both ends physical that layer is the other end's
    ghost, which `qgd3d_ghosts` writes in the same launch, so the fused 3D
    step refuses the config (`supported`, checked once when a step is
    built; the composable padding has no second layer there either).  A
    slab of one plane with a partition end reads the halo plane and is
    taken."""
    from test_torch_gpu import one_kind_on_sides, random_frames

    for shape, axes in (((4, 1, 5), (1, 2)), ((1, 4, 5), (0, 1, 2))):
        ts, _ = tcases.supersonic_duct_3d(shape=shape, device="cpu")
        assert F.supported(ts)
        ts = one_kind_on_sides(ts, tbc, "extrap", axes)
        assert not F.supported(ts)
        with pytest.raises(ValueError, match="not supported"):
            F.build_fused_step_3d(ts)
    assert F.supported(one_kind_on_sides(
        tcases.supersonic_duct_3d(shape=(4, 2, 5), device="cpu")[0], tbc,
        "extrap", (0, 1, 2)))
    prm, planes = F.make_params(ts)
    frames = random_frames(shape, 10)
    side = torch.zeros((2,) + shape[1:])
    prm.edge_hi = 0
    out = F.qgd3d_ghosts(prm, [f.clone() for f in frames], side,
                         torch.as_tensor(planes))
    assert torch.equal(out[0][0, 1:-1, 1:-1],
                       2.0 * frames[0][1, 1:-1, 1:-1]
                       - frames[0][2, 1:-1, 1:-1])


def test_x_side_planes_on_a_y_or_z_of_one_cell():
    """The varsc jet's (3, 1, ny, nz) array inlet becomes a (ny, nz) plane
    when ny or nz is 1, so the 3D step takes such meshes."""
    for shape in ((6, 4, 1), (6, 1, 4)):
        ts, _ = tcases.supersonic_jet_3d_varsc(shape=shape, device="cpu")
        assert F.supported(ts)
        _, planes = F.make_params(ts)
        assert planes.shape[1:] == shape[1:]


def _build_params_copy(prm):
    from qgdsolver_tpu_torch.ops import _build as tbuild

    return tbuild.QGD3DParams.from_buffer_copy(prm)


def _fresh_frames(shape, seed):
    """p, T, sc frames (edge-framed cells) of a spiky density, a random
    temperature and a random previous sensor, from a seed."""
    rng = np.random.default_rng(seed)
    rho = 1.2 * (1.0 + 0.05 * rng.standard_normal(shape))
    rho[tuple(slice(n // 3, n // 3 + 2) for n in shape)] *= 2.0
    T = rng.uniform(280.0, 320.0, shape)
    p = rho * 287.0 * T
    sc_prev = rng.uniform(0.05, 0.5, shape)
    return tuple(F._edge_frame(torch.as_tensor(x, dtype=torch.float32))
                 for x in (p, T, sc_prev))


@pytest.mark.parametrize("shape", [(6, 5, 4), (13, 9, 7), (9, 2, 5)])
def test_emit_reference_matches_jax_sc_raw_update(shape):
    """`qgd3d_emit`'s plain version on fresh frames: the raw sensor against
    the JAX sc_raw_update on the same density (rel 1e-5, as the sensor
    test above); ring 1 and its flag bitwise `smooth_reference` of that raw
    sensor, with the raw sensor returned only when asked for; and the JAX
    package's `fvc_smooth_continue` from the port's ring 1 and flag equal to
    its `fvc_smooth` of the raw sensor (rtol 1e-6: jit rounds the ring's
    division otherwise, as in tests/test_torch_tiled.py)."""
    js, _, ts, _ = _build("supersonic_jet_3d_varsc", shape)
    prm, _ = F.make_params(ts)
    pf, Tf, scf = _fresh_frames(shape, 3)
    raw, s1, chg = F.qgd3d_emit(prm, pf, Tf, scf, raw=True)
    assert raw.shape == shape and s1.shape == pf.shape and chg.shape == ()
    rho32 = pf[C] * (1.0 / (prm.R * Tf[C]))
    ref = js.tau_model.sc_raw_update(js.mesh, jnp.asarray(rho32.numpy()),
                                     jnp.asarray(scf[C].numpy()))
    assert _rel(ref, raw.numpy()) < 1e-5
    cells, flag = F.smooth_reference_3d(prm, raw, 1)
    assert torch.equal(s1, F._edge_frame(cells))
    assert float(chg) == float(flag) == 1.0, "the spike must raise ring 1"
    again = F.qgd3d_emit(prm, pf, Tf, scf)
    assert again[0] is None and torch.equal(again[1], s1)
    coeff = ts.tau_model.smoothCoeff
    cont = jcoeffs.fvc_smooth_continue(jnp.asarray(cells.numpy()),
                                       jnp.asarray(float(chg) > 0.0), coeff)
    np.testing.assert_allclose(
        np.asarray(cont),
        np.asarray(jcoeffs.fvc_smooth(jnp.asarray(raw.numpy()), coeff)),
        rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("field", ["random", "spike", "smooth"])
def test_emitted_ring_continuation_is_bitwise_fvc_smooth(field, k):
    """The 3D step's smoothing from the emitted first ring (a frame) and
    its flag: `smooth_sensor` on `qgd3d_smooth`'s plain version, k rings a
    call, is the port's fvc_smooth of the raw sensor edge-framed, bit for
    bit, with one host flag read for the emitted flag and one a call; at
    rest (flag 0) it returns the emitted frame itself, with no call."""
    raw = torch.as_tensor(_smooth_field3(field))
    ts, _ = tcases.supersonic_jet_3d_varsc(shape=RAGGED, device="cpu")
    prm, _ = F.make_params(ts)
    cells, chg = F.smooth_reference_3d(prm, raw, 1)
    s1 = F._edge_frame(cells)
    ref = F._edge_frame(tcoeffs.fvc_smooth(raw, 0.1))
    smooths = [S._smooth_plain]
    if k <= F.SMOOTH3_KMAX:
        smooths.append(F.qgd3d_smooth)
    for smooth in smooths:
        reads, rings = S.smooth_sensor.reads, S.smooth_sensor.rings
        out = S.smooth_sensor(prm, s1, chg, smooth, k)
        reads = S.smooth_sensor.reads - reads
        rings = S.smooth_sensor.rings - rings
        assert torch.equal(out, ref)
        assert rings == k * (reads - 1)
        if field == "smooth":
            assert float(chg) == 0.0 and out is s1 and reads == 1
        else:
            assert float(chg) == 1.0 and reads >= 2 and out is not s1


def _fixed_field(field, shape):
    """A sensor for the fixed point's tests: random in [0.05, 1], a spike,
    at rest (0.05), below the division-free ring's guard (2^-96: subnormals
    and zeros among them, one normal spike), or zeros."""
    rng = np.random.default_rng(17)
    if field == "random":
        return rng.uniform(0.05, 1.0, size=shape).astype(np.float32)
    if field == "zeros":
        return np.zeros(shape, dtype=np.float32)
    if field == "tiny":
        raw = np.ldexp(rng.uniform(0.5, 1.0, shape),
                       rng.integers(-150, -90, shape)).astype(np.float32)
        raw[rng.random(shape) < 0.1] = 0.0
        raw[tuple(n // 2 for n in shape)] = 0.5
        return raw
    raw = np.full(shape, 0.05, dtype=np.float32)
    if field == "spike":
        raw[tuple(n // 3 for n in shape)] = 1.0
        raw[-1, -1, 0] = 0.7
    return raw


def _with_ratio(prm, ratio):
    out = _build_params_copy(prm)
    out.smooth_ratio = ratio
    return out


@pytest.mark.parametrize("start", ["raw", "ring1"])
@pytest.mark.parametrize("ratio", [1.05, 1.1, 2.0])
@pytest.mark.parametrize("field", ["random", "spike", "rest", "tiny",
                                   "zeros"])
def test_fixed_point_sweeps_are_bitwise_fvc_smooth(field, ratio, start):
    """The plain version of `qgd3d_smooth`'s fixed point (line sweeps along
    z, y, x) of the raw sensor or of its first ring, on ragged shapes and
    through the wrapper on cells and on a frame, is the port's fvc_smooth
    of the raw sensor edge-framed, bit for bit, with the flag 0."""
    for shape in (RAGGED, (5, 17, 1), (1, 6, 23)):
        ts, _ = tcases.supersonic_jet_3d_varsc(shape=shape, device="cpu")
        prm = _with_ratio(F.make_params(ts)[0], ratio)
        raw = torch.as_tensor(_fixed_field(field, shape))
        f = raw if start == "raw" else F.smooth_reference_3d(prm, raw, 1)[0]
        ref = F._edge_frame(tcoeffs.fvc_smooth(raw, ratio - 1.0))
        cells, flag = S.smooth_fixed_reference(prm, f)
        assert torch.equal(F._edge_frame(cells), ref), shape
        assert float(flag) == 0.0
        for src in (f, F._edge_frame(f)):
            out, flag = F.qgd3d_smooth(prm, src, S.SMOOTH_FIXED)
            assert torch.equal(out, ref) and float(flag) == 0.0, shape
    if field == "spike":
        assert float(ref[C][0, 0, 0]) > 0.05, "the spike must spread"


@pytest.mark.parametrize("bad", ["nan", "negative", "inf", "minus_zero"])
def test_fixed_point_flag_sends_the_step_to_the_rings(bad):
    """A ring 1 with a NaN, a negative, an infinite or a -0 cell: the fixed
    point's flag is 1, and the 3D step's smoothing (`smooth_sensor` with
    `fixed`) counts a fallback and returns the ring loop's result, NaN
    exactly where it has NaN, after one read for the carried flag, one for
    the fixed point's and one a call of rings.  At rest nothing runs, and a
    mesh whose diameter reaches the ring cap less a group takes the rings
    alone."""
    raw = torch.as_tensor(_fixed_field("spike", RAGGED))
    ts, _ = tcases.supersonic_jet_3d_varsc(shape=RAGGED, device="cpu")
    prm, _ = F.make_params(ts)
    cells, chg = F.smooth_reference_3d(prm, raw, 1)
    cells[3, 4, 5] = {"nan": float("nan"), "negative": -0.5,
                      "inf": float("inf"), "minus_zero": -0.0}[bad]
    s1 = F._edge_frame(cells)
    assert float(S.smooth_fixed_reference(prm, cells)[1]) == 1.0
    assert float(F.qgd3d_smooth(prm, s1, S.SMOOTH_FIXED)[1]) == 1.0
    ring = S.smooth_sensor(prm, s1, chg, F.qgd3d_smooth, F.SMOOTH3_RINGS)
    reads, rings = S.smooth_sensor.reads, S.smooth_sensor.rings
    fixed, fallbacks = F.qgd3d_smooth.fixed, F.qgd3d_smooth.fallbacks
    out = S.smooth_sensor(prm, s1, chg, F.qgd3d_smooth, F.SMOOTH3_RINGS,
                          cache={"fixed": True})
    nan = torch.isnan(ring)
    assert torch.equal(torch.isnan(out), nan)
    assert torch.equal(out[~nan], ring[~nan])
    assert (int(nan.sum()) > 1) == (bad == "nan")
    assert F.qgd3d_smooth.fixed - fixed == 1
    assert F.qgd3d_smooth.fallbacks - fallbacks == 1
    calls = (S.smooth_sensor.rings - rings) // F.SMOOTH3_RINGS
    assert calls >= 1 and S.smooth_sensor.reads - reads == 2 + calls
    fixed = F.qgd3d_smooth.fixed
    at_rest = S.smooth_sensor(prm, s1, torch.zeros(()), F.qgd3d_smooth,
                              F.SMOOTH3_RINGS, cache={"fixed": True})
    assert at_rest is s1 and F.qgd3d_smooth.fixed == fixed
    s1 = F._edge_frame(F.smooth_reference_3d(prm, raw, 1)[0])
    capped = S.smooth_sensor(prm, s1, chg, F.qgd3d_smooth, F.SMOOTH3_RINGS,
                             cache={"fixed": True},
                             max_iters=sum(RAGGED) - 3 + 4)
    assert F.qgd3d_smooth.fixed == fixed
    assert torch.equal(capped, F._edge_frame(tcoeffs.fvc_smooth(raw, 0.1)))
    with pytest.raises(ValueError):
        F.qgd3d_smooth(_with_ratio(prm, 0.9), s1, S.SMOOTH_FIXED)
    long_x = _build_params_copy(prm)
    long_x.nx = F.SMOOTH3_FIXED_MAXN + 1
    assert not F.fixed_supported(long_x) and F.fixed_supported(prm)


@pytest.mark.parametrize("name", ["supersonic_jet_3d_varsc", "flagship",
                                  "flagship_bump"])
def test_to_fused_carries_ring_1_and_flag(name):
    """to_fused carries the first ring of the State's raw sensor (as the
    composable step computes it) as a frame with edge-replicated ghosts,
    and its flag, both bitwise the plain ring; the first step's sensor
    frame is fvc_smooth of that raw sensor."""
    _, _, ts, st = _build(name)
    prm, _ = F.make_params(ts)
    step, to_f, _ = ts.make_fused_step()
    fs = to_f(st)
    raw = ts.tau_model.sc_raw_update(
        ts.mesh, ts.thermo.rho_from_p_T(fs.p[C], fs.T[C]), st.sc)
    cells, flag = F.smooth_reference_3d(prm, raw, 1)
    assert torch.equal(fs.sc_s1, F._edge_frame(cells))
    assert float(fs.sc_chg) == float(flag)
    if name == "flagship_bump":
        assert float(flag) == 1.0, "the bump must keep the rings going"
    assert torch.equal(step(fs).sc, F._edge_frame(
        tcoeffs.fvc_smooth(raw, ts.tau_model.smoothCoeff)))


@pytest.mark.parametrize("px,nx,extrap,taken", [
    (2, 2, True, False), (2, 4, True, True), (2, 2, False, True),
    (1, 2, True, True)])
def test_sharded_gate_refuses_one_plane_slabs_with_extrapolation(px, nx,
                                                                 extrap,
                                                                 taken):
    """K5's gate: a slab of one plane whose x ends carry an extrapolated BC
    reads its halo plane at ghost time, before the exchange fills it, so
    `sharded_supported` refuses it (and `build_sharded_fused_step_3d`
    raises); slabs of two planes, one-plane slabs without extrapolation
    and the serial step on the same mesh are taken."""
    from qgdsolver_tpu_torch.parallel import sharding
    from test_torch_gpu import one_kind_on_sides

    ts, _ = tcases.supersonic_duct_3d(shape=(nx, 4, 5), device="cpu")
    if extrap:
        ts = one_kind_on_sides(ts, tbc, "extrap", (0,))
    grid = sharding.ProcessGrid(px, 1)
    assert F.supported(ts)
    assert F.sharded_supported(ts, grid) is taken
    if not taken:
        with pytest.raises(ValueError, match="not supported"):
            F.build_sharded_fused_step_3d(ts, grid)
