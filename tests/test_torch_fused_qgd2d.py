"""The port's fused 2D step (ops.fused_qgd2d) against the JAX package.

On the CPU the kernel wrappers run their plain torch versions, so these
tests check the plain versions, the BC compiler and the State conversions;
the CUDA kernels are held against the same plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).  The JAX fused step runs in
interpret mode, as tests/test_fused_qgd2d.py runs it.  Bounds are the JAX
fused tests' own: dt rtol 1e-6 (1e-5 varsc), fields within 1e-3 (2e-3 varsc)
of their max over 10 steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgdsolver_tpu import cases as jcases
from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.ops.pad import ghost_pad as j_ghost_pad
from qgdsolver_tpu_torch import cases as tcases
from qgdsolver_tpu_torch import interop
from qgdsolver_tpu_torch.core import bc as tbc
from qgdsolver_tpu_torch.ops import fused_common as FC
from qgdsolver_tpu_torch.ops import fused_qgd2d as F
from qgdsolver_tpu_torch.physics.qgdcoeffs import TauModel

SHAPE = (64, 32)
BOUNDS = {"supersonic_jet": (1e-6, 1e-3), "supersonic_jet_varsc": (1e-5, 2e-3),
          "every_bc_kind": (1e-6, 1e-3)}


def _every_bc_kind(pkg_cases, bcm, dtype, xp, **device):
    """The jet with every BC kind the kernels take on some side."""
    solver, state = pkg_cases.supersonic_jet(shape=SHAPE, dtype=dtype,
                                             **device)
    nx = SHAPE[0]
    solver = dataclasses.replace(
        solver,
        bc_U=bcm.FieldBCs(((solver.bc_U[0, 0], bcm.Extrapolated()),
                           (bcm.Symmetry(),
                            bcm.InletOutlet(np.array([0.0, -30.0]))))),
        bc_p=bcm.FieldBCs(((bcm.FixedGradient(10.0), bcm.InletOutlet(1e5)),
                           (bcm.Symmetry(),
                            bcm.FixedValue(xp(np.full((nx, 1), 1e5)))))),
        bc_T=bcm.FieldBCs(((bcm.FixedValue(300.0), bcm.Extrapolated()),
                           (bcm.InletOutlet(310.0),
                            bcm.FixedGradient(xp(np.linspace(0.0, 5.0, nx)
                                                 .reshape(nx, 1)))))))
    return solver, state


def _build(name):
    """(jax solver, jax f32 state, port solver, port state from the JAX one)."""
    if name == "every_bc_kind":
        js, jst = _every_bc_kind(jcases, jbc, np.float32, jnp.asarray)
        ts, _ = _every_bc_kind(tcases, tbc, torch.float32, np.asarray,
                               device="cpu")
        rng = np.random.default_rng(0)
        kick = (20.0 * rng.standard_normal(jst.rhoU.shape)).astype(np.float32)
        jst = jst._replace(rhoU=jst.rhoU + kick * jst.rho[None])
    else:
        js, jst = getattr(jcases, name)(shape=SHAPE, dtype=np.float32)
        ts, _ = getattr(tcases, name)(shape=SHAPE, dtype=torch.float32,
                                      device="cpu")
    st = interop.state_from_numpy(jax.tree.map(np.asarray, jst),
                                  dtype=torch.float32)
    return js, jst, ts, st


def _f32(x):
    return np.asarray(x).astype(np.float32)


def _rel(a, b):
    a = _f32(a)
    return np.max(np.abs(a - _f32(b))) / max(np.max(np.abs(a)), 1e-30)


@pytest.mark.parametrize("name", list(BOUNDS))
def test_fused_step_matches_jax_fused(name):
    js, jst, ts, st = _build(name)
    assert F.supported(ts) and ts.fused_supported()
    jstep, jto, jfrom = js.make_fused_step()
    tstep, tto, tfrom = ts.make_fused_step()
    jstep = jax.jit(jstep)
    jfs, tfs = jto(jst), tto(st)
    for _ in range(10):
        jfs = jstep(jfs)
        tfs = tstep(tfs)
    a = jfrom(jfs)
    b = interop.state_to_numpy(tfrom(tfs))
    dt_tol, f_tol = BOUNDS[name]
    np.testing.assert_allclose(_f32(a.dt), b.dt, rtol=dt_tol)
    np.testing.assert_allclose(_f32(a.t), b.t, rtol=dt_tol)
    for f in ("rho", "rhoU", "rhoE", "sc"):
        assert _rel(getattr(a, f), getattr(b, f)) < f_tol, f
    # the lagged qgdFlux gradient comes back from the p ghost rows, which
    # quantizes it at eps(p)/dx
    assert len(a.pbc) == len(b.pbc)
    quant = 4.0 * np.float32(1e5) * np.finfo(np.float32).eps \
        / float(ts.mesh.dx[0][0])
    for ga, gb in zip(a.pbc, b.pbc):
        np.testing.assert_allclose(_f32(ga), gb, rtol=2e-2, atol=quant)


def test_supported():
    for name in ("supersonic_jet", "supersonic_jet_varsc"):
        ts, _ = getattr(tcases, name)(shape=SHAPE, device="cpu")
        assert F.supported(ts) and ts.fused_supported()


def test_unsupported_configs():
    ts, _ = tcases.supersonic_jet(shape=SHAPE, device="cpu")
    assert not F.supported(dataclasses.replace(ts, fvsc_scheme="reduced"))
    assert not F.supported(dataclasses.replace(ts, implicit_diffusion=True))

    class OtherTau(TauModel):
        pass

    assert not F.supported(dataclasses.replace(ts, tau_model=OtherTau()))
    assert not F.supported(dataclasses.replace(ts, qgdflux_relax=0.5))
    t64, _ = tcases.supersonic_jet(shape=SHAPE, dtype=torch.float64,
                                   device="cpu")
    assert not F.supported(t64)
    # qgdFlux p on a y side
    bc_p = ts.bc_p.replace(1, 1, tbc.QGDFluxP())
    assert not F.supported(dataclasses.replace(ts, bc_p=bc_p))
    with pytest.raises(ValueError):
        F.build_fused_step(dataclasses.replace(ts, bc_p=bc_p))


@pytest.mark.parametrize("shape,axis", [((1, 8), 0), ((8, 1), 1)])
def test_gate_refuses_extrapolation_along_one_cell(shape, axis):
    """An extrapolated ghost reads the second interior layer; along an axis
    of one cell with both sides physical that layer is the other side's
    ghost, which `qgd2d_ghosts` writes in the same launch, so the fused 2D
    step refuses the config (`supported`, checked once when a step is
    built; the composable padding has no second layer there either);
    zeroGradient there is taken.
    The refusal reads the global mesh, so K3's `sharded_supported` on a 2x1
    grid of an (8, 4) mesh with extrapolated sides is unchanged."""
    from qgdsolver_tpu_torch.parallel import sharding

    def on_sides(solver, a, b):
        return dataclasses.replace(
            solver, bc_T=solver.bc_T.replace(a, 0, b).replace(a, 1, b))

    ts, _ = tcases.supersonic_jet(shape=shape, device="cpu")
    zg = on_sides(ts, axis, tbc.ZeroGradient())
    assert F.supported(zg) and zg.fused_supported()
    ex = on_sides(ts, axis, tbc.Extrapolated())
    assert not F.supported(ex) and not ex.fused_supported()
    with pytest.raises(ValueError, match="not supported"):
        F.build_fused_step(ex)
    ts, _ = tcases.supersonic_jet(shape=(8, 4), device="cpu")
    for a in range(2):
        ts = on_sides(ts, a, tbc.Extrapolated())
    assert F.supported(ts)
    assert F.sharded_supported(ts, sharding.ProcessGrid(2, 1))


def test_time_dependent_bc_rejected():
    ts, _ = tcases.supersonic_jet(shape=SHAPE, device="cpu")

    def oscillating(t, coords):
        yy = coords[1]
        amp = np.sin(2.0 * t) * torch.ones_like(yy)
        return torch.stack(torch.broadcast_tensors(amp, torch.zeros_like(yy)))

    s2 = dataclasses.replace(
        ts, bc_U=ts.bc_U.replace(0, 0, tbc.FixedValue(oscillating)))
    assert not F.supported(s2)
    assert not s2.fused_supported()


def test_roundtrip_state():
    for name in ("supersonic_jet", "supersonic_jet_varsc"):
        ts, s = getattr(tcases, name)(shape=SHAPE, device="cpu")
        s = ts.make_step()(s)  # populate sc and pbc
        _, to_f, from_f = ts.make_fused_step()
        s2 = from_f(to_f(s))
        for f in ("rho", "rhoU", "rhoE", "sc"):
            torch.testing.assert_close(getattr(s2, f), getattr(s, f),
                                       rtol=1e-6, atol=0.0)
        assert s2.t is s.t and s2.dt is s.dt


def _one_jax_step(name):
    """JAX composable step from the initial state, and the port's frames of
    the same initial state."""
    js, jst, ts, st = _build(name)
    s1 = jax.jit(js.make_step())(jst)
    return js, jst, s1, ts, st


@pytest.mark.parametrize("name", list(BOUNDS))
def test_dt_reference_matches_jax_step(name):
    _, _, s1, ts, st = _one_jax_step(name)
    _, to_f, _ = ts.make_fused_step()
    fs = to_f(st)
    prm, _ = F.make_params(ts)
    dt = F.dt_reference(prm, fs.T, fs.ux, fs.uy, fs.dt)
    np.testing.assert_allclose(float(dt), float(s1.dt), rtol=1e-6)


@pytest.mark.parametrize("name", list(BOUNDS))
def test_update_reference_matches_jax_step(name):
    _, _, s1, ts, st = _one_jax_step(name)
    _, to_f, from_f = ts.make_fused_step()
    fs = to_f(st)
    prm, _ = F.make_params(ts)
    sc = F._edge_frame(torch.as_tensor(_f32(s1.sc))) if prm.varsc else None
    dt = torch.tensor(float(s1.dt), dtype=torch.float32)
    frames, _ = F.update_reference(prm, fs.p, fs.T, fs.ux, fs.uy, sc, dt)
    out = from_f(F.FusedState(*frames, t=fs.t, dt=dt, sc=sc))
    # one f32 step against the JAX composable step (partly f64 under x64);
    # the random velocity kick of every_bc_kind makes gradients ~300/s whose
    # f32 cancellation costs one more digit
    tol = 1e-4 if name == "every_bc_kind" else 1e-5
    for f in ("rho", "rhoU", "rhoE"):
        assert _rel(getattr(s1, f), getattr(out, f).numpy()) < tol, f


@pytest.mark.parametrize("name", list(BOUNDS))
def test_ghosts_reference_matches_jax_ghost_pad(name):
    """Ghost rows and lanes (corners, inletOutlet, qgdFlux) of fresh frames
    against ghost_pad of the same interior under the JAX BCs."""
    js, _, s1, ts, _ = _one_jax_step(name)
    prm, prof = F.make_params(ts)
    U, _, T, p = js.primitives(s1)
    bc_U, bc_p, bc_T = js._bcs()
    for i, (a, side) in enumerate(js._flux_sides()):
        bc_p = bc_p.replace(a, side, jbc.FixedGradient(s1.pbc[i]))
    padded = [j_ghost_pad(p, jbc.resolve_inlet_outlet(bc_p, U, 2), js.mesh),
              j_ghost_pad(T, jbc.resolve_inlet_outlet(bc_T, U, 2), js.mesh)]
    Up = j_ghost_pad(U, jbc.resolve_inlet_outlet(bc_U, U, 2), js.mesh,
                     vector=True)
    padded += [Up[0], Up[1]]
    frames = []
    for ref in padded:
        f = torch.zeros(ref.shape, dtype=torch.float32)
        f[1:-1, 1:-1] = torch.as_tensor(_f32(ref[1:-1, 1:-1]))
        frames.append(f)
    side = torch.zeros((2, SHAPE[1] + 2), dtype=torch.float32)
    for i, (a, sd) in enumerate(js._flux_sides()):
        g = torch.as_tensor(_f32(s1.pbc[i])).reshape(-1)
        side[sd, 1:-1] = g if sd == 0 else -g
    F.ghosts_reference(prm, frames, side, torch.as_tensor(prof))
    for k, ref in enumerate(padded):
        assert _rel(ref, frames[k].numpy()) < 1e-6, F.FIELDS[k]


def test_wrappers_check_their_inputs():
    ts, s = tcases.supersonic_jet(shape=SHAPE, device="cpu")
    _, to_f, _ = ts.make_fused_step()
    fs = to_f(s)
    prm, _ = F.make_params(ts)
    with pytest.raises(TypeError):
        F.qgd2d_dt(prm, fs.T.double(), fs.ux, fs.uy, fs.dt)
    with pytest.raises(ValueError):
        F.qgd2d_dt(prm, fs.T[:-1], fs.ux, fs.uy, fs.dt)
    with pytest.raises(ValueError):
        F.qgd2d_dt(prm, fs.T.t().contiguous().t(), fs.ux, fs.uy, fs.dt)
    launches = [k.launches for k in F.KERNELS]
    F.qgd2d_dt(prm, fs.T, fs.ux, fs.uy, fs.dt)
    assert [k.launches for k in F.KERNELS] == launches, \
        "the plain version on the CPU is not a launch"


@pytest.mark.parametrize("name", ["supersonic_jet", "supersonic_jet_varsc"])
def test_nan_T_cell_gives_nan_dt_like_jax(name):
    """One cell's energy NaN, so its T in the frame: the port's plain dt,
    its dt quad and both of `emit_reference`'s rates are NaN, as is the
    JAX package's dt from its fused step and from its composable step
    (both fold with jnp.max).  The kernels' folds follow the plain versions
    (a `gpu` test)."""
    js, jst, ts, st = _build(name)
    idx = (7, 5)
    jst = jst._replace(rhoE=jst.rhoE.at[idx].set(jnp.nan))
    rhoE = st.rhoE.clone()
    rhoE[idx] = float("nan")
    fs = F.build_fused_step(ts)[1](st._replace(rhoE=rhoE))
    assert bool(torch.isnan(fs.T[idx[0] + 1, idx[1] + 1]))
    assert int(torch.isnan(fs.T).sum()) == 1
    prm, _ = F.make_params(ts)
    assert bool(torch.isnan(F.dt_reference(prm, fs.T, fs.ux, fs.uy, fs.dt)))
    assert bool(torch.isnan(F.dt_fold_reference(prm, fs.T, fs.ux,
                                                fs.uy)).any())
    sc = F._edge_frame(fs.sc[1:-1, 1:-1]) if prm.varsc else None
    rates = F.emit_reference(prm, fs.p, fs.T, fs.ux, fs.uy, sc)[:2]
    assert all(bool(torch.isnan(r)) for r in rates)
    jstep, jto, jfrom = js.make_fused_step()
    assert np.isnan(float(jfrom(jax.jit(jstep)(jto(jst))).dt))
    assert np.isnan(float(jax.jit(js.make_step())(jst).dt))


def _ghosts_one_launch_model(prm, frames, side, profiles):
    """A model of `qgd2d_ghosts`' one launch: every ghost cell of copies of
    the frames computed by the kernel's composition from the input's
    interior cells (and a partition's halo) alone: an x-ghost from the
    interior rows, a y-ghost from two values after the x phase (on a
    physical x-ghost row, x-ghosts computed on the spot).  No ghost that
    the model writes is read."""
    nx, ny = prm.nx, prm.ny
    src = [f.clone() for f in frames]
    out = [f.clone() for f in frames]
    ux, uy = src[2], src[3]
    extrap = F.KINDS["extrap"]

    def ghost(e, in1, in2, d, v, un, sd):
        # in2 is read only by an extrapolated ghost
        return FC.bc_ghost(e, in1, in2() if e.kind == extrap else None, d,
                           v, un, sd)

    def x_ghost(f, sd, s):
        e = prm.bc[f][0][sd]
        r1, r2 = (1, 2) if sd == 0 else (nx, nx - 1)
        in1 = src[f][r1, s]
        if e.kind == F.KINDS["qgdflux"]:
            q = side[sd, s] * prm.dx
            return in1 + q if sd == 0 else in1 - q
        v = profiles[e.prof, s] if e.prof >= 0 else e.value
        return ghost(e, in1, lambda: src[f][r2, s], prm.dx, v, ux[r1, s],
                     sd)

    def x_value(f, r, s):
        if r == 0 and prm.edge_lo:
            return x_ghost(f, 0, s)
        if r == nx + 1 and prm.edge_hi:
            return x_ghost(f, 1, s)
        return src[f][r, s]

    def y_ghost(f, sd, r):
        e = prm.bc[f][1][sd]
        l1, l2 = (1, 2) if sd == 0 else (ny, ny - 1)
        v = profiles[e.prof, r] if e.prof >= 0 else e.value
        return ghost(e, x_value(f, r, l1), lambda: x_value(f, r, l2), prm.dy,
                     v, uy[min(max(r, 1), nx), l1], sd)

    for f in range(4):
        for sd, phys in ((0, prm.edge_lo), (1, prm.edge_hi)):
            if phys:
                for s in range(1, ny + 1):
                    out[f][0 if sd == 0 else nx + 1, s] = x_ghost(f, sd, s)
        for sd, phys in ((0, prm.edge_lo_y), (1, prm.edge_hi_y)):
            if phys:
                for r in range(nx + 2):
                    out[f][r, 0 if sd == 0 else ny + 1] = y_ghost(f, sd, r)
    return out


@pytest.mark.parametrize("kind", ["jet", "varsc", "every", "zg", "fixed",
                                  "grad", "sym", "extrap", "io"])
def test_ghosts_one_launch_model_equals_ghosts_reference(kind):
    """The one-launch composition of `qgd2d_ghosts` (each ghost from
    interior cells: `_ghosts_one_launch_model`) equals `ghosts_reference`
    (x-ghost rows, then y-ghost lanes of every row) bit for bit, for the
    jet's BCs (the array inlet), the varsc jet's (qgdFlux), every BC kind
    the kernels take (array values on y sides too) and each BC kind on
    every side, under all 16 edge-flag sets.  The ghost cells that the
    launch writes hold NaN in the input, and neither reads them: no NaN
    comes out."""
    import itertools

    from test_torch_gpu import one_kind_on_sides, random_frames_2d

    shape = (3, 4)
    if kind == "every":
        ts, _ = _every_bc_kind(tcases, tbc, torch.float32, torch.as_tensor,
                               device="cpu")
        shape = SHAPE
    else:
        base = "supersonic_jet_varsc" if kind == "varsc" else \
            "supersonic_jet"
        ts, _ = getattr(tcases, base)(shape=shape, device="cpu")
        if kind not in ("jet", "varsc"):
            ts = one_kind_on_sides(ts, tbc, kind, (0, 1))
    prm, prof = F.make_params(ts)
    prof = torch.as_tensor(prof)
    frames = random_frames_2d(shape, 9)
    rng = np.random.default_rng(9)
    side = torch.as_tensor(rng.uniform(-5.0, 5.0, (2, shape[1] + 2))
                           .astype(np.float32))
    nx = shape[0]
    for flags in itertools.product((1, 0), repeat=4):
        (prm.edge_lo, prm.edge_hi, prm.edge_lo_y, prm.edge_hi_y) = flags
        fr = [f.clone() for f in frames]
        for f in fr:
            for r, phys in ((0, flags[0]), (nx + 1, flags[1])):
                if phys:
                    f[r, 1:-1] = float("nan")
            for lane, phys in ((0, flags[2]), (-1, flags[3])):
                if phys:
                    f[:, lane] = float("nan")
        model = _ghosts_one_launch_model(prm, fr, side, prof)
        ref = F.ghosts_reference(prm, [f.clone() for f in fr], side, prof)
        for k in range(4):
            assert not bool(torch.isnan(ref[k]).any()), (flags, F.FIELDS[k])
            assert torch.equal(model[k], ref[k]), (flags, F.FIELDS[k])


@pytest.mark.parametrize("grid,shape,axis,taken", [
    ((2, 1), (2, 8), 0, False), ((1, 2), (8, 2), 1, False),
    ((2, 2), (4, 2), 1, False), ((2, 1), (4, 8), 0, True),
    ((2, 1), (2, 8), 1, True), ((1, 2), (8, 2), 0, True)])
def test_sharded_gate_refuses_one_cell_blocks_with_extrapolation(
        grid, shape, axis, taken):
    """K3's gate: a block of one cell along a partitioned axis with an
    extrapolated side there reads its halo at ghost time, before the
    exchange fills it, so `sharded_supported` refuses it (and
    `build_sharded_fused_step` raises); blocks of two cells, and an
    extrapolated axis that is not partitioned into one-cell blocks, are
    taken."""
    from qgdsolver_tpu_torch.parallel import sharding

    ts, _ = tcases.supersonic_jet(shape=shape, device="cpu")
    ts = dataclasses.replace(ts, bc_T=ts.bc_T.replace(
        axis, 0, tbc.Extrapolated()).replace(axis, 1, tbc.Extrapolated()))
    g = sharding.ProcessGrid(*grid)
    assert F.supported(ts)
    assert F.sharded_supported(ts, g) is taken
    if not taken:
        with pytest.raises(ValueError, match="not supported"):
            F.build_sharded_fused_step(ts, g)
