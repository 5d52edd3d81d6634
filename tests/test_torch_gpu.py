"""CUDA kernels of the fused 2D (K1, K2's `qgd2d_emit` and `qgd2d_smooth`)
and 3D steps (with `qgd3d_emit` and `qgd3d_smooth`) against their plain
torch versions, on
the card, at the production sizes (1024x512 and 256x126x126 f32), from a
state after 20 plain steps, and the smoothing kernels on ragged shapes;
the division-free ring against a correctly rounded division
(`smooth_ring_check`), the plain `fvc_smooth` on the card against the
CPU's, the ring kernels' NaN cells against the plain versions', and the
composable implicit-diffusion step (its CG) on the card against the CPU.
Marked `gpu`: they skip where no CUDA device exists.  Run them on the card
with `python -m pytest tests/test_torch_gpu.py -m gpu -q`.

Bounds: dt, ghosts, the emitted rates and the 3D raw sensor rtol 1e-6 (a
reduction of exact max/min; selects plus one FMA; the CPU's sqrt is not
always correctly rounded); the 2D emitted sensor, the 3D emitted ring 1
(of the kernel's own raw sensor) and the smoothing rings bitwise; one
update step within 1e-5 of
each field's max (rsqrtf and FMA contraction); 10 lock-step steps within
the JAX fused tests' bounds.  The decomposed steps K3 and K5 run on two
ranks that share cuda:0 over gloo and must equal the serial kernel path
bit for bit (the same kernels on the same cells; max/min folds are exact).
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from qgdsolver_tpu_torch import cases
from qgdsolver_tpu_torch.core import bc
from qgdsolver_tpu_torch.ops import fused_qgd2d as F
from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
from qgdsolver_tpu_torch.ops import smoothing as S
from qgdsolver_tpu_torch.solvers import common

pytestmark = pytest.mark.gpu

SHAPE = (1024, 512)
CASES = ["supersonic_jet", "supersonic_jet_varsc"]
SHAPE3 = (256, 126, 126)
CASES3 = ["supersonic_duct_3d", "supersonic_jet_3d_varsc"]


def every_bc_kind_3d(cases_mod, bcm, shape, dtype, xp, **kw):
    """The 3D varsc jet with every BC kind the 3D kernels take on some side:
    extrapolated, symmetry, inletOutlet (scalar and plane), fixed gradient
    (scalar and plane), fixed value, the array inlet and qgdFlux.  Built
    the same way from either package's `cases` and `bc` modules (`kw`: the
    port's `device`)."""
    solver, state = cases_mod.supersonic_jet_3d_varsc(shape=shape,
                                                      dtype=dtype, **kw)
    ny, nz = shape[1], shape[2]
    plane = 1e5 + 100.0 * np.sin(np.arange(ny * nz)).reshape(1, ny, nz)
    solver = dataclasses.replace(
        solver,
        bc_U=bcm.FieldBCs((
            (solver.bc_U[0, 0], bcm.Extrapolated()),
            (bcm.Symmetry(), bcm.InletOutlet(xp(np.array([0.0, -30.0, 5.0])))),
            (bcm.InletOutlet(xp(np.array([1.0, 2.0, 3.0]))), bcm.Symmetry()))),
        bc_p=bcm.FieldBCs((
            (bcm.FixedGradient(xp(plane * 1e-3)), bcm.QGDFluxP()),
            (bcm.Symmetry(), bcm.FixedValue(1e5)),
            (bcm.FixedGradient(3.0), bcm.InletOutlet(xp(1e5))))),
        bc_T=bcm.FieldBCs((
            (bcm.FixedValue(300.0), bcm.Extrapolated()),
            (bcm.InletOutlet(310.0), bcm.FixedGradient(2.0)),
            (bcm.ZeroGradient(), bcm.FixedValue(305.0)))))
    return solver, state


# the BC kinds the 3D ghosts take on a y or z side
YZ_KINDS = ("zg", "fixed", "grad", "sym", "extrap", "io")


def one_kind_on_sides(solver, bcm, kind, axes=(1, 2), xp=torch.as_tensor):
    """The solver (2D or 3D) with BC `kind` on both sides of each axis in
    `axes`, for every field (values that differ by side, so a ghost shows
    which side it came from; inletOutlet switches both ways on random
    velocities)."""
    ndim = solver.mesh.ndim
    vals = {"U": ([20.0, -10.0, 5.0], [-5.0, 30.0, -15.0]),
            "p": (1.01e5, 0.99e5), "T": (310.0, 290.0)}
    grads = {"U": ([1.0, -2.0, 3.0], [-3.0, 2.0, 1.0]), "p": (50.0, -30.0),
             "T": (2.0, -1.5)}

    def wrap(x):
        x = x[:ndim] if isinstance(x, list) else x
        return xp(np.asarray(x, np.float32)) if np.ndim(x) else float(x)

    def make(field, sd):
        if kind in ("zg", "sym", "extrap"):
            return {"zg": bcm.ZeroGradient, "sym": bcm.Symmetry,
                    "extrap": bcm.Extrapolated}[kind]()
        v = wrap(vals[field][sd])
        return {"fixed": lambda: bcm.FixedValue(v),
                "grad": lambda: bcm.FixedGradient(wrap(grads[field][sd])),
                "io": lambda: bcm.InletOutlet(v)}[kind]()

    def sides(old, field):
        return bcm.FieldBCs(tuple(
            (make(field, 0), make(field, 1)) if a in axes
            else (old[a, 0], old[a, 1]) for a in range(ndim)))

    return dataclasses.replace(solver, bc_U=sides(solver.bc_U, "U"),
                               bc_p=sides(solver.bc_p, "p"),
                               bc_T=sides(solver.bc_T, "T"))


def random_frames(shape, seed, device="cpu"):
    """Ghost-padded f32 frames p, T, ux, uy, uz of plausible magnitudes
    (velocities of either sign), made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    fs = tuple(n + 2 for n in shape)
    lims = ((0.9e5, 1.1e5), (250.0, 350.0)) + ((-60.0, 60.0),) * 3
    return [torch.as_tensor(rng.uniform(lo, hi, fs).astype(np.float32),
                            device=device) for lo, hi in lims]


def random_frames_2d(shape, seed, device="cpu"):
    """`random_frames`' p, T, ux and uy on a 2D (nx, ny) mesh."""
    return [f[..., 1].contiguous()
            for f in random_frames(tuple(shape) + (1,), seed, device)[:4]]


def extrap_on_one_cell(prm):
    """True where the fused 3D step must refuse the BCs: an extrapolated
    side on an axis of one cell whose two ends are physical."""
    n = (prm.nx, prm.ny, prm.nz)
    both = (prm.edge_lo and prm.edge_hi, True, True)
    return any(prm.bc[f][a][sd].kind == F.KINDS["extrap"] and n[a] < 2
               and both[a] for f in range(5) for a in range(3)
               for sd in (0, 1))


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))


def _warm(name, device):
    solver, state = getattr(cases, name)(shape=SHAPE, device=device)
    step, to_f, _ = F.build_fused_step(solver, plain=True)
    fs = to_f(state)
    for _ in range(20):
        fs = step(fs)
    return solver, fs


@pytest.mark.parametrize("name", CASES)
def test_kernels_match_plain_versions(name, device):
    solver, fs = _warm(name, device)
    prm, prof = F.make_params(solver)
    prof = solver.mesh.tensor(prof).contiguous()
    sc = None
    if prm.varsc:
        rho = solver.thermo.rho_from_p_T(fs.p[1:-1, 1:-1], fs.T[1:-1, 1:-1])
        sc = F._edge_frame(solver.tau_model.sc_update(solver.mesh, rho,
                                                      fs.sc[1:-1, 1:-1]))
    dt_ref = F.dt_reference(prm, fs.T, fs.ux, fs.uy, fs.dt)
    dt_k = F.qgd2d_dt(prm, fs.T, fs.ux, fs.uy, fs.dt)
    torch.testing.assert_close(dt_k, dt_ref, rtol=1e-6, atol=0.0)

    args = (fs.p, fs.T, fs.ux, fs.uy, sc, dt_ref)
    ref, side_ref = F.update_reference(prm, *args)
    new, side = F.qgd2d_update(prm, *args)
    for k in range(4):
        assert _rel(ref[k][1:-1, 1:-1], new[k][1:-1, 1:-1]) <= 1e-5, \
            F.FIELDS[k]
    if solver._flux_sides():
        assert _rel(side_ref[:, 1:-1], side[:, 1:-1]) <= 1e-5

    fa = [x.clone() for x in ref]
    fb = [x.clone() for x in ref]
    F.ghosts_reference(prm, fa, side_ref, prof)
    F.qgd2d_ghosts(prm, fb, side_ref, prof)
    for k in range(4):
        assert _rel(fa[k], fb[k]) <= 1e-6, F.FIELDS[k]


@pytest.mark.parametrize("name,dt_tol,f_tol",
                         [("supersonic_jet", 1e-6, 1e-3),
                          ("supersonic_jet_varsc", 1e-5, 2e-3)])
def test_kernel_path_tracks_plain_path(name, dt_tol, f_tol, device):
    solver, fs = _warm(name, device)
    k_step, _, from_f = F.build_fused_step(solver)
    p_step, _, _ = F.build_fused_step(solver, plain=True)
    a = b = fs
    for _ in range(10):
        a, b = k_step(a), p_step(b)
    sa, sb = from_f(a), from_f(b)
    torch.testing.assert_close(sa.dt, sb.dt, rtol=dt_tol, atol=0.0)
    for f in ("rho", "rhoU", "rhoE"):
        assert _rel(getattr(sb, f), getattr(sa, f)) <= f_tol, f


@pytest.mark.parametrize("name,want", [
    ("supersonic_jet", [20, 20, 20, 0, 0]),
    # K2's path: qgd2d_emit once per step plus once in to_fused, no qgd2d_dt;
    # qgd2d_smooth at least once per step and once in to_fused
    ("supersonic_jet_varsc", [0, 20, 20, 21, 21])])
def test_main_path_launches_each_kernel_once_per_step(name, want, device):
    solver, state = getattr(cases, name)(shape=SHAPE, device=device)
    step, to_f, from_f = solver.make_fused_step()
    for k in F.KERNELS:
        k.launches = 0
    s = from_f(common.run_steps(step, to_f(state), 20))
    got = [k.launches for k in F.KERNELS]
    assert got[:4] == want[:4] and got[4] >= want[4], got
    assert bool(torch.isfinite(s.rho).all()) and bool((s.rho > 0).all())


@pytest.mark.parametrize("kind", ("case",) + YZ_KINDS)
@pytest.mark.parametrize("shape", [(nx, ny) for nx in (2, 3, 17, 33, 130)
                                   for ny in (2, 3, 17, 33, 130)])
def test_2d_dt_and_ghosts_on_ragged_shapes(shape, kind, device):
    """qgd2d_dt, qgd2d_dt_fold and qgd2d_ghosts where nx and ny are 2, 3,
    17, 33 or 130 (none a multiple of the dt kernel's 31-lane strip or its
    chunk of rows), on random frames, for the jet (constScPrModel1) and
    the varsc jet (varScModel5 and qgdFlux), each with its own BCs or with
    one BC kind on every side of every field (the varsc jet's y sides),
    under all 16 edge-flag sets (edge_lo, edge_hi, edge_lo_y, edge_hi_y):
    dt and each quad entry within rtol 1e-6 of the plain versions, the
    ghost-filled frames within 1e-6 of each field's max, as phase 3 of
    chip_smoke.py holds them."""
    for base, seed in (("supersonic_jet", 1), ("supersonic_jet_varsc", 2)):
        solver, _ = getattr(cases, base)(shape=shape, device=device)
        if kind != "case":
            axes = (0, 1) if base == "supersonic_jet" else (1,)
            solver = one_kind_on_sides(solver, bc, kind, axes)
        assert F.supported(solver)
        prm, prof = F.make_params(solver)
        prof = solver.mesh.tensor(prof).contiguous()
        frames = random_frames_2d(shape, seed, device)
        rng = np.random.default_rng(seed)
        side = torch.as_tensor(rng.uniform(-5.0, 5.0, (2, shape[1] + 2))
                               .astype(np.float32), device=device)
        dt = torch.tensor(1e-7, dtype=torch.float32, device=device)
        for flags in itertools.product((1, 0), repeat=4):
            (prm.edge_lo, prm.edge_hi, prm.edge_lo_y,
             prm.edge_hi_y) = flags
            where = (base, kind, flags)
            torch.testing.assert_close(
                F.qgd2d_dt(prm, *frames[1:], dt),
                F.dt_reference(prm, *frames[1:], dt), rtol=1e-6, atol=0.0,
                msg=lambda m: f"{where}: {m}")
            quad = F.dt_fold_reference(prm, *frames[1:])
            got = F.qgd2d_dt_fold(prm, *frames[1:])
            assert float(((got - quad).abs() / quad.abs().clamp(min=1e-30))
                         .max()) <= 1e-6, (where, got, quad)
            a = F.qgd2d_ghosts(prm, [f.clone() for f in frames], side, prof)
            b = F.ghosts_reference(prm, [f.clone() for f in frames], side,
                                   prof)
            for k in range(4):
                assert _rel(b[k], a[k]) <= 1e-6, (where, F.FIELDS[k])


def test_2d_dt_calls_back_to_back_are_each_their_own(device):
    """Three qgd2d_dt and qgd2d_dt_fold calls on different frames, launched
    back to back (and three more on a second stream beside them), each
    bitwise the same call made alone: the kernel's ticket starts each call
    from 0 and no two streams share a workspace."""
    shape = (130, 97)
    solver, _ = cases.supersonic_jet_varsc(shape=shape, device=device)
    prm, _ = F.make_params(solver)
    frames = [random_frames_2d(shape, seed, device) for seed in (3, 4, 5)]
    dt = torch.tensor(1e-7, dtype=torch.float32, device=device)
    other = torch.cuda.Stream(device)
    other.wait_stream(torch.cuda.current_stream(device))
    together = []
    for fr in frames:
        together.append((F.qgd2d_dt(prm, *fr[1:], dt),
                         F.qgd2d_dt_fold(prm, *fr[1:])))
    with torch.cuda.stream(other):
        beside = [(F.qgd2d_dt(prm, *fr[1:], dt),
                   F.qgd2d_dt_fold(prm, *fr[1:])) for fr in frames[::-1]]
    torch.cuda.synchronize()
    beside = beside[::-1]
    for fr, got, got2 in zip(frames, together, beside):
        alone = F.qgd2d_dt(prm, *fr[1:], dt)
        torch.cuda.synchronize()
        quad = F.qgd2d_dt_fold(prm, *fr[1:])
        torch.cuda.synchronize()
        for g in (got, got2):
            assert torch.equal(g[0], alone) and torch.equal(g[1], quad)
    assert len({tuple(g[1].tolist()) for g in together}) == 3


def _warm_tiled(name, device, shape=SHAPE):
    solver, state = getattr(cases, name)(shape=shape, device=device)
    step, to_f, _ = F.build_tiled_fused_step(solver, plain=True)
    ts = to_f(state)
    for _ in range(20):
        ts = step(ts)
    return solver, ts


@pytest.mark.parametrize("name", CASES)
def test_emit_kernel_matches_plain_version(name, device):
    """qgd2d_emit against emit_reference on the fresh frames of a warm K2
    state: rates rtol 1e-6 (rsqrtf); the sensor, ring 1 and the flag
    bitwise (explicit roundings in the kernel)."""
    solver, ts = _warm_tiled(name, device)
    prm, _ = F.make_params(solver)
    args = (prm, ts.p, ts.T, ts.ux, ts.uy, ts.sc)
    ref = F.emit_reference(*args)
    got = F.qgd2d_emit(*args)
    torch.cuda.synchronize()
    for a, b in zip(ref[:2], got[:2]):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=0.0)
    if prm.varsc:
        for a, b in zip(ref[2:], got[2:]):
            assert torch.equal(a, b)
    else:
        assert got[2:] == (None, None, None)


@pytest.mark.parametrize("name,dt_tol,f_tol",
                         [("supersonic_jet", 1e-6, 1e-3),
                          ("supersonic_jet_varsc", 1e-5, 2e-3)])
def test_tiled_kernel_path_tracks_plain_path(name, dt_tol, f_tol, device):
    solver, ts = _warm_tiled(name, device)
    k_step, _, from_f = F.build_tiled_fused_step(solver)
    p_step, _, _ = F.build_tiled_fused_step(solver, plain=True)
    a = b = ts
    for _ in range(10):
        a, b = k_step(a), p_step(b)
    sa, sb = from_f(a), from_f(b)
    torch.testing.assert_close(sa.dt, sb.dt, rtol=dt_tol, atol=0.0)
    for f in ("rho", "rhoU", "rhoE", "sc"):
        assert _rel(getattr(sb, f), getattr(sa, f)) <= f_tol, f


def test_tiled_main_path_launches_emit_once_per_step(device):
    """make_fused_step takes K2's builder for the varsc jet: qgd2d_emit once
    per step (and once for the initial rates), never qgd2d_dt."""
    solver, state = cases.supersonic_jet_varsc(shape=SHAPE, device=device)
    assert solver.fused_builder() is F.build_tiled_fused_step
    step, to_f, from_f = solver.make_fused_step()
    F.qgd2d_emit.launches = F.qgd2d_dt.launches = 0
    ts = common.run_steps(step, to_f(state), 15)
    assert (F.qgd2d_emit.launches, F.qgd2d_dt.launches) == (16, 0)
    s = from_f(ts)
    assert bool(torch.isfinite(s.sc).all()) and float(s.sc.min()) >= 0.05


@pytest.mark.parametrize("k", sorted({0, 1, 3, 8, F.SMOOTH_RINGS,
                                      F.SMOOTH_KMAX}))
@pytest.mark.parametrize("shape", [(100, 261), (37, 13), (130, 131),
                                   (256, 128)])
def test_smooth_kernel_on_ragged_shapes(shape, k, device):
    """qgd2d_smooth where (nx, ny) are no multiples of its tile (and where
    they are: a tile of no ring then ends on the edge), on cells and on a
    frame, bitwise its plain version (cells, ghosts and the last-ring
    flag); and the K2 continuation on it bitwise the same loop on the plain
    version, to the fixed point.  k covers every ring count that is timed
    (8 and SMOOTH_RINGS) and odd counts (1, 3), on which the kernel's two
    shared row buffers end on the other buffer."""
    prm = F.make_params(cases.supersonic_jet_varsc(shape=shape,
                                                   device=device)[0])[0]
    rng = np.random.default_rng(11)
    raw = rng.uniform(0.05, 1.0, shape).astype(np.float32)
    raw[rng.integers(0, shape[0], 4), rng.integers(0, shape[1], 4)] = 5.0
    f = torch.as_tensor(raw, device=device)
    for src in (f, F._edge_frame(f)):
        out, flag = F.qgd2d_smooth(prm, src, k)
        cells, ref_flag = S.smooth_reference(prm, f, k)
        assert torch.equal(out, F._edge_frame(cells))
        assert float(flag) == float(ref_flag)
    s1, chg = S.smooth_reference(prm, f, 1)
    got = S.smooth_sensor(prm, s1, chg, F.qgd2d_smooth, k)
    ref = S.smooth_sensor(prm, s1, chg, S._smooth_plain, k)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("name,shape", [("supersonic_jet_varsc", (45, 37)),
                                        ("supersonic_jet", (130, 200))])
def test_update_on_ragged_shapes(name, shape, device):
    """qgd2d_update where the mesh is no multiple of its 63-lane strip or
    its row chunk: within 1e-5 of each field's max of the plain version
    (the qgdFlux side rows too); and on K3 blocks cut off the chunk grid,
    flagged at their partition edges, bit for bit the serial kernel's
    window."""
    from qgdsolver_tpu_torch.ops import _build

    solver, ts = _warm_tiled(name, device, shape)
    prm, _ = F.make_params(solver)
    sc = ts.sc if prm.varsc else None
    frames = (ts.p, ts.T, ts.ux, ts.uy)
    ref, side_ref = F.update_reference(prm, *frames, sc, ts.dt)
    new, side = F.qgd2d_update(prm, *frames, sc, ts.dt)
    C = (slice(1, -1),) * 2
    for k in range(4):
        assert _rel(ref[k][C], new[k][C]) <= 1e-5, F.FIELDS[k]
    if solver._flux_sides():
        assert _rel(side_ref[:, 1:-1], side[:, 1:-1]) <= 1e-5
    nx, ny = prm.nx, prm.ny
    for (ox, n), (oy, m) in (((0, nx // 2 + 3), (0, ny)),
                             ((5, nx // 2), (7, ny - 7)),
                             ((nx // 2 + 3, nx - nx // 2 - 3),
                              (0, ny // 2 + 1))):
        blk = _build.QGDParams.from_buffer_copy(prm)
        blk.nx, blk.ny = n, m
        blk.edge_lo, blk.edge_hi = int(ox == 0), int(ox + n == nx)
        blk.edge_lo_y, blk.edge_hi_y = int(oy == 0), int(oy + m == ny)
        win = (slice(ox, ox + n + 2), slice(oy, oy + m + 2))
        cut = [f[win].contiguous() for f in frames]
        got, _ = F.qgd2d_update(blk, *cut, None if sc is None
                                else sc[win].contiguous(), ts.dt)
        for k in range(4):
            assert torch.equal(new[k][win][C], got[k][C]), (ox, oy, k)


def test_k2_main_path_counts_rings_and_launches(device):
    """K2's path on a varsc jet with a density spike (the sensor active):
    per step one update, ghosts and emit launch, one host read of the
    emitted flag plus one per qgd2d_smooth launch, and every ring counted
    by the wrapper; the result within the plain path's bounds."""
    shape = (512, 256)
    solver, state = cases.supersonic_jet_varsc(shape=shape, device=device)
    band = torch.ones(shape[0], device=device)
    band[shape[0] // 3] = 3.5
    state = state._replace(rho=state.rho * band[:, None],
                           rhoE=state.rhoE * band[:, None])
    step, to_f, from_f = solver.make_fused_step()
    ts = to_f(state)
    for k in F.KERNELS:
        k.launches = 0
    F.qgd2d_smooth.rings = S.smooth_sensor.rings = S.smooth_sensor.reads = 0
    n = 10
    s = from_f(common.run_steps(step, ts, n))
    launches = {k.__name__: k.launches for k in F.KERNELS}
    assert launches["qgd2d_update"] == launches["qgd2d_ghosts"] == n
    assert launches["qgd2d_emit"] == n and launches["qgd2d_dt"] == 0
    assert F.qgd2d_smooth.rings == S.smooth_sensor.rings > 0
    # one read of the emitted flag a step, one per launch of rings: at most
    # the 1 + rings/4 of a host loop testing every fourth ring
    assert n < S.smooth_sensor.reads <= n + S.smooth_sensor.rings // 4
    assert F.qgd2d_smooth.rings <= F.SMOOTH_RINGS * launches["qgd2d_smooth"]
    p_step, p_to, p_from = F.build_tiled_fused_step(solver, plain=True)
    b = p_from(common.run_steps(p_step, p_to(state), n))
    for f in ("rho", "rhoU", "rhoE", "sc"):
        assert _rel(getattr(b, f), getattr(s, f)) <= 2e-3, f


def _step_sensor(prm, fs):
    """The sensor frame the next 3D varsc step uses: fvc_smooth of the raw
    sensor, from the carried first ring and flag, in plain torch."""
    return S.smooth_sensor(prm, fs.sc_s1, fs.sc_chg, S._smooth_plain,
                           F3.SMOOTH3_RINGS)


def _check_emit(prm, p, T, sc):
    """qgd3d_emit against its plain version: the raw sensor within rtol
    1e-6, ring 1 and the flag bitwise the plain ring of the kernel's own
    raw sensor, the same ring and flag without the raw sensor, and
    qgd3d_sensor (the raw-only mode) bitwise the emit's raw sensor."""
    raw, s1, chg = F3.qgd3d_emit(prm, p, T, sc, raw=True)
    assert _rel(F3.sensor_reference_3d(prm, p, T, sc), raw) <= 1e-6
    cells, flag = F3.smooth_reference_3d(prm, raw, 1)
    assert torch.equal(s1, F._edge_frame(cells))
    assert float(chg) == float(flag)
    got = F3.qgd3d_emit(prm, p, T, sc)
    assert got[0] is None and torch.equal(got[1], s1)
    assert float(got[2]) == float(chg)
    assert torch.equal(F3.qgd3d_sensor(prm, p, T, sc), raw)
    return raw, s1, chg


def _warm3(name, device, shape=SHAPE3):
    if name == "every_bc_kind_3d":
        solver, state = every_bc_kind_3d(cases, bc, shape, torch.float32,
                                         torch.as_tensor, device=device)
    else:
        solver, state = getattr(cases, name)(shape=shape, device=device)
    step, to_f, _ = F3.build_fused_step_3d(solver, plain=True)
    fs = to_f(state)
    for _ in range(20):
        fs = step(fs)
    return solver, fs


@pytest.mark.parametrize("name", CASES3 + ["every_bc_kind_3d"])
def test_3d_kernels_match_plain_versions(name, device):
    solver, fs = _warm3(name, device)
    prm, planes = F3.make_params(solver)
    planes = solver.mesh.tensor(planes).contiguous()
    dts = (fs.T, fs.ux, fs.uy, fs.uz, fs.dt)
    dt_ref = F3.dt_reference_3d(prm, *dts)
    torch.testing.assert_close(F3.qgd3d_dt(prm, *dts), dt_ref, rtol=1e-6,
                               atol=0.0)
    sc = _step_sensor(prm, fs) if prm.varsc else None
    args = (fs.p, fs.T, fs.ux, fs.uy, fs.uz, sc, dt_ref)
    ref, side_ref = F3.update_reference_3d(prm, *args)
    new, side = F3.qgd3d_update(prm, *args)
    C = (slice(1, -1),) * 3
    for k in range(5):
        assert _rel(ref[k][C], new[k][C]) <= 1e-5, F3.FIELDS[k]
    if solver._flux_sides():
        assert _rel(side_ref, side) <= 1e-5
    if prm.varsc:
        _check_emit(prm, ref[0], ref[1], sc)
    fa = [x.clone() for x in ref]
    fb = [x.clone() for x in ref]
    F3.ghosts_reference_3d(prm, fa, side_ref, planes)
    F3.qgd3d_ghosts(prm, fb, side_ref, planes)
    for k in range(5):
        assert _rel(fa[k], fb[k]) <= 1e-6, F3.FIELDS[k]


@pytest.mark.parametrize("name,shape", [("supersonic_duct_3d", (37, 13, 45)),
                                        ("every_bc_kind_3d", (20, 10, 9)),
                                        ("supersonic_jet_3d_varsc",
                                         (70, 21, 40))])
def test_3d_update_on_ragged_shapes(name, shape, device):
    """qgd3d_update where the mesh is no multiple of the kernel's (12, 32)
    tile or of its chunk (16 or 32 planes, from the grid: 70 planes make
    five of 16, the last of 6), and a frame row (nz + 2 floats) is no
    multiple of 16 bytes: within 1e-5
    of each field's max of the plain
    version; and on x-slabs whose offsets are no multiple of the chunk,
    flagged at their partition planes, bit for bit the serial kernel's
    window (the qgdFlux side rows too where a slab end is physical)."""
    from qgdsolver_tpu_torch.ops import _build

    solver, fs = _warm3(name, device, shape)
    prm, _ = F3.make_params(solver)
    sc = _step_sensor(prm, fs) if prm.varsc else None
    frames = (fs.p, fs.T, fs.ux, fs.uy, fs.uz)
    ref, side_ref = F3.update_reference_3d(prm, *frames, sc, fs.dt)
    new, side = F3.qgd3d_update(prm, *frames, sc, fs.dt)
    C = (slice(1, -1),) * 3
    for k in range(5):
        assert _rel(ref[k][C], new[k][C]) <= 1e-5, F3.FIELDS[k]
    if solver._flux_sides():
        assert _rel(side_ref, side) <= 1e-5
    nx = prm.nx
    half = nx // 2 + 3
    for off, n in ((0, half), (half, nx - half), (5, nx // 2)):
        blk = _build.QGD3DParams.from_buffer_copy(prm)
        blk.nx, blk.edge_lo, blk.edge_hi = n, int(off == 0), int(off + n == nx)
        win = (slice(off, off + n + 2),)
        cut = [f[win].contiguous() for f in frames]
        got, got_side = F3.qgd3d_update(blk, *cut, None if sc is None
                                        else sc[win].contiguous(), fs.dt)
        for k in range(5):
            assert torch.equal(new[k][win][C], got[k][C]), (off, F3.FIELDS[k])
        for sd, phys in ((0, blk.edge_lo), (1, blk.edge_hi)):
            if phys:
                assert torch.equal(side[sd], got_side[sd]), (off, sd)


@pytest.mark.parametrize("name,dt_tol,f_tol",
                         [("supersonic_duct_3d", 1e-6, 1e-3),
                          ("supersonic_jet_3d_varsc", 1e-5, 2e-3)])
def test_3d_kernel_path_tracks_plain_path(name, dt_tol, f_tol, device):
    solver, fs = _warm3(name, device)
    k_step, _, from_f = F3.build_fused_step_3d(solver)
    p_step, _, _ = F3.build_fused_step_3d(solver, plain=True)
    a = b = fs
    for _ in range(10):
        a, b = k_step(a), p_step(b)
    sa, sb = from_f(a), from_f(b)
    torch.testing.assert_close(sa.dt, sb.dt, rtol=dt_tol, atol=0.0)
    for f in ("rho", "rhoU", "rhoE", "sc"):
        assert _rel(getattr(sb, f), getattr(sa, f)) <= f_tol, f


@pytest.mark.parametrize("name", CASES3)
def test_3d_main_path_launches_each_kernel_once_per_step(name, device):
    """dt, update, ghosts once per step; for the varsc jet at rest the emit
    once per step, with one host flag read a step and no `qgd3d_smooth`
    launch (its ring 1 is the fixed point); the duct launches neither, and
    no step launches `qgd3d_sensor` (K5's)."""
    solver, state = getattr(cases, name)(shape=SHAPE3, device=device)
    step, to_f, from_f = solver.make_fused_step()
    fs = to_f(state)
    kernels = F3.KERNELS + (F3.qgd3d_sensor,)
    for k in kernels:
        k.launches = 0
    reads = S.smooth_sensor.reads
    s = from_f(common.run_steps(step, fs, 10))
    reads = S.smooth_sensor.reads - reads
    varsc = F3.make_params(solver)[0].varsc
    got = {k.__name__: k.launches for k in kernels}
    assert got == {"qgd3d_dt": 10, "qgd3d_update": 10,
                   "qgd3d_emit": 10 if varsc else 0, "qgd3d_ghosts": 10,
                   "qgd3d_smooth": 0, "qgd3d_sensor": 0}
    assert reads == (10 if varsc else 0)
    assert bool(torch.isfinite(s.rho).all()) and bool((s.rho > 0).all())


def test_3d_main_path_with_a_bump_runs_the_rings(device):
    """The varsc jet with a density bump through the main path: the emit
    once a step, and where the carried flag is set `qgd3d_smooth`'s fixed
    point in its three launches instead of the rings (no ring, no
    fallback), one host flag read a step and one a fixed-point call, and
    each step's sensor frame fvc_smooth of the raw sensor the step before
    emitted."""
    from chip_smoke import with_bump

    solver, state = cases.supersonic_jet_3d_varsc(shape=SHAPE3, device=device)
    prm, _ = F3.make_params(solver)
    step, to_f, from_f = solver.make_fused_step()
    fs = step(to_f(with_bump(solver, state)))
    for k in F3.KERNELS:
        k.launches = 0
    F3.qgd3d_smooth.rings = F3.qgd3d_smooth.fixed = 0
    F3.qgd3d_smooth.fallbacks = 0
    reads = S.smooth_sensor.reads
    active = 0
    for _ in range(5):
        active += float(fs.sc_chg) == 1.0
        raw = F3.qgd3d_emit(prm, fs.p, fs.T, fs.sc, raw=True)[0]
        new = step(fs)
        assert torch.equal(new.sc, F._edge_frame(
            F3.fvc_smooth(raw, solver.tau_model.smoothCoeff)))
        fs = new
    reads = S.smooth_sensor.reads - reads
    got = {k.__name__: k.launches for k in F3.KERNELS}
    assert got["qgd3d_emit"] == 10 and got["qgd3d_dt"] == 5
    assert active >= 1 and F3.qgd3d_smooth.fixed == active
    assert got["qgd3d_smooth"] == F3.SMOOTH3_FIXED_LAUNCHES * active
    assert F3.qgd3d_smooth.rings == 0 and F3.qgd3d_smooth.fallbacks == 0
    assert reads == 5 + active
    s = from_f(fs)
    assert bool(torch.isfinite(s.rho).all()) and bool((s.rho > 0).all())


def test_3d_traced_segment_times_each_refill(device, tmp_path):
    """A segment of the bumped varsc jet on the main path, traced by
    `observability.trace`: a refill timed on CUDA events for each host flag
    read, positive and finite on the device's clock, read once the caller
    has synchronised; the spans are host events only, none on the device's
    timeline; the events kept follow the session's marker kernel."""
    import json

    from chip_smoke import with_bump
    from torch.autograd import DeviceType

    from qgdsolver_tpu_torch.utils import observability

    solver, state = cases.supersonic_jet_3d_varsc(shape=SHAPE3, device=device)
    step, to_f, _ = solver.make_fused_step()
    fs = step(to_f(with_bump(solver, state)))
    reads = S.smooth_sensor.reads
    with observability.trace(str(tmp_path)) as prof:
        common.run_steps(step, fs, 5)
        torch.cuda.synchronize()
    reads = S.smooth_sensor.reads - reads
    events = prof.events()
    assert not any("spin_kernel" in e.name for e in events)
    assert any("qgd3d_smooth" in e.name for e in events)
    spans = [e for e in events if e.name.startswith("qgd.")]
    assert {e.device_type for e in spans} == {DeviceType.CPU}
    assert sum(e.name == "qgd.flag_read" for e in spans) == reads
    seg = observability.segment_log()[-1]
    assert json.loads((tmp_path / "spans.json").read_text()) == [seg]
    assert seg["steps"] == 5 and seg["flag_reads"] == reads > 5
    assert seg["refills"] == reads
    assert 0.0 < seg["refill_us"] < float("inf")


@pytest.mark.parametrize("shape", [(1, 9, 126), (2, 1, 33), (17, 2, 31),
                                   (17, 9, 1), (37, 13, 45), (20, 40, 70)])
def test_3d_emit_on_ragged_shapes(shape, device):
    """qgd3d_emit where (nx, ny, nz) are no multiples of its (16, 32) tile
    or its x chunk (and axes of one cell), on random frames with a spike:
    as `_check_emit`; and qgd3d_sensor under each partition-edge pair
    within rtol 1e-6 of the flagged plain version."""
    from qgdsolver_tpu_torch.ops import _build

    prm = F3.make_params(cases.supersonic_jet_3d_varsc(shape=shape,
                                                       device=device)[0])[0]
    p, T = random_frames(shape, 21, device)[:2]
    p[tuple(n // 2 for n in p.shape)] *= 2.0
    rng = np.random.default_rng(21)
    sc = torch.as_tensor(rng.uniform(0.05, 0.5, p.shape).astype(np.float32),
                         device=device)
    _check_emit(prm, p, T, sc)
    for edges in ((0, 1), (1, 0), (0, 0)):
        blk = _build.QGD3DParams.from_buffer_copy(prm)
        blk.edge_lo, blk.edge_hi = edges
        assert _rel(F3.sensor_reference_3d(blk, p, T, sc),
                    F3.qgd3d_sensor(blk, p, T, sc)) <= 1e-6, edges


def _same_with_nan(got, ref):
    """got equals ref bit for bit, NaN exactly where ref is NaN."""
    bad = torch.isnan(ref)
    return (torch.equal(torch.isnan(got), bad)
            and torch.equal(got[~bad], ref[~bad]))


def test_3d_sensor_path_with_a_nan_cell(device, record_property):
    """One NaN cell of p in fresh frames (its rho NaN), and one NaN cell of
    a sensor: qgd3d_emit and qgd3d_smooth beside their plain versions.  The
    raw sensor is NaN exactly where the plain one is (its clamps propagate
    NaN, as torch.clamp does), and so are ring 1 and the rings: their max
    is nan_max, which propagates NaN as the plain rings' torch.maximum
    does.  Everywhere else the kernels equal the plain versions bit for
    bit.  The NaN counts are recorded as properties."""
    shape = (20, 40, 70)
    prm = F3.make_params(cases.supersonic_jet_3d_varsc(shape=shape,
                                                       device=device)[0])[0]
    p, T = random_frames(shape, 23, device)[:2]
    p[5, 7, 9] = float("nan")
    sc = torch.full_like(p, 0.1)
    raw, s1, chg = F3.qgd3d_emit(prm, p, T, sc, raw=True)
    ref = F3.sensor_reference_3d(prm, p, T, sc)
    assert torch.equal(torch.isnan(raw), torch.isnan(ref))
    assert int(torch.isnan(ref).sum()) == 7
    ok = ~torch.isnan(ref)
    assert _rel(ref[ok], raw[ok]) <= 1e-6
    cells, flag = F3.smooth_reference_3d(prm, raw, 1)
    plain = F._edge_frame(cells)
    assert _same_with_nan(s1, plain)
    assert float(chg) == float(flag)
    record_property("emit_ring1_plain_nan_cells", int(torch.isnan(plain).sum()))
    record_property("emit_ring1_kernel_nan_cells", int(torch.isnan(s1).sum()))
    f = torch.full(shape, 0.1, device=device)
    f[10, 20, 30] = float("nan")
    out, flag = F3.qgd3d_smooth(prm, f, F3.SMOOTH3_RINGS)
    cells, ref_flag = F3.smooth_reference_3d(prm, f, F3.SMOOTH3_RINGS)
    plain = F._edge_frame(cells)
    assert int(torch.isnan(plain).sum()) > 1
    assert _same_with_nan(out, plain)
    assert float(flag) == float(ref_flag) == 0.0
    record_property("smooth_plain_nan_cells", int(torch.isnan(plain).sum()))
    record_property("smooth_kernel_nan_cells", int(torch.isnan(out).sum()))


def test_2d_sensor_path_with_a_nan_cell(device, record_property):
    """The 2D counterpart: one NaN cell of p in fresh frames for
    qgd2d_emit, whose raw sensor is NaN exactly where emit_reference's is
    and within rel 1e-6 elsewhere (on the card the plain version's
    gradient divides by dx as a Python float, which torch turns into a
    product by its reciprocal), and whose ring 1 and flag are the plain
    ring's of the kernel's own raw sensor, NaN cells included; and one NaN
    cell of a sensor for qgd2d_smooth (1, 3 and SMOOTH_KMAX rings against
    the plain rings): NaN exactly where the plain rings are, bit for bit
    elsewhere."""
    shape = (130, 131)
    prm = F.make_params(cases.supersonic_jet_varsc(shape=shape,
                                                   device=device)[0])[0]
    p, T, ux, uy = random_frames_2d(shape, 29, device)
    p[40, 50] = float("nan")
    sc = torch.full_like(p, 0.1)
    got = F.qgd2d_emit(prm, p, T, ux, uy, sc)
    ref = F.emit_reference(prm, p, T, ux, uy, sc)
    bad = torch.isnan(ref[2])
    assert int(bad.sum()) == 5
    assert torch.equal(torch.isnan(got[2]), bad)
    assert _rel(ref[2][~bad], got[2][~bad]) <= 1e-6
    s1, flag = S.smooth_reference(prm, got[2], 1)
    assert int(torch.isnan(s1).sum()) > 5
    assert _same_with_nan(got[3], s1)
    assert float(got[4]) == float(flag)
    record_property("emit_ring1_plain_nan_cells", int(torch.isnan(s1).sum()))
    record_property("emit_ring1_kernel_nan_cells",
                    int(torch.isnan(got[3]).sum()))
    f = torch.full(shape, 0.1, device=device)
    f[60, 70] = float("nan")
    for k in sorted({1, 3, F.SMOOTH_KMAX}):
        out, flag = F.qgd2d_smooth(prm, f, k)
        cells, ref_flag = S.smooth_reference(prm, f, k)
        plain = F._edge_frame(cells)
        assert int(torch.isnan(plain).sum()) > 1
        assert _same_with_nan(out, plain), k
        assert float(flag) == float(ref_flag), k
    record_property("smooth_plain_nan_cells", int(torch.isnan(plain).sum()))
    record_property("smooth_kernel_nan_cells", int(torch.isnan(out).sum()))


@pytest.mark.parametrize("kind,name,shape", [
    ("k3", "supersonic_jet", (256, 128)),
    ("k5", "supersonic_duct_3d", (64, 30, 30))])
def test_sharded_kernels_on_two_ranks_match_serial_kernels(kind, name, shape,
                                                           device):
    """K3 / K5 on two ranks sharing cuda:0 (gloo, halos through pinned host
    memory), 10 steps: bitwise the serial kernel path's, with every flagged
    kernel launched once per step on each rank."""
    import _torch_rank_bodies as bodies
    from qgdsolver_tpu_torch import interop
    from qgdsolver_tpu_torch.ops import _build
    from qgdsolver_tpu_torch.parallel import distributed

    _build.load()  # here, once: the ranks only load the library
    _, state = getattr(cases, name)(shape=shape, device="cpu")
    job = (kind, name, shape, "float32", (2, 1), 10,
           interop.state_to_numpy(state))
    ranks = distributed.spawn(bodies.run_jobs, 2, [job], "cuda",
                              device="cuda", timeout=300)
    solver, state = getattr(cases, name)(shape=shape, device=device)
    build = F.build_fused_step if kind == "k3" else F3.build_fused_step_3d
    step, to_f, from_f = build(solver)
    ref = interop.state_to_numpy(from_f(common.run_steps(step, to_f(state),
                                                         10)))
    kernels = F.SHARDED_KERNELS if kind == "k3" else F3.SHARDED_KERNELS
    for got, launches in (r[0] for r in ranks):
        for f in ("rho", "rhoU", "rhoE", "t", "dt"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                          err_msg=f)
        assert launches == {k.__name__: 10 for k in kernels
                            if k.__name__ != "qgd3d_sensor"}


@pytest.mark.parametrize("kind", ("case",) + YZ_KINDS)
@pytest.mark.parametrize("shape", [(1, 9, 126), (2, 1, 33), (17, 2, 31),
                                   (17, 9, 1), (2, 2, 126), (1, 1, 31),
                                   (17, 9, 33)])
def test_3d_dt_and_ghosts_on_ragged_shapes(shape, kind, device):
    """qgd3d_dt, qgd3d_dt_fold and qgd3d_ghosts where nx is 1, 2 or 17, ny
    1, 2 or 9 and nz 1, 31, 33 or 126 (none a multiple of the dt kernel's
    8x32 tile), on random frames, for the duct and the varsc jet (qgdFlux
    and the array inlet on x), each with its own BCs or with one BC kind
    on all four y and z sides of every field (and on x for the duct), under
    every (edge_lo, edge_hi): dt and the quad within rtol 1e-6 of the plain
    versions, the ghost-filled frames within 1e-6 of each field's max.
    Extrapolation along an axis of one cell is refused by `supported`."""
    for base, seed in (("supersonic_duct_3d", 1), ("supersonic_jet_3d_varsc",
                                                   2)):
        solver, _ = getattr(cases, base)(shape=shape, device=device)
        if kind != "case":
            axes = (0, 1, 2) if base == "supersonic_duct_3d" else (1, 2)
            solver = one_kind_on_sides(solver, bc, kind, axes)
        prm, planes = F3.make_params(solver)
        planes = solver.mesh.tensor(planes).contiguous()
        frames = random_frames(shape, seed, device)
        rng = np.random.default_rng(seed)
        side = torch.as_tensor(rng.uniform(-5.0, 5.0, (2,) + shape[1:])
                               .astype(np.float32), device=device)
        dt = torch.tensor(1e-7, dtype=torch.float32, device=device)
        for lo, hi in ((1, 1), (0, 1), (1, 0), (0, 0)):
            prm.edge_lo, prm.edge_hi = lo, hi
            where = (base, kind, lo, hi)
            torch.testing.assert_close(
                F3.qgd3d_dt(prm, *frames[1:], dt),
                F3.dt_reference_3d(prm, *frames[1:], dt), rtol=1e-6,
                atol=0.0, msg=lambda m: f"{where}: {m}")
            quad = F3.dt_fold_reference_3d(prm, *frames[1:])
            got = F3.qgd3d_dt_fold(prm, *frames[1:])
            assert float(((got - quad).abs() / quad.abs()).max()) <= 1e-6, \
                (where, got, quad)
            if extrap_on_one_cell(prm):
                assert not F3.supported(solver), where
                continue
            a = F3.qgd3d_ghosts(prm, [f.clone() for f in frames], side,
                                planes)
            b = F3.ghosts_reference_3d(prm, [f.clone() for f in frames],
                                       side, planes)
            for k in range(5):
                assert _rel(b[k], a[k]) <= 1e-6, (where, F3.FIELDS[k])


def test_3d_dt_calls_back_to_back_are_each_their_own(device):
    """Three qgd3d_dt and qgd3d_dt_fold calls on different frames, launched
    back to back (and three more on a second stream beside them), each
    bitwise the same call made alone: the kernel's ticket starts each call
    from 0 and no two streams share a workspace."""
    shape = (40, 30, 50)
    solver, _ = cases.supersonic_jet_3d_varsc(shape=shape, device=device)
    prm, _ = F3.make_params(solver)
    frames = [random_frames(shape, seed, device) for seed in (3, 4, 5)]
    dt = torch.tensor(1e-7, dtype=torch.float32, device=device)
    other = torch.cuda.Stream(device)
    other.wait_stream(torch.cuda.current_stream(device))
    together = []
    for fr in frames:
        together.append((F3.qgd3d_dt(prm, *fr[1:], dt),
                         F3.qgd3d_dt_fold(prm, *fr[1:])))
    with torch.cuda.stream(other):
        beside = [(F3.qgd3d_dt(prm, *fr[1:], dt),
                   F3.qgd3d_dt_fold(prm, *fr[1:])) for fr in frames[::-1]]
    torch.cuda.synchronize()
    beside = beside[::-1]
    for fr, got, got2 in zip(frames, together, beside):
        alone = F3.qgd3d_dt(prm, *fr[1:], dt)
        torch.cuda.synchronize()
        quad = F3.qgd3d_dt_fold(prm, *fr[1:])
        torch.cuda.synchronize()
        for g in (got, got2):
            assert torch.equal(g[0], alone) and torch.equal(g[1], quad)
    assert len({tuple(g[1].tolist()) for g in together}) == 3


@pytest.mark.parametrize("dims", [2, 3])
def test_dt_kernels_give_nan_where_plain_versions_do(dims, device):
    """Each dt kernel (qgd2d_dt, qgd2d_dt_fold and qgd2d_emit's rates;
    qgd3d_dt and qgd3d_dt_fold) on frames with one NaN T cell: NaN exactly
    where its plain version gives NaN - a NaN in an interior cell or in a
    ghost cell that a boundary face reads - and finite where the plain
    version stays finite (an edge ghost that no face reads)."""
    shape = (20, 12) if dims == 2 else (12, 10, 9)
    names = (CASES if dims == 2 else CASES3)
    cells = {"interior": tuple(n // 2 for n in shape),
             "x-ghost": (0,) + tuple(n // 2 for n in shape[1:]),
             "y-ghost": (shape[0] // 2, shape[1] + 1) + tuple(
                 n // 2 for n in shape[2:]),
             "edge ghost": (0, 0) + tuple(n // 2 for n in shape[2:])}
    for name in names:
        solver, _ = getattr(cases, name)(shape=shape, device=device)
        dt = torch.tensor(1e-7, dtype=torch.float32, device=device)
        frames = random_frames(shape + (1,) if dims == 2 else shape, 6,
                               device)
        if dims == 2:
            frames = [f[..., 1].contiguous() for f in frames[:4]]
            prm, _ = F.make_params(solver)
            sc = F._edge_frame(torch.full(shape, 0.2, device=device)) \
                if prm.varsc else None

            def pairs(p, T, ux, uy):
                e, er = F.qgd2d_emit(prm, p, T, ux, uy, sc), \
                    F.emit_reference(prm, p, T, ux, uy, sc)
                return [(F.qgd2d_dt(prm, T, ux, uy, dt),
                         F.dt_reference(prm, T, ux, uy, dt)),
                        (F.qgd2d_dt_fold(prm, T, ux, uy),
                         F.dt_fold_reference(prm, T, ux, uy)),
                        (e[0], er[0]), (e[1], er[1])]
        else:
            prm, _ = F3.make_params(solver)

            def pairs(p, T, ux, uy, uz):
                return [(F3.qgd3d_dt(prm, T, ux, uy, uz, dt),
                         F3.dt_reference_3d(prm, T, ux, uy, uz, dt)),
                        (F3.qgd3d_dt_fold(prm, T, ux, uy, uz),
                         F3.dt_fold_reference_3d(prm, T, ux, uy, uz))]
        for label, idx in cells.items():
            bad = [f.clone() for f in frames]
            bad[1][idx] = float("nan")
            outs = pairs(*bad)
            # the plain dt: NaN unless no face reads the cell
            assert bool(torch.isnan(outs[0][1])) == (label != "edge ghost")
            for i, (got, ref) in enumerate(outs):
                assert torch.equal(torch.isnan(got), torch.isnan(ref)), \
                    (name, label, i, got, ref)


@pytest.mark.parametrize("k", sorted({0, 1, 2, 3, F3.SMOOTH3_RINGS,
                                      F3.SMOOTH3_KMAX}))
@pytest.mark.parametrize("shape", [(37, 13, 45), (20, 70, 9), (9, 30, 130)])
def test_smooth3_kernel_on_ragged_shapes(shape, k, device):
    """qgd3d_smooth where (nx, ny, nz) are no multiples of its (y, z) tile
    or its x chunk, on cells and on a frame, bitwise its plain version
    (cells, ghosts, edges and corners, and the last-ring flag); and the
    smoothing loop on it, from the raw sensor and from an emitted first
    ring (a frame) and its flag, bitwise the same loop on the plain
    version and `fvc_smooth` edge-framed."""
    prm = F3.make_params(cases.supersonic_jet_3d_varsc(shape=shape,
                                                       device=device)[0])[0]
    rng = np.random.default_rng(11)
    raw = rng.uniform(0.05, 1.0, shape).astype(np.float32)
    for _ in range(4):
        raw[tuple(rng.integers(0, n) for n in shape)] = 5.0
    f = torch.as_tensor(raw, device=device)
    for src in (f, F._edge_frame(f)):
        out, flag = F3.qgd3d_smooth(prm, src, k)
        cells, ref_flag = F3.smooth_reference_3d(prm, f, k)
        assert torch.equal(out, F._edge_frame(cells))
        assert float(flag) == float(ref_flag)
    if k == 0:
        return
    got = S.smooth_sensor(prm, f, None, F3.qgd3d_smooth, k)
    ref = S.smooth_sensor(prm, f, None, S._smooth_plain, k)
    assert torch.equal(got, ref)
    assert torch.equal(got, F._edge_frame(F3.fvc_smooth(f, 0.1)))
    cells, chg = F3.smooth_reference_3d(prm, f, 1)
    s1 = F._edge_frame(cells)
    assert torch.equal(S.smooth_sensor(prm, s1, chg, F3.qgd3d_smooth, k), ref)


@pytest.mark.parametrize("ratio", [1.1, 1.05, 2.0])
@pytest.mark.parametrize("shape", [(37, 13, 45), (20, 70, 9), (9, 30, 130),
                                   (1, 1, 1), (2, 1, 33), (13, 257, 9),
                                   (3, 4, 1024), (1024, 3, 5), (70, 33, 97)])
def test_smooth3_fixed_point_on_ragged_shapes(shape, ratio, device):
    """`qgd3d_smooth`'s fixed point (k = SMOOTH_FIXED: its z, y and x
    passes) where no axis is a multiple of a pass's segments or blocks
    (the longest lines the passes take among them), on cells and on a
    frame of a random sensor with spikes and of one below the ring's
    underflow guard: bitwise its plain version, with the flag 0; for the
    cases' maxRatio also bitwise `fvc_smooth` edge-framed on the card."""
    solver = cases.supersonic_jet_3d_varsc(shape=shape, device=device)[0]
    prm = F3.make_params(solver)[0]
    prm.smooth_ratio = ratio
    rng = np.random.default_rng(19)
    fields = [rng.uniform(0.05, 1.0, shape).astype(np.float32)]
    for _ in range(4):
        fields[0][tuple(rng.integers(0, n) for n in shape)] = 5.0
    tiny = np.ldexp(rng.uniform(0.5, 1.0, shape),
                    rng.integers(-150, -85, shape)).astype(np.float32)
    tiny[rng.random(shape) < 0.05] = 0.0
    tiny[tuple(n // 2 for n in shape)] = 1.0
    fields.append(tiny)
    for raw in fields:
        f = torch.as_tensor(raw, device=device)
        cells, ref_flag = S.smooth_fixed_reference(prm, f)
        ref = F._edge_frame(cells)
        assert float(ref_flag) == 0.0
        for src in (f, F._edge_frame(f)):
            out, flag = F3.qgd3d_smooth(prm, src, S.SMOOTH_FIXED)
            assert torch.equal(out, ref)
            assert float(flag) == 0.0
        if ratio == 1.1:
            assert torch.equal(ref, F._edge_frame(F3.fvc_smooth(f, 0.1)))


def _shocked(solver, state):
    """The 3D jet's state with the shocked traffic's three density slabs
    (rho and rhoE times 1.375, 1.5625 and 1.75 where |x - c| < 0.1, at
    c = 1, 2 and 3)."""
    x = torch.as_tensor(np.asarray(solver.mesh.centers[0]),
                        device=state.rho.device)
    factor = torch.ones_like(x)
    for c, a in ((1.0, 0.375), (2.0, 0.5625), (3.0, 0.75)):
        factor = factor + a * (torch.abs(x - c) < 0.1).to(x.dtype)
    factor = factor.reshape(-1, 1, 1).to(state.rho.dtype)
    return state._replace(rho=state.rho * factor, rhoE=state.rhoE * factor)


def test_smooth3_fixed_point_on_the_shocked_jet(device):
    """The ring 1 that the 3D jet with three density slabs emits
    (96x62x62, 369k cells): the fixed-point call bitwise its plain
    version and the ring loop, with the flag 0, counted as one fixed call
    of SMOOTH3_FIXED_LAUNCHES launches and no ring; with one NaN cell its
    flag is 1 and the step's smoothing falls back to the rings' result, NaN
    exactly where they have NaN.  Its launches appear in a trace under
    `qgdbench.timing.kernel_key` as qgd3d_smooth."""
    from qgdbench.timing import kernel_key

    solver, state = cases.supersonic_jet_3d_varsc(shape=(96, 62, 62),
                                                  device=device)
    prm = F3.make_params(solver)[0]
    step, to_f, _ = solver.make_fused_step()
    fs = step(to_f(_shocked(solver, state)))
    assert float(fs.sc_chg) == 1.0, "the slabs must keep the sensor active"
    rings = S.smooth_sensor(prm, fs.sc_s1, fs.sc_chg, F3.qgd3d_smooth,
                            F3.SMOOTH3_RINGS)
    assert not torch.equal(rings, fs.sc_s1)
    from chip_smoke import device_events

    was = (F3.qgd3d_smooth.launches, F3.qgd3d_smooth.fixed,
           F3.qgd3d_smooth.rings)
    out, flag = F3.qgd3d_smooth(prm, fs.sc_s1, S.SMOOTH_FIXED)
    counts = (F3.qgd3d_smooth.launches - was[0],
              F3.qgd3d_smooth.fixed - was[1], F3.qgd3d_smooth.rings - was[2])
    assert counts == (F3.SMOOTH3_FIXED_LAUNCHES, 1, 0)
    names = [n for n, _ in device_events(
        lambda: F3.qgd3d_smooth(prm, fs.sc_s1, S.SMOOTH_FIXED), 1)
        if "smooth" in n]
    assert len(names) == F3.SMOOTH3_FIXED_LAUNCHES, names
    assert {kernel_key(n) for n in names} == {"qgd3d_smooth"}, names
    assert float(flag) == 0.0
    assert torch.equal(out, rings)
    cells, _ = S.smooth_fixed_reference(prm, fs.sc_s1[(slice(1, -1),) * 3])
    assert torch.equal(out, F._edge_frame(cells))
    bad = fs.sc_s1.clone()
    bad[40, 30, 20] = float("nan")
    assert float(F3.qgd3d_smooth(prm, bad, S.SMOOTH_FIXED)[1]) == 1.0
    ring = S.smooth_sensor(prm, bad, fs.sc_chg, F3.qgd3d_smooth,
                           F3.SMOOTH3_RINGS)
    fallbacks = F3.qgd3d_smooth.fallbacks
    got = S.smooth_sensor(prm, bad, fs.sc_chg, F3.qgd3d_smooth,
                          F3.SMOOTH3_RINGS, cache={"fixed": True})
    assert F3.qgd3d_smooth.fallbacks == fallbacks + 1
    assert _same_with_nan(got, ring) and int(torch.isnan(ring).sum()) > 1


@pytest.mark.parametrize("dims", [2, 3])
def test_smooth_kernels_below_the_underflow_guard(dims, device):
    """Both smoothing kernels on sensors whose first x-rows lie below the
    division-free ring's guard (2^-96: the ring divides there), across it,
    among subnormals and zeros, with a normal spike, and whose other rows
    hold sensor values: bitwise their plain versions for one launch of 1
    and of the most rings, and to the fixed point.  In 2D this runs tiles
    with the guard (those holding a tiny value) beside tiles without it."""
    if dims == 2:
        shape, kmax, smooth = (150, 140), F.SMOOTH_KMAX, F.qgd2d_smooth
        prm = F.make_params(cases.supersonic_jet_varsc(
            shape=shape, device=device)[0])[0]
    else:
        shape, kmax, smooth = (20, 40, 70), F3.SMOOTH3_KMAX, F3.qgd3d_smooth
        prm = F3.make_params(cases.supersonic_jet_3d_varsc(
            shape=shape, device=device)[0])[0]
    rng = np.random.default_rng(13)
    raw = rng.uniform(0.05, 1.0, shape).astype(np.float32)
    tiny = (shape[0] * 2 // 5,) + shape[1:]
    raw[:tiny[0]] = np.ldexp(rng.uniform(0.5, 1.0, tiny),
                             rng.integers(-150, -80, tiny))
    raw[:tiny[0]][rng.random(tiny) < 0.05] = 0.0
    raw[(tiny[0] // 2,) + tuple(n // 2 for n in shape[1:])] = 1.0
    assert np.count_nonzero((raw > 0) & (raw < np.float32(2.0 ** -126))) > 0
    f = torch.as_tensor(raw, device=device)
    for k in (1, kmax):
        out, flag = smooth(prm, f, k)
        cells, ref_flag = S.smooth_reference(prm, f, k)
        assert torch.equal(out, F._edge_frame(cells))
        assert float(flag) == float(ref_flag)
    got = S.smooth_sensor(prm, f, None, smooth, kmax)
    assert torch.equal(got, S.smooth_sensor(prm, f, None, S._smooth_plain,
                                            kmax))


@pytest.mark.parametrize("ratio", [1.1, 1.01, 1.05, 1.2, 1.3, 1.5, 2.0])
def test_smooth_ring_check_is_exact(ratio, device):
    """The kernels' division-free ring equals __fdiv_rn on every float of
    the ranges `smooth_ring_check` sweeps, for the cases' maxRatio (1.1)
    and a sweep of others."""
    bad = S.smooth_ring_check(ratio, device)
    assert list(bad) == list(S.RING_RANGES)
    assert not any(bad.values()), bad


@pytest.mark.parametrize("shape", [(257, 131), (40, 17, 23)])
@pytest.mark.parametrize("field", ["random", "spike"])
def test_fvc_smooth_on_card_equals_cpu(shape, field, device):
    """The plain rings divide by a tensor maxRatio, so `fvc_smooth` on the
    card is the CPU's bit for bit (a Python scalar divisor would become a
    product by its reciprocal there)."""
    rng = np.random.default_rng(5)
    if field == "random":
        raw = rng.uniform(0.05, 1.0, shape).astype(np.float32)
    else:
        raw = np.full(shape, 0.05, np.float32)
        raw[tuple(n // 3 for n in shape)] = 1.0
    cpu = torch.as_tensor(raw)
    from qgdsolver_tpu_torch.physics import qgdcoeffs

    got = qgdcoeffs.fvc_smooth(cpu.to(device), 0.1).cpu()
    assert torch.equal(got, qgdcoeffs.fvc_smooth(cpu, 0.1))
    assert not torch.equal(got, cpu)


def test_cg_on_card_matches_cpu(device):
    """The implicit-diffusion Helmholtz solve of the jet's U (float64) on
    the card and on the CPU: equal iteration counts, x within 1e-12 of its
    max (the card's sums reduce in another order), and one host read per
    group of CG_GROUP iterations plus one."""
    from qgdsolver_tpu_torch.ops import linsolve

    out = {}
    for dev in (device, torch.device("cpu")):
        solver, s = cases.supersonic_jet(shape=(256, 128), dtype=torch.float64,
                                         device=dev)
        mesh = solver.mesh
        U = s.rhoU / s.rho[None]
        g = tuple(torch.full(mesh.face_shape(a), 5e-3, dtype=torch.float64,
                             device=dev) for a in range(2))
        diag = s.rho / 1e-6
        linsolve.reset_counts()
        res = linsolve.solve_helmholtz(
            diag_coeff=diag, gamma_faces=g, rhs=diag * U, x0=U,
            bcs=bc.resolve_inlet_outlet(solver.bc_U, U, 2), mesh=mesh,
            vector=True, tol=1e-12, maxiter=500)
        out[dev.type] = (res, linsolve.cg.reads)
    (gpu, reads), (cpu, _) = out["cuda"], out["cpu"]
    n = int(cpu.iters)
    assert int(gpu.iters) == n > 1
    assert _rel(cpu.x, gpu.x.cpu()) <= 1e-12
    assert reads == -(-n // linsolve.CG_GROUP) + 1


def test_implicit_jet_on_card_matches_cpu(device):
    """5 implicit-diffusion steps of the jet at 256x128 (float64; the
    composable path: the fused gates refuse implicit diffusion) on the card
    and on the CPU: every field within 1e-10 of its max."""
    out = []
    for dev in (device, torch.device("cpu")):
        solver, s = cases.supersonic_jet(shape=(256, 128), dtype=torch.float64,
                                         device=dev, implicit_diffusion=True)
        assert not solver.fused_supported()
        out.append(common.run_steps(solver.make_step(), s, 5))
    gpu, cpu = out
    for f in ("rho", "rhoU", "rhoE", "t", "dt"):
        assert _rel(getattr(cpu, f), getattr(gpu, f).cpu()) <= 1e-10, f
