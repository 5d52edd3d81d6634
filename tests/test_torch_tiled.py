"""The port of K2 (`ops.fused_qgd2d.build_tiled_fused_step`, `qgd2d_emit`,
the smoothing continuation `smooth_sensor` on `qgd2d_smooth`) and
`fvc_smooth_continue` against the JAX package.

On the CPU `qgd2d_emit` and `qgd2d_smooth` run their plain versions,
`emit_reference` and `smooth_reference`; the CUDA kernels are held against
them on the card (tests/test_torch_gpu.py, chip_smoke.py). The JAX tiled
step runs its Pallas slab kernel in interpret mode, as
tests/test_fused_qgd2d.py runs it. Bounds are those JAX tests' own: dt rtol
1e-6; rho/rhoU/rhoE within 1e-5 of their max (2e-5 with the density bump
across a slab boundary); sc rtol 1e-4 with atol 1e-5 (bump) or 1e-4
(spike). The emitted rates and sensor fields match one JAX tiled step to
rtol 1e-6 (f32 round-off of the same expressions), and the smoothing
continuation is bitwise `fvc_smooth`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgdsolver_tpu import cases as jcases
from qgdsolver_tpu.ops import fused_qgd2d as JF
from qgdsolver_tpu.physics import qgdcoeffs as jcoeffs
from qgdsolver_tpu_torch import cases as tcases
from qgdsolver_tpu_torch import interop
from qgdsolver_tpu_torch.ops import fused_qgd2d as F
from qgdsolver_tpu_torch.ops import fused_qgd3d as F3
from qgdsolver_tpu_torch.ops import smoothing as S
from qgdsolver_tpu_torch.physics import qgdcoeffs as tcoeffs
from qgdsolver_tpu_torch.solvers import common

SHAPE = (64, 32)
NAMES = {"plain": "supersonic_jet", "varsc": "supersonic_jet_varsc"}


def _f32(x):
    return np.asarray(x).astype(np.float32)


def _rel(a, b):
    a = _f32(a)
    return np.max(np.abs(a - _f32(b))) / max(np.max(np.abs(a)), 1e-30)


def _perturbed(case, width, centre_row):
    """Both packages' solvers and the JAX state, with rho and rhoE scaled
    by 1 + `width`-wide x-band of amplitude (bump 0.35, spike 2.5)."""
    js, jst = getattr(jcases, NAMES[case])(shape=SHAPE, dtype=np.float32)
    ts, _ = getattr(tcases, NAMES[case])(shape=SHAPE, device="cpu")
    if width is not None:
        amp, cells = width
        x = np.asarray(js.mesh.centers[0])
        band = (1.0 + amp * (np.abs(x[:, None] - x[centre_row])
                             < cells * (x[1] - x[0]))).astype(np.float32)
        jst = jst._replace(rho=jst.rho * band, rhoE=jst.rhoE * band)
    return js, jst, ts


def _seeded(js, jst):
    """One JAX composable step (seeds sc and pbc), as numpy and as the
    port's State."""
    s = jax.jit(js.make_step())(jst)
    return s, interop.state_from_numpy(jax.tree.map(np.asarray, s),
                                       dtype=torch.float32)


def _run_both(js, ts, s, st, n, slab_rows):
    jstep, jto, jfrom = JF.build_tiled_fused_step(js, slab_rows=slab_rows)
    tstep, tto, tfrom = F.build_tiled_fused_step(ts)
    jstep = jax.jit(jstep)
    jt, tt = jto(s), tto(st)
    fired = [False, False]
    for _ in range(n):
        jt, tt = jstep(jt), tstep(tt)
        if jt.sc_chg is not None:
            fired[0] |= float(jnp.max(jt.sc_chg)) > 0.0
            fired[1] |= float(tt.sc_chg) > 0.0
    return jt, jfrom(jt), tt, interop.state_to_numpy(tfrom(tt)), fired


@pytest.mark.parametrize("case", ["plain", "varsc"])
def test_tiled_matches_jax_tiled(case):
    """Mirror of tests/test_fused_qgd2d.py::test_tiled_matches_whole_frame:
    the port's K2 path against the JAX x-slab kernel (4 slabs) and against
    the port's own K1 path, 5 steps."""
    js, jst, ts = _perturbed(case, None, 0)
    assert F.tiled_supported(ts) and JF.tiled_supported(js)
    s, st = _seeded(js, jst)
    jt, a, tt, b, _ = _run_both(js, ts, s, st, 5, slab_rows=16)
    np.testing.assert_allclose(_f32(jt.dt), b.dt, rtol=1e-6)
    for name in ("rho", "rhoU", "rhoE"):
        assert _rel(getattr(a, name), getattr(b, name)) < 1e-5, name
    kstep, kto, kfrom = F.build_fused_step(ts)
    fs = kto(st)
    for _ in range(5):
        fs = kstep(fs)
    c = interop.state_to_numpy(kfrom(fs))
    np.testing.assert_allclose(c.dt, b.dt, rtol=1e-6)
    for name in ("rho", "rhoU", "rhoE", "sc"):
        assert _rel(getattr(c, name), getattr(b, name)) < 1e-5, name


def test_tiled_varsc_sensor_active_matches_jax():
    """Mirror of test_tiled_varsc_sensor_active_matches_whole_frame: a
    density bump straddling a slab boundary of the JAX kernel activates the
    sensor; 8 steps."""
    js, jst, ts = _perturbed("varsc", (0.35, 6), 32)
    s, st = _seeded(js, jst)
    jt, a, _, b, _ = _run_both(js, ts, s, st, 8, slab_rows=16)
    assert float(np.max(b.sc)) > 0.1, "sensor must be active"
    np.testing.assert_allclose(_f32(jt.dt), b.dt, rtol=1e-6)
    np.testing.assert_allclose(b.sc, _f32(a.sc), rtol=1e-4, atol=1e-5)
    for name in ("rho", "rhoU", "rhoE"):
        assert _rel(getattr(a, name), getattr(b, name)) < 2e-5, name


def test_tiled_varsc_smooth_continuation_fires_and_matches():
    """Mirror of test_tiled_varsc_smooth_continuation_fires_and_matches: a
    near-delta density spike drives the raw sensor ratios far beyond
    maxRatio; the change flag must fire in the port too, and the smoothed
    sensor track both the JAX composable fvc_smooth wave and the JAX slab
    kernel (slab_rows=8), 4 steps."""
    js, jst, ts = _perturbed("varsc", (2.5, 1.1), 24)
    s, st = _seeded(js, jst)
    rings = S.smooth_sensor.rings
    jt, a, _, b, fired = _run_both(js, ts, s, st, 4, slab_rows=8)
    assert fired[0], "the JAX ring-1 change partial never fired"
    assert fired[1], "the port's change flag never fired"
    assert S.smooth_sensor.rings > rings
    step_c = jax.jit(js.make_step())
    ref = s
    for _ in range(4):
        ref = step_c(ref)
    np.testing.assert_allclose(b.dt, _f32(ref.dt), rtol=1e-6)
    np.testing.assert_allclose(b.sc, _f32(ref.sc), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b.sc, _f32(a.sc), rtol=1e-4, atol=1e-4)


def _port_frames(jt, M):
    """The JAX TiledState's cell rows and ghost tiles as the port's
    (nx+2, ny+2) frames (p, T, ux, uy) and its sensor frame."""
    out = []
    for k, name in enumerate(("p", "T", "ux", "uy")):
        rows = np.concatenate([_f32(jt.gl[k][7:8]), _f32(getattr(jt, name)),
                               _f32(jt.gh[k][0:1])])[:, :M + 2]
        out.append(torch.as_tensor(np.ascontiguousarray(rows)))
    sc = None
    if jt.sc is not None:
        sc = F._edge_frame(torch.as_tensor(_f32(jt.sc)[:, 1:M + 1]))
    return out, sc


@pytest.mark.parametrize("case,width", [("plain", None),
                                        ("varsc", (2.5, 1.1))])
def test_emit_reference_matches_jax_tiled_step(case, width):
    """emit_reference on the fresh frames of one JAX tiled step (one slab,
    so no strip completion is pending) against what that step's kernel
    emitted: co_rate, tau_rate, sc_raw, sc_s1 and the flag."""
    js, jst, ts = _perturbed(case, width, 24)
    s, _ = _seeded(js, jst)
    jstep, jto, _ = JF.build_tiled_fused_step(js, slab_rows=SHAPE[0])
    jt = jax.jit(jstep)(jto(s))
    M = SHAPE[1]
    (p, T, ux, uy), sc = _port_frames(jt, M)
    prm, _ = F.make_params(ts)
    co, tau, raw, s1, chg = F.emit_reference(prm, p, T, ux, uy, sc)
    np.testing.assert_allclose(float(co), float(jt.co_rate), rtol=1e-6)
    np.testing.assert_allclose(float(tau), float(jt.tau_rate), rtol=1e-6)
    if case == "plain":
        assert raw is None and s1 is None and chg is None
        return
    np.testing.assert_allclose(raw.numpy(), _f32(jt.sc_raw)[:, 1:M + 1],
                               rtol=1e-6)
    np.testing.assert_allclose(s1.numpy(), _f32(jt.sc_s1)[:, 1:M + 1],
                               rtol=1e-6)
    assert float(chg) == 1.0 and float(jnp.max(jt.sc_chg)) > 0.0


@pytest.mark.parametrize("field", ["random", "spike"])
def test_fvc_smooth_continue_is_bitwise_fvc_smooth(field):
    """Continuing from ring 1 and its flag gives the port's fvc_smooth bit
    for bit, also with a flag that fires when nothing changed.  Against
    the JAX package's fvc_smooth and fvc_smooth_continue the bound is
    rtol 1e-6: eagerly one JAX ring is bitwise the port's, but under jit
    XLA evaluates the ring's division by maxRatio with other roundings
    (1.7e-7 apart after the random field's rings)."""
    rng = np.random.default_rng(3)
    if field == "random":
        raw = rng.uniform(0.05, 1.0, size=(40, 24)).astype(np.float32)
    else:
        raw = np.full((40, 24), 0.05, dtype=np.float32)
        raw[17, 5] = 1.0
    f = torch.as_tensor(raw)
    f1 = torch.maximum(f, tcoeffs._neighbour_max(f) / 1.1)
    ref = tcoeffs.fvc_smooth(f, 0.1)
    out = tcoeffs.fvc_smooth_continue(f1, torch.any(f1 > f), 0.1)
    assert torch.equal(out, ref)
    j1 = jnp.asarray(f1.numpy())
    for jref in (jcoeffs.fvc_smooth(jnp.asarray(raw), 0.1),
                 jcoeffs.fvc_smooth_continue(j1, True, 0.1)):
        np.testing.assert_allclose(out.numpy(), np.asarray(jref), rtol=1e-6)
    if field == "spike":
        assert float(out[17, 0]) > 0.05, "the smoothing wave must spread"
    # the fixed point with a flag that fires anyway: one no-op sweep
    rings = tcoeffs.fvc_smooth_continue.rings
    again = tcoeffs.fvc_smooth_continue(ref, True, 0.1)
    assert torch.equal(again, ref)
    assert tcoeffs.fvc_smooth_continue.rings == rings + 4


def _smooth_field(field):
    rng = np.random.default_rng(3)
    if field == "random":
        return rng.uniform(0.05, 1.0, size=(40, 24)).astype(np.float32)
    raw = np.full((40, 24), 0.05, dtype=np.float32)
    if field == "spike":
        raw[17, 5] = 1.0
    return raw


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("field", ["random", "spike", "smooth"])
def test_grouped_smoothing_is_bitwise_fvc_smooth(field, k):
    """K2's continuation (`smooth_sensor`: k rings per `qgd2d_smooth` call,
    its plain version here, one host flag read per call) from ring 1 and
    its flag, also with a flag that fires when nothing changed: the sensor
    frame is the port's fvc_smooth edge-framed, bit for bit, whatever k;
    against the JAX package's fvc_smooth and fvc_smooth_continue rtol 1e-6
    (jit rounds the ring's division otherwise, as in the test above).  From
    k = 4 on, the flag reads stay within those of `fvc_smooth_continue`,
    which tests every fourth ring: 1 + rings/4."""
    raw = _smooth_field(field)
    prm = _build_prm(raw.shape)
    f = torch.as_tensor(raw)
    s1, chg = S.smooth_reference(prm, f, 1)
    ref = tcoeffs.fvc_smooth(f, 0.1)
    for flag in (chg, torch.tensor(1.0)):
        reads, rings = S.smooth_sensor.reads, S.smooth_sensor.rings
        out = S.smooth_sensor(prm, s1, flag, F.qgd2d_smooth, k)
        reads = S.smooth_sensor.reads - reads
        rings = S.smooth_sensor.rings - rings
        assert torch.equal(out, F._edge_frame(ref))
        assert rings % k == 0
        # the host loop that tests every fourth ring reads 1 + rings/4
        before = tcoeffs.fvc_smooth_continue.rings
        tcoeffs.fvc_smooth_continue(s1, flag, 0.1)
        if k >= 4:
            assert reads <= 1 + (tcoeffs.fvc_smooth_continue.rings
                                 - before) // 4
    assert (float(chg) == 0.0) == (field == "smooth")
    j1 = jnp.asarray(s1.numpy())
    for jref in (jcoeffs.fvc_smooth(jnp.asarray(raw), 0.1),
                 jcoeffs.fvc_smooth_continue(j1, True, 0.1)):
        np.testing.assert_allclose(out[1:-1, 1:-1].numpy(), np.asarray(jref),
                                   rtol=1e-6)
    # one call of k rings: the plain loop's cells, ghosts and last flag
    frame, last = F.qgd2d_smooth(prm, F._edge_frame(s1), k)
    cells, ref_last = S.smooth_reference(prm, s1, k)
    assert torch.equal(frame, F._edge_frame(cells))
    assert float(last) == float(ref_last)


def _build_prm(shape):
    from qgdsolver_tpu_torch.ops import _build
    return _build.QGDParams(nx=shape[0], ny=shape[1], smooth_ratio=1.1)


def _fma32(a, b, c):
    """fmaf(a, b, c) on float32 arrays, rounded once: a*b is exact in
    float64 and TwoSum gives p + c = s + e exactly; s rounds to the float32
    nearest p + c unless it is a float32 midpoint, where e decides."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    d = s - r.astype(np.float64)
    toward = np.nextafter(r, np.where(d > 0, np.float32(np.inf),
                                      np.float32(-np.inf)))
    mid = (d != 0) & (2 * np.abs(d) == np.abs(toward.astype(np.float64)
                                               - r.astype(np.float64)))
    return np.where(mid & (e != 0) & (np.sign(e) == np.sign(d)), toward, r)


@pytest.mark.parametrize("ratio", [1.1, 1.01, 1.05, 1.2, 1.5, 2.0])
def test_division_free_ring_is_exact_in_numpy(ratio):
    """The smoothing kernels' division-free quotient (smooth_ring.cuh):
    q = RN(nb*y), rem = fmaf(-q, r, nb), q' = fmaf(rem, y, q) with r the
    params' float32 maxRatio and y = RN(1/r), as the kernels derive it
    (`smooth_inverse`), equals the correctly rounded nb / r on every
    float32 of [1, 2) (scaling by 2 is exact, so this binade decides every
    normal one above the kernels' underflow guard), while q alone misses on
    many.  The card repeats this sweep with its own fmaf
    (`smooth_ring_check`)."""
    from qgdsolver_tpu_torch.ops import _build

    r = np.float32(_build.QGDParams(smooth_ratio=ratio).smooth_ratio)
    assert r == np.float32(ratio)
    y = np.float32(1.0) / r
    first = int(np.float32(1.0).view(np.uint32))
    q_misses = 0
    for lo in range(first, first + (1 << 23), 1 << 21):
        nb = np.arange(lo, lo + (1 << 21), dtype=np.uint32).view(np.float32)
        want = nb / r
        q = nb * y
        q_misses += int(np.count_nonzero(q != want))
        rem = _fma32(-q, np.full_like(q, r), nb)
        got = _fma32(rem, np.full_like(q, y), q)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # q alone is exact only where 1/r is (a power of two)
    assert (q_misses == 0) == (float(r) * float(y) == 1.0)


def test_routing_and_gate():
    """make_fused_step: 2D varScModel5 with a scalar cqSc takes K2's
    builder, every other 2D config K1's, 3D meshes the 3D builder."""
    plain, _ = tcases.supersonic_jet(shape=SHAPE, device="cpu")
    varsc, _ = tcases.supersonic_jet_varsc(shape=SHAPE, device="cpu")
    assert plain.fused_builder() is F.build_fused_step
    assert varsc.fused_builder() is F.build_tiled_fused_step
    cq = dataclasses.replace(varsc.tau_model,
                             cqSc=torch.full(SHAPE, 0.1))
    per_cell = dataclasses.replace(varsc, tau_model=cq)
    assert F.supported(per_cell) and not F.tiled_supported(per_cell)
    assert per_cell.fused_builder() is F.build_fused_step
    with pytest.raises(ValueError):
        F.build_tiled_fused_step(per_cell)
    duct, _ = tcases.supersonic_duct_3d(shape=(8, 6, 6), device="cpu")
    assert duct.fused_builder() is F3.build_fused_step_3d
    step, to_f, from_f = varsc.make_fused_step()
    assert isinstance(to_f(varsc.init(
        p0=torch.full(SHAPE, 1e5), T0=torch.full(SHAPE, 300.0),
        U0=torch.zeros((2,) + SHAPE))), F.TiledState)


def test_tiled_step_on_cpu_is_no_launch():
    """On CPU tensors every wrapper takes its plain version: a tiled run
    adds no launch to any kernel count."""
    ts, st = tcases.supersonic_jet_varsc(shape=SHAPE, device="cpu")
    step, to_f, from_f = F.build_tiled_fused_step(ts)
    before = [k.launches for k in F.KERNELS] + [F.qgd2d_smooth.rings]
    s = from_f(common.run_steps(step, to_f(st), 3))
    assert [k.launches for k in F.KERNELS] + [F.qgd2d_smooth.rings] == before
    assert bool(torch.isfinite(s.rho).all())
    prm, _ = F.make_params(ts)
    fs = to_f(st)
    with pytest.raises(TypeError):
        F.qgd2d_emit(prm, fs.p.double(), fs.T, fs.ux, fs.uy, fs.sc)
    with pytest.raises(ValueError):
        F.qgd2d_emit(prm, fs.p, fs.T, fs.ux, fs.uy, fs.sc[:-1])
