"""The port's composable QGDFoam step against `qgdsolver_tpu`'s make_step.

Both jets at 32x16 in float64 (conftest turns on x64), 10 steps from the JAX
initial State carried across with `interop.state_from_numpy`.  The formulas
and their order are the same, so every State field agrees within 1e-9 of
its max (only libm rounding may differ).
"""
import jax
import numpy as np
import pytest
import torch

from qgdsolver_tpu import cases as jcases
from qgdsolver_tpu.physics import qgdcoeffs as jcoeffs
from qgdsolver_tpu_torch import cases as tcases
from qgdsolver_tpu_torch import interop
from qgdsolver_tpu_torch.physics import qgdcoeffs as tcoeffs
from qgdsolver_tpu_torch.solvers import common

CASES = ["supersonic_jet", "supersonic_jet_varsc"]


def _rel(a, b):
    a = np.asarray(a)
    return np.max(np.abs(a - np.asarray(b))) / max(np.max(np.abs(a)), 1e-300)


@pytest.mark.parametrize("name", CASES)
def test_composable_step_matches_jax(name):
    jsolver, js = getattr(jcases, name)(shape=(32, 16), dtype=np.float64)
    tsolver, _ = getattr(tcases, name)(shape=(32, 16), dtype=torch.float64,
                                       device="cpu")
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js),
                                  dtype=torch.float64)
    rho0 = np.asarray(js.rho)
    jstep = jax.jit(jsolver.make_step())
    ts = common.run_steps(tsolver.make_step(), ts, 10)
    for _ in range(10):
        js = jstep(js)
    out = interop.state_to_numpy(ts)
    assert _rel(rho0, out.rho) > 1e-6, "the state must evolve"
    for f in ("rho", "rhoU", "rhoE", "sc", "t", "dt"):
        assert _rel(getattr(js, f), getattr(out, f)) < 1e-9, f
    assert len(out.pbc) == len(js.pbc) == (1 if "varsc" in name else 0)
    for ja, tb in zip(js.pbc, out.pbc):
        assert _rel(ja, tb) < 1e-9


def test_case_builders_match_jax():
    """Both packages build the same initial state from the same arguments."""
    for name in CASES:
        _, js = getattr(jcases, name)(shape=(32, 16), dtype=np.float64)
        _, ts = getattr(tcases, name)(shape=(32, 16), dtype=torch.float64,
                                      device="cpu")
        out = interop.state_to_numpy(ts)
        for f in ("rho", "rhoU", "rhoE", "sc", "t", "dt"):
            assert _rel(getattr(js, f), getattr(out, f)) < 1e-12, (name, f)


def test_interop_round_trip():
    _, js = jcases.supersonic_jet_varsc(shape=(16, 8), dtype=np.float64)
    jn = jax.tree.map(np.asarray, js)
    back = interop.state_to_numpy(
        interop.state_from_numpy(jn, dtype=torch.float64))
    for f in ("rho", "rhoU", "rhoE", "sc", "t", "dt"):
        np.testing.assert_array_equal(getattr(jn, f), getattr(back, f))
    np.testing.assert_array_equal(jn.pbc[0], back.pbc[0])


def test_varsc_sensor_and_smooth_match_jax():
    """sc_raw_update and the fvc::smooth fixed point on a spiky density."""
    rng = np.random.default_rng(4)
    jsolver, _ = jcases.supersonic_jet_varsc(shape=(32, 16),
                                             dtype=np.float64)
    tsolver, _ = tcases.supersonic_jet_varsc(shape=(32, 16),
                                             dtype=torch.float64, device="cpu")
    rho = 1.0 + 0.05 * rng.standard_normal((32, 16))
    rho[10:12, 5:7] *= 3.0
    sc_prev = rng.uniform(0.05, 0.5, (32, 16))
    jm, tm = jsolver.tau_model, tsolver.tau_model
    j_raw = jm.sc_raw_update(jsolver.mesh, jax.numpy.asarray(rho),
                             jax.numpy.asarray(sc_prev))
    t_raw = tm.sc_raw_update(tsolver.mesh, torch.as_tensor(rho),
                             torch.as_tensor(sc_prev))
    assert _rel(j_raw, t_raw.numpy()) < 1e-12
    spike = np.full((32, 16), 0.05)
    spike[16, 8] = 1.0
    j_s = jcoeffs.fvc_smooth(jax.numpy.asarray(spike), 0.1)
    t_s = tcoeffs.fvc_smooth(torch.as_tensor(spike), 0.1)
    assert _rel(j_s, t_s.numpy()) < 1e-12
    assert float(t_s[16, 0]) > 0.05, "the smoothing wave must spread"


def test_run_steps_checks_state(tmp_path):
    tsolver, ts = tcases.supersonic_jet(shape=(16, 8), dtype=torch.float64,
                                        device="cpu")
    bad = ts._replace(rho=-ts.rho)
    with pytest.raises(common.NonphysicalStateError):
        common.run_steps(lambda s: s, bad, 2, check_every=1,
                         dump_dir=str(tmp_path))
    seen = []
    common.run_steps(tsolver.make_step(), ts, 4, log_every=2,
                     log_fn=lambda n, s: seen.append(n))
    assert seen == [2, 4]


def test_unported_branches_raise():
    """The implicit-diffusion and qgdFlux limiter/relaxation branches are
    ported (they build and step), and so are QGDFoam's neighbours of
    ROADMAP item 7 (zQGDFoam, the JANAF thermo); so is interQHDFoam (item
    9), whose config without its phases raises."""
    import dataclasses

    from qgdsolver_tpu_torch.core import config

    tsolver, ts = tcases.supersonic_jet(shape=(16, 8), dtype=torch.float64,
                                        device="cpu")
    for kw in ({"implicit_diffusion": True}, {"qgdflux_relax": 0.5},
               {"qgdflux_limit": 4.0}):
        s = dataclasses.replace(tsolver, **kw).make_step()(ts)
        assert bool(torch.isfinite(s.rho).all()), kw
    cfg = {"solver": "zQGDFoam", "mesh": {"shape": [8, 4]},
           "thermo": {"type": "psiPerfectGas", "R": 287.0, "Cp": 1004.5}}
    assert type(config.build_solver(cfg, device="cpu")).__name__ == \
        "ZQGDFoam"
    with pytest.raises(ValueError, match="props"):
        config.build_solver(dict(cfg, solver="interQHDFoam"), device="cpu")
