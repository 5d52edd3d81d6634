"""The benchmark's frozen plain 2D K2 step (`qgdbench/reference/qgd2d.py`,
which imports nothing of the port) against the JAX package's K2
(`qgdsolver_tpu.ops.fused_qgd2d.build_tiled_fused_step`, its Pallas slab
kernel in interpret mode on the CPU), 20 steps of the small varsc jet from
the benchmark's shocked traffic: so the reference is tied to the untouched
JAX package and not only to the port.

Bounds are those of the port's K2 tests against the JAX package
(tests/test_torch_tiled.py): dt and t rtol 1e-6; p, T and the velocity
within 1e-5 of their largest magnitude (ghosts included); the sensor frame
rtol 1e-4 with atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qgdsolver_tpu import cases as jcases
from qgdsolver_tpu.ops import fused_qgd2d as JF

from qgdbench import generator, harness
from qgdbench.reference import qgd2d

SHAPE = (64, 32)
STEPS = 20


def _f32(x):
    return np.asarray(x).astype(np.float32)


def _rel(got, want):
    """Largest |got - want| over the largest |want|, lists of arrays."""
    gap = max(np.max(np.abs(_f32(g) - _f32(w))) for g, w in zip(got, want))
    return gap / max(max(np.max(np.abs(_f32(w))) for w in want), 1e-30)


def _frames(jt, M):
    """The JAX TiledState's cell rows and x-ghost tiles as (nx+2, ny+2)
    frames p, T, ux, uy."""
    return [np.concatenate([_f32(jt.gl[k][7:8]), _f32(getattr(jt, name)),
                            _f32(jt.gh[k][0:1])])[:, :M + 2]
            for k, name in enumerate(qgd2d.FIELDS)]


@pytest.fixture(scope="module")
def both():
    cell = harness.resolve(harness.load_benchmark(), "jet2d_varsc.shocked")
    cfg = dict(cell.cfg, shape=[*SHAPE, 1])
    fields = generator.fields(cfg, cell.mix, 2**33 + 7, "cpu")
    want = qgd2d.run(cfg, fields, STEPS)
    js, _ = jcases.supersonic_jet_varsc(shape=SHAPE, dtype=np.float32)
    p, T, U = (jnp.asarray(x.numpy()) for x in qgd2d.plane_fields(fields))
    jst = js.init(p0=p, T0=T, U0=U,
                  sc0=jnp.asarray(fields["sc"][..., 0].numpy()))
    step, to_fused, _ = JF.build_tiled_fused_step(js, slab_rows=SHAPE[0])
    step = jax.jit(step)
    jt = to_fused(jst)
    for _ in range(STEPS):
        jt = step(jt)
    return jt, want


def test_reference_2d_dt_and_t_hold_to_the_jax_k2_step(both):
    jt, want = both
    np.testing.assert_allclose(_f32(jt.dt), want["dt"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(_f32(jt.t), want["t"].numpy(), rtol=1e-6)


def test_reference_2d_fields_hold_to_the_jax_k2_step(both):
    jt, want = both
    got = dict(zip(qgd2d.FIELDS, _frames(jt, SHAPE[1])))
    for names in (("p",), ("T",), ("ux", "uy")):
        assert _rel([got[k] for k in names],
                    [want[k].numpy() for k in names]) < 1e-5, names


def test_reference_2d_sensor_holds_to_the_jax_k2_step(both):
    jt, want = both
    assert max(want["rings"]) > 1, "the smoothing must run past ring 1"
    np.testing.assert_allclose(_f32(jt.sc)[:, 1:SHAPE[1] + 1],
                               want["sc"][1:-1, 1:-1].numpy(), rtol=1e-4,
                               atol=1e-5)
