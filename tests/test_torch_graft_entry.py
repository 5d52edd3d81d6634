"""The port's graft entry points (`qgdsolver_tpu_torch.graft_entry`)
against the root `__graft_entry__.py` of the JAX package.

`entry(device="cpu")` and the JAX `entry()` build the same 256x128 float32
jet; one step of each holds every field within 1e-5 of its max and dt to
rtol 1e-6 (the f32 bounds of tests/test_torch_io.py's ingested jet;
measured: rho 1.0e-7, rhoU 3.8e-8, rhoE 6.0e-8 of their max, sc and dt
equal).
`dryrun_multichip(4, device="cpu")` runs in one 4-rank gloo world; each of
its paths holds itself to its bound against the port's serial step (its
docstring), and on the CPU all three come out bit for bit.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import _torch_rank_bodies as bodies
from qgdsolver_tpu_torch import graft_entry, interop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("rho", "rhoU", "rhoE", "sc", "t", "dt")


def _jax_graft():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    return float(np.max(np.abs(a - np.asarray(b, dtype=np.float64)))
                 / np.max(np.abs(a)))


def test_entry_matches_jax_entry():
    jstep, (jstate,) = _jax_graft().entry()
    step, (state,) = graft_entry.entry(device="cpu")
    assert state.rho.device.type == "cpu"
    assert state.rho.dtype == torch.float32 and state.rho.shape == (256, 128)
    ref = jax.tree.map(np.asarray, jax.jit(jstep)(jstate))
    got = interop.state_to_numpy(step(state))
    np.testing.assert_allclose(got.dt, ref.dt, rtol=1e-6, atol=0.0)
    for f in ("rho", "rhoU", "rhoE", "sc"):
        assert _rel(getattr(ref, f), getattr(got, f)) <= 1e-5, f
    assert _rel(jstate.rhoU, got.rhoU) > 1e-6, "the state must evolve"


@pytest.mark.parametrize("name", ["entry", "dryrun_multichip"])
def test_default_is_the_card(name, monkeypatch):
    """Without a card both entry points raise by default, never falling
    back to the CPU (the `cases` builders' rule)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = getattr(graft_entry, name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn() if name == "entry" else fn(2)


@pytest.fixture(scope="module")
def report():
    return graft_entry.dryrun_multichip(4, device="cpu")


# the JAX dry run's shapes and grids on 4 devices (__graft_entry__.py)
GRIDS = {"spmd": ((16, 16), (2, 2), "spmd"),
         "k3": ((32, 8), (4, 1), "bitwise"),
         "k5": ((16, 6, 6), (4, 1), "varsc")}


@pytest.mark.parametrize("path", list(GRIDS))
def test_dryrun_4_ranks_equal_serial(report, path):
    shape, grid, bound = GRIDS[path]
    r = report[path]
    assert (r["shape"], r["grid"], r["bound"]) == (shape, grid, bound)
    assert r["bitwise"], r["max_rel"]
    assert set(r["max_rel"]) == set(FIELDS)
    assert all(v == 0.0 for v in r["max_rel"].values()), r["max_rel"]
    # on the CPU the wrappers run their plain versions: no launch counted
    assert r["launches"] == {}


def test_dryrun_has_no_gspmd_path(report):
    assert set(report) == set(GRIDS)
    assert "GSPMD" in graft_entry.dryrun_multichip.__doc__


@pytest.mark.parametrize("n", [2, 3, 6, 8])
def test_dryrun_grids_follow_jax(n):
    """K3's blocks and the spmd grid as `__graft_entry__.py` picks them:
    an x-ring when n is prime, (4, n/4) or (2, n/2) otherwise."""
    from qgdsolver_tpu.parallel import sharding as jshd

    g = graft_entry.dryrun_grids(n)
    px, py = jshd.factor2d(n)
    fx = next(d for d in (4, 2, n) if n % d == 0)
    assert g["spmd"][1:] == ((8 * px, 8 * py), (px, py))
    assert g["k3"][1:] == ((8 * fx, 8 * (n // fx)), (fx, n // fx))
    assert g["k5"][1:] == ((4 * n, 6, 6), (n, 1))


@pytest.mark.parametrize("bound", ["spmd", "bitwise", "split", "varsc"])
def test_a_difference_beyond_the_bound_raises(bound):
    """The serial comparison raises where a path leaves its bound: one rho
    cell off by 1e-4 of its value (beyond every bound), and dt off by one
    ulp (dt must be equal in each)."""
    path = {"spmd": "spmd", "varsc": "k5"}.get(bound, "k3")
    name, shape, _ = graft_entry.dryrun_grids(2)[path]
    ref = graft_entry._serial(path, name, shape, "cpu", 2)
    assert graft_entry._held(path, ref, ref, bound)["rho"] == 0.0
    rho = ref.rho.copy()
    rho.flat[3] *= np.float32(1 + 1e-4)
    dt = np.nextafter(ref.dt, np.float32(np.inf))
    for bad in (ref._replace(rho=rho), ref._replace(dt=dt)):
        with pytest.raises(RuntimeError, match=f"dry run path {path}"):
            graft_entry._held(path, ref, bad, bound)


def test_a_failing_rank_fails_the_dry_run(monkeypatch):
    monkeypatch.setattr(graft_entry, "_dryrun_rank", bodies.dryrun_rank_fails)
    with pytest.raises(RuntimeError,
                       match="rank 1 of 2 failed(.|\n)*planted failure"):
        graft_entry.dryrun_multichip(2, device="cpu")
