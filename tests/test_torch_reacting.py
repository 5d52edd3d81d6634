"""The port's multicomponent reacting QGD solver against the JAX package's.

Mirrors tests/test_reacting.py and the reacting parts of
tests/test_foam_case_e2e.py.  The mixture thermo (constant-cp and JANAF
species) and the reacting step (`solvers.reacting.ReactingQGDFoam`: species
fluxes, QGDYEqn with the inert closure, the species' enthalpy fluxes, Qdot,
the implicit Y/U/e Helmholtz solves, the DeviceISAT table in the State,
the `sources` hook) are held to the JAX package float64 from the same
numpy-seeded States: one-step windows within 1e-9 of each field's max
without a CG, 2*cg_tol with one (with every CG's iteration count equal,
`_torch_parity.solve_logs`); a free tabulated run's hits, lookups and
evictions equal.  The analytic oracles run on the port: freestream
preservation, mass conservation of an advected blob, heat release of a
single-step flame.  tests/fixtures/reacting_case builds, steps, writes
(every specie, Ydefault-templated ones included), resumes, checkpoints and
runs through the CLI as the JAX package's does.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import same_iterations, solve_logs
from qgdsolver_tpu import cli as jcli
from qgdsolver_tpu.core import bc as jbc
from qgdsolver_tpu.core.mesh import Mesh as JMesh
from qgdsolver_tpu.io import foam_case as jfc
from qgdsolver_tpu.physics import chemistry as jc
from qgdsolver_tpu.physics import species as jsp
from qgdsolver_tpu.physics import thermo as jth
from qgdsolver_tpu.physics.qgdcoeffs import ConstScPrModel1
from qgdsolver_tpu.solvers import common as jcommon
from qgdsolver_tpu.solvers.reacting import ReactingQGDFoam as JReacting
from qgdsolver_tpu_torch import cli, interop
from qgdsolver_tpu_torch.io import foam_case, foam_write
from qgdsolver_tpu_torch.physics import chemistry as tc
from qgdsolver_tpu_torch.solvers import common
from qgdsolver_tpu_torch.utils import checkpoint

F64 = torch.float64
ROUND_OFF = 1e-9
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
FIELDS = ("rho", "rhoU", "rhoE", "Y", "T")


def _mix(hf_F=-7.49e6):
    F = jsp.Specie(name="F", W=16.0, Cp=2200.0, hf=hf_F, Sc=0.7)
    O = jsp.Specie(name="O", W=32.0, Cp=920.0, hf=0.0, Sc=0.8)
    N = jsp.Specie(name="N", W=28.0, Cp=1040.0, hf=0.0, Sc=1.0)
    return jsp.MixtureThermo(species=(F, O, N), inert_index=2,
                             transport=jth.ConstTransport(1.8e-5), Pr=0.7)


def _rxn(A=7e8):
    return jc.Reaction(lhs=((0, 1.0), (1, 2.0)), rhs=((2, 2.5),), A=A,
                       beta=0.0, Ta=2000.0)


PER = jbc.FieldBCs.uniform(jbc.Periodic(), 2)


def _solver(shape, lengths, **kw):
    kw.setdefault("bc_U", PER)
    kw.setdefault("bc_p", PER)
    kw.setdefault("bc_T", PER)
    kw.setdefault("bc_Y", PER)
    kw.setdefault("mixture", _mix())
    kw.setdefault("tau_model", ConstScPrModel1(alpha=0.5))
    return JReacting(mesh=JMesh.uniform(shape, lengths=lengths,
                                        dtype=np.float64), **kw)


def _state(solver, T0=1200.0, U=(0.0, 0.0), Y=(0.1, 0.5, 0.4), seed=None):
    """The JAX State of uniform (or, with a seed, perturbed) fields."""
    shape = solver.mesh.shape
    rng = np.random.default_rng(seed)
    wob = (lambda s: 1.0 + s * rng.standard_normal(shape)) if seed \
        is not None else (lambda s: 1.0)
    Y0 = np.stack([np.full(shape, y) * wob(0.05) for y in Y[:-1]])
    Y0 = np.concatenate([Y0, 1.0 - Y0.sum(0, keepdims=True)])
    U0 = np.stack([np.full(shape, u) * wob(0.1) for u in U])
    return solver.init(p0=jnp.full(shape, 1e5) * wob(0.01),
                       T0=jnp.asarray(np.full(shape, T0) * wob(0.02)),
                       U0=jnp.asarray(U0), Y0=jnp.asarray(Y0))


def _gap(a, b, floor=0.0):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b))
                 / max(np.max(np.abs(a)), floor, 1e-300))


def _np(s):
    return jax.tree.map(np.asarray, s)


def _windows(jsolver, js, n, monkeypatch, floors=None, sources=None):
    """n steps of the JAX solver and n one-step windows of its port from
    the JAX States: each field within 1e-9 of its max (2*cg_tol with a
    CG solve, each solve's iteration count equal); the table's counters
    equal.  sources: (JAX hook, port hook) of `make_step`.  Returns the
    JAX States and the port's last window State."""
    floors = floors or {}
    tsolver = interop.solver_from(jsolver, dtype=F64)
    jkw, tkw = ({"sources": sources[0]}, {"sources": sources[1]}) \
        if sources else ({}, {})
    jstep = jax.jit(jsolver.make_step(**jkw))
    tstep = tsolver.make_step(**tkw)
    tol = 2 * jsolver.cg_tol if jsolver.implicit_diffusion else ROUND_OFF
    states = [js]
    with solve_logs(monkeypatch) as (jlog, tlog):
        for _ in range(n):
            states.append(jstep(states[-1]))
        jax.block_until_ready(states[-1])
        for k in range(n):
            ts = tstep(interop.state_from_numpy(_np(states[k]), dtype=F64))
            for f in FIELDS:
                gap = _gap(getattr(states[k + 1], f), getattr(ts, f).numpy(),
                           floors.get(f, 0.0))
                assert gap <= tol, (k, f, gap)
            if ts.tab is not None:
                for c in ("hits", "lookups", "evictions"):
                    assert tc.DeviceISAT.counter(ts.tab, c) == \
                        jc.DeviceISAT.counter(states[k + 1].tab, c), (k, c)
    same_iterations(jlog, tlog, jsolver.cg_tol)
    return states, ts


def test_mixture_thermo_matches_jax():
    """e(T, Y), its Newton inversion, R, cp, gamma, c, psi and the
    species' Hs and Es of a constant-cp and a JANAF mixture equal the JAX
    package's; T round-trips through e to 1e-8 and p through rho to
    1e-12."""
    import test_chemistry_models as jt

    def janaf(W, low, high):
        return jth.JanafThermo(R=jsp.R_UNIVERSAL / W, low=low, high=high)

    jan = jsp.MixtureThermo(species=(
        jsp.Specie(name="H2", W=2.01588, janaf=janaf(2.01588, jt.H2_LOW,
                                                     jt.H2_HIGH)),
        jsp.Specie(name="H", W=1.00794, janaf=janaf(1.00794, jt.H_LOW,
                                                    jt.H_HIGH))))
    rng = np.random.default_rng(0)
    for jmix in (_mix(), jan):
        mix = interop._carried(jmix)
        ns = jmix.n_species
        Y = rng.uniform(0.05, 1.0, (ns, 16))
        Y /= Y.sum(0)
        T = rng.uniform(400.0, 2500.0, 16)
        p = rng.uniform(5e4, 2e5, 16)
        jY, jT, jp = jnp.asarray(Y), jnp.asarray(T), jnp.asarray(p)
        tY, tT, tp = (torch.as_tensor(x) for x in (Y, T, p))
        e = jmix.e_from_T(jY, jT)
        for name, jv, tv in (
                ("e", e, mix.e_from_T(tY, tT)),
                ("T", jmix.T_from_e(jY, e, jnp.full(16, 900.0)),
                 mix.T_from_e(tY, torch.as_tensor(np.array(e)),
                              torch.full((16,), 900.0, dtype=F64))),
                ("R", jmix.R(jY), mix.R(tY)),
                ("cp", jmix.cp(jY, jT), mix.cp(tY, tT)),
                ("gamma", jmix.gamma(jY, jT), mix.gamma(tY, tT)),
                ("c", jmix.c_from_pT(jY, jp, jT), mix.c_from_pT(tY, tp, tT)),
                ("psi", jmix.psi(jY, jT), mix.psi(tY, tT)),
                ("hs", jnp.stack([jmix.hs_i(i, jT) for i in range(ns)]),
                 torch.stack([mix.hs_i(i, tT) for i in range(ns)])),
                ("es", jnp.stack([jmix.es_i(i, jT) for i in range(ns)]),
                 torch.stack([mix.es_i(i, tT) for i in range(ns)]))):
            assert _gap(jv, tv.numpy()) <= 1e-12, name
        T2 = mix.T_from_e(tY, mix.e_from_T(tY, tT),
                          torch.full((16,), 500.0, dtype=F64))
        np.testing.assert_allclose(T2.numpy(), T, rtol=1e-8)
        rho = mix.rho_from_p_T(tY, tp, tT)
        np.testing.assert_allclose(mix.p_from_rho_T(tY, rho, tT).numpy(), p,
                                   rtol=1e-12)


def test_freestream_preservation_multispecies(monkeypatch):
    """A uniform periodic stream of three species stays uniform in the
    port (10 steps: rho to 1e-12, Y to 1e-12); 3 windows against the JAX
    package."""
    js = _solver((12, 8), (1.0, 1.0), combustion=jc.NoCombustion(),
                 time=jcommon.TimeControls(max_co=0.3, max_dt=1e-3,
                                           dt0=1e-6))
    s0 = _state(js, T0=600.0, U=(80.0, 0.0), Y=(0.2, 0.3, 0.5))
    _windows(js, s0, 3, monkeypatch)
    solver = interop.solver_from(js, dtype=F64)
    s = common.run_steps(solver.make_step(),
                         interop.state_from_numpy(_np(s0), dtype=F64), 10)
    np.testing.assert_allclose(s.rho.numpy(), float(s.rho[0, 0]),
                               rtol=1e-12)
    np.testing.assert_allclose(s.Y[0].numpy(), 0.2, atol=1e-12)
    np.testing.assert_allclose(s.Y[2].numpy(), 0.5, atol=1e-12)


def _blob(shape=(48, 8)):
    js = _solver(shape, (1.0, 0.2), combustion=jc.NoCombustion(),
                 implicit_diffusion=True,
                 time=jcommon.TimeControls(max_co=0.3, max_dt=1e-3,
                                           dt0=1e-6))
    x = np.asarray(js.mesh.cell_coords(0)) * np.ones(shape)
    yF = 0.3 * np.exp(-((x - 0.3) / 0.08) ** 2)
    Y0 = jnp.stack([jnp.asarray(yF), jnp.full(shape, 0.2),
                    jnp.asarray(0.8 - yF)])
    return js, js.init(p0=jnp.full(shape, 1e5), T0=jnp.full(shape, 400.0),
                       U0=jnp.stack([jnp.full(shape, 50.0),
                                     jnp.zeros(shape)]), Y0=Y0)


def test_species_advection_and_mass_conservation(monkeypatch):
    """Implicit diffusion (CG Helmholtz solves of Y, U and e): 3 windows
    against the JAX package with equal CG counts; in the port a fuel blob
    advects downstream over 60 steps, the species stay in [0, 1] and sum
    to 1 to 1e-10."""
    js, s0 = _blob()
    _windows(js, s0, 3, monkeypatch, floors={"rhoU": 1.0})
    solver = interop.solver_from(js, dtype=F64)
    s = common.run_steps(solver.make_step(),
                         interop.state_from_numpy(_np(s0), dtype=F64), 60)
    np.testing.assert_allclose(s.Y.sum(0).numpy(), 1.0, atol=1e-10)
    assert float(s.Y.min()) >= 0.0 and bool(torch.isfinite(s.rho).all())
    i0 = int(torch.argmax(s.Y[0][:, 4]))
    assert solver.mesh.centers[0][i0] > 0.3 + 0.01


def _flame(**kw):
    return _solver((8, 8), (0.1, 0.1), mixture=_mix(hf_F=5.0e6),
                   combustion=jc.Laminar(reactions=(_rxn(),)), **kw)


def test_single_step_combustion_releases_heat(monkeypatch):
    """F + 2 O -> products, Arrhenius: 3 windows against the JAX package;
    in the port over 50 steps the fuel burns (max Y_F < 0.09), T rises
    above 1250 K and the species sum to 1 to 1e-9."""
    js = _flame(time=jcommon.TimeControls(max_co=0.3, max_dt=2e-5,
                                          dt0=1e-7))
    s0 = _state(js)
    _windows(js, s0, 3, monkeypatch, floors={"rhoU": 1.0})
    solver = interop.solver_from(js, dtype=F64)
    s = common.run_steps(solver.make_step(),
                         interop.state_from_numpy(_np(s0), dtype=F64), 50)
    assert float(s.Y[0].max()) < 0.09
    assert float(s.T.min()) > 1250.0
    np.testing.assert_allclose(s.Y.sum(0).numpy(), 1.0, atol=1e-9)


def test_device_isat_tabulated_run_matches_jax():
    """TDAC with a DeviceISAT on a fixed dt (tests/test_reacting.py's
    quasi-steady flame): over 10 free steps the port's hits, lookups and
    evictions equal the JAX package's (lookups 640, hits above 80% of the
    last 9 steps' cells), its fields stay within 1e-9 of the JAX run's,
    and the retrieved rates track the direct integration (T to 1e-4, Y to
    2e-3)."""
    tdac = jc.TDACChemistrySolver(
        base=jc.SubcycledEuler(n_sub=2),
        tabulation=jc.DeviceISAT(tol=1e-3, capacity=1 << 10))
    tctl = jcommon.TimeControls(adjust_time_step=False, dt0=1e-7)
    js = _solver((8, 8), (0.1, 0.1), mixture=_mix(hf_F=5.0e6),
                 combustion=jc.Laminar(reactions=(_rxn(A=5e5),)),
                 chemistry_solver=tdac, time=tctl)
    s0 = _state(js)
    jref = jcommon.run_steps(jax.jit(js.make_step()), s0, 10)
    solver = interop.solver_from(js, dtype=F64)
    st = common.run_steps(solver.make_step(),
                          interop.state_from_numpy(_np(s0), dtype=F64), 10)
    for c in ("hits", "lookups", "evictions"):
        assert tc.DeviceISAT.counter(st.tab, c) == \
            jc.DeviceISAT.counter(jref.tab, c), c
    assert tc.DeviceISAT.counter(st.tab, "lookups") == 640
    assert tc.DeviceISAT.counter(st.tab, "hits") > 0.8 * 9 * 64
    for f in FIELDS:
        assert _gap(getattr(jref, f), getattr(st, f).numpy(),
                    1.0 if f == "rhoU" else 0.0) <= ROUND_OFF, f
    direct = interop.solver_from(
        _solver((8, 8), (0.1, 0.1), mixture=_mix(hf_F=5.0e6),
                combustion=jc.Laminar(reactions=(_rxn(A=5e5),)),
                chemistry_solver=jc.SubcycledEuler(n_sub=2), time=tctl),
        dtype=F64)
    sd = direct.init(p0=st.rho.new_full((8, 8), 1e5),
                     T0=st.rho.new_full((8, 8), 1200.0),
                     U0=st.rho.new_zeros((2, 8, 8)),
                     Y0=torch.as_tensor(np.array(s0.Y)))
    assert sd.tab is None
    sd = common.run_steps(direct.make_step(), sd, 10)
    np.testing.assert_allclose(st.T.numpy(), sd.T.numpy(), rtol=1e-4)
    np.testing.assert_allclose(st.Y.numpy(), sd.Y.numpy(), rtol=2e-3,
                               atol=1e-6)


def _jet_bcs():
    """Non-periodic sides: a fixed inflow on x low (per-specie inlet
    values), inletOutlet and zero gradients elsewhere."""
    zg = jbc.ZeroGradient()
    bc_U = jbc.FieldBCs(((jbc.FixedValue([60.0, 0.0]), zg),
                         (zg, jbc.InletOutlet([0.0, 0.0]))))
    bc_p = jbc.FieldBCs(((zg, jbc.FixedValue(1e5)), (zg, zg)))
    bc_T = jbc.FieldBCs(((jbc.FixedValue(900.0), zg),
                         (zg, jbc.InletOutlet(900.0))))
    bc_Y = tuple(jbc.FieldBCs(((jbc.FixedValue(v), zg), (zg, zg)))
                 for v in (0.3, 0.2, 0.5))
    return dict(bc_U=bc_U, bc_p=bc_p, bc_T=bc_T, bc_Y=bc_Y)


def _variant(kind):
    tctl = jcommon.TimeControls(max_co=0.3, max_dt=1e-5, dt0=1e-7)
    lam = jc.Laminar(reactions=(_rxn(),))
    if kind == "inflow_per_specie_bcs":
        return _solver((16, 8), (0.2, 0.1), combustion=lam, time=tctl,
                       **_jet_bcs())
    if kind == "implicit":
        return _solver((16, 8), (0.2, 0.1), combustion=lam, time=tctl,
                       implicit_diffusion=True, **_jet_bcs())
    if kind == "diffusion_flame":
        return _solver((16, 8), (0.2, 0.1), time=tctl, combustion=jc.Diffusion(
            fuel=0, oxidizer=1, products=((2, 5.0),), s=4.0, q_fuel=5e7))
    if kind == "ode_pasr":
        return _solver((16, 8), (0.2, 0.1), time=tctl,
                       combustion=jc.PaSR(base=lam),
                       chemistry_solver=jc.SubcycledRK4(n_sub=3))
    # a DeviceISAT given directly, a reduced scheme
    return _solver((16, 8), (0.2, 0.1), time=tctl, combustion=lam,
                   chemistry_solver=jc.SubcycledEuler(n_sub=3),
                   tabulation=jc.DeviceISAT(tol=1e-3, capacity=256),
                   fvsc_scheme="reduced")


@pytest.mark.parametrize("kind", ["inflow_per_specie_bcs", "implicit",
                                  "diffusion_flame", "ode_pasr",
                                  "isat_reduced"])
def test_reacting_step_matches_jax(kind, monkeypatch):
    """3 one-step windows of each variant from a seeded State: per-specie
    BCs with an inflow and inletOutlet sides; implicit diffusion; the
    diffusion flame (aux gradients); RK4 under PaSR; a direct DeviceISAT
    with the reduced fvsc scheme."""
    js = _variant(kind)
    s0 = _state(js, T0=1200.0, U=(40.0, 5.0), seed=11)
    _windows(js, s0, 3, monkeypatch)


def test_sources_hook_matches_jax(monkeypatch):
    """The `sources` hook (state, primitives, dt) -> (rhoSu, rhoUSu,
    rhoESu, YSu) of the parcels: fields made from the State and the dt
    the step applies enter every equation as in the JAX package."""
    js = _flame(time=jcommon.TimeControls(max_co=0.3, max_dt=2e-5,
                                          dt0=1e-7))
    s0 = _state(js, U=(30.0, 0.0), seed=3)

    def make(xp):
        def hook(s, prims, dt):
            U, e, T, p = prims
            w = 1e-3 * s.rho * (1.0 + 0.1 * T / 1200.0)
            return (w, 50.0 * w * U, -2e3 * w * e / (1.0 + dt * 1e5),
                    [w, 0.0 * w, 0.0 * w])
        return hook

    _windows(js, s0, 3, monkeypatch, floors={"rhoU": 1.0},
             sources=(make(jnp), make(torch)))


def _reacting_copy(tmp_path, name="reacting"):
    case = tmp_path / name
    shutil.copytree(os.path.join(FIX, "reacting_case"), case)
    return case


def test_reacting_case_builds_and_steps_as_jax(tmp_path):
    """tests/fixtures/reacting_case (tests/test_foam_case_e2e.py:224): the
    species F, O2, N2 (N2 inert, from 0/Ydefault), ScNumbers, the parsed
    reaction, TDAC with an active ISATDevice table in the State (capacity
    2^15), the reacting cloud (rho 800, d^2-law K 1e-9, latent heat 3e5,
    one parcel); 5 steps in both packages: fields within 1e-9 of their
    max, the parcel's state and the table's counters equal."""
    from qgdsolver_tpu_torch.solvers.particles import (
        ReactingLagrangianQGDFoam)

    case = str(_reacting_copy(tmp_path))
    jsolver, js = jfc.build_case(case)
    solver, s = foam_case.build_case(case, device="cpu")
    assert isinstance(solver, ReactingLagrangianQGDFoam)
    mix = solver.fluid.mixture
    assert [sp.name for sp in mix.species] == ["F", "O2", "N2"]
    assert mix.inert == 2 and mix.sc_numbers() == (0.7, 0.8, 1.0)
    assert solver.cloud.rho_p == 800.0 and solver.cloud.K_evap == 1e-9
    assert solver.cloud.latent_heat == 3e5 and solver.cloud.evap_specie == 0
    rxn = solver.fluid.combustion.reactions[0]
    assert (rxn.lhs, rxn.rhs, rxn.A, rxn.Ta) == (((0, 1.0), (1, 2.0)),
                                                 ((2, 2.5),), 5e5, 2000.0)
    assert isinstance(solver.fluid.tabulation, tc.DeviceISAT)
    assert s.fluid.tab["keys"].shape == (6, 1 << 15)
    assert s.fluid.rho.dtype == F64 and s.cloud.x.shape == (2, 1)
    jref = jcommon.run_steps(jax.jit(jsolver.make_step()), js, 5)
    got = common.run_steps(solver.make_step(), s, 5)
    for f in FIELDS:
        assert _gap(getattr(jref.fluid, f), getattr(got.fluid, f).numpy(),
                    1.0 if f == "rhoU" else 0.0) <= ROUND_OFF, f
    for f in ("x", "u", "Tp", "dp", "active"):
        assert _gap(getattr(jref.cloud, f),
                    getattr(got.cloud, f).numpy()) <= ROUND_OFF, f
    for c in ("hits", "lookups", "evictions"):
        assert tc.DeviceISAT.counter(got.fluid.tab, c) == \
            jc.DeviceISAT.counter(jref.fluid.tab, c), c
    assert float(got.cloud.dp[0]) < 5e-5  # the parcel evaporates


def test_reacting_case_writes_every_specie_and_resumes(tmp_path):
    """write_state writes U, p, T and each specie, N2 templated from
    0/Ydefault with its own object word; the latestTime resume reads the
    evolved composition and t back; a tabulated State round-trips through
    a checkpoint (the table dict's leaves by sorted key)."""
    case = _reacting_copy(tmp_path)
    solver, s = foam_case.build_case(str(case), device="cpu")
    s = common.run_steps(solver.make_step(), s, 3)
    tdir = foam_write.write_state(str(case), solver, s)
    assert sorted(os.listdir(tdir)) == ["F", "N2", "O2", "T", "U", "p"]
    assert "object N2;" in open(os.path.join(tdir, "N2")).read()
    ctrl = case / "system" / "controlDict"
    ctrl.write_text(ctrl.read_text().replace("startFrom       startTime;",
                                             "startFrom       latestTime;"))
    _, s2 = foam_case.build_case(str(case), device="cpu")
    np.testing.assert_allclose(s2.fluid.Y.numpy(), s.fluid.Y.numpy(),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(s2.fluid.t), float(s.fluid.t),
                               rtol=1e-10)
    path = checkpoint.save(s, str(tmp_path / "ck"), 3)
    assert path.endswith(".npz")
    back, step = checkpoint.restore_latest(s2, str(tmp_path / "ck"))
    assert step == 3
    for a, b in zip(checkpoint._flatten(s), checkpoint._flatten(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert back.fluid.tab["valid"].dtype == torch.bool
    assert int(back.fluid.tab["lookups"]) == 3 * 64


def test_reacting_cli_matches_jax_cli(tmp_path):
    """Both packages' CLIs on two copies of reacting_case, 10 steps and a
    write: the same time directory, and the written fields (U, p, T and
    every specie), read back by each package's latestTime resume, within
    1e-9 of their max (float64 in both, no CG)."""
    def run(name, fn):
        case = _reacting_copy(tmp_path, name)
        assert fn(str(case)) == 10
        ctrl = case / "system" / "controlDict"
        ctrl.write_text(ctrl.read_text().replace(
            "startFrom       startTime;", "startFrom       latestTime;"))
        return case, sorted(d for d in os.listdir(case)
                            if d not in ("0", "system", "constant"))

    jcase, jdirs = run("j", lambda c: jcli.run_case(
        c, max_steps=10, chunk=5, log=lambda *_: None, fused="never"))
    tcase, tdirs = run("t", lambda c: cli.run_case(
        c, max_steps=10, chunk=5, log=lambda *_: None, device="cpu"))
    assert jdirs == tdirs and len(tdirs) == 1
    assert sorted(os.listdir(tcase / tdirs[0])) == ["F", "N2", "O2", "T",
                                                   "U", "p"]
    _, a = jfc.build_case(str(jcase))
    _, b = foam_case.build_case(str(tcase), device="cpu")
    for f in FIELDS:
        assert _gap(getattr(a.fluid, f), getattr(b.fluid, f).numpy(),
                    1.0 if f == "rhoU" else 0.0) <= ROUND_OFF, f
    assert _gap(a.fluid.t, b.fluid.t.numpy()) <= 1e-12
