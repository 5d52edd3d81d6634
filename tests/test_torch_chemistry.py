"""The port's chemistry and combustion models against the JAX package's.

Mirrors tests/test_chemistry_models.py: the same numpy-seeded inputs go
through the JAX function and the port's (`qgdsolver_tpu_torch.physics
.chemistry`), float64, each result within 1e-12 of its max (the same
formulas in the same order); the registry's words; DRG's pruned set and the
host ISAT's hit and miss counts equal; DeviceISAT's hits, lookups and
evictions equal and its table's keys and flags bitwise, the saturated
64-into-16 table and the one-slot false-hit rejection included.  The
analytic oracles run on the port: the sub-cycled integrators against the
exponential decay, the PSR equilibrium of H2 + M = 2H + M at 3000 K, the
third-body efficiencies, and the mixing-limited families' closed forms.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgdsolver_tpu.core import registry as jregistry
from qgdsolver_tpu.io import foam_case as jfc
from qgdsolver_tpu.physics import chemistry as jc
from qgdsolver_tpu.physics import species as jsp
from qgdsolver_tpu.physics import thermo as jth
from qgdsolver_tpu_torch import interop
from qgdsolver_tpu_torch.core import registry
from qgdsolver_tpu_torch.io import foam_case
from qgdsolver_tpu_torch.physics import chemistry as tc

F64 = torch.float64
TOL = 1e-12
KINDS = ("combustion", "chemistrySolver", "chemistryReduction",
         "chemistryTabulation")


def _jmix():
    F = jsp.Specie(name="F", W=16.0, Cp=2200.0, hf=-7.49e6, Sc=0.7)
    O = jsp.Specie(name="O", W=32.0, Cp=920.0, hf=0.0, Sc=0.8)
    P = jsp.Specie(name="P", W=44.0, Cp=1100.0, hf=-9.0e6, Sc=0.9)
    N = jsp.Specie(name="N", W=28.0, Cp=1040.0, hf=0.0, Sc=1.0)
    return jsp.MixtureThermo(species=(F, O, P, N), inert_index=3,
                             transport=jth.ConstTransport(1.8e-5), Pr=0.7)


def _inputs(seed=0):
    """(Y tuple, rho, T, p) on a 4x4 patch, from a numpy seed."""
    rng = np.random.default_rng(seed)
    Y = np.stack([rng.uniform(0.01, 0.1, (4, 4)), rng.uniform(0.1, 0.3,
                                                            (4, 4)),
                  rng.uniform(0.0, 0.1, (4, 4))])
    Y = np.concatenate([Y, 1.0 - Y.sum(0, keepdims=True)])
    return (tuple(Y), rng.uniform(0.9, 1.3, (4, 4)),
            rng.uniform(1200.0, 1800.0, (4, 4)), np.full((4, 4), 1e5))


def _j(arrs):
    Y, rho, T, p = arrs
    return tuple(jnp.asarray(y) for y in Y), jnp.asarray(rho), \
        jnp.asarray(T), jnp.asarray(p)


def _t(arrs):
    Y, rho, T, p = arrs
    return tuple(torch.as_tensor(y) for y in Y), torch.as_tensor(rho), \
        torch.as_tensor(T), torch.as_tensor(p)


def _gap(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-300))


def _same(jout, tout):
    (jrr, jq), (trr, tq) = jout, tout
    assert len(jrr) == len(trr)
    for a, b in zip(jrr, trr):
        assert _gap(a, b) <= TOL
    assert _gap(jq, tq) <= TOL


def _jrxn():
    return jc.Reaction(lhs=((0, 1.0), (1, 2.0)), rhs=((2, 1.0),), A=1e8,
                       beta=0.3, Ta=10000.0)


def _models():
    """name -> the JAX model of each combustion family."""
    lam = jc.Laminar(reactions=(_jrxn(),))
    prods = ((2, 5.0),)
    rng = np.random.default_rng(5)
    return {
        "none": jc.NoCombustion(),
        "laminar": lam,
        "eddyDissipation": jc.EddyDissipation(fuel=0, oxidizer=1,
                                              products=prods, s=4.0,
                                              q_fuel=5e7),
        "infinitelyFastChemistry": jc.InfinitelyFastChemistry(
            fuel=0, oxidizer=1, products=prods, s=4.0, C=1.0, q_fuel=5e7),
        "PaSR": jc.PaSR(base=lam, t_mix=1e-4),
        "eddyDissipationDiffusion": jc.EddyDissipationDiffusion(
            fuel=0, oxidizer=1, products=prods, s=4.0, q_fuel=5e7),
        "zoneCombustion": jc.ZoneCombustion(
            base=lam, mask=jnp.asarray((rng.random((4, 4)) > 0.5) * 1.0)),
        "EDC": jc.EDC(base=lam, k=1.0, eps=1e3, nu=1.5e-5),
        "FSD": jc.FSD(fuel=0, oxidizer=1, products=prods, s=4.0, YF0=0.12,
                      S_L=0.4, delta_L=5e-4, rho_u=1.2, q_fuel=5e7),
        "diffusion": jc.Diffusion(fuel=0, oxidizer=1, products=prods,
                                  s=4.0, C=500.0, q_fuel=5e7),
        "diffusionMulticomponent": jc.DiffusionMulticomponent(
            pairs=((0, 1),), si=(4.0,), Ci=(500.0,), products=((2, 1.0),),
            q_fuel=(5e7,)),
    }


def _aux(seed=6):
    rng = np.random.default_rng(seed)
    g = rng.normal(0.0, 3.0, (4, 2, 4, 4))
    mu = rng.uniform(1e-5, 2e-5, (4, 4))
    return ({"gradY": tuple(jnp.asarray(x) for x in g),
             "mu_eff": jnp.asarray(mu)},
            {"gradY": tuple(torch.as_tensor(x) for x in g),
             "mu_eff": torch.as_tensor(mu)})


def test_registry_words_match_jax():
    """Every word of the four chemistry kinds that the JAX package
    registers, the port registers (the reference's selection tables)."""
    for kind in KINDS:
        assert registry.available(kind) == jregistry.available(kind), kind
    assert {"none", "noCombustion", "laminar", "eddyDissipation", "PaSR",
            "infinitelyFastChemistry", "eddyDissipationDiffusion",
            "zoneCombustion", "EDC", "FSD", "diffusion",
            "diffusionMulticomponent"} <= set(registry.available(
                "combustion"))
    assert {"none", "EulerImplicit", "euler", "ode", "TDAC"} <= set(
        registry.available("chemistrySolver"))
    assert registry.available("chemistryTabulation") == [
        "ISAT", "ISATDevice", "none"]


@pytest.mark.parametrize("name", sorted(_models()))
def test_combustion_model_matches_jax(name):
    """Each combustion family's sources and heat release on the same
    seeded state (aux fields for the gradient-limited families), within
    1e-12 of their max; the port's model is the JAX one carried across."""
    jmodel = _models()[name]
    tmodel = interop._carried(jmodel)
    assert type(tmodel).__name__ == type(jmodel).__name__
    jmix = _jmix()
    tmix = interop._carried(jmix)
    arrs = _inputs(1)
    jaux, taux = _aux()
    _same(jc._call(jmodel, jmix, *_j(arrs), 1e-3, aux=jaux),
          tc._call(tmodel, tmix, *_t(arrs), 1e-3, aux=taux))


@pytest.mark.parametrize("solver", ["none", "EulerImplicit", "ode"])
def test_chemistry_solver_matches_jax(solver):
    """The integrators' mean rates over a stiff dt (k dt = 2) equal the
    JAX package's."""
    jmix = _jmix()
    rxn = jc.Reaction(lhs=((0, 1.0),), rhs=((2, 16.0 / 44.0),), A=2000.0)
    jlam = jc.Laminar(reactions=(rxn,))
    js = jregistry.create("chemistrySolver", solver)
    ts = registry.create("chemistrySolver", solver)
    arrs = _inputs(2)
    _same(js.rates(jlam, jmix, *_j(arrs), 1e-3),
          ts.rates(interop._carried(jlam), interop._carried(jmix),
                   *_t(arrs), 1e-3))


def test_chemistry_solvers_converge_to_exponential_decay():
    """dY/dt = -k Y: the sub-cycled integrators beat the instantaneous
    split step, RK4 within 2e-5 and Euler within 2e-3 of exp(-k dt)."""
    mix = interop._carried(_jmix())
    Y = tuple(torch.full((4, 4), y, dtype=F64)
              for y in (0.05, 0.2, 0.05, 0.7))
    rho = torch.full((4, 4), 1.1, dtype=F64)
    T = torch.full((4, 4), 1500.0, dtype=F64)
    p = torch.full((4, 4), 1e5, dtype=F64)
    k, dt = 2000.0, 1e-3
    lam = tc.Laminar(reactions=(tc.Reaction(lhs=((0, 1.0),),
                                            rhs=((2, 16.0 / 44.0),), A=k),))
    exact = 0.05 * np.exp(-k * dt)

    def y_end(solver):
        rr, _ = solver.rates(lam, mix, Y, rho, T, p, dt)
        return 0.05 + dt * float(rr[0][0, 0]) / 1.1

    y_direct = y_end(tc.DirectRates())
    y_euler = y_end(tc.SubcycledEuler(n_sub=64))
    y_rk = y_end(tc.SubcycledRK4(n_sub=8))
    assert abs(y_euler - exact) < abs(y_direct - exact)
    assert abs(y_rk - exact) < 2e-5
    assert abs(y_euler - exact) < 2e-3


def test_mixing_limited_closed_forms():
    """infinitelyFastChemistry consumes the deficient reactant in C*dt,
    mass-conserving; PaSR scales Laminar by kappa in (0, 1]; EDC by
    gammaL^2/(1-gammaL^3); FSD peaks at c = 1/2 and vanishes unburnt;
    the zone mask zeroes its outside."""
    mix = interop._carried(_jmix())
    Y = tuple(torch.full((4, 4), y, dtype=F64)
              for y in (0.05, 0.2, 0.05, 0.7))
    rho = torch.full((4, 4), 1.1, dtype=F64)
    T = torch.full((4, 4), 1500.0, dtype=F64)
    p = torch.full((4, 4), 1e5, dtype=F64)
    ifc = tc.InfinitelyFastChemistry(fuel=0, oxidizer=1,
                                     products=((2, 5.0),), s=4.0, C=1.0,
                                     q_fuel=5e7)
    RR, Q = ifc.correct(mix, Y, rho, T, p, dt=1e-3)
    np.testing.assert_allclose(RR[0].numpy(), -1.1 * 0.05 / 1e-3, rtol=1e-12)
    np.testing.assert_allclose(sum(RR).numpy(), 0.0, atol=1e-9)
    assert float(Q[0, 0]) > 0
    lam = tc.Laminar(reactions=(tc.Reaction(lhs=((0, 1.0), (1, 2.0)),
                                            rhs=((2, 1.0),), A=1e8,
                                            Ta=10000.0),))
    rr_l, q_l = lam.correct(mix, Y, rho, T, p)
    rr_p, q_p = tc.PaSR(base=lam, t_mix=1e-4).correct(mix, Y, rho, T, p)
    ratio = float(q_p[0, 0] / q_l[0, 0])
    assert 0.0 < ratio <= 1.0
    for a, b in zip(rr_p, rr_l):
        assert (a.abs() <= b.abs() + 1e-12).all()
    gl = 2.1377 * (1.5e-5 * 1e3) ** 0.25
    rr_e, _ = tc.EDC(base=lam).correct(mix, Y, rho, T, p)
    np.testing.assert_allclose(rr_e[0].numpy(),
                               gl ** 2 / (1 - gl ** 3) * rr_l[0].numpy(),
                               rtol=1e-12)
    fsd = tc.FSD(fuel=0, oxidizer=1, products=((2, 5.0),), s=4.0, YF0=0.05,
                 S_L=0.4, delta_L=5e-4, rho_u=1.2, q_fuel=5e7)
    unburnt = (torch.full_like(T, 0.05),) + Y[1:]
    half = (torch.full_like(T, 0.025),) + Y[1:]
    assert float(fsd.correct(mix, unburnt, rho, T, p)[0][0].abs().max()) \
        < 1e-10
    np.testing.assert_allclose(fsd.correct(mix, half, rho, T, p)[0][0],
                               -1.2 * 0.4 * 0.05 / 5e-4, rtol=1e-12)
    mask = np.zeros((4, 4))
    mask[:2] = 1.0
    zoned = tc.ZoneCombustion(base=tc.EddyDissipation(
        fuel=0, oxidizer=1, products=((2, 5.0),), s=4.0), mask=mask)
    rr_z, _ = zoned.correct(mix, Y, rho, T, p)
    assert float(rr_z[0][3, 3]) == 0.0 and float(rr_z[0][0, 0]) != 0.0


def test_drg_pruned_set_matches_jax():
    """DRG from the fuel keeps F, O, P and drops the N path with a
    negligible rate, as the JAX package's; the pruned mechanisms equal."""
    jmix = _jmix()
    r1 = jc.Reaction(lhs=((0, 1.0), (1, 2.0)), rhs=((2, 1.0),), A=1e8,
                     Ta=1000.0)
    r2 = jc.Reaction(lhs=((3, 1.0),), rhs=((1, 28.0 / 32.0),), A=1e-20)
    Y0 = (0.05, 0.2, 0.05, 0.7)
    jpruned, jkeep = jc.DRG(targets=(0,)).reduce(jmix, (r1, r2), Y0, 1500.0,
                                                 1e5)
    tpruned, tkeep = tc.DRG(targets=(0,)).reduce(
        interop._carried(jmix), interop._carried((r1, r2)), Y0, 1500.0, 1e5)
    assert tkeep == jkeep == (0, 1, 2)
    assert [dataclasses.asdict(r) for r in tpruned] == \
        [dataclasses.asdict(r) for r in jpruned]
    assert len(tpruned) == 1


def test_host_isat_counts_match_jax():
    """TDAC with DRG and the host ISAT: the rates track the direct
    integration within the table's tolerance, and two calls give the JAX
    package's hit and miss counts (eager JAX, as the port always is)."""
    jmix = _jmix()
    rxn = jc.Reaction(lhs=((0, 1.0),), rhs=((2, 16.0 / 44.0),), A=2000.0)
    jlam = jc.Laminar(reactions=(rxn,))
    ref = ((0.05, 0.2, 0.05, 0.7), 1500.0, 1e5)
    rng = np.random.default_rng(4)
    arrs = _inputs(4)
    # a few repeated cells: their keys hit within one call
    arrs = (tuple(np.where(rng.random((4, 4)) < 0.3, 0.05, y)
                  for y in arrs[0]),) + arrs[1:]
    out = {}
    for name, mod, conv in (("jax", jc, _j), ("port", tc, _t)):
        isat = mod.ISAT(tol=1e-4)
        mix = jmix if mod is jc else interop._carried(jmix)
        lam = jlam if mod is jc else interop._carried(jlam)
        tdac = mod.TDACChemistrySolver(
            base=mod.SubcycledEuler(n_sub=16),
            reduction=mod.DRG(targets=(0,)), tabulation=isat, ref_state=ref)
        first = tdac.rates(lam, mix, *conv(arrs), 1e-3)
        tdac.rates(lam, mix, *conv(arrs), 1e-3)
        out[name] = (isat.hits, isat.misses, first,
                     mod.SubcycledEuler(n_sub=16).rates(lam, mix,
                                                        *conv(arrs), 1e-3))
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][0] >= 16
    _same(out["jax"][2], out["port"][2])
    for a, b in zip(out["port"][2][0], out["port"][3][0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-8)


class _Mix:
    n_species = 1


def _isat_case(name):
    """(capacity, n_species, calls of (T, p, Y list, dt)) of a DeviceISAT
    comparison."""
    n = 64
    T = np.linspace(300.0, 3000.0, n)
    sweep = (T, np.full(n, 1e5), [np.linspace(0.0, 1.0, n)], 1e-6)
    if name == "repeat":  # tests/test_chemistry_models.py, engages under jit
        T3 = np.array([1000.0, 1200.0, 1000.0])
        call = (T3, np.full(3, 1e5),
                [np.array([0.2, 0.3, 0.2]), np.array([0.8, 0.7, 0.8])], 1e-6)
        return 1 << 10, 2, [call, call]
    if name == "false_hit":  # one slot: a colliding key must not retrieve
        return 1, 1, [(np.array([1000.0]), np.array([1e5]), [np.array([0.2])],
                       1e-6),
                      (np.array([1300.0]), np.array([1e5]), [np.array([0.4])],
                       1e-6)]
    if name == "comfortable":
        return 1 << 12, 1, [sweep, sweep]
    if name == "saturated":  # 64 keys into 16 slots
        return 16, 1, [sweep, sweep, sweep]
    rng = np.random.default_rng(7)  # a random state revisited in part
    Tr = rng.uniform(800.0, 2500.0, 256)
    Yr = [rng.uniform(0.0, 0.5, 256), rng.uniform(0.0, 0.5, 256)]
    half = (Tr[:128].repeat(2), np.full(256, 2e5),
            [y[:128].repeat(2) for y in Yr], 2e-6)
    return 64, 2, [(Tr, np.full(256, 2e5), Yr, 2e-6), half,
                   (Tr, np.full(256, 2e5), Yr, 2e-6)]


def _jcompute(Y, rho, T, p, dt, miss=None):
    return tuple(-0.1 * Yi * T + 7.0 * i for i, Yi in enumerate(Y)), \
        1e3 * Y[0] * T


def _tcompute(Y, rho, T, p, dt, miss=None):
    return tuple(-0.1 * Yi * T + 7.0 * i for i, Yi in enumerate(Y)), \
        1e3 * Y[0] * T


@pytest.mark.parametrize("name", ["repeat", "false_hit", "comfortable",
                                  "saturated", "random"])
def test_device_isat_matches_jax(name):
    """Each call's retrieved rates and every counter equal the JAX
    package's, and the tables' keys and valid flags are bitwise the same
    after each call: the port's explicit writer (per slot, the largest
    cell index that maps to it) is the order the JAX package's scatter
    applies.  The saturated table evicts and misses on its repeat pass;
    the one-slot table recomputes a colliding composition."""
    cap, ns, calls = _isat_case(name)

    class Mix:
        n_species = ns

    jt, tt = jc.DeviceISAT(tol=1e-3, capacity=cap), \
        tc.DeviceISAT(tol=1e-3, capacity=cap)
    jtab, ttab = jt.init(ns, dtype=jnp.float64), tt.init(ns, dtype=F64)
    for T, p, Y, dt in calls:
        rho = np.ones_like(T)
        jout, jtab = jt.rates_stateful(
            jtab, _jcompute, Mix, tuple(jnp.asarray(y) for y in Y),
            jnp.asarray(rho), jnp.asarray(T), jnp.asarray(p), dt)
        tout, ttab = tt.rates_stateful(
            ttab, _tcompute, Mix, tuple(torch.as_tensor(y) for y in Y),
            torch.as_tensor(rho), torch.as_tensor(T), torch.as_tensor(p), dt)
        _same(jout, tout)
        for k in ("hits", "lookups", "evictions"):
            assert tc.DeviceISAT.counter(ttab, k) == \
                jc.DeviceISAT.counter(jtab, k), k
        for k in ("keys", "valid"):
            assert np.array_equal(np.asarray(jtab[k]), ttab[k].numpy()), k
    hits = tc.DeviceISAT.counter(ttab, "hits")
    ev = tc.DeviceISAT.counter(ttab, "evictions")
    if name == "repeat":
        assert hits == 3
    if name == "false_hit":
        assert hits == 0 and float(tout[1][0]) == 1e3 * 0.4 * 1300.0
    if name == "saturated":
        assert ev > 0 and hits < 2 * 64
    if name == "comfortable":
        assert ev <= 3 and hits >= 64 - 4


def test_device_isat_skips_compute_when_every_cell_hits():
    """A repeat call retrieves every cell: the compute is not called, one
    host read is counted, and the table is unchanged."""
    calls = []

    def compute(Y, rho, T, p, dt):
        calls.append(1)
        return (0.5 * Y[0],), 2.0 * T

    tab = tc.DeviceISAT(tol=1e-3, capacity=64)
    table = tab.init(1, dtype=F64)
    T = torch.linspace(500.0, 900.0, 8, dtype=F64)
    args = (_Mix, (torch.full_like(T, 0.3),), torch.ones_like(T), T,
            torch.full_like(T, 1e5), 1e-6)
    reads = tc.DeviceISAT.reads
    (rr1, _), table = tab.rates_stateful(table, compute, *args)
    (rr2, _), table2 = tab.rates_stateful(table, compute, *args)
    assert len(calls) == 1 and tc.DeviceISAT.reads - reads == 2
    assert torch.equal(rr1[0], rr2[0])
    assert all(torch.equal(table[k], table2[k])
               for k in ("keys", "valid", "rr", "q"))
    assert tc.DeviceISAT.counter(table2, "hits") == 8


def _h2_mix():
    """GRI-Mech 3.0's H2 and H, JANAF (tests/test_chemistry_models.py)."""
    import test_chemistry_models as jt

    def sp(name, W, low, high):
        return jsp.Specie(name=name, W=W, Cp=0.0, hf=0.0,
                          janaf=jth.JanafThermo(R=jsp.R_UNIVERSAL / W,
                                                low=low, high=high))

    return jsp.MixtureThermo(
        species=(sp("H2", 2.01588, jt.H2_LOW, jt.H2_HIGH),
                 sp("H", 1.00794, jt.H_LOW, jt.H_HIGH)),
        inert_index=-1, transport=jth.ConstTransport(mu0=0.0), Pr=0.7)


def test_reversible_third_body_psr_equilibrium():
    """H2 + M = 2H + M at 3000 K: the port's Kc(T) and net rate equal the
    JAX package's, and its perfectly stirred reactor relaxes to
    [H]^2/[H2] = Kc with the H atoms conserved, Kp in the literature band
    (~0.026 atm)."""
    from qgdsolver_tpu_torch.physics.species import R_UNIVERSAL

    jmix = _h2_mix()
    mix = interop._carried(jmix)
    jrxn = jc.Reaction(lhs=((0, 1.0),), rhs=((1, 2.0),), A=1e5,
                       reversible=True, third_body=True,
                       efficiencies=((0, 2.5),))
    rxn = interop._carried(jrxn)
    Ts = np.linspace(800.0, 3500.0, 7)
    assert _gap(jrxn.equilibrium_kc(jmix, jnp.asarray(Ts)),
                rxn.equilibrium_kc(mix, torch.as_tensor(Ts))) <= TOL
    conc = [np.full(7, 1e-3), np.full(7, 2e-4)]
    assert _gap(jrxn.net_rate([jnp.asarray(c) for c in conc],
                              jnp.asarray(Ts), jmix),
                rxn.net_rate([torch.as_tensor(c) for c in conc],
                             torch.as_tensor(Ts), mix)) <= TOL
    for k, sp in enumerate(mix.species):
        assert _gap(jmix.species[k].janaf.s_abs(jnp.asarray(Ts)),
                    sp.janaf.s_abs(torch.as_tensor(Ts))) <= TOL

    psr = tc.Reaction(lhs=((0, 1.0),), rhs=((1, 2.0),), A=1e5,
                      reversible=True, third_body=True)
    model = tc.Laminar(reactions=(psr,))
    T = torch.tensor(3000.0, dtype=F64)
    rho = torch.tensor(101325.0 * mix.species[0].W / (R_UNIVERSAL * 3000.0),
                       dtype=F64)
    Y = [torch.tensor(1.0, dtype=F64), torch.tensor(0.0, dtype=F64)]
    for _ in range(6000):
        rr, _ = model.correct(mix, Y, rho, T, None)
        Y = [Y[i] + 1e-5 * rr[i] / rho for i in range(2)]
    np.testing.assert_allclose(float(Y[0] + Y[1]), 1.0, rtol=1e-10)
    c = [float(rho * Y[i] / mix.species[i].W) for i in range(2)]
    kc = float(psr.equilibrium_kc(mix, T))
    np.testing.assert_allclose(c[1] ** 2 / c[0], kc, rtol=1e-3)
    assert 0.01 < kc / (101325.0 / (R_UNIVERSAL * 3000.0)) < 0.06
    assert float(Y[1]) > 0.05


def test_third_body_efficiencies_scale_rate():
    """Per-specie efficiencies scale [M]: the rate ratio is the [M]
    ratio."""
    mix = interop._carried(_h2_mix())
    base = tc.Reaction(lhs=((0, 1.0),), rhs=((1, 2.0),), A=1e3,
                       third_body=True)
    eff = dataclasses.replace(base, efficiencies=((0, 2.5),))
    conc = [torch.tensor(1e-3, dtype=F64), torch.tensor(2e-4, dtype=F64)]
    T = torch.tensor(1500.0, dtype=F64)
    np.testing.assert_allclose(
        float(eff.net_rate(conc, T, mix) / base.net_rate(conc, T, mix)),
        (2.5e-3 + 2e-4) / (1e-3 + 2e-4), rtol=1e-12)


def test_reaction_words_ingest_as_jax(tmp_path):
    """chemistryProperties with reversible/thirdBody reaction words, an
    efficiencies list and a TDAC method with DRG and an active
    ISATDevice tabulation: the port reads the JAX package's reactions,
    combustion model, solver and tabulation."""
    (tmp_path / "constant").mkdir()
    (tmp_path / "constant" / "chemistryProperties").write_text("""
FoamFile { version 2.0; format ascii; class dictionary; object chemistryProperties; }
chemistryType { solver ode; method TDAC; }
reduction { active yes; targetSpecies (H2); tolerance 0.05; }
tabulation { active yes; method ISATDevice; tolerance 2e-3; }
reactions
{
    dissociation
    {
        type reversibleThirdBodyArrheniusReaction;
        reaction "H2 = 2H";
        A 1e5; beta 0; Ta 0;
        coeffs ((H2 2.5) (H 1.0));
    }
    forwardOnly
    {
        type irreversibleArrheniusReaction;
        reaction "H2 + O = H + OH";
        A 5e4; beta 2.67; Ta 3165;
    }
}
""")
    jmix = _h2_mix()
    jout = jfc._read_chemistry(str(tmp_path), jmix)
    tout = foam_case._read_chemistry(str(tmp_path), interop._carried(jmix))
    for j, t in zip(jout, tout):
        assert type(t).__name__ == type(j).__name__
        assert dataclasses.asdict(t) == dataclasses.asdict(
            interop._carried(j))
    rxns = tout[0].reactions
    assert rxns[0].reversible and rxns[0].third_body
    assert dict(rxns[0].efficiencies) == {0: 2.5, 1: 1.0}
    assert isinstance(tout[2], tc.DeviceISAT) and tout[2].tol == 2e-3
