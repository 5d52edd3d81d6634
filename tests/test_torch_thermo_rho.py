"""The port's rho-based, rhoConst and JANAF thermo against the JAX package:
the RhoThermo and stiffened-gas round trips, the JANAF Newton round trip
and gamma at 300 K, the thermo words of `build_foam_thermo` and
`core.config.build_thermo`, and the fused gates' refusal of every thermo
but the perfect gas.  Mirrors tests/test_thermo_coeffs.py and
tests/test_foam_case_e2e.py's thermo-word cases.

Inputs are float64 numpy arrays from one seed through both packages; the
closed forms agree to 1e-14 relative (the same operations in the same
order), and the Newton solves (12 fixed iterations each) to 1e-12.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgdsolver_tpu.io import foam_case as jfc
from qgdsolver_tpu.io import foamdict as jfd
from qgdsolver_tpu.physics import thermo as jtm
from qgdsolver_tpu_torch import cases, interop
from qgdsolver_tpu_torch.core import config
from qgdsolver_tpu_torch.io import foam_case, foamdict
from qgdsolver_tpu_torch.ops import fused_qgd2d, fused_qgd3d
from qgdsolver_tpu_torch.physics import thermo as tm

F64 = torch.float64
N2_LOW = (3.298677, 1.4082404e-3, -3.963222e-6, 5.641515e-9, -2.444854e-12,
          -1020.8999, 3.950372)
N2_HIGH = (2.92664, 1.4879768e-3, -5.68476e-7, 1.0097038e-10,
           -6.753351e-15, -922.7977, 5.980528)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _close(a, b, rtol):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=0.0)


def _fields(seed=0):
    rng = np.random.default_rng(seed)
    p = 1e5 * (0.5 + rng.random(64))
    T = 250.0 + 1500.0 * rng.random(64)
    return p, T


@pytest.mark.parametrize("eos", ["perfectGas", "stiffenedGas"])
def test_rho_thermo_matches_jax_and_round_trips(eos):
    p, T = _fields()
    kw = dict(R=287.0) if eos == "perfectGas" else dict(R=287.0, p_inf=1e6)
    jcls = {"perfectGas": jtm.PerfectGasEoS, "stiffenedGas":
            jtm.StiffenedGasEoS}[eos]
    jth = jtm.RhoThermo(eos=jcls(**kw), R=287.0, Cp=1005.0,
                        transport=jtm.SutherlandTransport(1.458e-6, 110.4))
    th = interop._thermo_from(jth)
    assert isinstance(th, tm.RhoThermo) and type(th.eos).__name__ == \
        type(jth.eos).__name__
    rho = th.rho(_t(p), _t(T))
    _close(jth.rho(p, T), rho, 1e-14)
    _close(p, th.p_from_rho_T(rho, _t(T)), 1e-10)  # the EoS round trip
    _close(jth.c(p, T), th.c(_t(p), _t(T)), 1e-14)
    _close(jth.c_from_pT(p, T), th.c_from_pT(_t(p), _t(T)), 1e-14)
    _close(jth.alphah(p, T), th.alphah(_t(p), _t(T)), 1e-14)
    e = th.e_from_T(_t(T))
    _close(T, th.T_from_e(e), 1e-14)
    assert th.gamma == jth.gamma and th.Cv == jth.Cv
    assert float(th.gamma_of(_t(T))) == jth.gamma


def test_stiffened_gas_sound_speed_is_psi_based():
    """c = sqrt(gamma/psi) = sqrt(gamma R T): the stiffening moves rho,
    not c."""
    th = tm.RhoThermo(eos=tm.StiffenedGasEoS(R=287.0, p_inf=1e6), R=287.0,
                      Cp=1005.0)
    T = _t([300.0])
    assert th.rho(_t([2e5]), T) > 11.0  # (2e5 + 1e6)/(287*300)
    np.testing.assert_allclose(float(th.c(_t([2e5]), T)),
                               np.sqrt(th.gamma * 287.0 * 300.0), rtol=1e-14)


def test_janaf_newton_round_trip_matches_jax():
    """tests/test_thermo_coeffs.py::test_janaf_newton_roundtrip on both
    packages: T from e_abs(T) by Newton from 1.3*T."""
    j = jtm.JanafThermo(R=296.8, low=N2_LOW, high=N2_HIGH)
    tj = interop._same(tm, j, low=N2_LOW, high=N2_HIGH)
    T = np.array([400.0, 1500.0])
    e = tj.e_abs(_t(T))
    _close(j.e_abs(T), e, 1e-14)
    T2 = tj.T_from_e(e, _t(T) * 1.3)
    _close(j.T_from_e(jnp.asarray(np.asarray(e)), T * 1.3), T2, 1e-12)
    _close(T, T2, 1e-6)


def test_janaf_perfect_gas_matches_jax():
    """The sensible-energy JANAF psi-thermo: e(T), T(e) (12 Newton
    iterations from 1000 K), gamma(T) (N2 at 300 K: 1.39-1.41), c, and
    the Eucken alpha of Sutherland transport, on both sides of
    Tcommon."""
    j = jtm.JanafThermo(R=296.8, low=N2_LOW, high=N2_HIGH)
    jth = jtm.JanafPerfectGasThermo(
        janaf=j, transport=jtm.SutherlandTransport(1.4792e-6, 116.0))
    th = interop._thermo_from(jth)
    assert isinstance(th, tm.JanafPerfectGasThermo)
    assert not hasattr(th, "gamma") and not hasattr(th, "Cv")
    p, T = _fields(1)
    e = th.e_from_T(_t(T))
    _close(jth.e_from_T(T), e, 1e-13)
    _close(jth.T_from_e(np.asarray(e)), th.T_from_e(e), 1e-12)
    _close(T, th.T_from_e(e), 1e-9)
    _close(jth.gamma_of(T), th.gamma_of(_t(T)), 1e-14)
    _close(jth.c_from_pT(p, T), th.c_from_pT(_t(p), _t(T)), 1e-14)
    _close(jth.alphah(p, T), th.alphah(_t(p), _t(T)), 1e-14)
    assert 1.39 < float(th.gamma_of(_t(300.0))) < 1.41


SUTHERLAND_JANAF = """
thermoType
{
    type hePsiQGDThermo; mixture pureMixture; transport sutherland;
    thermo janaf; equationOfState perfectGas; specie specie;
    energy sensibleInternalEnergy;
}
mixture
{
    specie { molWeight 28.0134; }
    thermodynamics
    {
        Tlow 100; Thigh 5000; Tcommon 1000;
        highCpCoeffs (2.92664 1.4879768e-3 -5.68476e-7 1.0097038e-10
                      -6.753351e-15 -922.7977 5.980528);
        lowCpCoeffs  (3.298677 1.4082404e-3 -3.963222e-6 5.641515e-9
                      -2.444854e-12 -1020.8999 3.950372);
    }
    transport { As 1.4792e-6; Ts 116; }
}
"""

RHO_CONST = """
thermoType
{
    type heRhoQGDThermo; mixture pureMixture; transport const;
    thermo hConst; equationOfState rhoConst; specie specie;
    energy sensibleInternalEnergy;
}
mixture
{
    specie { molWeight 18.0; }
    equationOfState { rho 1000; }
    thermodynamics { Cp 4181; Hf 0; }
    transport { mu 1e-3; Pr 7; }
}
beta 2.07e-4;
"""

HE_RHO = """
thermoType
{
    type heRhoQGDThermo; mixture pureMixture; transport const;
    thermo hConst; equationOfState perfectGas; specie specie;
    energy sensibleInternalEnergy;
}
mixture
{
    specie { molWeight 28.96; }
    thermodynamics { Cp 1004.5; Hf 0; }
    transport { mu 1.8e-5; Pr 0.7; }
}
"""


@pytest.mark.parametrize("text,cls", [
    (SUTHERLAND_JANAF, "JanafPerfectGasThermo"),
    (RHO_CONST, "RhoConstThermo"),
    (HE_RHO, "RhoThermo")])
def test_thermo_words_build_as_jax(text, cls):
    """The janaf, rhoConst and heRho words build the thermo the JAX
    package builds, field for field."""
    th = foam_case.build_foam_thermo(foamdict.parse(text))
    jth = jfc.build_foam_thermo(jfd.parse(text))
    assert type(th).__name__ == type(jth).__name__ == cls
    assert th == interop._thermo_from(jth)
    if cls == "RhoConstThermo":
        assert th.rho0 == 1000 and th.beta == 2.07e-4 and th.Pr == 7
    if cls == "JanafPerfectGasThermo":
        assert 1.39 < float(th.gamma_of(_t(300.0))) < 1.41


def test_stiffened_gas_word_reads_p_inf():
    """equationOfState stiffenedGas builds the port's StiffenedGasEoS with
    pInf from the mixture's equationOfState dict (the JAX package reads
    the word as perfectGas)."""
    text = HE_RHO.replace("equationOfState perfectGas",
                          "equationOfState stiffenedGas").replace(
        "thermodynamics {", "equationOfState { pInf 3e5; }\n"
                            "    thermodynamics {")
    th = foam_case.build_foam_thermo(foamdict.parse(text))
    assert isinstance(th.eos, tm.StiffenedGasEoS) and th.eos.p_inf == 3e5
    assert th.eos.R == pytest.approx(8314.462618 / 28.96)


def test_config_build_thermo_words():
    """core.config's thermo sub-dicts: rhoThermo with an eos sub-dict,
    janafPerfectGas with a janaf one, rhoConst."""
    th = config.build_thermo({"type": "rhoThermo", "Cp": 1004.5, "R": 287.0,
                              "eos": {"type": "stiffenedGas", "R": 287.0,
                                      "p_inf": 2e5},
                              "transport": {"type": "const", "mu0": 1e-5}})
    assert th == tm.RhoThermo(eos=tm.StiffenedGasEoS(287.0, 2e5), Cp=1004.5,
                              R=287.0, transport=tm.ConstTransport(1e-5))
    th = config.build_thermo({"type": "janafPerfectGas", "janaf": {
        "R": 296.8, "low": list(N2_LOW), "high": list(N2_HIGH)}})
    assert th.janaf == tm.JanafThermo(296.8, N2_LOW, N2_HIGH)
    th = config.build_thermo({"type": "rhoConst", "rho0": 1.0, "Cp": 1000.0,
                              "mu0": 1e-2, "Pr": 0.71, "beta": -3e-3})
    assert th.nu() == pytest.approx(1e-2)


@pytest.mark.parametrize("kind", ["rho", "janaf"])
def test_fused_gates_refuse_other_thermos(kind):
    """The 2D and 3D fused `supported()` take the perfect gas only, as the
    JAX gates do: a RhoThermo or a JANAF gas runs on the composable
    step."""
    if kind == "rho":
        th = tm.RhoThermo(eos=tm.PerfectGasEoS(287.0), Cp=1004.5, R=287.0)
    else:
        th = tm.JanafPerfectGasThermo(
            janaf=tm.JanafThermo(287.0, N2_LOW, N2_HIGH))
    for build, mod in ((cases.supersonic_jet, fused_qgd2d),
                       (cases.supersonic_duct_3d, fused_qgd3d)):
        shape = (16, 8) if mod is fused_qgd2d else (8, 6, 6)
        solver, _ = build(shape=shape, device="cpu")
        assert mod.supported(solver)
        assert not mod.supported(dataclasses.replace(solver, thermo=th))
