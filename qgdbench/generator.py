"""The one traffic generator: a configuration's initial primitive fields,
perturbed as a traffic mix's data file says, drawn from a seed.

A configuration's `initial` block names each field's base (a named value
of the configuration, a number, or a named value with a hot sphere in T or
the inlet profile decaying along x); a mix's `density_factor` block
multiplies rho and rhoE by a factor built from density slabs and low sine
modes.  Multiplying rho and rhoE alike leaves U and e, so T, unchanged and
multiplies p: the generator multiplies p.

The seed draws only the handful of numbers a mix leaves open (slab centres,
the order of the slab amplitudes, the phases of the modes) with numpy's
generator on the host, so a seed gives the same fields on any device; the
fields themselves are made on the device in a few broadcast calls.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference.qgd3d import centres, inlet_profile, values


def draws(mix, seed) -> dict:
    """The numbers `seed` draws for the mix: slab centres (at least
    `min_gap` apart) and amplitudes in a seeded order, and mode phases."""
    rng = np.random.default_rng(seed)
    out = {}
    factor = mix.get("density_factor", {})
    slabs = factor.get("slabs")
    if slabs is not None:
        amps = [float(a) for a in rng.permutation(slabs["amplitudes"])]
        lo, hi = slabs["x_range"]
        while True:
            xs = np.sort(rng.uniform(lo, hi, len(amps)))
            if np.all(np.diff(xs) >= slabs["min_gap"]):
                break
        out["slabs"] = [(float(x), a) for x, a in zip(xs, amps)]
    modes = factor.get("modes")
    if modes is not None:
        out["phases"] = [float(v) for v in
                         rng.uniform(0.0, 2.0 * math.pi, len(modes["waves"]))]
    return out


def _axis(cfg, a, device, dtype):
    """Cell centres of axis a, shaped to broadcast over the mesh."""
    shape = [1, 1, 1]
    shape[a] = cfg["shape"][a]
    return torch.as_tensor(centres(cfg, a), dtype=dtype,
                           device=device).reshape(shape)


def _base(cfg, spec, device, dtype):
    """A field's base: a number, a named value, or {"base": name, ...} with
    a `hot_sphere` (1 + amplitude*exp(-r^2/width2)) or the `inlet` profile
    decaying as exp(-x/decay_length)."""
    named = values(cfg)
    if not isinstance(spec, dict):
        v = named[spec] if isinstance(spec, str) else float(spec)
        return torch.full(tuple(cfg["shape"]), v, dtype=dtype, device=device)
    v = named[spec["base"]]
    if "hot_sphere" in spec:
        hs = spec["hot_sphere"]
        r2 = sum((_axis(cfg, a, device, torch.float64) - hs["centre"][a]) ** 2
                 for a in range(3))
        return (v * (1.0 + hs["amplitude"] * torch.exp(-r2 / hs["width2"]))
                ).to(dtype)
    if "inlet" in spec:
        prof = torch.as_tensor(inlet_profile(cfg), dtype=torch.float64,
                               device=device)[None]
        decay = torch.exp(-_axis(cfg, 0, device, torch.float64)
                          / spec["inlet"]["decay_length"])
        return (v * prof * decay).to(dtype)
    raise ValueError(f"unknown initial field spec {spec!r}")


def density_factor(cfg, mix, seed, device, dtype):
    """The factor on rho and rhoE, or None: the product over the slabs of
    (1 + amplitude) inside |x - centre| < half_width, times 1 + amplitude
    * the sum of sin(2 pi k.x/L + phase) over the modes."""
    factor = mix.get("density_factor", {})
    drawn = draws(mix, seed)
    out = None
    if "slabs" in drawn:
        x = _axis(cfg, 0, device, torch.float64)
        half = factor["slabs"]["half_width"]
        f = torch.ones_like(x)
        for centre, amp in drawn["slabs"]:
            f = f * torch.where(torch.abs(x - centre) < half, 1.0 + amp, 1.0)
        out = f.to(dtype)
    if "phases" in drawn:
        waves = factor["modes"]["waves"]
        s = None
        for k, phase in zip(waves, drawn["phases"]):
            arg = sum(2.0 * math.pi * k[a] / cfg["lengths"][a]
                      * _axis(cfg, a, device, torch.float32)
                      for a in range(3)) + phase
            s = torch.sin(arg) if s is None else s + torch.sin(arg)
        m = (1.0 + factor["modes"]["amplitude"] * s).to(dtype)
        out = m if out is None else out * m
    return out


def fields(cfg, mix, seed, device) -> dict:
    """The initial primitive cell fields of a configuration under a mix:
    p, T, U (3, nx, ny, nz) and, where the configuration gives one, sc,
    in the configuration's dtype on `device`."""
    dtype = getattr(torch, cfg["dtype"])
    init = cfg["initial"]
    out = {k: _base(cfg, init[k], device, dtype) for k in ("p", "T")}
    out["U"] = torch.stack([_base(cfg, init[k], device, dtype)
                            for k in ("ux", "uy", "uz")])
    if "sc" in init:
        out["sc"] = _base(cfg, init["sc"], device, dtype)
    f = density_factor(cfg, mix, seed, device, dtype)
    if f is not None:
        out["p"] = out["p"] * f
    return out
