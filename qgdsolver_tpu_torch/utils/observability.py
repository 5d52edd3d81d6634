"""Per-step logging, crash diagnostics and profiler hooks (PyTorch port of
`qgdsolver_tpu.utils.observability`).

  * `StepLogger` — periodic host-side log lines with t/dt/field ranges and
    a points/s meter (the device is read only at the logging cadence);
  * `nonphysical_dump` — counts nonfinite/nonpositive cells of named fields;
  * `trace` — a `torch.profiler` context over CPU and, where present, CUDA
    activity, exported as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


class StepLogger:
    """Log a line every `every` steps: t, dt, points/s, field ranges."""

    def __init__(self, mesh_shape, every: int = 50, fields=(), out=print):
        self.points = int(np.prod(mesh_shape))
        self.every = every
        self.fields = tuple(fields)  # names of state attrs to min/max
        self.out = out
        self._t0 = time.perf_counter()
        self._last_steps = 0

    def __call__(self, done_steps: int, state):
        now = time.perf_counter()
        dsteps = done_steps - self._last_steps
        rate = self.points * dsteps / max(now - self._t0, 1e-12)
        parts = [
            f"step={done_steps}",
            f"t={float(state.t):.6g}",
            f"deltaT={float(state.dt):.6g}",
            f"points/s={rate:.3e}",
        ]
        for name in self.fields:
            f = getattr(state, name)
            parts.append(f"max/min {name}: {float(torch.max(f)):.6g}/"
                         f"{float(torch.min(f)):.6g}")
        self.out("  ".join(parts))
        self._t0 = now
        self._last_steps = done_steps


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler context; writes `logdir/trace.json` (Chrome trace
    format) when the block ends.  The profile object is yielded, so a
    caller can also read `key_averages()`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def nonphysical_dump(state, fields=("rho", "rhoE"), out=print):
    """Report nonfinite/nonpositive cell counts of the named fields (the
    reference aborts on negative e or rho); returns {name: count}."""
    bad = {}
    for name in fields:
        f = getattr(state, name, None)
        if f is None:
            continue
        n_bad = int(torch.sum(~torch.isfinite(f)) + torch.sum(f <= 0))
        if n_bad:
            bad[name] = n_bad
    if bad:
        out(f"NONPHYSICAL STATE detected: {bad}")
    return bad
