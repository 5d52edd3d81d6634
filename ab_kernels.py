"""Device times of `qgd2d_update` and `qgd2d_emit` from two or more builds
of `qgd2d.cu`, on the same inputs, in one process on one card.

    python3 ab_kernels.py NAME=PATH/qgd2d.cu [NAME=PATH/qgd2d.cu ...]

Each PATH (another revision's source, unpacked with `git archive`, or a
variant of it) is compiled alone with the port's nvcc flags into
`build/ab_kernels/`; the checkout's own kernels are the build "this".  The
inputs are those the port's steps hand the two kernels, recorded in a step:

- the 1024x512 jet after 20 plain steps, on K1's path (`qgd2d_update`);
- the 1024x512 varsc + qgdFlux jet after 20 plain steps, on K2's path;
- the 4096x2048 varsc + qgdFlux jet with a density bump (its sensor
  active), after 3 steps of K2's path;
- block 0 of a 2x2 split of the warm 1024x512 jet, flagged at its
  partition edges, as K3 updates it (`qgd2d_update`).

For each input and kernel every build runs in the order given, then in the
reverse order (A B B A), timed by the profiler's device time of the port's
kernels (`chip_smoke.device_ms`), and each build's output is held against
"this" build's (the update's fields within 1e-5 of their max, as phase 3 of
`chip_smoke.py`; the emitted rates rel 1e-6, the sensor fields bitwise).  It
prints each build's `qgd2d_update_kernel` registers from ptxas, one line per
input and kernel, and the card's name and power limit.  It needs a card and
imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch

import chip_smoke as cs

OUT_DIR = pathlib.Path(__file__).resolve().parent / "build" / "ab_kernels"


def build_other(name: str, src: pathlib.Path):
    """(library, ptxas report) of one qgd2d.cu built alone, with the entry
    points the wrappers of `qgd2d_update` and `qgd2d_emit` call bound."""
    from qgdsolver_tpu_torch.ops import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / f"{name}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                           "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    p2 = ctypes.POINTER(_build.QGDParams)
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    _build._bind(lib, "qgd2d_error_string", [c_int], ctypes.c_char_p)
    _build._bind(lib, "qgd2d_dt_partials", [c_int, c_int])
    _build._bind(lib, "qgd2d_update", [p2] + [ptr] * 12)
    _build._bind(lib, "qgd2d_emit", [p2] + [ptr] * 11)
    if hasattr(lib, "qgd2d_emit_partials"):
        _build._bind(lib, "qgd2d_emit_partials", [c_int, c_int])
    else:
        # a build whose emit runs on qgd2d_dt's face grid
        lib.qgd2d_emit_partials = lib.qgd2d_dt_partials
    return lib, proc.stderr


def update_registers(report: str) -> str:
    """ptxas's registers line of qgd2d_update_kernel in a -v report."""
    lines = report.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and "qgd2d_update_kernel" in ln:
            for nxt in lines[i + 1:i + 4]:
                if "registers" in nxt:
                    return nxt.split(":", 1)[1].strip()
    return "not reported"


def on_library(lib, fn):
    """fn() with the wrappers launching lib's kernels."""
    from qgdsolver_tpu_torch.ops import _build

    saved = _build.load
    _build.load = lambda: lib
    try:
        return fn()
    finally:
        _build.load = saved


def inputs(dev):
    """(label, kernel, args) of every timed call."""
    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F
    from qgdsolver_tpu_torch.parallel import sharding, spmd

    out = []
    small, big = ("x".join(map(str, sh)) for sh in (cs.SHAPE, cs.BIG))
    solver, fs = cs.warm_state("supersonic_jet", cs.SHAPE, F.build_fused_step,
                               dev)
    got = cs.recorded(F.build_fused_step, solver, fs, 1)
    out.append((f"jet {small}, K1", "update", got["update"]))
    grid = sharding.ProcessGrid(2, 2)
    ctx = sharding.block_context(solver.mesh, grid, 0)
    prm, _ = F.block_params(solver, ctx)
    win = spmd.frame_window(ctx)
    blk = [f[win].contiguous() for f in (fs.p, fs.T, fs.ux, fs.uy)]
    out.append((f"jet block 0 of 2x2 ({prm.nx}x{prm.ny}), K3", "update",
                (prm, *blk, None, fs.dt)))
    solver, fs = cs.warm_state("supersonic_jet_varsc", cs.SHAPE,
                               F.build_tiled_fused_step, dev)
    got = cs.recorded(F.build_tiled_fused_step, solver, fs, 1)
    for k in ("update", "emit"):
        out.append((f"varsc jet {small}, K2", k, got[k]))
    solver, state = cases.supersonic_jet_varsc(shape=cs.BIG, device=dev)
    fs = F.build_tiled_fused_step(solver)[1](cs.with_bump(solver, state))
    got = cs.recorded(F.build_tiled_fused_step, solver, fs, 3)
    for k in ("update", "emit"):
        out.append((f"varsc jet {big} with a bump, K2", k, got[k]))
    return out


def agree(kernel, ref, got) -> None:
    """Hold one build's output against "this" build's."""
    if kernel == "update":
        C = (slice(1, -1),) * 2
        for a, b in zip(ref[0], got[0]):
            cs.check(cs.rel_err(a[C], b[C]) <= 1e-5,
                     f"qgd2d_update differs by {cs.rel_err(a[C], b[C]):.2e}")
        return
    for i, (a, b) in enumerate(zip(ref, got)):
        if a is None:
            continue
        ok = cs.rel_err(a, b) <= 1e-6 if i < 2 else torch.equal(a, b)
        cs.check(ok, f"qgd2d_emit output {i} differs")


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this comparison needs the card")
    from qgdsolver_tpu_torch.ops import _build
    from qgdsolver_tpu_torch.ops import fused_qgd2d as F

    builds = {"this": (_build.load(), _build.ptxas_report())}
    for arg in argv:
        name, _, path = arg.partition("=")
        if not path or name in builds:
            raise SystemExit(f"usage: ab_kernels.py NAME=PATH ... ({arg!r})")
        builds[name] = build_other(name, pathlib.Path(path))
    card = cs.card_line()
    print("qgd2d_update_kernel: " + "; ".join(
        f"{n} {update_registers(rep)}" for n, (_, rep) in builds.items()),
        flush=True)
    fns = {"update": F.qgd2d_update, "emit": F.qgd2d_emit}
    order = list(builds) + list(builds)[::-1]
    for label, kernel, args in inputs("cuda"):
        ref = fns[kernel](*args)
        for name, (lib, _) in builds.items():
            agree(kernel, ref, on_library(lib, lambda: fns[kernel](*args)))
        times = [(name, on_library(builds[name][0], lambda: cs.device_ms(
            lambda: fns[kernel](*args), 20, match="qgd"))) for name in order]
        print(f"qgd2d_{kernel}, {label}: device ms per call "
              + " | ".join(f"{n} {ms:.4f}" for n, ms in times)
              + f" | card: {card}", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
