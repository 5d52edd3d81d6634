"""Entry points of the port: one step on the card, and a dry run of
the decomposed paths (the counterparts of the root `__graft_entry__.py`'s
`entry` and `dryrun_multichip`).

    from qgdsolver_tpu_torch import graft_entry
    step, (state,) = graft_entry.entry()            # the card
    report = graft_entry.dryrun_multichip(4)        # 4 ranks

Both run on the card unless the caller passes device="cpu"; without a card
their default raises and never falls back to the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

FIELDS = ("rho", "rhoU", "rhoE", "sc", "t", "dt")
DRYRUN_STEPS = 5  # steps of each dry-run path, decomposed and serial


def entry(device="cuda"):
    """(step, (state,)): one composable QGDFoam step of the flagship
    supersonic-jet config at 256x128 float32, and its initial State, on
    `device`."""
    from . import cases

    solver, state = cases.supersonic_jet(shape=(256, 128),
                                         dtype=torch.float32, device=device)
    return solver.make_step(), (state,)


def dryrun_grids(n_devices: int) -> dict:
    """{path: (case, shape, (px, py))} of the dry run on `n_devices` ranks:
    the JAX dry run's shapes and grids (`__graft_entry__.py:36-78`)."""
    from .parallel.sharding import factor2d

    px, py = factor2d(n_devices)
    # K3 over 2-D blocks; an x-ring when n_devices is prime
    fx = next(d for d in (4, 2, n_devices) if n_devices % d == 0)
    fy = n_devices // fx
    return {
        "spmd": ("supersonic_jet_varsc", (8 * px, 8 * py), (px, py)),
        "k3": ("supersonic_jet", (8 * fx, 8 * fy), (fx, fy)),
        "k5": ("supersonic_jet_3d_varsc", (4 * n_devices, 6, 6),
               (n_devices, 1)),
    }


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Validate the port's decomposed paths on `n_devices` ranks, each
    against the port's serial step of the same config over DRYRUN_STEPS
    steps.

    The ranks are processes (`parallel.distributed.spawn`): gloo on the
    CPU, NCCL when there are at least as many cards as ranks, gloo with
    the ranks sharing the cards otherwise.  The paths, numbered as in the
    JAX dry run:

    1. `sharding.build_spmd_step` (the composable step decomposed) on the
       varScModel5 + qgdFlux jet over the (px, py) grid of `factor2d`,
       held to 1e-12 of each field's max (tests/test_torch_spmd.py);
    3. K3, `fused_qgd2d.build_sharded_fused_step`, on the jet over (fx, fy)
       blocks against the serial fused step: bit for bit on an x-ring,
       else dt equal and the JAX 2D-split bounds (rho, rhoE rtol 1e-6;
       rhoU rtol 1e-5 atol 0.05);
    4. K5, `fused_qgd3d.build_sharded_fused_step_3d`, on the 3D varsc jet
       over an x-ring against the serial fused 3D step: dt equal and rho,
       rhoE, sc within rtol 2e-5, atol 1e-6
       (tests/test_torch_fused_sharded.py).

    Path 2, the JAX package's GSPMD fallback `sharded_step`, has no
    counterpart (ROADMAP queue 1, item 11): GSPMD is XLA's automatic
    partitioning of one jitted program, which torch has no counterpart of,
    and in the JAX package it stood beside the explicit shard_map
    decomposition that path 1 ports, so the port keeps one decomposed
    composable path.

    On the CPU, K3 and K5 run their plain versions; on the card, their
    kernels.  Raises if a rank fails or a path leaves its bound.  Returns
    {path: {"shape", "grid", "bound", "bitwise", "max_rel": {field: largest
    difference from serial over the field's max}, "launches": {kernel:
    launches summed over the ranks}}}.
    """
    from .core.mesh import checked_device
    from .parallel import distributed

    if checked_device(device).type == "cuda":
        from .ops import _build

        _build.load()  # the ranks load the built library, never race on it
    grids = dryrun_grids(n_devices)
    ranks = distributed.spawn(_dryrun_rank, n_devices, grids, device,
                              DRYRUN_STEPS, device=device)
    report = {}
    for path, (name, shape, grid) in grids.items():
        ref = _serial(path, name, shape, device, DRYRUN_STEPS)
        got = ranks[0][path][0]
        launches = {}
        for rank in ranks:
            for k, v in rank[path][1].items():
                launches[k] = launches.get(k, 0) + v
        bound = ("spmd" if path == "spmd" else "varsc" if path == "k5"
                 else "bitwise" if grid[1] == 1 else "split")
        report[path] = {"shape": shape, "grid": grid, "bound": bound,
                        "bitwise": _bitwise(ref, got),
                        "max_rel": _held(path, ref, got, bound),
                        "launches": launches}
    return report


def _dryrun_rank(grids, device, steps):
    """One rank's dry run: {path: (gathered State with numpy leaves on rank
    0, None elsewhere; {kernel: this rank's launches})}.  The counts are
    set to 0 just before a path's steps and read just after."""
    import torch.distributed as dist

    from . import cases, interop
    from .ops import fused_qgd2d, fused_qgd3d
    from .parallel import distributed, sharding

    builders = {"spmd": sharding.build_spmd_step,
                "k3": fused_qgd2d.build_sharded_fused_step,
                "k5": fused_qgd3d.build_sharded_fused_step_3d}
    kernels = fused_qgd2d.SHARDED_KERNELS + fused_qgd3d.SHARDED_KERNELS
    dev = distributed.rank_device(device)
    out = {}
    for path, (name, shape, grid) in grids.items():
        solver, state = getattr(cases, name)(shape=shape, device=dev)
        step, to_s, from_s = builders[path](solver,
                                            sharding.ProcessGrid(*grid))
        s = to_s(state)
        for k in kernels:
            k.launches = 0
        for _ in range(steps):
            s = step(s)
        launches = {k.__name__: k.launches for k in kernels if k.launches}
        whole = interop.state_to_numpy(from_s(s))
        out[path] = (whole if dist.get_rank() == 0 else None, launches)
    return out


def _serial(path, name, shape, device, steps):
    """The port's serial step of a path's config: the composable step for
    path 1, the serial fused step (K1's, K4's kernels) for K3 and K5."""
    from . import cases, interop
    from .ops import fused_qgd2d, fused_qgd3d

    solver, state = getattr(cases, name)(shape=shape, device=device)
    if path == "spmd":
        step, to_f, from_f = solver.make_step(), (lambda s: s), (lambda s: s)
    else:
        build = (fused_qgd2d.build_fused_step if path == "k3"
                 else fused_qgd3d.build_fused_step_3d)
        step, to_f, from_f = build(solver)
    s = to_f(state)
    for _ in range(steps):
        s = step(s)
    return interop.state_to_numpy(from_f(s))


def _bitwise(ref, got) -> bool:
    return all(np.array_equal(getattr(ref, f), getattr(got, f))
               for f in FIELDS)


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    return float(np.max(np.abs(a - np.asarray(b, dtype=np.float64)))
                 / max(np.max(np.abs(a)), 1e-300))


def _held(path, ref, got, bound) -> dict:
    """Each field's largest difference from serial over its max; raises
    RuntimeError where the path leaves its bound."""
    rel = {f: _rel(getattr(ref, f), getattr(got, f)) for f in FIELDS}

    def check(ok, what):
        if not ok:
            raise RuntimeError(f"dry run path {path}: {what} (differences "
                               f"from serial: {rel})")

    if bound == "spmd":
        for f in FIELDS:
            check(rel[f] <= 1e-12, f"{f} beyond 1e-12 of its max")
        for i, (a, b) in enumerate(zip(ref.pbc, got.pbc)):
            check(_rel(a, b) <= 1e-12, f"pbc[{i}] beyond 1e-12 of its max")
        return rel
    if bound == "bitwise":
        check(_bitwise(ref, got), "not bit for bit the serial step")
        return rel
    check(np.array_equal(ref.dt, got.dt), "dt differs")
    if bound == "split":
        tols = {"rho": (1e-6, 0.0), "rhoE": (1e-6, 0.0), "rhoU": (1e-5, 0.05)}
    else:
        tols = {f: (2e-5, 1e-6) for f in ("rho", "rhoE", "sc")}
    for f, (rtol, atol) in tols.items():
        check(np.allclose(getattr(got, f), getattr(ref, f), rtol=rtol,
                          atol=atol), f"{f} outside rtol {rtol} atol {atol}")
    return rel
