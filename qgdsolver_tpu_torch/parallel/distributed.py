"""Starting the ranks of a decomposed run, and measuring it (PyTorch port of
`qgdsolver_tpu.parallel.distributed`).

The reference scales with `decomposePar + mpirun`; here the ranks are
torch.distributed processes, one block each:

* `initialize()` joins the world a launcher (`torchrun`) describes in the
  environment, and does nothing when none is set;
* `spawn(fn, nprocs, *args)` starts the ranks itself (spawn method, a
  `file://` rendezvous in a temporary directory, so parallel test runs never
  clash on a port), runs fn(*args) on each and returns their results;
* `measure_scaling()` is the weak-scaling figure, run inside a launched
  world.

Backends: CPU ranks use gloo.  CUDA ranks use NCCL with rank r on cuda:r
when there are at least as many cards as ranks; with fewer cards they share
them (rank r on cuda:r % count) over gloo, whose CUDA tensors
`parallel.spmd` stages through pinned host memory.  The kernels run on the
card either way.  Every collective has the timeout given here, so a rank
that waits for a peer that never comes raises instead of hanging.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
import typing as tp

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = 300.0  # seconds a collective may wait for its peers
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK")


def _cards(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available")
    return torch.cuda.device_count()


def placement(device, world: int) -> tp.Tuple[str, str]:
    """(backend, description) for `world` ranks of this host on `device`."""
    cards = _cards(device)
    if cards == 0:
        return "gloo", f"{world} CPU ranks"
    if cards >= world:
        return "nccl", f"rank r on cuda:r ({world} of {cards} cards)"
    return "gloo", (f"rank r on cuda:r % {cards} ({world} ranks share "
                    f"{cards} card(s); halos through pinned host memory)")


def rank_device(device="cuda") -> torch.device:
    """This rank's device: the CPU, or card LOCAL_RANK (the rank when no
    launcher set it) modulo the cards of the host."""
    if _cards(device) == 0:
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    rank = int(local) if local is not None else (
        dist.get_rank() if dist.is_initialized() else 0)
    return torch.device("cuda", rank % torch.cuda.device_count())


def _join_world(backend, init_method, rank, world, device, timeout, log):
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    # NCCL binds the rank to its card up front (no guess from the rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout),
                            device_id=dev if backend == "nccl" else None)
    if rank == 0:
        log(f"distributed: {world} rank(s), backend {backend}, "
            f"{placement(device, world)[1]}")


def initialize(device="cuda", timeout: float = DEFAULT_TIMEOUT,
               log=print) -> bool:
    """Join the world that `torchrun` describes (RANK, WORLD_SIZE,
    MASTER_ADDR, LOCAL_RANK).  Returns False, touching nothing, when none
    of them is set; True once this process is a rank."""
    if not any(k in os.environ for k in _LAUNCHER_ENV):
        return False
    if dist.is_initialized():
        return True
    world = int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend, _ = placement(device, local_world)
    _join_world(backend, "env://", int(os.environ["RANK"]), world, device,
                timeout, log)
    return True


def _rank_main(fn, args, rank, world, init_method, device, backend,
               timeout, results):
    try:
        _join_world(backend, init_method, rank, world, device, timeout,
                    lambda m: print(m, flush=True))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 - reported to the parent, re-raised
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, nprocs: int, *args, device="cuda",
          timeout: float = DEFAULT_TIMEOUT) -> list:
    """Run fn(*args) on `nprocs` new ranks; their results in rank order.

    fn must be importable by name (a module-level function) and return
    something picklable.  If any rank raises or dies, the others are
    stopped and this raises RuntimeError with that rank's traceback.
    Build the CUDA kernels (`ops._build.load()`) before calling this, so
    the ranks only load the cached library and never race to compile it.
    """
    backend, _ = placement(device, nprocs)
    mp = multiprocessing.get_context("spawn")
    results = mp.Queue()
    out, failure = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [mp.Process(target=_rank_main,
                            args=(fn, args, r, nprocs, init, device, backend,
                                  timeout, results))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        try:
            while failure is None and len(out) < nprocs:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        # give a dying rank's report a moment to arrive
                        try:
                            rank, ok, payload = results.get(timeout=5.0)
                        except queue_mod.Empty:
                            failure = (dead[0], f"exit code "
                                       f"{procs[dead[0]].exitcode}")
                            continue
                    else:
                        continue
                if ok:
                    out[rank] = pickle.loads(payload)
                else:
                    failure = (rank, payload)
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        raise RuntimeError(f"rank {failure[0]} of {nprocs} failed:\n"
                           f"{failure[1]}")
    return [out[r] for r in range(nprocs)]


def _steps_per_s(step, state, n_steps, repeats):
    """Best steps/s of n_steps over `repeats` timed runs, all ranks
    together (synchronized device and barrier around each run)."""

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if dist.is_initialized():
            dist.barrier()

    for _ in range(n_steps):
        state = step(state)
    best = float("inf")
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state = step(state)
        sync()
        best = min(best, time.perf_counter() - t0)
    return n_steps / best


def measure_scaling(solver_factory, grid, n_steps: int = 50,
                    repeats: int = 2, base=(256, 256)) -> dict:
    """Weak scaling over `grid`, called on every rank of a launched world.

    solver_factory(shape) -> (solver, state) on this rank's device.  Each
    rank times the `base` tile alone, then the decomposed run of the
    base * grid problem (`build_spmd_step`); the efficiency is the points/s
    per rank of the latter over the former.  Ranks that share a card time
    that card's sharing, not scaling: the figure means something only with
    one card per rank."""
    from .sharding import build_spmd_step

    solver1, state1 = solver_factory(tuple(base))
    pts1 = solver1.mesh.shape[0] * solver1.mesh.shape[1]
    pps1 = pts1 * _steps_per_s(solver1.make_step(), state1, n_steps,
                               repeats)
    solver_n, state_n = solver_factory((base[0] * grid.px,
                                        base[1] * grid.py))
    step, to_spmd, _ = build_spmd_step(solver_n, grid)
    pts_n = solver_n.mesh.shape[0] * solver_n.mesh.shape[1]
    pps_n = pts_n * _steps_per_s(step, to_spmd(state_n), n_steps, repeats)
    return {"devices": grid.size, "points_per_s_1dev": pps1,
            "points_per_s_per_dev": pps_n / grid.size,
            "weak_scaling_efficiency": pps_n / grid.size / pps1}
