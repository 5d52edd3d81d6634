"""The launch protocol of the port's CUDA kernels, written once.

A kernel wrapper checks its tensors (`check_tensors`, `check_dt`), runs its
plain version for CPU tensors, allocates its outputs and calls `launch`.
The library is looked up at every call (`_build.load` is cached), so a tool
that swaps `_build.load` and `_DT_WORK` for a while launches another build's
kernels through the same wrappers.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def check_tensors(name, shape, *tensors):
    """Raise unless the tensors are contiguous float32 of `shape` on one CPU
    or CUDA device; True if that device is a card."""
    shape = tuple(shape)
    dev = tensors[0].device
    for x in tensors:
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: frames must be float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name}: frames on {x.device} and {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: frame shape {tuple(x.shape)} != {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: frames must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev.type == "cuda"


def check_dt(name, x, like):
    """Raise unless x, the dt a kernel reads, is a one-element float32
    tensor on like's device."""
    if x.dtype != torch.float32 or x.numel() != 1 or x.device != like.device:
        raise ValueError(f"{name}: dt must be a one-element float32 tensor "
                         f"on {like.device}")


def _ptr(x):
    return x.data_ptr() if isinstance(x, torch.Tensor) else x


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _call(cname, args, device):
    """(library, what its entry `cname` returns for args), called inside
    device's context."""
    lib = _build.load()
    with torch.cuda.device(device):
        return lib, getattr(lib, cname)(*args)


def query(cname, *args, device):
    """What the host-side entry `cname` (a launch's block count) returns for
    args on device."""
    return _call(cname, args, device)[1]


def launch(counter, cname, *args, like, count=1):
    """Launch the entry `cname` on like's device and current stream: each
    tensor among args passed as its pointer, the stream appended.  Raises
    RuntimeError naming `cname` on a CUDA error; else adds `count`, the
    kernels the entry launches, to `counter.launches`."""
    lib, code = _call(cname, [_ptr(a) for a in args] + [_stream(like)],
                      like.device)
    _build.check(lib, code, cname)
    counter.launches += count


def launch_shape(cname, *args, device) -> tuple:
    """The five ints the shape query `cname` writes for args on device."""
    out = (ctypes.c_int * 5)()
    lib, code = _call(cname, args + (out,), device)
    _build.check(lib, code, cname)
    return tuple(out)


# The workspace of the one-launch dt kernels (qgd2d_dt and qgd3d_dt, with
# their _fold forms) on each (device, stream): the ticket that the kernel's
# last block sets back to 0, then one partial per block.  Launches on one
# stream run in turn, so they share it; another stream gets its own.
_DT_WORK = {}
_DT_HEAD = 4


def dt_work(per_block, like, cname, *args):
    """The dt workspace for a launch on like's device and current stream of
    `per_block` floats a block, its blocks counted by the entry `cname` at
    args: zeros when made, and every launch leaves its ticket 0."""
    blocks = query(cname, *args, device=like.device)
    if blocks < 1:
        raise RuntimeError(f"{cname}: no launch shape ({blocks})")
    key = (like.device, _stream(like))
    work = _DT_WORK.get(key)
    if work is None or work.numel() < _DT_HEAD + per_block * blocks:
        work = torch.zeros(_DT_HEAD + per_block * blocks, dtype=torch.float32,
                           device=like.device)
        _DT_WORK[key] = work
    return work
