"""The roofline's counts, frozen: the card's published peaks, the bytes a
kernel must move, the float operations of its plain version, and the
least time they allow.

`work_bytes`, `count_ops` and `bound` are frozen copies of `chip_smoke.py`
at commit f5c3372 (its 2D entries left out).  Bytes count each input frame
read once and each output written once; operations are those of the plain
version, counted through a dispatch counter, so they are the work the
function needs and not the work a kernel repeats.
"""
from __future__ import annotations

import numpy as np
import torch

# NVIDIA's H100 SXM data sheet: HBM3 bytes/s, and float32 operations/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def work_bytes(name, shape, varsc=False) -> int:
    """The bytes a 3D kernel must move at `shape` cells: each input frame
    read once, each output written once."""
    nx, ny, nz = shape
    cells = int(np.prod(shape))
    frame = int(np.prod([n + 2 for n in shape]))
    ghosts = 2 * (ny * nz + (nx + 2) * nz + (nx + 2) * (ny + 2))
    io = {"qgd3d_dt": 4 * frame, "qgd3d_dt_fold": 4 * frame,
          "qgd3d_update": (5 + varsc) * frame + 5 * cells,
          "qgd3d_sensor": 3 * frame + cells,
          # p, T, sc in, the ring-1 frame out
          "qgd3d_emit": 4 * frame,
          "qgd3d_ghosts": 5 * 3 * ghosts,
          # per launch: the cells of a frame in, a frame out
          "qgd3d_smooth": cells + frame}
    return 4 * io[name]


# what count_ops counts: one operation per output element of an elementwise
# op, one per input element of a reduction to fewer elements
POINTWISE = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt",
             "rsqrt", "reciprocal", "pow", "minimum", "maximum", "fmin",
             "fmax", "clamp", "clamp_min", "clamp_max", "where", "lt", "le",
             "gt", "ge", "eq", "ne"}
REDUCTIONS = {"max", "min", "amax", "amin", "sum", "any", "all"}


def count_ops(fn) -> int:
    """The float operations that one call of fn() does: fn is a kernel's
    plain version on this run's inputs (tensors on the meta device count
    as well, with no data).  Index, copy and fill ops count nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            ins = [a for a in args if torch.is_tensor(a)]
            if name in REDUCTIONS and len(ins) == 1:
                Counter.ops += ins[0].numel()
            elif name in POINTWISE or name in REDUCTIONS:
                Counter.ops += (out[0] if isinstance(out, tuple)
                                else out).numel()
            return out

    with Counter():
        fn()
    return Counter.ops


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def meta_frame(shape):
    """A float32 frame of `shape` cells on the meta device, for counting."""
    return torch.empty(tuple(n + 2 for n in shape), dtype=torch.float32,
                       device="meta")
