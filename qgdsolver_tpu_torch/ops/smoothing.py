"""fvc::smooth of the varScModel5 sensor on the card, shared by the 2D and
3D fused steps (`fused_qgd2d.qgd2d_smooth`, `fused_qgd3d.qgd3d_smooth`).

A ring is f <- max(f, nbr_max(f)/maxRatio) over the face neighbours, a
cell beyond a physical edge being the cell itself; fvc::smooth carries the
rings to their fixed point.  This module holds what does not depend on the
number of axes: the plain version of a launch of k rings
(`smooth_reference`, `_smooth_plain`) and of the fixed point in line sweeps
(`smooth_fixed_reference`), the checks both wrappers share
(`smooth_args`), the host loop that groups the rings into launches
(`smooth_sensor`), and the card's check of the kernels' division-free ring
(`smooth_ring_check`, `require_exact_ring`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..physics.qgdcoeffs import _neighbour_max, smooth_ratio
from ..utils import observability
from .launch import check_tensors, launch


def _edge_frame(interior):
    """Interior cells -> frame with edge-replicated ghosts (any number of
    axes)."""
    f = interior
    for a, n in enumerate(interior.shape):
        idx = (torch.arange(n + 2, device=f.device) - 1).clamp(0, n - 1)
        f = f.index_select(a, idx)
    return f.contiguous()


def smooth_reference(prm, f, k):
    """Plain version of the smoothing kernels' rings: k fvc::smooth rings
    of the sensor cells f (any number of axes; edge-replicated neighbours
    at the boundary).  Returns (the cells after k rings, flag): flag is a
    0-dim 1.0 if the last ring raised any cell, else 0.0 (0.0 for k = 0).
    maxRatio is a tensor on f's device (`qgdcoeffs.smooth_ratio` of the
    coefficient, prm holding 1 + coefficient), so the division is a
    correctly rounded one on the card too, as the kernels'."""
    ratio = smooth_ratio(prm.smooth_ratio - 1.0, f)
    flag = torch.zeros((), dtype=f.dtype, device=f.device)
    for _ in range(k):
        fn = torch.maximum(f, _neighbour_max(f) / ratio)
        flag = torch.any(fn > f).to(f.dtype)
        f = fn
    return f, flag


# the k that asks a smoothing call for the fixed point itself (only
# `qgd3d_smooth` and `_smooth_plain` take it)
SMOOTH_FIXED = -1


def _sweeps(g, a, ratio):
    """S_a of g: along axis a the forward sweep t <- max(g, t/ratio), then
    the backward one over its result."""
    t = g.movedim(a, 0).clone()
    for i in range(1, t.shape[0]):
        t[i] = torch.maximum(t[i], t[i - 1] / ratio)
    for i in range(t.shape[0] - 2, -1, -1):
        t[i] = torch.maximum(t[i], t[i + 1] / ratio)
    return t.movedim(0, a).contiguous()


def smooth_fixed_reference(prm, f):
    """Plain version of `qgd3d_smooth`'s fixed point: the rings' fixed point
    of the cells f (any number of axes) as line sweeps, one axis after the
    other from the last (`_sweeps`), and a 0-dim flag, 1.0 if a cell is not
    finite or has its sign bit set, else 0.0.  With h(v) the ring's
    division by maxRatio (>= 1), the rings reach max over cells d of
    h^n(f(d)), n the L1 distance, and the sweeps form that max from the
    same divisions: for a flag of 0 the cells are `fvc_smooth`'s bit for
    bit (csrc/qgd3d.cu says why); for a flag of 1 they are not the rings'."""
    ratio = smooth_ratio(prm.smooth_ratio - 1.0, f)
    flag = (~(torch.isfinite(f) & ~torch.signbit(f))).any().to(f.dtype)
    for a in reversed(range(f.ndim)):
        f = _sweeps(f, a, ratio)
    return f, flag


def _smooth_plain(prm, f, k, out, flag):
    """What `qgd2d_smooth` and `qgd3d_smooth` compute, in plain torch:
    `smooth_reference` (`smooth_fixed_reference` for k = SMOOTH_FIXED) on
    the cells of f (the cells, or the interior of a frame shaped as out),
    edge-framed into out; the flag into flag."""
    cells = tuple(n - 2 for n in out.shape)
    if tuple(f.shape) != cells:
        f = f[(slice(1, -1),) * f.ndim]
    got, fl = (smooth_fixed_reference(prm, f) if k == SMOOTH_FIXED
               else smooth_reference(prm, f, k))
    out.copy_(_edge_frame(got))
    flag.copy_(fl)
    return out, flag


_smooth_plain.fallbacks = 0


def smooth_args(name, cells, kmax, f, k, out, flag):
    """The checks and defaults the smoothing wrappers share: f the `cells`
    shaped sensor or the frame around them, 0 <= k <= kmax, out a frame
    (new if None) and flag a 0-dim tensor (new if None) beside f.  Returns
    (on_card, out, flag, base, pitches): the address of f's first cell and
    f's pitches in floats along all axes but the last, as the smoothing
    kernels take them."""
    frame = tuple(n + 2 for n in cells)
    bare = tuple(f.shape) == tuple(cells)
    dims = tuple(cells) if bare else frame
    on_card = check_tensors(name, dims, f)
    if not 0 <= k <= kmax:
        raise ValueError(f"{name}: k={k} outside 0..{kmax}")
    out = torch.empty(frame, dtype=f.dtype, device=f.device) \
        if out is None else out
    flag = torch.empty((), dtype=f.dtype, device=f.device) \
        if flag is None else flag
    check_tensors(name, frame, out)
    check_tensors(name, (), flag)
    if out.device != f.device or flag.device != f.device:
        raise ValueError(f"{name}: out and flag must lie beside f")
    pitches = tuple(math.prod(dims[a + 1:]) for a in range(len(dims) - 1))
    # cell (0, ...) of a frame is its element (1, ...)
    base = f.data_ptr() + (0 if bare else 4 * (sum(pitches) + 1))
    return on_card, out, flag, base, pitches


def smooth_sensor(prm, s1, chg, smooth, k, cache=None, max_iters=10_000):
    """The sensor frame of a step: fvc::smooth carried to its fixed point
    and edge-framed - bitwise `fvc_smooth` of the raw sensor, whatever k -
    on `smooth` (the signature of `qgd2d_smooth` and `qgd3d_smooth`, or
    `_smooth_plain`), in any number of axes.

    With a flag `chg`, s1 is the emitted first ring and chg its change
    flag: the host reads it, and if it is 0, ring 1 is the fixed point: a
    frame s1 (the 3D step's) is returned as it is, with no launch, and bare
    cells (K2's) are framed by one launch of 0 rings.  With chg None, s1 is
    the raw sensor and the first launch runs ring 1 alone, as `fvc_smooth`
    tests after its first ring: an inactive sensor costs one ring.  Then it
    launches k rings at a time, reading each launch's last-ring flag, until
    a launch's last ring raised no cell or the `fvc_smooth` cap of
    max_iters rings is reached.

    Where `cache` holds "fixed" true (the 3D step's) and the flag chg is
    set, `smooth` first writes the fixed point itself (k = SMOOTH_FIXED)
    into the returned frame, and the host reads that call's flag: at 0 the
    frame is the sensor, after two reads in all; at 1 (a cell of s1 not
    finite or with its sign bit set, where the fixed point is not the
    rings') `smooth.fallbacks` counts it and the rings run from s1.  A mesh
    whose L1 diameter (its axes' cells less one each, summed) is not below
    max_iters - 4, where the rings may stop at the cap short of the fixed
    point, takes the rings alone.

    The ring launches alternate between the
    returned frame, which is new, and a scratch frame; the last one lands
    in the returned frame when the call takes as many launches as the call
    before it, else one copy moves it there.  `cache` (a dict a step
    builder keeps) holds the scratch frame, the flag and the launches of
    the last call per device across calls, and "fixed".  Counts its host flag reads in
    `reads` and its rings in `rings`.  Inside a traced `run_steps` call
    the call is a `qgd.smooth_sensor` span and each flag read a
    `qgd.flag_read` span, with its refill timed on a card
    (`utils.observability.Segment`)."""
    seg = observability.active
    if seg is None:
        return _smooth_sensor(prm, s1, chg, smooth, k, cache, max_iters,
                              bool, _no_enqueue)
    with observability.span("qgd.smooth_sensor"):
        return _smooth_sensor(prm, s1, chg, smooth, k, cache, max_iters,
                              seg.flag_read, seg.enqueued)


def _no_enqueue():
    pass


def _smooth_sensor(prm, s1, chg, smooth, k, cache, max_iters, read,
                   enqueued):
    """`smooth_sensor` with its flag reads through `read` and `enqueued()`
    called just before the next enqueue after each read."""
    cells = tuple(getattr(prm, a) for a in ("nx", "ny", "nz")[:s1.ndim])
    framed = tuple(s1.shape) != cells
    it, rings, still = 0, 1, False
    if chg is not None:
        smooth_sensor.reads += 1
        still = not read(chg)
        if still and framed:
            enqueued()
            return s1
        it, rings = 1, k
    out = torch.empty(tuple(n + 2 for n in cells), dtype=s1.dtype,
                      device=s1.device)
    bufs = None if cache is None else cache.get(s1.device)
    if bufs is None:
        bufs = [torch.empty_like(out), torch.empty((), dtype=s1.dtype,
                                                   device=s1.device), 1]
        if cache is not None:
            cache[s1.device] = bufs
    scratch, flag, last = bufs
    if still:
        enqueued()
        return smooth(prm, s1, 0, out, flag)[0]
    fixed = cache is not None and cache.get("fixed", False)
    if fixed and chg is not None and sum(cells) - len(cells) < max_iters - 4:
        enqueued()
        smooth(prm, s1, SMOOTH_FIXED, out, flag)
        smooth_sensor.reads += 1
        if not read(flag):
            enqueued()
            return out
        smooth.fallbacks += 1
    src, dst, n = s1, (out if last % 2 else scratch), 0
    while True:
        enqueued()
        smooth(prm, src, rings, dst, flag)
        smooth_sensor.rings += rings
        it, n = it + rings, n + 1
        smooth_sensor.reads += 1
        if not read(flag) or it >= max_iters:
            break
        src, dst, rings = dst, (scratch if dst is out else out), k
    enqueued()
    bufs[2] = n
    if dst is not out:
        out.copy_(dst)
    return out


smooth_sensor.reads = 0
smooth_sensor.rings = 0

# the ranges smooth_ring_check holds the division-free ring to __fdiv_rn on
RING_RANGES = ("[1, 2)", "the binade at SMOOTH_TINY", "the lowest normal "
               "binade", "the subnormals", "the top binade")


def smooth_ring_check(ratio: float, device) -> dict:
    """{range: mismatches}: the kernels' division-free ring against a
    correctly rounded division by float32 `ratio` on every float of each of
    RING_RANGES, on a card (`smooth_ring_check` in qgd2d.cu, which derives
    the reciprocal from the ratio as the smoothing kernels do)."""
    bad = torch.zeros(len(RING_RANGES), dtype=torch.int32, device=device)
    launch(smooth_ring_check, "smooth_ring_check", float(np.float32(ratio)),
           bad, like=bad)
    return dict(zip(RING_RANGES, bad.tolist()))


smooth_ring_check.launches = 0


_RINGS_CHECKED = set()


def require_exact_ring(prm, device) -> None:
    """Raise unless the division-free ring is exact for prm's maxRatio on
    every float `smooth_ring_check` tries, checked once per ratio and card
    before a step builder hands the ratio to the smoothing kernels."""
    key = (prm.smooth_ratio, str(device))
    if key in _RINGS_CHECKED:
        return
    bad = smooth_ring_check(prm.smooth_ratio, device)
    if any(bad.values()):
        raise RuntimeError(
            f"the division-free smoothing ring is not exact for maxRatio "
            f"{prm.smooth_ratio!r}: {sum(bad.values())} mismatches ({bad})")
    _RINGS_CHECKED.add(key)
