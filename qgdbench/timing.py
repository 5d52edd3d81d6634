"""Device timing: a profiler session over a whole window that does not
lose its events, and its reduction to device time by kernel, the device's
busy time and the idle gaps by what the host was doing.

`kernel_key` (the naming of `step_parts`) is a frozen copy of
`chip_smoke.py` at commit f5c3372; `traced` puts `profile_session`'s
settling wait and marker kernel (the same file and commit) around a window
of any length.
"""
from __future__ import annotations

import bisect
import re
import time

import torch

# a profiler session that launches at once sometimes records no event at
# all; one that first waits this long has not
PROFILE_SETTLE_S = 0.02


def kernel_key(name: str) -> str:
    """What a device operation is: one of the port's kernels by name, a
    copy or fill, or PyTorch's own kernels."""
    found = re.search(r"(qgd\dd_\w+?)_kernel", name)
    return (found.group(1) if found else "copies and fills"
            if name.startswith(("Memcpy", "Memset")) else "torch ops")


class Trace:
    """A traced window reduced: `kernels` maps each `kernel_key` to the
    seconds of each of its device operations; `busy_s` is the time in
    which some device operation ran; `idle_by_host` maps what the host was
    doing (its innermost profiled call) to the device's idle seconds."""

    def __init__(self, device, host):
        self.kernels = {}
        for name, start, end in device:
            self.kernels.setdefault(kernel_key(name), []).append(
                (end - start) * 1e-6)
        spans = sorted((s, e) for _, s, e in device)
        busy, gaps, last = 0.0, [], None
        for s, e in spans:
            if last is None or s > last:
                if last is not None:
                    gaps.append((last, s))
                busy += e - s
                last = e
            elif e > last:
                busy += e - last
                last = e
        self.busy_s = busy * 1e-6
        self.idle_by_host = _attribute(gaps, host)

    def device_ops(self, top: int = 10) -> list:
        """[[kernel, seconds], ...]: the device operations that took most
        time, at most `top`."""
        total = sorted(((k, sum(v)) for k, v in self.kernels.items()),
                       key=lambda kv: -kv[1])
        return [[k, v] for k, v in total[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host activity, seconds], ...]: the device's idle time by what
        the host was doing, the largest first, at most `top`."""
        total = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])
        return [[k, v] for k, v in total[:top]]


def _attribute(gaps, host) -> dict:
    """Idle seconds by the innermost host call that holds each gap's middle
    (host events nest on the thread that launches), `host python` where no
    profiled call does."""
    host = sorted(host, key=lambda ev: (ev[1], -ev[2]))
    starts = [s for _, s, _ in host]
    out = {}
    stack, i = [], 0
    for lo, hi in sorted(gaps):
        mid = 0.5 * (lo + hi)
        j = bisect.bisect_right(starts, mid)
        while i < j:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        inner = next((ev for ev in reversed(stack) if ev[2] >= mid), None)
        key = inner[0] if inner is not None else "host python"
        out[key] = out.get(key, 0.0) + (hi - lo) * 1e-6
    return out


def traced(window, settle: float = PROFILE_SETTLE_S, sessions: int = 3):
    """(window's result, Trace) of `window()` run under the profiler: the
    session waits `settle` seconds and runs a marker kernel first, and only
    what follows the marker counts.  A session that lost the marker is
    taken again with twice the wait, at most `sessions` in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(settle)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            result = window()
        events = prof.events()
        marks = [e.time_range.end for e in events
                 if e.device_type == DeviceType.CUDA
                 and "spin_kernel" in e.name]
        if marks:
            mark = marks[0]
            device, host = [], []
            for e in events:
                span = (e.name, e.time_range.start, e.time_range.end)
                if e.time_range.start < mark or "spin_kernel" in e.name:
                    continue
                (device if e.device_type == DeviceType.CUDA
                 else host).append(span)
            return result, Trace(device, host)
        settle *= 2
    raise RuntimeError(f"the profiler lost the marker kernel in {sessions} "
                       "sessions")
