"""Per-step logging, crash diagnostics and profiler hooks (PyTorch port of
`qgdsolver_tpu.utils.observability`).

  * `StepLogger` — periodic host-side log lines with t/dt/field ranges and
    a points/s meter over finished steps (the device is read, and waited
    for, only at the logging cadence);
  * `nonphysical_dump` — counts nonfinite/nonpositive cells of named fields;
  * `trace` — a `torch.profiler` context over CPU and, where present, CUDA
    activity, exported as a Chrome trace beside the program's span
    summaries;
  * the program's spans — `qgd.run_steps` (one `solvers.common.run_steps`
    call) > `qgd.step` (one call of its step) > `qgd.smooth_sensor` (one
    `ops.smoothing.smooth_sensor` call) > `qgd.flag_read` (a host read of a
    smoothing flag), and on a card the refill after each read on CUDA
    events.  The switch is the profiler itself: while no `torch.profiler`
    session is open, `run_steps` tests one boolean and records nothing.
    While one is, each span is a range of the profiler's own host events
    (`span`), on the trace's clock beside the kernels, and each
    `run_steps` call leaves a `Segment` summary in a bounded log
    (`segment_log`).
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time

import numpy as np
import torch

# a profiler session that launches at once sometimes records no event at
# all; one that first waits this long has not
PROFILE_SETTLE_S = 0.02
# the traced run_steps calls whose summaries `segment_log` keeps
SEGMENT_LOG_LENGTH = 4096


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
        # reading t waits for the device, so the rate spans finished steps
        # and not their enqueue
        t = float(state.t)
        now = time.perf_counter()
        dsteps = done_steps - self._last_steps
        rate = self.points * dsteps / max(now - self._t0, 1e-12)
        parts = [
            f"step={done_steps}",
            f"t={t:.6g}",
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


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------

# the Segment of the run_steps call being traced, None while none is
active = None
_log = collections.deque(maxlen=SEGMENT_LOG_LENGTH)
_closed = 0  # run_steps calls traced so far
_unread = []  # closed Segments with refill events not yet read


def span(name: str):
    """A profiler range named `name`, as a context manager.  A host event of
    the operator kind (`_RecordFunctionFast`), not `record_function`: with
    CUDA activity on, the profiler copies each `record_function` range onto
    the device's timeline as an annotation event, which would read as
    device time over every kernel the range launched."""
    return torch._C._profiler._RecordFunctionFast(name)


_spare = collections.defaultdict(list)  # device -> timing events read


def _timing_event(device):
    """A timing event recorded on `device`'s current stream, one whose time
    has been read where there is one: creating an event costs the host
    about as much again as recording it."""
    spare = _spare[device]
    event = spare.pop() if spare else torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


class Segment:
    """One traced `run_steps` call.  Host nanoseconds (`perf_counter_ns`):
    `host_ns` the call, `step_ns` its `qgd.step` spans, `read_ns` its
    `qgd.flag_read` spans (the host's waits), `event_ns` the recording of
    its refill events.  On a card, each flag read is paired with CUDA
    events A, recorded just before the read, and B, just before the
    program's next enqueue after it (`enqueued`): A to B on the device's
    clock is the flag's copy and the idle while the host refills the
    queue.  The pairs are read lazily, once later reads or a synchronise
    have completed them, into `refills` and `refill_us`."""

    def __init__(self):
        self.steps = self.host_ns = self.step_ns = 0
        self.reads = self.read_ns = self.event_ns = 0
        self.refills, self.refill_us = 0, 0.0
        self._pairs = collections.deque()  # (A, B, device) not yet read
        self._a = None  # (A, device) of the last read on a card
        self._t0 = time.perf_counter_ns()
        self._span = span("qgd.run_steps")
        self._span.__enter__()

    def step(self, step_fn, state):
        with span("qgd.step"):
            t0 = time.perf_counter_ns()
            state = step_fn(state)
            self.step_ns += time.perf_counter_ns() - t0
        self.steps += 1
        return state

    def flag_read(self, flag) -> bool:
        """bool(flag), a host read that waits for the device."""
        if flag.is_cuda:
            t0 = time.perf_counter_ns()
            self._a = (_timing_event(flag.device), flag.device)
            self.event_ns += time.perf_counter_ns() - t0
        with span("qgd.flag_read"):
            t0 = time.perf_counter_ns()
            value = bool(flag)
            self.read_ns += time.perf_counter_ns() - t0
        self.reads += 1
        return value

    def enqueued(self):
        """Called just before the program's next enqueue after a flag read
        (or where it hands the step back): the end of the read's refill."""
        if self._a is not None:
            t0 = time.perf_counter_ns()
            a, device = self._a
            self._pairs.append((a, _timing_event(device), device))
            self._a = None
            self.event_ns += time.perf_counter_ns() - t0

    def close(self):
        global active, _closed
        self.host_ns = time.perf_counter_ns() - self._t0
        self._span.__exit__(None, None, None)
        self._a = None
        active = None
        _log.append(self)
        _closed += 1
        if self._pairs:
            _unread.append(self)

    def read_refills(self, wait: bool) -> None:
        """Fold the completed refill pairs into the totals; with `wait`,
        wait for the device to complete them all first."""
        while self._pairs:
            a, b, device = self._pairs[0]
            if wait:
                b.synchronize()
            elif not b.query():
                return
            self.refill_us += a.elapsed_time(b) * 1e3
            self.refills += 1
            self._pairs.popleft()
            _spare[device] += (a, b)

    def summary(self) -> dict:
        return {"steps": self.steps, "host_ns": self.host_ns,
                "step_self_ns": self.step_ns - self.read_ns - self.event_ns,
                "flag_reads": self.reads, "flag_read_ns": self.read_ns,
                "event_ns": self.event_ns,
                "refills": self.refills, "refill_us": self.refill_us}


def _read_unread(wait: bool) -> None:
    for seg in list(_unread):
        seg.read_refills(wait)
        if not seg._pairs:
            _unread.remove(seg)


def segment():
    """The Segment of a `run_steps` call, open, when a `torch.profiler`
    session is; else None (the one test a call pays untraced).  Refill
    pairs the device has completed since earlier calls are read first."""
    global active
    if not torch._C._autograd._profiler_enabled():
        return None
    if _unread:
        _read_unread(wait=False)
    active = Segment()
    return active


def segment_log() -> list:
    """The summaries of the last SEGMENT_LOG_LENGTH traced `run_steps`
    calls, oldest first: `steps`, `host_ns`, `step_self_ns` (the `qgd.step`
    spans less their flag reads and the recording of the refill events:
    Python, checks and launches), `flag_reads`, `flag_read_ns`,
    `event_ns`, `refills` and `refill_us` (the device's microseconds from
    each read to the next enqueue, summed).  Waits for the device to
    complete the refill events not yet read (none once the caller has
    synchronised)."""
    _read_unread(wait=True)
    return [seg.summary() for seg in _log]


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler context; writes `logdir/trace.json` (Chrome trace
    format) and `logdir/spans.json` (the `segment_log` summaries of the
    run_steps calls inside the block) when the block ends.  The profile
    object is yielded, so a caller can also read `key_averages()` and
    `events()`.  On a card the session first waits PROFILE_SETTLE_S and
    runs a marker kernel (a session that launches at once can lose its
    events), and the events the profile object gives are those after the
    marker (all of them if the marker itself was lost)."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    closed = _closed
    with profile(activities=acts) as prof:
        if on_card:
            torch.cuda.synchronize()
            time.sleep(PROFILE_SETTLE_S)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    if on_card:
        _after_marker(prof)
    log = segment_log()
    spans = log[len(log) - min(_closed - closed, len(log)):]
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(spans, f, indent=1)


def _after_marker(prof) -> None:
    """Leave in `prof`'s event list (in place, so `key_averages` reads it
    too) the events that start after the marker kernel's end."""
    from torch.autograd import DeviceType

    events = prof.events()
    marks = [e.time_range.end for e in events
             if e.device_type == DeviceType.CUDA and "spin_kernel" in e.name]
    if marks:
        events[:] = [e for e in events if e.time_range.start >= marks[0]
                     and "spin_kernel" not in e.name]


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
