"""smooth.refill_us: the device's mean microseconds from just before a host
read of a smoothing flag to the program's next enqueue after it (the flag's
copy and the idle while the host refills the queue), on the CUDA events the
program records in a traced run (`utils.observability.segment_log`).  The
window's segments are the log's last `run.segments` summaries, each of
`run.seg_steps` steps; anything else, an untraced run, or a program that
keeps no log has no reading."""


def read(run):
    from qgdsolver_tpu_torch.utils import observability

    log = getattr(observability, "segment_log", None)
    if run.trace is None or log is None or run.segments < 1:
        return None
    segs = log()[-run.segments:]
    if len(segs) != run.segments or any(s["steps"] != run.seg_steps
                                        for s in segs):
        return None
    n = sum(s["refills"] for s in segs)
    return sum(s["refill_us"] for s in segs) / n if n else None
