"""step.host_self_ms: the host's own milliseconds a step inside the
program's `qgd.step` spans less their `qgd.flag_read` spans (its Python,
the wrappers' checks and the launches, not its waits for the device), from
the summaries the program keeps in a traced run
(`utils.observability.segment_log`).  The window's segments are the log's
last `run.segments` summaries, each of `run.seg_steps` steps; anything
else, an untraced run, or a program that keeps no log has no reading."""


def read(run):
    from qgdsolver_tpu_torch.utils import observability

    log = getattr(observability, "segment_log", None)
    if run.trace is None or log is None or run.segments < 1:
        return None
    segs = log()[-run.segments:]
    if len(segs) != run.segments or any(s["steps"] != run.seg_steps
                                        for s in segs):
        return None
    steps = sum(s["steps"] for s in segs)
    return sum(s["step_self_ns"] for s in segs) * 1e-6 / steps
