"""step_roofline: the least time of a whole step over the traced window's
wall time a step, in percent.  The least time is the larger of the bytes
and the float operations a step needs, as the cell's family file gives them
(`step_least(cfg)`), over the HBM and float32 rates.  A family that gives
none has no reading."""
from qgdbench import roofline


def read(run):
    least = getattr(run.family, "step_least", None)
    if run.trace is None or least is None:
        return None
    ms = roofline.bound(*least(run.cfg))[0]
    return 100.0 * ms * 1e-3 / (run.window_s / run.steps)
