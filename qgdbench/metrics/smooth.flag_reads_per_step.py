"""smooth.flag_reads_per_step: the host reads of a smoothing flag in the
window (`smoothing.smooth_sensor.reads`), each a wait for the device, over
the steps."""


def read(run):
    reads = run.counters.get("smoothing.smooth_sensor.reads")
    return None if reads is None else reads / run.steps
