"""device.idle_share: the share of the traced window in which no operation
ran on the device, 1 - busy/window, in percent."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
