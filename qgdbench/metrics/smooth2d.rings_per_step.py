"""smooth2d.rings_per_step: the rings `qgd2d_smooth` ran in the window
(`fused_qgd2d.qgd2d_smooth.rings`) over the steps; the first ring of each
step, which `qgd2d_emit` makes, is not counted."""


def read(run):
    rings = run.counters.get("fused_qgd2d.qgd2d_smooth.rings")
    return None if rings is None else rings / run.steps
