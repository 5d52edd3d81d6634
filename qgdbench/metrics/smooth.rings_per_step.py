"""smooth.rings_per_step: the rings `qgd3d_smooth` ran in the window
(`fused_qgd3d.qgd3d_smooth.rings`) over the steps; the first ring of each
step, which `qgd3d_emit` makes, is not counted."""


def read(run):
    rings = run.counters.get("fused_qgd3d.qgd3d_smooth.rings")
    return None if rings is None else rings / run.steps
