"""points_per_s: interior cells x steps completed in the window over the
window's wall seconds (host clock, closed by a synchronise)."""


def read(run):
    return run.cells * run.steps / run.window_s
