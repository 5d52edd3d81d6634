"""setup_s: the process's start to the first timed step: imports, the
kernels' build or load, the case, the traffic's fields, the carry and one
warm segment."""


def read(run):
    return run.setup_s
