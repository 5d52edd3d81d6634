"""bytes_per_point: the program's peak device memory over set-up and the
window (`torch.cuda.max_memory_allocated`, the CUDA caching allocator's
count, after a reset at the start, read before the reference runs) over the
interior cells.  The peak is as a rule reached in set-up, where the State
becomes the step's carry, and not in the window: a change that shrinks only
the window's working set leaves it where it is."""


def read(run):
    if run.memory_peak_bytes is None:
        return None
    return run.memory_peak_bytes / run.cells
