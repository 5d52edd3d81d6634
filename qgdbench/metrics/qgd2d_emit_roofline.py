"""qgd2d_emit_roofline: the least time of one `qgd2d_emit` launch over its
mean device time in the traced window, in percent.  A launch is two device
operations, the per-block partials and the final fold
(`qgd2d_emit_partial`, `qgd2d_emit_final`), so its time is theirs
together.  The least time is the larger of its bytes
(`roofline2d.work_bytes`) over the HBM rate and the float operations of
the plain emit (`reference.qgd2d.emit`: the Courant and tau rates, the raw
sensor and its first smoothing ring, counted on the meta device at the
cell's shape) over the float32 rate."""
from qgdbench import roofline, roofline2d
from qgdbench.reference import qgd2d


def least_ms(cfg) -> float:
    shape = cfg["shape"][:2]
    prm = qgd2d.params(cfg, "meta")
    frames = [roofline.meta_frame(shape) for _ in range(4)]
    sc = roofline.meta_frame(shape) if prm.varsc else None
    ops = roofline.count_ops(lambda: qgd2d.emit(prm, *frames, sc))
    return roofline.bound(roofline2d.work_bytes("qgd2d_emit", shape,
                                                prm.varsc), ops)[0]


def read(run):
    kernels = run.trace.kernels if run.trace else {}
    partial = kernels.get("qgd2d_emit_partial")
    final = kernels.get("qgd2d_emit_final")
    if not partial or not final or len(partial) != len(final):
        return None
    mean = (sum(partial) + sum(final)) / len(partial)
    return 100.0 * least_ms(run.cfg) * 1e-3 / mean
