"""qgd2d_update_roofline: the least time of one `qgd2d_update` launch over
its mean device time in the traced window, in percent.  The least time is
the larger of its bytes (each input frame read once, each output written
once: `roofline2d.work_bytes`) over the HBM rate and the float operations
of the plain update (`reference.qgd2d.update`, counted on the meta device
at the cell's shape) over the float32 rate."""
import torch

from qgdbench import roofline, roofline2d
from qgdbench.reference import qgd2d


def least_ms(cfg) -> float:
    shape = cfg["shape"][:2]
    prm = qgd2d.params(cfg, "meta")
    frames = [roofline.meta_frame(shape) for _ in range(4)]
    sc = roofline.meta_frame(shape) if prm.varsc else None
    dt = torch.empty((), dtype=torch.float32, device="meta")
    ops = roofline.count_ops(lambda: qgd2d.update(prm, *frames, sc, dt))
    return roofline.bound(roofline2d.work_bytes("qgd2d_update", shape,
                                                prm.varsc), ops)[0]


def read(run):
    durs = run.trace.kernels.get("qgd2d_update") if run.trace else None
    if not durs:
        return None
    return 100.0 * least_ms(run.cfg) * 1e-3 / (sum(durs) / len(durs))
