"""qgd3d_update_roofline: the least time of one `qgd3d_update` launch over
its mean device time in the traced window, in percent.  The least time is
the larger of its bytes (each input frame read once, each output written
once: `roofline.work_bytes`) over the HBM rate and the float operations of
the plain update (`reference.qgd3d.update`, counted on the meta device at
the cell's shape) over the float32 rate."""
import torch

from qgdbench import roofline
from qgdbench.reference import qgd3d


def least_ms(cfg) -> float:
    shape = cfg["shape"]
    prm = qgd3d.params(cfg)
    frames = [roofline.meta_frame(shape) for _ in range(5)]
    sc = roofline.meta_frame(shape) if prm.varsc else None
    dt = torch.empty((), dtype=torch.float32, device="meta")
    ops = roofline.count_ops(lambda: qgd3d.update(prm, *frames, sc, dt))
    return roofline.bound(roofline.work_bytes("qgd3d_update", shape,
                                              prm.varsc), ops)[0]


def read(run):
    durs = run.trace.kernels.get("qgd3d_update") if run.trace else None
    if not durs:
        return None
    return 100.0 * least_ms(run.cfg) * 1e-3 / (sum(durs) / len(durs))
