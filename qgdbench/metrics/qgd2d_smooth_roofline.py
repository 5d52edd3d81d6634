"""qgd2d_smooth_roofline: the least time of one `qgd2d_smooth` launch over
its mean device time in the traced window, in percent.  A launch reads a
frame and writes one (`roofline2d.work_bytes`), whatever its rings; its
operations are those of its rings in the plain ring
(`reference.qgd3d.ring` on the 2D cells, counted on the meta device), the
rings a launch being the window's rings over its launches."""
import torch

from qgdbench import roofline, roofline2d
from qgdbench.reference import qgd2d, qgd3d


def least_ms(cfg, rings: int) -> float:
    shape = cfg["shape"][:2]
    prm = qgd2d.params(cfg, "meta")
    cells = torch.empty(tuple(shape), dtype=torch.float32, device="meta")

    def launch():
        f = cells
        for _ in range(rings):
            f = qgd3d.ring(prm, f)[0]

    return roofline.bound(roofline2d.work_bytes("qgd2d_smooth", shape),
                          roofline.count_ops(launch))[0]


def read(run):
    durs = run.trace.kernels.get("qgd2d_smooth") if run.trace else None
    launches = run.counters.get("fused_qgd2d.qgd2d_smooth.launches")
    if not durs or not launches:
        return None
    rings = round(run.counters["fused_qgd2d.qgd2d_smooth.rings"] / launches)
    return 100.0 * least_ms(run.cfg, rings) * 1e-3 / (sum(durs) / len(durs))
