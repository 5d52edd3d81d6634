"""The bytes a 2D kernel must move, frozen: the 2D entries of
`chip_smoke.py`'s `work_bytes` at commit c89fb21, which `roofline.work_bytes`
leaves out.  Each input frame is read once and each output written once;
`roofline.bound` turns them into a least time."""


def work_bytes(name, shape, varsc=False) -> int:
    """The bytes a 2D kernel must move at `shape` = (nx, ny) cells."""
    nx, ny = shape
    cells = nx * ny
    frame = (nx + 2) * (ny + 2)
    ghosts = 2 * (ny + nx + 2)  # ghost cells of one field
    io = {"qgd2d_dt": 3 * frame, "qgd2d_dt_fold": 3 * frame,
          "qgd2d_update": (4 + varsc) * frame + 4 * cells,
          "qgd2d_ghosts": 4 * 3 * ghosts,
          # p, T, ux, uy, sc in; the raw sensor and its first ring out
          "qgd2d_emit": 5 * frame + 2 * cells,
          # per launch: one frame in, one out
          "qgd2d_smooth": 2 * frame}
    return 4 * io[name]
