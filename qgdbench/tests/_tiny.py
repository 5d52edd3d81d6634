"""Cells of BENCHMARK.json at a mesh a CPU test holds."""
from qgdbench import harness

SHAPE = [32, 14, 14]
CELLS = ("jet3d_varsc.shocked", "duct3d.steady")


def cell(name, shape=SHAPE):
    c = harness.resolve(harness.load_benchmark(), name)
    c.cfg["shape"] = list(shape)
    return c
