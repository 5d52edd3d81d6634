"""The reduction of a traced window: device time by kernel, busy time, and
idle gaps by what the host was doing (times in microseconds, as the
profiler gives them)."""
import pytest

from qgdbench import timing


def test_a_window_reduces_to_kernels_busy_time_and_gaps():
    device = [("void qgd3d_update_kernel<4>(QGD3DParams)", 0.0, 10.0),
              ("qgd3d_dt_kernel", 12.0, 14.0),
              ("Memcpy DtoH (Device -> Pageable)", 20.0, 21.0),
              ("void at::native::vectorized_elementwise_kernel", 20.5, 23.0)]
    host = [("outer", 0.0, 30.0), ("aten::item", 14.0, 22.0),
            ("cudaMemcpyAsync", 14.5, 21.5), ("aten::empty", 1.0, 2.0)]
    tr = timing.Trace(device, host)
    assert tr.busy_s == pytest.approx(15e-6)  # 10 + 2 + 3 overlapping
    assert tr.kernels["qgd3d_update"] == [pytest.approx(10e-6)]
    assert set(tr.kernels) == {"qgd3d_update", "qgd3d_dt", "copies and fills",
                               "torch ops"}
    assert tr.idle_by_host == {"outer": pytest.approx(2e-6),
                               "cudaMemcpyAsync": pytest.approx(6e-6)}
    assert tr.idle_gaps()[0][0] == "cudaMemcpyAsync"
    assert tr.device_ops(top=1) == [["qgd3d_update", pytest.approx(10e-6)]]


def test_a_gap_with_no_host_call_is_host_python():
    tr = timing.Trace([("a", 0.0, 1.0), ("b", 5.0, 6.0)], [("x", 0.0, 2.0)])
    assert tr.idle_by_host == {"host python": pytest.approx(4e-6)}


def test_step_roofline_takes_the_least_step_from_the_family():
    """`step_roofline` reads a step's least bytes and operations from the
    cell's family file, and has no reading where the family gives none."""
    import types

    from qgdbench import harness, roofline

    cell = harness.resolve(harness.load_benchmark(), "duct3d.steady")
    read = harness.reader({"name": "step_roofline"})
    run = types.SimpleNamespace(family=cell.family, cfg=cell.cfg,
                                trace=object(), window_s=2.0, steps=100)
    least_ms = roofline.bound(*cell.family.step_least(cell.cfg))[0]
    assert read(run) == pytest.approx(100.0 * least_ms * 1e-3 / 0.02)
    run.family = types.SimpleNamespace()
    assert read(run) is None
