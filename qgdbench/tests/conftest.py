"""The benchmark's own tests: `python -m pytest qgdbench/tests -q` from the
repository's root.  Tests marked `gpu` need a CUDA card and skip without
one, deciding inside the test."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason elsewhere")
