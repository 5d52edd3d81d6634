"""No run loads JAX or the JAX package, and the reference loads nothing of
the program: checked in fresh interpreters, comparing whole top-level
module names (the program's name begins with the JAX package's)."""
import json
import subprocess
import sys

from qgdbench import harness

TOP = "sorted({m.split('.')[0] for m in sys.modules})"


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + f"\nprint({TOP})"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))


def test_the_harness_and_a_run_load_no_jax():
    code = ("import sys\n"
            "import qgdbench.__main__, qgdbench.calibrate\n"
            "from qgdbench import harness\n"
            "b = harness.load_benchmark()\n"
            "for w in b['workloads']:\n"
            "    cell = harness.resolve(b, w['name'])\n"
            "    for m in cell.end_to_end + cell.per_layer:\n"
            "        harness.reader(m)\n"
            "cell = harness.resolve(b, 'jet3d_varsc.shocked')\n"
            "cell.cfg['shape'] = [16, 6, 6]\n"
            "harness.measure(cell, 1, 0.0, device='cpu', plain=True)\n"
            "assert not harness.forbidden_loaded()\n")
    top = _loaded(code)
    assert "qgdsolver_tpu_torch" in top  # the program ran
    assert not top & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json\n"
            "from qgdbench import generator\n"
            "from qgdbench.reference import qgd3d\n"
            "cfg = json.load(open('qgdbench/configs/jet3d_varsc.json'))\n"
            "cfg['shape'] = [16, 6, 6]\n"
            "mix = json.load(open('qgdbench/traffic/shocked.json'))\n"
            "qgd3d.run(cfg, generator.fields(cfg, mix, 1, 'cpu'), 2)\n")
    top = _loaded(code)
    assert "torch" in top
    assert not top & (set(harness.FORBIDDEN) | {"qgdsolver_tpu_torch"})


def test_forbidden_names_are_compared_whole():
    import qgdsolver_tpu_torch.ops  # noqa: F401 - loaded, and not JAX's

    assert not harness.forbidden_loaded()
