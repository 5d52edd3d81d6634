"""The benchmark is driven by its data: every cell of BENCHMARK.json finds
its configuration, traffic, family, limits and metric readers by name; a
new cell needs new files and entries only; each configuration's file says
what the program's case builder builds."""
import hashlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from qgdbench import harness
from qgdbench.reference import qgd3d

from . import _tiny

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(name):
    cell = harness.resolve(BENCH, name)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    here = harness.HERE
    for path in (here / "configs" / f"{w['config']}.json",
                 here / "traffic" / f"{w['traffic']}.json",
                 here / "families" / f"{cell.cfg['family']}.py",
                 here / "checks" / f"{name}.json"):
        assert path.is_file(), path
    assert callable(cell.family.Program) and callable(cell.family.reference)
    for spec in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(spec)), spec["name"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert set(cell.limits) <= {"fields_gap", "dt_gap", "sensor_gap"}


def test_benchmark_json_keeps_the_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["qgdbench"]
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert c["file"].startswith("qgdbench/")
        assert json.loads(pathlib.Path(harness.ROOT, c["file"]).read_text()
                          )["reduced"] == c["reduced"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_reference_constants_are_the_programs(name):
    """The reference's constants and BC table, worked out from the
    configuration's file, equal those the program derives from its case
    builder (`fused_qgd3d.make_params`)."""
    from qgdsolver_tpu_torch import cases
    from qgdsolver_tpu_torch.ops import fused_qgd2d, fused_qgd3d

    cell = _tiny.cell(name, shape=(24, 10, 12))
    cfg = cell.cfg
    solver, _ = getattr(cases, cfg["case"])(shape=tuple(cfg["shape"]),
                                            mach=cfg["mach"], device="cpu")
    prm, planes = fused_qgd3d.make_params(solver)
    ref = qgd3d.params(cfg)
    for field in ("nx", "ny", "nz", "inv_vol", "R", "Cv", "inv_Cv", "CvR",
                  "gammaR", "gamma", "alpha", "k_mu", "k_muv", "inv_Pr_tau",
                  "mu0", "mu0_Pr_th", "max_co", "max_dt", "c_tau", "rC",
                  "one_m_rC", "minSc", "maxSc", "cqSc", "h_cell",
                  "smooth_ratio"):
        assert getattr(prm, field) == getattr(ref, field), field
    for field in ("d", "inv_d", "inv_2d", "area"):
        assert tuple(getattr(prm, field)) == getattr(ref, field), field
    assert (bool(prm.varsc), bool(prm.mu_const0), bool(prm.adjust_dt)) == \
        (ref.varsc, ref.mu_const0, ref.adjust_dt)
    kinds = {v: k for k, v in fused_qgd2d.KINDS.items()}
    for f in range(5):
        for a in range(3):
            for side in (0, 1):
                e, r = prm.bc[f][a][side], ref.bc[f][a][side]
                assert kinds[e.kind] == r.kind, (f, a, side)
                if e.prof >= 0:  # a plane; the reference may hold a number
                    plane = torch.as_tensor(planes[e.prof])
                    assert torch.equal(plane, torch.as_tensor(
                        r.value, dtype=plane.dtype).expand_as(plane)), \
                        (f, a, side)
                elif r.kind == "fixed":
                    assert e.value == r.value, (f, a, side)


def _digests(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_needs_no_edit(tmp_path):
    """A copy of the benchmark gains a cell by new files and entries alone:
    a configuration, a traffic mix, its limits and a BENCHMARK.json entry.
    The harness runs it at a tiny mesh, and no file it had changes."""
    shutil.copytree(harness.HERE, tmp_path / "qgdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    before = _digests(tmp_path / "qgdbench")
    cfg = json.loads((harness.HERE / "configs" / "duct3d.json").read_text())
    cfg["shape"] = [16, 6, 8]
    (tmp_path / "qgdbench" / "configs" / "duct3d_small.json").write_text(
        json.dumps(cfg))
    mix = {"segment_steps": 3,
           "density_factor": {"slabs": {"amplitudes": [0.1, 0.2],
                                        "x_range": [1.0, 3.0],
                                        "half_width": 0.3, "min_gap": 0.8}}}
    (tmp_path / "qgdbench" / "traffic" / "two_slabs.json").write_text(
        json.dumps(mix))
    (tmp_path / "qgdbench" / "checks" / "duct3d_small.two_slabs.json"
     ).write_text(json.dumps({"fields_gap": 1e-6, "dt_gap": 1e-6}))
    bench["configs"].append({"name": "duct3d_small", "source": "x",
                             "file": "qgdbench/configs/duct3d_small.json",
                             "reduced": ["shape"], "why": "x"})
    bench["workloads"].append({"name": "duct3d_small.two_slabs",
                               "config": "duct3d_small",
                               "traffic": "two_slabs", "chips": 1,
                               "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from qgdbench import harness\n"
            "assert harness.HERE.parent.samefile('.')\n"
            "cell = harness.resolve(harness.load_benchmark(), "
            "'duct3d_small.two_slabs')\n"
            "run = harness.measure(cell, 11, 0.1, device='cpu', plain=True)\n"
            "print(harness.correct(run), run.gaps)\n")
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("True"), out.stdout
    after = _digests(tmp_path / "qgdbench")
    assert {k: after[k] for k in before} == before
