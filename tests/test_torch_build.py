"""The kernel library's build key (`qgdsolver_tpu_torch.ops._build`): the
library is named by a hash of the nvcc flags, the sources and the headers
they share, so editing any of them builds anew; the launch protocol every
kernel wrapper goes through (`ops.launch`), against a fake library; and the
direction of the ops modules' imports.  Nothing is compiled here.
"""
import contextlib
import pathlib
import re
import subprocess
import sys
import types

import pytest
import torch

from qgdsolver_tpu_torch.ops import _build, launch


def test_library_key_hashes_sources_and_headers(tmp_path, monkeypatch):
    """With `CSRC` pointed at a directory of one source and one header, the
    key changes when either one's bytes change, and returns with them."""
    src, hdr = tmp_path / "a.cu", tmp_path / "ring.cuh"
    src.write_text('#include "ring.cuh"\n')
    hdr.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.sources() == [src]
    key = _build._library_path()
    assert key.parent == _build.BUILD_DIR
    hdr.write_text("// two\n")
    assert _build._library_path() != key
    hdr.write_text("// one\n")
    assert _build._library_path() == key
    src.write_text('#include "ring.cuh"\n// edited\n')
    assert _build._library_path() != key


def test_every_included_header_is_hashed():
    """Every header a kernel source includes from its own directory is a
    `csrc/*.cuh`, which the key hashes."""
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    assert "smooth_ring.cuh" in headers
    for src in _build.sources():
        for name in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert name in headers, (src.name, name)


def test_launch_passes_pointers_and_the_stream_and_counts(monkeypatch):
    """`launch.launch` calls the library's entry inside the device context
    of `like` with each tensor as its pointer (other arguments as they are)
    and like's current stream last, and adds `count` to the counter; a
    nonzero code raises RuntimeError naming the entry and counts nothing."""
    calls, entered = [], []

    class FakeLibrary:
        code = 0

        def entry(self, *args):
            calls.append(args)
            return self.code

        def qgd2d_error_string(self, code):
            return b"fake failure"

    @contextlib.contextmanager
    def device(dev):
        entered.append(dev)
        yield

    lib = FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=4242))

    def counter():
        pass

    counter.launches = 5
    x, y = torch.zeros(3), torch.ones(2)
    launch.launch(counter, "entry", "prm", x, None, 7, y, like=x, count=3)
    assert calls == [("prm", x.data_ptr(), None, 7, y.data_ptr(), 4242)]
    assert entered == [x.device]
    assert counter.launches == 8
    lib.code = 700
    with pytest.raises(RuntimeError, match=r"^entry launch failed: CUDA "
                       r"error 700 \(fake failure\)"):
        launch.launch(counter, "entry", x, like=y, count=3)
    assert calls[-1] == (x.data_ptr(), 4242)
    assert counter.launches == 8


def test_ops_imports_point_one_way():
    """The 3D step and the smoothing load no 2D step module (in a fresh
    interpreter), and no module under ops/ but `launch` and `_build` loads
    the library or enters a device context itself."""
    code = ("import sys\n"
            "import qgdsolver_tpu_torch.ops.smoothing\n"
            "print('qgdsolver_tpu_torch.ops.fused_qgd2d' in sys.modules)\n"
            "import qgdsolver_tpu_torch.ops.fused_qgd3d\n"
            "print('qgdsolver_tpu_torch.ops.fused_qgd2d' in sys.modules)\n")
    root = pathlib.Path(_build.__file__).resolve().parents[2]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "False"]
    ops = pathlib.Path(_build.__file__).parent
    for src in sorted(ops.glob("*.py")):
        if src.name in ("launch.py", "_build.py"):
            continue
        text = src.read_text()
        assert "_build.load(" not in text, src.name
        assert "torch.cuda.device(" not in text, src.name
