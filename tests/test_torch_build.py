"""The kernel library's build key (`qgdsolver_tpu_torch.ops._build`): the
library is named by a hash of the nvcc flags, the sources and the headers
they share, so editing any of them builds anew.  Nothing is compiled here.
"""
import re

from qgdsolver_tpu_torch.ops import _build


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
