"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

`load()` compiles every `csrc/*.cu` into one shared library with a plain C
interface at first use, under `build/qgd_kernels/` at the repository root,
keyed by a hash of all the sources, the headers they share (`csrc/*.cuh`)
and the flags, and loads it.  Each source
is compiled by its own nvcc process, all started together, and the objects
are then linked.  Nothing is built or loaded at import: importing this
module needs neither nvcc nor a card.  `QGDParams`, `QGD3DParams` and
`BCEntry` mirror the C structs of the same names.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "qgd_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_c_int, _c_float, _ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


class BCEntry(ctypes.Structure):
    """One ghost spec: kind, scalar value (symmetry: the sign), profile row
    (-1: none)."""

    _fields_ = [("kind", _c_int), ("value", _c_float), ("prof", _c_int)]


class QGDParams(ctypes.Structure):
    """Step constants of the 2D kernels; every float is rounded to f32 here
    once, and the plain torch versions read the same rounded values.  The
    edge flags are 1 where a frame edge is a physical boundary and 0 at a
    partition edge of a decomposed run."""

    _fields_ = (
        [(n, _c_int) for n in ("nx", "ny", "varsc", "mu_const0", "adjust_dt",
                               "prof_len", "edge_lo", "edge_hi", "edge_lo_y",
                               "edge_hi_y")]
        + [(n, _c_float) for n in (
            "dx", "dy", "inv_dx", "inv_dy", "inv_2dx", "inv_2dy", "hfx", "hfy",
            "inv_vol", "R", "Cv", "inv_Cv", "CvR", "gammaR", "gamma", "alpha",
            "k_mu", "k_muv", "Pr_tau", "inv_Pr_tau", "Pr_th", "mu0", "max_co",
            "max_dt", "c_tau", "inv_hfx", "inv_hfy", "h_cell", "rC",
            "one_m_rC", "minSc", "maxSc", "cqSc", "smooth_ratio")]
        + [("bc", BCEntry * 2 * 2 * 4)]  # [field p, T, ux, uy][axis][side]
    )


class QGD3DParams(ctypes.Structure):
    """Step constants of the 3D kernels, rounded to f32 once like
    `QGDParams`; per-axis constants are 3-vectors (x, y, z); the edge flags
    of the two x ends as in `QGDParams`."""

    _fields_ = (
        [(n, _c_int) for n in ("nx", "ny", "nz", "varsc", "mu_const0",
                               "adjust_dt", "edge_lo", "edge_hi")]
        + [(n, _c_float * 3) for n in ("d", "inv_d", "inv_2d", "area")]
        + [(n, _c_float) for n in (
            "inv_vol", "R", "Cv", "inv_Cv", "CvR", "gammaR", "gamma", "alpha",
            "k_mu", "k_muv", "inv_Pr_tau", "mu0", "mu0_Pr_th", "max_co",
            "max_dt", "c_tau", "rC", "one_m_rC", "minSc", "maxSc", "cqSc",
            "h_cell")]
        # [field p, T, ux, uy, uz][axis][side]
        + [("bc", BCEntry * 2 * 3 * 5)]
        + [("smooth_ratio", _c_float)]
    )


def nvcc_path() -> str:
    """The nvcc to build with: PATH first, then the CUDA toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list:
    """Every kernel source, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> pathlib.Path:
    """The library's path, keyed by the flags and the bytes of every source
    and shared header: editing either builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"qgd_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless these sources were built already: one nvcc
    per source, run together, then one link.  The `-Xptxas -v` report
    (registers, shared memory, spills) of every source is kept beside the
    library.  Raises with nvcc's stderr when a build fails."""
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reports, failed = [], []
    for src, _, proc in jobs:
        _, err = proc.communicate()
        reports.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name}:\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out.with_name(f"{tag}.tmp.so")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *(str(obj) for _, obj, _ in jobs)],
                          capture_output=True, text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link the kernels:\n{link.stderr}")
    out.with_suffix(".ptxas.txt").write_text("".join(reports))
    os.replace(tmp, out)
    return out


def ptxas_report() -> str:
    """The `-Xptxas -v` lines of the current build ('' before a build)."""
    rep = _library_path().with_suffix(".ptxas.txt")
    return rep.read_text() if rep.exists() else ""


def _bind(lib, name, argtypes, restype=_c_int):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = restype


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes set."""
    lib = ctypes.CDLL(str(build()))
    p2 = ctypes.POINTER(QGDParams)
    p3 = ctypes.POINTER(QGD3DParams)
    _bind(lib, "qgd2d_dt_partials", [_c_int, _c_int])
    _bind(lib, "qgd2d_error_string", [_c_int], ctypes.c_char_p)
    _bind(lib, "qgd2d_dt", [p2] + [_ptr] * 7)
    _bind(lib, "qgd2d_dt_fold", [p2] + [_ptr] * 6)
    _bind(lib, "qgd2d_dt_apply", [p2] + [_ptr] * 4)
    _bind(lib, "qgd2d_dt_shape", [_c_int, _c_int, ctypes.POINTER(_c_int)])
    _bind(lib, "qgd2d_update", [p2] + [_ptr] * 12)
    _bind(lib, "qgd2d_update_shape", [_c_int, _c_int,
                                      ctypes.POINTER(_c_int)])
    _bind(lib, "qgd2d_ghosts", [p2] + [_ptr] * 7)
    _bind(lib, "qgd2d_emit_partials", [_c_int, _c_int])
    _bind(lib, "qgd2d_emit", [p2] + [_ptr] * 11)
    _bind(lib, "qgd2d_smooth", [p2, _ptr, _c_int, _c_int, _ptr, _ptr, _ptr])
    _bind(lib, "smooth_ring_check", [_c_float, _ptr, _ptr])
    _bind(lib, "qgd3d_dt_partials", [p3])
    _bind(lib, "qgd3d_dt", [p3] + [_ptr] * 8)
    _bind(lib, "qgd3d_dt_fold", [p3] + [_ptr] * 7)
    _bind(lib, "qgd3d_dt_apply", [p3] + [_ptr] * 4)
    _bind(lib, "qgd3d_dt_shape", [p3, ctypes.POINTER(_c_int)])
    _bind(lib, "qgd3d_update", [p3] + [_ptr] * 14)
    _bind(lib, "qgd3d_update_launch", [p3, ctypes.POINTER(_c_int)])
    _bind(lib, "qgd3d_sensor", [p3] + [_ptr] * 5)
    _bind(lib, "qgd3d_emit", [p3] + [_ptr] * 7)
    _bind(lib, "qgd3d_emit_shape", [p3, ctypes.POINTER(_c_int)])
    _bind(lib, "qgd3d_ghosts", [p3] + [_ptr] * 8)
    _bind(lib, "qgd3d_smooth", [p3, _ptr, ctypes.c_long, ctypes.c_long,
                                _c_int, _ptr, _ptr, _ptr])
    _bind(lib, "qgd3d_smooth_shape", [p3, _c_int, ctypes.POINTER(_c_int)])
    _bind(lib, "qgd3d_smooth_fixed", [p3, _ptr, ctypes.c_long, ctypes.c_long,
                                      _ptr, _ptr, _ptr])
    _bind(lib, "qgd3d_smooth_fixed_shape", [p3, ctypes.POINTER(_c_int)])
    i64 = ctypes.c_longlong
    for name in ("deposit_f32", "deposit_f64"):
        _bind(lib, name, [_ptr, i64, _c_int, _ptr, _ptr, _ptr, i64, _ptr])
    return lib


def check(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.qgd2d_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
