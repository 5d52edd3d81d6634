"""OpenFOAM dictionary parsing (PyTorch port of `qgdsolver_tpu.io.foamdict`).

The port keeps its own copy of the reference's native parser,
`csrc/foamdict.cpp` (byte-identical to the JAX package's), built on demand
with g++ into `build/foamdict/` at the repository root and bound with
ctypes.  The library's name carries a hash of the source and the flags, so
an edited source builds anew, and it is written beside its target and
renamed, so a process loading it never sees a half-written file.  The
pure-Python grammar below is the plain version, used where no toolchain is
found.  Host-side parsing only: nothing here touches torch.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import pathlib
import re
import subprocess

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "foamdict.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "foamdict"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
_LIB = None
_TRIED = False


def library_path() -> pathlib.Path:
    """The library's path, keyed by the flags and the source's bytes."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0"
                       + SOURCE.read_bytes())
    return BUILD_DIR / f"libfoamdict_{h.hexdigest()[:16]}.so"


def _build() -> pathlib.Path:
    """Compile the parser unless this source was built already."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        finally:
            tmp.unlink(missing_ok=True)
    return so


def _load_native():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.SubprocessError):
        return None  # no toolchain: the Python grammar parses
    lib.foamdict_parse_json.restype = ctypes.c_void_p
    lib.foamdict_parse_json.argtypes = [ctypes.c_char_p]
    lib.foamdict_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def parse(text: str) -> dict:
    """Parse OpenFOAM dictionary text into a plain dict (native if
    available, Python fallback otherwise)."""
    lib = _load_native()
    if lib is not None:
        ptr = lib.foamdict_parse_json(text.encode())
        try:
            raw = ctypes.string_at(ptr).decode()
        finally:
            lib.foamdict_free(ptr)
        return json.loads(raw)
    return _parse_py(text)


def parse_file(path: str) -> dict:
    with open(path) as f:
        return parse(f.read())


def native_available() -> bool:
    return _load_native() is not None


# ---------------------------------------------------------------------------
# pure-Python fallback (same grammar)
# ---------------------------------------------------------------------------

# OpenFOAM words may embed balanced, whitespace-free parentheses:
# grad(p) / div(phi,U) / div((rho*U)) are single keyword tokens.
_TOKEN_RE = re.compile(
    r'"(?:\\.|[^"])*"'
    r'|[^\s{}()\[\];"]+(?:\((?:[^()\s{}\[\];"]|\([^()\s{}\[\];"]*\))*\))+'
    r'[^\s{}()\[\];"]*'
    r'|[{}()\[\];]'
    r'|[^\s{}()\[\];"]+'
)


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    text = re.sub(r"#[^\n]*", " ", text)  # directives
    return text


def _parse_py(text: str) -> dict:
    toks = _TOKEN_RE.findall(_strip_comments(text))
    pos = [0]

    def peek():
        return toks[pos[0]] if pos[0] < len(toks) else None

    def take():
        t = peek()
        pos[0] += 1
        return t

    def atom(tok):
        if tok.startswith('"'):
            return tok[1:-1]
        try:
            f = float(tok)
            return int(f) if f.is_integer() and "e" not in tok.lower() \
                and "." not in tok else f
        except ValueError:
            pass
        if tok in ("true", "yes", "on"):
            return True
        if tok in ("false", "no", "off"):
            return False
        return tok

    def single():
        tok = take()
        if tok == "(":
            out = []
            while peek() not in (")", None):
                out.append(single())
            take()
            return out
        if tok == "[":
            dims = []
            while peek() not in ("]", None):
                dims.append(atom(take()))
            take()
            return {"__dims__": dims}
        if tok == "{":
            # a dictionary inside a list or a value: its closing brace is
            # its own, as in the native parser
            d = dict_body()
            if peek() == "}":
                take()
            return d
        return atom(tok)

    def value_tokens():
        parts = []
        while peek() not in (";", "}", None):
            parts.append(single())
        if peek() == ";":
            take()
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else parts

    def dict_body():
        d = {}
        while peek() not in ("}", None):
            if peek() in (";",):
                take()
                continue
            key = atom(take())
            if not isinstance(key, str):
                continue
            if peek() == "{":
                take()
                d[key] = dict_body()
                if peek() == "}":
                    take()
            else:
                d[key] = value_tokens()
        return d

    return dict_body()
