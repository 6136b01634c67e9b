"""ctypes bindings for the native CSV column parser
(``eegsynth_torch/native/csv_loader.cpp``).

Counterpart of ``eegsynth/data/fast_csv.py`` (``read_header``,
``read_columns``): selected columns as float64, malformed or empty fields
NaN (pandas' ``to_numeric(errors="coerce")``), a UTF-8 BOM and fully quoted
names cleaned off the header. The parser builds at first use with ``g++ -O3
-shared -fPIC`` into ``build/native/`` at the repository root, under a name
that carries a hash of the source and flags. A failed build raises: there is
no pandas fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "csv_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where the parser for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libeegsynth_csv_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the parser unless a library for this exact source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp.so"
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with exit code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the parser once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.csv_open.restype = ctypes.c_void_p
            lib.csv_open.argtypes = [ctypes.c_char_p]
            lib.csv_num_rows.restype = ctypes.c_int64
            lib.csv_num_rows.argtypes = [ctypes.c_void_p]
            lib.csv_header.restype = ctypes.c_int64
            lib.csv_header.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
            lib.csv_read_columns.restype = ctypes.c_int64
            lib.csv_read_columns.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_double)]
            lib.csv_close.restype = None
            lib.csv_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def _clean_header(fields: list[str]) -> list[str]:
    """pandas-parity header names: a UTF-8 BOM stripped off the first name,
    fully quoted names unquoted (a name with a leading space before its quote
    stays as it is). Commas inside quoted names are not supported: they would
    shift the parser's comma-indexed columns."""
    out = []
    for i, name in enumerate(fields):
        if i == 0:
            name = name.lstrip("\ufeff")
        if len(name) >= 2 and name[0] == '"' and name[-1] == '"':
            name = name[1:-1]
        out.append(name)
    return out


def _open(lib: ctypes.CDLL, path):
    h = lib.csv_open(str(path).encode())
    if not h:
        raise OSError(f"csv_open failed: {path}")
    return h


def _header(lib: ctypes.CDLL, h) -> list[str]:
    n = lib.csv_header(h, None, 0)
    buf = ctypes.create_string_buffer(int(n) + 1)
    lib.csv_header(h, buf, n + 1)
    return _clean_header(buf.value.decode("utf-8", errors="replace").split(","))


def read_header(path) -> list[str]:
    """The CSV's column names."""
    lib = load_library()
    h = _open(lib, path)
    try:
        return _header(lib, h)
    finally:
        lib.csv_close(h)


def read_columns(path, column_names: list[str]) -> np.ndarray:
    """Selected columns of a CSV as an (n_rows, n_cols) float64 array."""
    lib = load_library()
    h = _open(lib, path)
    try:
        idx_map = {name: i for i, name in enumerate(_header(lib, h))}
        try:
            sel = np.array([idx_map[c] for c in column_names], dtype=np.int32)
        except KeyError as e:
            raise KeyError(f"column {e} not found in {path}") from e
        n_rows = int(lib.csv_num_rows(h))
        out = np.empty((n_rows, len(column_names)), dtype=np.float64)
        got = lib.csv_read_columns(
            h, sel.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(sel),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if got < 0:
            raise OSError(f"csv_read_columns failed: {path}")
        return out[:got]
    finally:
        lib.csv_close(h)
