"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``eegsynth_torch/csrc/*.cu`` compiles into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes), for Hopper only (``sm_90a``). The sources compile in parallel, one
``nvcc`` process each, and are then linked. The library lands in
``build/kernels/`` at the repository root under a name that carries a hash
of the sources (the ``csrc/*.cuh`` headers included) and flags: it is built
at first use and rebuilt whenever a source changes. A failed build raises;
there is no fallback.

Pointers and the stream cross the C boundary as ``ctypes.c_void_p`` (a bare
Python int would be cut to 32 bits).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels cannot be built")
    return str(nvcc)


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libeegsynth_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists.
    The compiler's report (``-Xptxas=-v``: registers, shared memory, spills)
    is kept beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    compiles = [[_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(_sources(), objs)]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    link = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *map(str, objs)]
    try:
        with ThreadPoolExecutor(max_workers=len(compiles)) as pool:
            procs = list(pool.map(_run, compiles))
        for cmd, proc in zip(compiles, procs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:"
                                   f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        proc = _run(link)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed with exit code {proc.returncode}:"
                               f"\n{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(
            "".join(p.stdout + p.stderr for p in procs))
        os.replace(tmp, out)     # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            # pointers, then the int dimensions, then the stream
            for fn, n_ptr, n_int in (("gru_seq_fwd", 5, 4), ("gru_seq_bwd", 9, 4),
                                     ("gru_seq_wide_fwd", 5, 4), ("gru_seq_wide_bwd", 9, 4),
                                     ("gru_seq_cluster_fwd", 5, 9), ("gru_seq_cluster_chain", 5, 9),
                                     ("multigru_fwd", 16, 7), ("flash_fwd", 5, 3),
                                     ("flash_bwd_dq", 7, 3), ("flash_bwd_dkv", 9, 3),
                                     ("flash_fwd_wide", 5, 3), ("flash_bwd_dq_wide", 7, 3),
                                     ("flash_bwd_dkv_wide", 8, 3),
                                     ("iir_filter_f64", 5, 3), ("iir_filter_f32", 5, 3)):
                f = getattr(lib, fn)
                f.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
                f.restype = i32
            for fn in ("gru_seq_fwd_tile", "gru_seq_wide_tile"):
                getattr(lib, fn).argtypes = [i32] * 3 + [ptr]
                getattr(lib, fn).restype = i32
            lib.gru_seq_cluster_card.argtypes = [ptr]
            lib.gru_seq_cluster_card.restype = i32
            lib.multigru_fwd_tile.argtypes = [i32] * 6 + [ptr]
            lib.multigru_fwd_tile.restype = i32
            lib.flash_bwd_dkv_scratch.argtypes = [i32] * 3
            lib.flash_bwd_dkv_scratch.restype = ctypes.c_size_t
            lib.eegsynth_cuda_error_string.argtypes = [ctypes.c_int]
            lib.eegsynth_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = lib.eegsynth_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
