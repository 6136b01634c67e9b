"""Time variants of the IIR filter kernel (``csrc/iir_filter.cu``) against
each other, and against another tree's kernel, on one CUDA card, in turns, at
preprocessing's filters (fs 128: the order-8 band-pass and the order-2
notch) and at wider batches of columns.

Each variant is ``iir_filter.cu`` built alone with nvcc into a library of its
own, with the lanes route built for float32 too (the tree builds it for
float64 alone), and launched on a plan of its own:

- (a) lane groups, lane 0 holding z0 alone (this tree with ``kLocal`` 1);
- (b) lane groups, lane 0 holding z0 and z1 (this tree: ``kLocal`` 2);
- (c) one thread a column (this tree's column route);
- ``base``: the file given with ``--base``, as it is: a kernel with the
  lanes argument runs this tree's plan; one without it (the
  one-thread-a-column kernel before the lane groups) runs as it did.

Where lane 0 holds the whole state (order 2 under (b)) a lane group is one
lane and the variant runs the column route. Every variant's output is held
to scipy's ``lfilter`` on the host, which the kernel equals bit for bit:
the line gives the count of unequal elements. Beside them, stand-ins of
this tree's kernel with one part of the step left out (no loads of x into
the full chunks, no stores of y but the last full chunk's, no shuffles)
give wrong results on purpose: the time they save is what that part costs
the step.

    python3 -m eegsynth_torch.tools.iir_variants [--base OLD_iir_filter.cu]

Prints ptxas's registers and spills of the order-8 instances, then for each
shape the route ``iir_plan`` picks and the step-chain probe alone and with a
shuffle round trip a step, and one line a variant: the unequal elements and
the mean over two passes in opposite order of the median of REPS timings
of BATCH launches back to back (CUDA events; a launch's time is the
device's, not the host's call), with the cycles a step at the card's
maximum SM clock.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.data.filters import design_filters
from eegsynth_torch.ops.filtering import (
    _taps, iir_chain_probe, iir_lanes, iir_plan, lfilter_zi,
)
from eegsynth_torch.tools.k1_fwd_variants import CSRC, _compile, _report, _time_ms

REPS, BATCH = 15, 8
F64, F32 = torch.float64, torch.float32
# (T, M, order, dtype): one 60 s trial with the band-pass's odd extension
# (preprocessing's pass: band-pass and notch, float64 and float32), one hour,
# and wider batches of columns, where the lane groups lose to one thread a column
SHAPES = ((7734, 14, 8, F64), (7734, 14, 2, F64), (7734, 14, 8, F32), (7734, 14, 2, F32),
          (460854, 14, 8, F64), (460854, 14, 2, F64), (7734, 300, 8, F64),
          (7734, 1024, 8, F64), (7734, 2048, 8, F64), (7734, 4096, 8, F64),
          (7734, 8192, 8, F64), (7734, 2048, 8, F32), (7734, 8192, 8, F32))

# every variant of this tree: the lanes route in both dtypes
BOTH_DTYPES = (("constexpr bool kLanesRoute = sizeof(T) == 8;",
                "constexpr bool kLanesRoute = true;"),)
LOCAL_1 = (("constexpr int kLocal = 2;", "constexpr int kLocal = 1;"),)
NO_LOADS = (("buf[u] = (kAll || u < rows) ? xc[static_cast<size_t>(u) * stride] : zero<T>();",
             "buf[u] = kAll ? cur[(u + 1) % kChunk] : (u < rows) ? "
             "xc[static_cast<size_t>(u) * stride] : zero<T>();"),
            ("void load_rows(T (&buf)[kChunk], const T* __restrict__ xc,",
             "void load_rows(T (&buf)[kChunk], const T (&cur)[kChunk], const T* __restrict__ xc,"),
            ("load_rows<false>(cur, xc, min(kChunk, T_len), stride);",
             "load_rows<false>(cur, cur, xc, min(kChunk, T_len), stride);"),
            ("load_rows<true>(nxt, xn, kChunk, stride);", "load_rows<true>(nxt, cur, xn, kChunk, stride);"),
            ("load_rows<false>(nxt, xn, T_len - t0 - kChunk, stride);",
             "load_rows<false>(nxt, cur, xn, T_len - t0 - kChunk, stride);"))
NO_STORES = (("    if (store) {\n#pragma unroll\n      for (int u = 0; u < kChunk; ++u) yc[",
              "    if (store && k + 1 == full) {\n#pragma unroll\n      for (int u = 0; u < kChunk; ++u) yc["),)
NO_SHUFFLES = (("const T s = __shfl_down_sync(kFull, zo, 1);", "const T s = zo;"),
               ("const T yb = __shfl_sync(kFull, yt, base);", "const T yb = yt;"))
# name: (the library, lane 0's local elements: None for one thread a
# column); the stand-ins keep this tree's plan
VARIANTS = {
    "(a) lanes, lane 0 holds z0": ("local 1", 1),
    "(b) lanes, lane 0 holds z0, z1": ("this tree", 2),
    "(c) one thread a column": ("this tree", None),
    "stand-in: no loads": ("no loads", 2),
    "stand-in: no stores": ("no stores", 2),
    "stand-in: no shuffles": ("no shuffles", 2),
}
SOURCES = {"this tree": (), "local 1": LOCAL_1, "no loads": NO_LOADS, "no stores": NO_STORES,
           "no shuffles": NO_SHUFFLES}


def _label(m: re.Match) -> str | None:
    if m.group(2) != "9":
        return None
    route = "column" if m.group(3) == "1" else f"{m.group(3)} lanes, lane 0 holds {m.group(4)}"
    return f"{'f64' if m.group(1) == 'd' else 'f32'}, order 8, {route}"


def _sources(base: Path | None) -> dict[str, str]:
    here = (CSRC / "iir_filter.cu").read_text()
    srcs = {}
    for name, patches in SOURCES.items():
        src = here
        for old, new in BOTH_DTYPES + patches:
            if old not in src:
                raise RuntimeError(f"{name}: patch target not found: {old!r}")
            src = src.replace(old, new)
        srcs[name] = src
    if base is not None:
        srcs["base"] = base.read_text()
    return srcs


def _takes_lanes(src: str) -> bool:
    return "int n, int lanes" in src


def _load(path: Path, lanes: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in ("iir_filter_f64", "iir_filter_f32"):
        getattr(lib, fn).argtypes = [ptr] * 5 + [i32] * (4 if lanes else 3) + [ptr]
        getattr(lib, fn).restype = i32
    return lib


def _inputs(T: int, M: int, order: int, dtype, seed: int):
    """chip_smoke.py's inputs: the filter, a random walk x (T, M) and
    filtfilt's seed zi = lfilter_zi · x[0], on the card; scipy's output."""
    import scipy.signal

    (b_bp, a_bp), (b_n, a_n) = design_filters(128.0)
    b, a = (b_bp, a_bp) if order == 8 else (b_n, a_n)
    x = np.random.default_rng(seed).standard_normal((T, M)).cumsum(axis=0)
    x = x.astype(np.float64 if dtype == F64 else np.float32)
    zi = (lfilter_zi(b, a)[:, None] * x[0]).astype(x.dtype)
    ref, _ = scipy.signal.lfilter(b.astype(x.dtype), a.astype(x.dtype), x, axis=0, zi=zi)
    bt, at = _taps(b, a, dtype)
    return (bt, at, torch.from_numpy(x).cuda(), torch.from_numpy(zi).cuda(),
            torch.from_numpy(ref).cuda())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, help="iir_filter.cu of another tree (the one-thread-"
                                              "a-column interface), timed too")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    clock = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True, check=True).stdout.splitlines()[0])
    print(smi, flush=True)
    srcs = _sources(args.base)
    with tempfile.TemporaryDirectory(prefix="iir_variants_") as tmp:
        work = Path(tmp)
        libs = {}
        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            futures = [pool.submit(_compile, name, src, work / f"lib{i}.so")
                       for i, (name, src) in enumerate(srcs.items())]
            for i, fut in enumerate(futures):
                name, log = fut.result()
                _report(name, log, r"iir_filter_kernelI([df])Li(\d+)ELi(\d+)ELi(\d+)E", _label)
                libs[name] = _load(work / f"lib{i}.so", _takes_lanes(srcs[name]))
        _run(libs, smi, clock, base_lanes="base" in srcs and _takes_lanes(srcs["base"]))


def _run(libs: dict, smi: str, clock: float, base_lanes: bool) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    for T, M, order, dtype in SHAPES:
        bt, at, x, zi, ref = _inputs(T, M, order, dtype, seed=T + M + order)
        y = torch.empty_like(x)
        fn = "iir_filter_f64" if dtype == F64 else "iir_filter_f32"
        n = order + 1
        runs = {}
        for name, (lib, local) in VARIANTS.items():
            lanes = 1 if local is None else iir_lanes(n, local)
            runs[name] = (libs[lib], (lanes,))
        plan = iir_plan(M, n, dtype)
        if "base" in libs:
            runs = {"base": (libs["base"], (plan["lanes"],) if base_lanes else ()), **runs}

        def call(name, batch=1):
            lib, extra = runs[name]
            for _ in range(batch):
                code = getattr(lib, fn)(x.data_ptr(), zi.data_ptr(), bt.data_ptr(),
                                        at.data_ptr(), y.data_ptr(), T, M, n, *extra, stream)
                if code:
                    raise RuntimeError(f"{name}: {fn} failed: CUDA error {code}")

        unequal, times = {}, {name: [] for name in runs}
        for name in runs:
            y.fill_(float("nan"))
            call(name)
            torch.cuda.synchronize()
            unequal[name] = int((y != ref).sum().item())
        reps = REPS if T < 10 ** 5 else 3
        for order_ in (list(runs), list(runs)[::-1]):
            for name in order_:
                times[name].append(_time_ms(lambda: call(name, BATCH), reps) / BATCH)
        chain = [_time_ms(lambda: [iir_chain_probe(T, dtype, shuffle) for _ in range(BATCH)],
                          reps) / BATCH for shuffle in (False, True)]
        label = f"T={T} M={M} order {order} {str(dtype)[6:]}"
        per_step = [t * 1e-3 * clock * 1e6 / T for t in chain]
        print(f"[plan] {label}: route {plan['route']}, {plan['lanes']} lanes, "
              f"{plan['blocks']} blocks; step-chain probe {chain[0]:.4f} ms "
              f"({per_step[0]:.1f} cycles a step), with a shuffle round trip "
              f"{chain[1]:.4f} ms ({per_step[1]:.1f}; the shuffle "
              f"{per_step[1] - per_step[0]:.1f}) at {clock:.0f} MHz | {smi}", flush=True)
        for name in runs:
            ms = statistics.mean(times[name])
            verdict = ("stand-in" if name.startswith("stand-in") else
                       f"{unequal[name]} unequal elements against scipy"
                       f"{' FAILS' if unequal[name] else ''}")
            print(f"[variant] {label} {name}: {ms:.4f} ms "
                  f"({' / '.join(f'{t:.4f}' for t in times[name])}; "
                  f"{ms * 1e-3 * clock * 1e6 / T:.1f} cycles a step), {verdict} | {smi}",
                  flush=True)


if __name__ == "__main__":
    main()
