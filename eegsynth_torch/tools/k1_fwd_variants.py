"""Time variants of K1's forward kernel (``csrc/gru_seq.cu``) against each
other on one CUDA card, in turns, at the main paths' shapes.

Each variant is ``gru_seq.cu`` (from this tree, with ``gru_cell.cuh``
inlined, or from the file given with ``--base``) built alone with nvcc into
a library of its own, with a
constant changed or with one part of the step replaced by a cheap stand-in.
The stand-ins give wrong results on purpose: the time they save is what
that part costs the step. Variants that keep the arithmetic are held to
the plain PyTorch recurrence within 1e-4.

    python3 -m eegsynth_torch.tools.k1_fwd_variants [--base OLD_gru_seq.cu]

Prints ptxas's registers and spills of every forward instance, then one
line a shape and variant: the error (or "stand-in"), and the mean over two
passes in opposite order of the median of 15 launches (CUDA events); and
for the ``timers`` variant the cycles a step spends in each phase.
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

import torch

from eegsynth_torch import _build
from eegsynth_torch.nn.gru_sequence import gru_sequence_reference

CSRC = Path(_build.__file__).resolve().parent / "csrc"
# (nb, T, B, H): serving (G/S/R, and the embedder's width), training
# (18 buckets of 63), the H cap, and the wide model's h80 / z40
SHAPES = ((1, 768, 256, 56), (18, 768, 63, 56), (1, 768, 256, 28),
          (1, 1024, 37, 128), (2, 768, 63, 80), (18, 768, 63, 40))
TOL = 1e-4     # as the card tests: f32 sums in another order over <= 1024 steps

# the forward's sigmoid as 1/(1 + expf(-x)), with its correctly rounded division
EXPF_SIGMOID = (("return fmaf(0.5f, tanhf(0.5f * x), 0.5f);",
                 "return 1.0f / (1.0f + expf(-x));"),)
# clock64() around the phases of one step, summed over the steps by thread 0
# of block (0, 0) (lane 0 of j 0: it computes gates); gru_seq_fwd_phases
# returns the cycles of the row groups' sums, reductions and gates, of the
# whole steps, and T
TIMERS = (
    ('#include "tf32_wgmma.cuh"',
     '#include "tf32_wgmma.cuh"\n__device__ long long g_fwd_phase[5];'),
    ("int s, int j, int hj, int H) {\n  constexpr int P = S * (KL + 4);\n  float a[RG][3];",
     "int s, int j, int hj, int H, long long (&ph)[4]) {\n  constexpr int P = S * (KL + 4);"
     "\n  float a[RG][3];\n  const long long c0 = clock64();"),
    ("  int off = 0;\n  reduce_rows<RG, S / 2, RG>(a, s, off);",
     "  const long long c1 = clock64();\n  int off = 0;\n  reduce_rows<RG, S / 2, RG>(a, s, off);"
     "\n  const long long c2 = clock64();"),
    ("        ys_t[r * H + j] = hn;\n      }\n    }\n  }\n}",
     "        ys_t[r * H + j] = hn;\n      }\n    }\n  }\n  const long long c3 = clock64();"
     "\n  ph[0] += c1 - c0;\n  ph[1] += c2 - c1;\n  ph[2] += c3 - c2;\n}"),
    ("s, j, hj, H);", "s, j, hj, H, ph);"),
    ("  for (int t = 0; t < T; ++t) {\n    // the slot",
     "  long long ph[4] = {0, 0, 0, 0};\n  for (int t = 0; t < T; ++t) {\n"
     "    const long long t0 = clock64();\n    // the slot"),
    ("    __syncthreads();             // h' and step t + 1's xp are visible to all\n  }",
     "    __syncthreads();             // h' and step t + 1's xp are visible to all\n"
     "    ph[3] += clock64() - t0;\n  }\n"
     "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {\n"
     "    for (int k = 0; k < 4; ++k) g_fwd_phase[k] = ph[k];\n    g_fwd_phase[4] = T;\n  }"),
    ('extern "C" const char* eegsynth_cuda_error_string',
     'extern "C" int gru_seq_fwd_phases(long long* out) {\n'
     '  return static_cast<int>(cudaMemcpyFromSymbol(out, g_fwd_phase, sizeof(g_fwd_phase)));\n}'
     '\n\nextern "C" const char* eegsynth_cuda_error_string'),
)
CHEAP_GATES = (("fmaf(0.5f, tanhf(0.5f * x), 0.5f)", "0.5f * x"),
               ("tanhf(x[2 * H]", "(0.5f * x[2 * H]"))
NO_SHUFFLES = (("__shfl_xor_sync(0xffffffffu, send, M)", "send"),
               ("__shfl_xor_sync(0xffffffffu, a[0][g], M)", "a[0][g]"))

# name: (source patches (old, new), keeps the arithmetic)
VARIANTS = {
    "this tree": ((), True),
    "ring 8": ((("constexpr int kRing = 16;", "constexpr int kRing = 8;"),), True),
    "expf sigmoid": (EXPF_SIGMOID, True),
    "timers": (TIMERS, True),
    "cheap gates": (CHEAP_GATES, False),
    "no shuffles": (NO_SHUFFLES, False),
}


def _compile(name: str, src: str, out: Path) -> tuple[str, str]:
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-shared", str(cu),
           "-o", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return name, proc.stdout + proc.stderr


def _fwd_label(m: re.Match) -> str:
    return f"KL {m.group(1)}, S {m.group(2)}" + (f", H <= {m.group(3)}" if m.group(3) else "")


def _report(name: str, log: str, kernel: str = r"gru_seq_fwd_kernelILi(\d+)ELi(\d+)E(?:Li(\d+)E)?",
            label=_fwd_label) -> None:
    """Print ptxas's registers and spills of each instance of ``kernel`` (a
    pattern of its mangled name) in ``log``, named ``label(match)``; an
    instance whose label is None is left out."""
    inst = spill = None
    for line in log.splitlines():
        m = re.search(rf"Function properties for \S*{kernel}", line)
        if m:
            inst = label(m)
        elif inst and "spill" in line:
            spill = line.strip()
        elif inst and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"[ptxas] {name}: {inst}: {regs} registers; {spill}", flush=True)
            inst = None


def _clocks() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _time_ms(fn, reps: int = 15) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, help="gru_seq.cu of another tree, timed too")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # the forward's cell code lives in gru_cell.cuh: inline it, so that the
    # patches reach it
    cell = (CSRC / "gru_cell.cuh").read_text().replace("#pragma once\n", "")
    here = (CSRC / "gru_seq.cu").read_text().replace('#include "gru_cell.cuh"', cell)
    jobs = {}
    for name, (patches, exact) in VARIANTS.items():
        src = here
        for old, new in patches:
            if old not in src:
                raise RuntimeError(f"{name}: patch target not found: {old!r}")
            src = src.replace(old, new)
        jobs[name] = (src, exact)
    if args.base:
        jobs = {"base": (args.base.read_text(), True), **jobs}
    with tempfile.TemporaryDirectory(prefix="k1_fwd_variants_") as tmp:
        _run(jobs, Path(tmp), smi)


def _run(jobs: dict, work: Path, smi: str) -> None:
    libs = {}
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = [pool.submit(_compile, name, src, work / f"lib{i}.so")
                   for i, (name, (src, _)) in enumerate(jobs.items())]
        for i, fut in enumerate(futures):
            name, log = fut.result()
            _report(name, log)
            lib = ctypes.CDLL(str(work / f"lib{i}.so"))
            lib.gru_seq_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            lib.gru_seq_fwd.restype = ctypes.c_int
            if hasattr(lib, "gru_seq_fwd_phases"):
                lib.gru_seq_fwd_phases.argtypes = [ctypes.c_void_p]
                lib.gru_seq_fwd_phases.restype = ctypes.c_int
            libs[name] = lib
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(0)
    for nb, T, B, H in SHAPES:
        xp = torch.randn(nb, T, B, 3 * H, generator=g).cuda()
        w = (torch.randn(nb, H, 3 * H, generator=g) / H ** 0.5).cuda()
        b = (0.1 * torch.randn(nb, 1, 3 * H, generator=g)).cuda()
        h0 = (torch.rand(nb, B, H, generator=g) - 0.5).cuda()
        ref = gru_sequence_reference(xp, w, b, h0)
        ys = torch.empty_like(ref)

        def run(lib):
            code = lib.gru_seq_fwd(xp.data_ptr(), w.data_ptr(), b.data_ptr(),
                                   h0.data_ptr(), ys.data_ptr(), nb, T, B, H, stream)
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")

        errs, times = {}, {name: [] for name in libs}
        for name, lib in libs.items():
            ys.fill_(float("nan"))
            run(lib)
            torch.cuda.synchronize()
            errs[name] = (ys - ref).abs().max().item()
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                times[name].append(_time_ms(lambda: run(libs[name])))
        for name, lib in libs.items():
            if hasattr(lib, "gru_seq_fwd_phases"):
                run(lib)
                torch.cuda.synchronize()
                ph = (ctypes.c_longlong * 5)()
                if lib.gru_seq_fwd_phases(ph):
                    raise RuntimeError("gru_seq_fwd_phases failed")
                fma, red, gates, step = (v / ph[4] for v in ph[:4])
                print(f"[phases] nb={nb} T={T} B={B} H={H} {name}: cycles a step, "
                      f"block (0, 0) thread 0: step {step:.0f} = row groups' sums "
                      f"issued {fma:.0f} + reduction {red:.0f} + gates {gates:.0f} + "
                      f"the rest (copies issued, wait, barrier) "
                      f"{step - fma - red - gates:.0f} | {_clocks()}", flush=True)
        for name in libs:
            exact = jobs[name][1]
            ok = errs[name] <= TOL
            verdict = (f"max|diff| {errs[name]:.3e}{'' if ok else ' FAILS'}" if exact
                       else "stand-in")
            print(f"[variant] nb={nb} T={T} B={B} H={H} {name}: "
                  f"{statistics.mean(times[name]):.4f} ms "
                  f"({' / '.join(f'{t:.4f}' for t in times[name])}), {verdict} | {smi}",
                  flush=True)


if __name__ == "__main__":
    main()
