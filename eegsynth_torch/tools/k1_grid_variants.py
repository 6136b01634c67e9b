"""Time variants of K1's grid forward (``csrc/gru_seq_grid.cu``) against each
other on one CUDA card, in turns, at the shapes past the clusters' cap.

Each variant is ``gru_seq_grid.cu`` (from this tree, or from the file given
with ``--base``) built alone with nvcc into a library of its own, with one
part of the step left out. The stand-ins give wrong results on purpose: the
time they save is what that part costs the step. The tree's own kernel and
``--base`` are held to the plain PyTorch recurrence within 1e-4. Every
variant runs on the plan the wrapper picks (``grid_plan``) from the card's
numbers.

    python3 -m eegsynth_torch.tools.k1_grid_variants [--base OLD_gru_seq_grid.cu]

Prints ptxas's registers and spills of every instance, then one line a
shape and variant: the error (or "stand-in") and the mean over two passes
in opposite order of the median of 10 calls (CUDA events); and the tree's
step-chain probe (the wait, the read of h from L2 and the publication
alone).
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

from eegsynth_torch.nn.gru_sequence import cluster_card, grid_plan, gru_sequence_reference
from eegsynth_torch.tools.k1_fwd_variants import CSRC, _compile, _time_ms

REPS = 10
# (nb, T, B, H): past the cap at chip_smoke.py's cap + 1 shape, the
# sequential trainer's batch at H 1024, [timegan-wide]'s generator batch and
# its CPU check's shape, and three buckets at a ragged H
SHAPES = ((1, 101, 9, 545), (1, 768, 64, 1024), (1, 768, 16, 1024), (1, 96, 4, 1024),
          (3, 768, 64, 600))
TOL = 1e-4     # as the card tests: f32 sums in another order over <= 1024 steps

COPIES = (("if (cp_part[j] < np) cp_async16(", "if (false) cp_async16("),)
FLAGS = (("while (ld_acquire(flags + i) < t + 1) {", "while (false) {"),)
PRODUCTS = (("            Wgmma<N>::rs(lh[k], f[k][1], dh0 + step);\n"
             "            Wgmma<N>::rs(hl[k], f[k][0], dl0 + step);\n"
             "            Wgmma<N>::rs(hh[k], f[k][0], dh0 + step);\n", ""),)
HI_ONLY = (("            Wgmma<N>::rs(lh[k], f[k][1], dh0 + step);\n"
            "            Wgmma<N>::rs(hl[k], f[k][0], dl0 + step);\n", ""),)
# one part in flight a warpgroup: each group waited for before the next
ONE_IN_FLIGHT = (("wgmma_wait<kSets - 1>();", "wgmma_wait<0>();"),)
BARRIER = (("          __syncthreads();  // chunk ch has landed; the stage before it is free",
            ""),)

# name: (source patches (old, new), keeps the arithmetic)
VARIANTS = {
    "this tree": ((), True),
    "no copies": (COPIES, False),
    "no flags": (FLAGS, False),
    "no products": (PRODUCTS, False),
    "hi.hi only": (HI_ONLY, False),
    "one part in flight": (ONE_IN_FLIGHT, True),
    "no chunk barrier": (BARRIER, False),
}


def _report(name: str, log: str) -> None:
    inst = spill = None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*gru_grid_fwd_kernelILb(\d)E", line)
        if m:
            inst = "probe" if m.group(1) == "1" else "forward"
        elif inst and "spill" in line:
            spill = line.strip()
        elif inst and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"[ptxas] {name}: {inst}: {regs} registers; {spill}", flush=True)
            inst = None


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in ("gru_seq_grid_fwd", "gru_seq_grid_chain"):
        getattr(lib, fn).argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        getattr(lib, fn).restype = i32
    lib.gru_seq_grid_workspace.argtypes = [i32] * 3
    lib.gru_seq_grid_workspace.restype = ctypes.c_longlong
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, help="gru_seq_grid.cu of another tree, timed too")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    here = (CSRC / "gru_seq_grid.cu").read_text()
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
    with tempfile.TemporaryDirectory(prefix="k1_grid_variants_") as tmp:
        _run(jobs, Path(tmp), smi)


def _run(jobs: dict, work: Path, smi: str) -> None:
    libs = {}
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = [pool.submit(_compile, name, src, work / f"lib{i}.so")
                   for i, (name, (src, _)) in enumerate(jobs.items())]
        for i, fut in enumerate(futures):
            name, log = fut.result()
            _report(name, log)
            libs[name] = _load(work / f"lib{i}.so")
    stream = torch.cuda.current_stream().cuda_stream
    card = cluster_card()
    g = torch.Generator().manual_seed(0)
    for nb, T, B, H in SHAPES:
        xp = torch.randn(nb, T, B, 3 * H, generator=g).cuda()
        w = (torch.randn(nb, H, 3 * H, generator=g) / H ** 0.5).cuda()
        b = (0.1 * torch.randn(nb, 1, 3 * H, generator=g)).cuda()
        h0 = (torch.rand(nb, B, H, generator=g) - 0.5).cuda()
        ref = gru_sequence_reference(xp, w, b, h0)
        ys = torch.empty_like(ref)
        plan = grid_plan(nb, B, H, card)

        def run(lib, fn="gru_seq_grid_fwd"):
            ws = torch.zeros(lib.gru_seq_grid_workspace(nb, B, H),
                             dtype=torch.int32, device="cuda")
            per_wave = plan["buckets_per_wave"]
            for first in range(0, nb, per_wave):
                code = getattr(lib, fn)(xp.data_ptr(), w.data_ptr(), b.data_ptr(),
                                        h0.data_ptr(), ys.data_ptr(), ws.data_ptr(), nb, T,
                                        B, H, first, min(per_wave, nb - first), stream)
                if code:
                    raise RuntimeError(f"{fn} failed: CUDA error {code}")

        errs, times = {}, {name: [] for name in libs}
        for name, lib in libs.items():
            ys.fill_(float("nan"))
            run(lib)
            torch.cuda.synchronize()
            errs[name] = (ys - ref).abs().max().item()
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                times[name].append(_time_ms(lambda: run(libs[name]), REPS))
        floor = _time_ms(lambda: run(libs["this tree"], "gru_seq_grid_chain"), REPS)
        label = f"nb={nb} T={T} B={B} H={H}"
        print(f"[plan] {label}: {plan['blocks']} blocks, {plan['buckets_per_wave']} "
              f"bucket(s) a wave, {plan['waves']} wave(s); the tree's step-chain probe {floor:.4f} ms | {smi}",
              flush=True)
        for name in libs:
            exact = jobs[name][1]
            ok = errs[name] <= TOL
            verdict = (f"max|diff| {errs[name]:.3e}{'' if ok else ' FAILS'}" if exact
                       else "stand-in")
            print(f"[variant] {label} {name}: {statistics.mean(times[name]):.4f} ms "
                  f"({' / '.join(f'{t:.4f}' for t in times[name])}), {verdict} | {smi}",
                  flush=True)


if __name__ == "__main__":
    main()
