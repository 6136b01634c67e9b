"""Time variants of K1's grid forward (``csrc/gru_seq_grid.cu``), with
``--backward`` of its grid backward (``csrc/gru_seq_grid_bwd.cu``), or with
``--stream`` of its grid forward past H 1024 (``csrc/gru_seq_grid_stream.cu``)
against each other on one CUDA card, in turns, at the shapes past the
clusters' cap (past H 1024 for ``--stream``).

Each variant is the kernel's source (from this tree, or from the file given
with ``--base``) built alone with nvcc into a library of its own, with one
part of the step left out. The stand-ins give wrong results on purpose: the
time they save is what that part costs the step. The tree's own kernel and
``--base`` are held to the plain PyTorch recurrence (or backward) within
1e-4; so is a variant that keeps the arithmetic. Every variant runs on the
plan the wrapper picks (``grid_plan``, ``grid_bwd_plan``,
``grid_stream_plan``) from the card's numbers.

    python3 -m eegsynth_torch.tools.k1_grid_variants [--backward | --stream] [--base OLD.cu]

Prints ptxas's registers and spills of every instance, then one line a
shape and variant: the error (or "stand-in") and the mean over two passes
in opposite order of the median of 10 calls (CUDA events); and the tree's
step-chain probe (the wait, the read of the exchanged operand from L2 and
the publication alone). The backward is timed as the kernel alone, fed hp
and h_prev as the wrapper feeds it, writing dhp to a buffer of its own.
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

from eegsynth_torch.nn.gru_sequence import (
    cluster_card, grid_bwd_plan, grid_plan, grid_stream_plan, gru_sequence_bwd_reference,
    gru_sequence_reference,
)
from eegsynth_torch.tools.k1_fwd_variants import CSRC, _compile, _report, _time_ms

REPS = 10
# (nb, T, B, H): past the cap at chip_smoke.py's cap + 1 shape, the
# sequential trainer's batch at H 1024, [timegan-wide]'s generator batch and
# its CPU check's shape, and chip_smoke.py's two shapes in waves: three
# buckets at a ragged H and eighteen at the cap + 1
SHAPES = ((1, 101, 9, 545), (1, 768, 64, 1024), (1, 768, 16, 1024), (1, 96, 4, 1024),
          (3, 768, 64, 600), (18, 768, 63, 545))
TOL = 1e-4     # as the card tests: f32 sums in another order over <= 1024 steps

COPIES = (("if (cp_part[j] < np) cp_async16(", "if (false) cp_async16("),)


def _products(hi: str, lo: str, keep_hi: bool = False) -> tuple:
    """The patch that drops a kernel's three wgmma a part (or all but
    hi.hi)."""
    lines = (f"            Wgmma<N>::rs(lh[k], f[k][1], {hi} + step);\n"
             f"            Wgmma<N>::rs(hl[k], f[k][0], {lo} + step);\n")
    last = f"            Wgmma<N>::rs(hh[k], f[k][0], {hi} + step);\n"
    return ((lines + last, last if keep_hi else ""),)


# name: (source patches (old, new), keeps the arithmetic)
VARIANTS = {
    "this tree": ((), True),
    "no copies": (COPIES, False),
    "no flags": ((("while (ld_acquire(flags + i) < t + 1) {", "while (false) {"),), False),
    "no products": (_products("dh0", "dl0"), False),
    "hi.hi only": (_products("dh0", "dl0", keep_hi=True), False),
    # one part in flight a warpgroup: each group waited for
    "one part in flight": ((("wgmma_wait<kSets - 1>();", "wgmma_wait<0>();"),), True),
    "no chunk barrier": ((("          __syncthreads();  // chunk ch has landed; the stage "
                           "before it is free", ""),), False),
}
# the grid forward past H 1024: [timegan-wide]'s h1536 and H 2048 at one
# bucket of the sequential trainer's B 64 and T 768, and H 1025 at nb 2
# (two waves of 129 blocks)
STREAM_SHAPES = ((1, 768, 64, 1536), (1, 768, 64, 2048), (2, 151, 37, 1025))
STREAM_PRODUCTS = ("            Wgmma<NB>::rs(acc, f[k][1], dh);\n"
                   "            Wgmma<NB>::rs(acc, f[k][0], dl);\n"
                   "            Wgmma<NB>::rs(acc, f[k][0], dh);\n")
STREAM_N24 = """#pragma unroll
            for (int j = 0; j < J; ++j) {
              float(&a)[12] = *reinterpret_cast<float(*)[12]>(acc + 12 * j);
              const uint64_t dh = desc(wh + off + 4 * kGroupN * j, 16 * NB, 128);
              const uint64_t dl = desc(wl + off + 4 * kGroupN * j, 16 * NB, 128);
              Wgmma<kGroupN>::rs(a, f[k][1], dh);
              Wgmma<kGroupN>::rs(a, f[k][0], dl);
              Wgmma<kGroupN>::rs(a, f[k][0], dh);
            }
"""
STREAM_VARIANTS = {
    "this tree": ((), True),
    # design variants: J wgmma of N 24 a k-slice (not one of N 24 J, the
    # same sums); the tensor cores drained at each chunk's end, a stage
    # refilled one chunk sooner (three chunks in flight, not two); three
    # stages at every J (one chunk in flight where the plan keeps its
    # resident rows)
    "J wgmma of N 24": ((("            const uint64_t dh = desc(wh + off, 16 * NB, 128);\n"
                          "            const uint64_t dl = desc(wl + off, 16 * NB, 128);\n"
                          + STREAM_PRODUCTS, STREAM_N24),), True),
    "drain each chunk": ((("  constexpr int kAhead = S - 2;", "  constexpr int kAhead = S - 1;"),
                          ("            wgmma_wait<1>();  // the part before is done: its "
                           "fragments are free\n          }\n",
                           "            wgmma_wait<1>();\n          }\n"
                           "          wgmma_wait<0>();\n")), True),
    "three stages": ((("return J <= 8 ? 4 : 3;", "return 3;"),), True),
    # stand-ins: what the W stream, the products and the wait cost a step
    "no W copies": ((("          if (ch >= rch) {", "          if (false) {"),), False),
    "no products": (((STREAM_PRODUCTS, ""),), False),
    "no flags": ((("while (ld_acquire(flags + i) < t + 1) {", "while (false) {"),), False),
}
BWD_STORES = (("    dhp[at] = o[0];\n    dhp[at + H] = o[1];\n    dhp[at + 2 * H] = o[2];\n"
               "    dxp[at] = o[0];\n    dxp[at + H] = o[1];\n    dxp[at + 2 * H] = o[3];\n",
               ""),)
BWD_MMA = ("              mma_16n8k8(acc[0], al, bh);\n",
           "              mma_16n8k8(acc[1], ah, bl);\n"
           "              mma_16n8k8(acc[2], ah, bh);\n")
BWD_VARIANTS = {
    "this tree": ((), True),
    "no loads": ((('  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];\\n"\n'
                   '               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p) : '
                   '"memory");',
                   "  v = make_float4(0.f, 0.f, 0.f, 0.f);"),), False),
    "no flags": ((("while (ld_acquire(flags + i) < T - t) {", "while (false) {"),), False),
    "no products": (((BWD_MMA[0] + BWD_MMA[1], ""),), False),
    "no lo.hi": (((BWD_MMA[0], ""),), False),
    "no dhp and dxp stores": (BWD_STORES, False),
    # dhp and dxp stored with the exchange, before the step's publication
    "stores before the flag": ((("              if (m0 != last) store(", "              store("),
                                ("        if (live(last, eu)) store(", "        if (false) store(")),
                               True),
    # parts in flight a lane: two blocks an SM (H up to 576), a block alone
    "4 ahead shared": ((("constexpr int kAheadShared = 2;", "constexpr int kAheadShared = 4;"),),
                       True),
    "12 ahead alone": ((("constexpr int kAheadAlone = 8;", "constexpr int kAheadAlone = 12;"),),
                       True),
}
# the kernel's source, its variants, its shapes, its function names in
# ptxas's report, its entry points and workspace, their pointer arguments
# and the plan's ints after the wave's buckets (the first also the
# workspace's)
HALVES = {
    "forward": ("gru_seq_grid.cu", VARIANTS, SHAPES, r"gru_grid_fwd_kernelILb(\d)E()",
                ("gru_seq_grid_fwd", "gru_seq_grid_chain"), "gru_seq_grid_workspace", 6, ()),
    "backward": ("gru_seq_grid_bwd.cu", BWD_VARIANTS, SHAPES,
                 r"gru_grid_bwd_kernelILb(\d)ELi(\d+)E",
                 ("gru_seq_grid_bwd", "gru_seq_grid_bwd_chain"), "gru_seq_grid_bwd_workspace",
                 10, ()),
    "stream": ("gru_seq_grid_stream.cu", STREAM_VARIANTS, STREAM_SHAPES,
               r"gru_grid_stream_kernelILi(\d+)ELb(\d)E",
               ("gru_seq_grid_stream_fwd", "gru_seq_grid_stream_chain"),
               "gru_seq_grid_stream_workspace", 6, ("groups", "resident_depth")),
}


def _grid_label(m: re.Match) -> str:
    return ("probe" if m.group(1) == "1" else "kernel") + (
        f", {m.group(2)} parts ahead" if m.group(2) else "")


def _stream_label(m: re.Match) -> str:
    return ("probe" if m.group(2) == "1" else "kernel") + f", J {m.group(1)}"


def _load(path: Path, fns: tuple, workspace: str, n_ptr: int, n_extra: int) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in fns:
        getattr(lib, fn).argtypes = [ptr] * n_ptr + [i32] * (6 + n_extra) + [ptr]
        getattr(lib, fn).restype = i32
    getattr(lib, workspace).argtypes = [i32] * (3 + min(n_extra, 1))
    getattr(lib, workspace).restype = ctypes.c_longlong
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    half = ap.add_mutually_exclusive_group()
    half.add_argument("--backward", action="store_true",
                      help="the grid backward (gru_seq_grid_bwd.cu) instead of the forward")
    half.add_argument("--stream", action="store_true",
                      help="the grid forward past H 1024 (gru_seq_grid_stream.cu)")
    ap.add_argument("--base", type=Path, help="the same kernel's source of another tree, "
                                              "timed too")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    mode = "backward" if args.backward else "stream" if args.stream else "forward"
    source, variants = HALVES[mode][:2]
    here = (CSRC / source).read_text()
    jobs = {}
    for name, (patches, exact) in variants.items():
        src = here
        for old, new in patches:
            if old not in src:
                raise RuntimeError(f"{name}: patch target not found: {old!r}")
            src = src.replace(old, new)
        jobs[name] = (src, exact)
    if args.base:
        jobs = {"base": (args.base.read_text(), True), **jobs}
    with tempfile.TemporaryDirectory(prefix="k1_grid_variants_") as tmp:
        _run(jobs, Path(tmp), smi, mode)


def _inputs(nb, T, B, H, g, mode: str):
    """The kernel's arguments on the card (outputs last but the workspace),
    its plain version's results to hold it to, and the plan; the backward's
    dhp is a buffer of its own, so that hp stays intact from one launch to
    the next."""
    xp = torch.randn(nb, T, B, 3 * H, generator=g).cuda()
    w = (torch.randn(nb, H, 3 * H, generator=g) / H ** 0.5).cuda()
    b = (0.1 * torch.randn(nb, 1, 3 * H, generator=g)).cuda()
    h0 = (torch.rand(nb, B, H, generator=g) - 0.5).cuda()
    card = cluster_card()
    if mode != "backward":
        ref = gru_sequence_reference(xp, w, b, h0)
        plan = (grid_stream_plan if mode == "stream" else grid_plan)(nb, B, H, card)
        return (xp, w, b, h0, torch.empty_like(ref)), (ref,), plan
    ys = gru_sequence_reference(xp, w, b, h0)
    d_ys = torch.randn(ys.shape, generator=g).cuda()
    h_prev = torch.cat([h0.unsqueeze(1), ys[:, :T - 1]], dim=1).reshape(nb, T * B, H)
    hp = torch.matmul(h_prev, w)
    ref = gru_sequence_bwd_reference(xp, w, b, h0, ys, d_ys)
    outs = (torch.empty_like(xp), torch.empty_like(hp), torch.empty_like(h0))
    return ((xp, hp, h_prev, d_ys, w, b, *outs), (ref[0], ref[3]),
            grid_bwd_plan(nb, B, H, card))


def _run(jobs: dict, work: Path, smi: str, mode: str) -> None:
    _, _, shapes, kernel, fns, workspace, n_ptr, keys = HALVES[mode]
    libs = {}
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = [pool.submit(_compile, name, src, work / f"lib{i}.so")
                   for i, (name, (src, _)) in enumerate(jobs.items())]
        for i, fut in enumerate(futures):
            name, log = fut.result()
            _report(name, log, kernel, _stream_label if mode == "stream" else _grid_label)
            libs[name] = _load(work / f"lib{i}.so", fns, workspace, n_ptr, len(keys))
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(0)
    for nb, T, B, H in shapes:
        tensors, refs, plan = _inputs(nb, T, B, H, g, mode)
        extra = tuple(plan[k] for k in keys)
        # the kernel's outputs held to the plain version: ys; or dxp and dh0
        outs = tensors[-1:] if mode != "backward" else (tensors[6], tensors[8])

        def run(lib, fn=fns[0]):
            ws = torch.zeros(getattr(lib, workspace)(nb, B, H, *extra[:1]), dtype=torch.int32,
                             device="cuda")
            per_wave = plan["buckets_per_wave"]
            for first in range(0, nb, per_wave):
                code = getattr(lib, fn)(*(t.data_ptr() for t in tensors), ws.data_ptr(), nb,
                                        T, B, H, first, min(per_wave, nb - first), *extra,
                                        stream)
                if code:
                    raise RuntimeError(f"{fn} failed: CUDA error {code}")

        errs, times = {}, {name: [] for name in libs}
        for name, lib in libs.items():
            for out in outs:
                out.fill_(float("nan"))
            run(lib)
            torch.cuda.synchronize()
            errs[name] = max((o - r).abs().max().item() for o, r in zip(outs, refs))
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                times[name].append(_time_ms(lambda: run(libs[name]), REPS))
        floor = _time_ms(lambda: run(libs["this tree"], fns[1]), REPS)
        label = f"nb={nb} T={T} B={B} H={H}"
        groups = f" of {plan['U']} units ({plan['streamed_depth']} of the depth streamed)" \
            if mode == "stream" else ""
        print(f"[plan] {label}: {plan['blocks']} blocks{groups}, {plan['buckets_per_wave']} "
              f"bucket(s) a wave, {plan['waves']} wave(s); the tree's step-chain probe "
              f"{floor:.4f} ms | {smi}", flush=True)
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
