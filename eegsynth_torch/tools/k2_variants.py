"""Time variants of K2 (``csrc/multigru.cu``, the D-step inputs of every
stacked bucket in one launch) against each other and against the composed
route on one CUDA card, in turns, at the training shape of each
``adaptive_dims`` width the checks use.

Each variant is ``multigru.cu`` (from this tree, or from the file given with
``--base``) built alone with nvcc into a library of its own, with a
constant changed (the xp rings' depth; the depth of the rings through
which the generator's projection reaches the supervisor and the
supervisor's state reaches the embedder, which bounds how far each block
runs ahead of the next) or with ``clock64()`` timers put in, or with one part of a step left out: the
stand-ins give wrong results on purpose, and the time they save is what
that part costs. The variants that keep the arithmetic are held to the
plain PyTorch version within 1e-4. A library that does not take a width
(an older tree's kernel past its shared memory) is reported as such.

The composed route is what ``fused_disc_inputs`` ran before K2 took every
width: ``encode(params, x)`` and ``refine_latent(params, gen_latent(params,
z))``, three K1 forward launches with the projections as products. It is
timed in the same turns, and one call of it is split by ``torch.profiler``
into K1's device time and the rest.

    python3 -m eegsynth_torch.tools.k2_variants [--base OLD_multigru.cu]
        [--variants "this tree,timers"] [--shapes 0,2] [--compile-only]

Prints ptxas's registers and spills of every K2 instance; then, a shape and
variant a line, the error and the mean over two passes in opposite order of
the median of 10 launches (CUDA events) of the kernel alone (its inputs
made beforehand), the composed route and K2's whole route as
``fused_disc_inputs`` runs it (the input products, the kernel of this tree's
build, the transposes); the tile each library chose where it reports one;
for the ``timers`` variant the cycles a step spends in each role.
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
from eegsynth_torch.models import timegan as ttg
from eegsynth_torch.nn.multigru import multigru_disc_inputs_reference

CSRC = Path(_build.__file__).resolve().parent / "csrc"
# (nb, T, B, channels): 14 channels at T 768 (z28/h56) and at T 1024
# (z36/h72), 20 channels (z40/h80), 28 channels at T 1024 (z64/h128, the
# widest adaptive_dims width)
SHAPES = ((18, 768, 63, 14), (18, 1024, 63, 14), (18, 768, 63, 20), (18, 1024, 63, 28))
TOL = 1e-4     # as the card tests: f32 sums in another order over <= 1024 steps
REPS = 10

# clock64() per role, summed over the steps by thread 0 of each role's
# first block; multigru_fwd_phases returns, per role (E, G, S), the cycles
# of the whole steps, of the waits on the other block, of the row groups
# and the steps counted
TIMERS = (
    ("constexpr bool kTimers = false;", "constexpr bool kTimers = true;"),
)
# Stand-ins: S without s_in = e W_is (its cell fed with b_is alone); G and E
# without their projections
NO_S_INPUT = (("  for (int q = 0; q < klz / 4; ++q) {", "  for (int q = 0; q < 0 * klz; ++q) {"),)
NO_PROJECTIONS = (("    if (v >= 0 && proj_warp) {", "    if (false) {"),)
# S's e W_is sums two float4s at a time (it spilled at KL 16 and 32)
E_UNROLLED_2 = (("#pragma unroll 1\n  for (int q = 0; q < klz / 4; ++q) {",
                 "#pragma unroll 2\n  for (int q = 0; q < klz / 4; ++q) {"),)
# Compile-only stand-ins: the kernel without one role's code, to find
# which role's registers the instances' budgets are spent on
WITHOUT_G = (("  if (rank == kRankG) {\n    g_block<KL, S>(", "  if (false) {\n    g_block<KL, S>("),)
WITHOUT_S = (("  } else if (rank == kRankS) {\n    s_block<KL, S>(",
              "  } else if (false) {\n    s_block<KL, S>("),)
WITHOUT_E = (("  } else {\n    e_block<KL, S>(", "  } else if (false) {\n    e_block<KL, S>("),)
VARIANTS = {
    "this tree": ((), True),
    "xp ring 4": ((("constexpr int kXRing = 2;", "constexpr int kXRing = 4;"),), True),
    "e ring 2": ((("constexpr int kERing = 4;", "constexpr int kERing = 2;"),), True),
    "e ring 8": ((("constexpr int kERing = 4;", "constexpr int kERing = 8;"),), True),
    "timers": (TIMERS, True),
    "no s_in": (NO_S_INPUT, False),
    "no projections": (NO_PROJECTIONS, False),
    "e unrolled 2": (E_UNROLLED_2, True),
    "without G": (WITHOUT_G, False),
    "without S": (WITHOUT_S, False),
    "without E": (WITHOUT_E, False),
    "only G": (WITHOUT_S + WITHOUT_E, False),
    "only E": (WITHOUT_G + WITHOUT_S, False),
}
ROLES = ("E", "G", "S")


def _compile(name: str, src: str, out: Path) -> tuple[str, str]:
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-shared", str(cu),
           "-o", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return name, proc.stdout + proc.stderr


def _report(name: str, log: str) -> None:
    inst, spill = None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*multigru_fwd_kernel(\S*)", line)
        if m:
            inst = m.group(1) or "(one instance)"
        elif inst and "spill" in line:
            spill = line.strip()
        elif inst and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"[ptxas] {name}: multigru_fwd_kernel{inst}: {regs} registers; {spill}",
                  flush=True)
            inst = None


def _clocks() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _time_ms(fn, reps: int = REPS) -> float:
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


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.multigru_fwd.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.multigru_fwd.restype = ctypes.c_int
    if hasattr(lib, "multigru_fwd_tile"):
        lib.multigru_fwd_tile.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.multigru_fwd_tile.restype = ctypes.c_int
    if hasattr(lib, "multigru_fwd_phases"):
        lib.multigru_fwd_phases.argtypes = [ctypes.c_void_p]
        lib.multigru_fwd_phases.restype = ctypes.c_int
    return lib


def _composed_split(params, x, z) -> tuple[float, float]:
    """Device time of one composed call (ms): K1's launches and all of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            ttg.encode(params, x), ttg.refine_latent(params, ttg.gen_latent(params, z))
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    total = sum(e.self_device_time_total for e in on_card) / 1e3
    k1 = sum(e.self_device_time_total for e in on_card
             if "gru_seq_fwd_kernel" in e.key) / 1e3
    return k1, total


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, help="multigru.cu of another tree, timed too")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of this tree's variants to build")
    ap.add_argument("--shapes", default=",".join(map(str, range(len(SHAPES)))),
                    help="comma-separated indices into SHAPES")
    ap.add_argument("--compile-only", action="store_true",
                    help="build the variants and print ptxas's report only")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    here = (CSRC / "multigru.cu").read_text()
    jobs = {}
    for name in args.variants.split(","):
        patches, exact = VARIANTS[name]
        src = here
        for old, new in patches:
            if old not in src:
                raise RuntimeError(f"{name}: patch target not found: {old!r}")
            src = src.replace(old, new)
        jobs[name] = (src, exact)
    if args.base:
        jobs = {"base": (args.base.read_text(), True), **jobs}
    shapes = [SHAPES[int(i)] for i in args.shapes.split(",")]
    with tempfile.TemporaryDirectory(prefix="k2_variants_") as tmp:
        _run(jobs, Path(tmp), [] if args.compile_only else shapes, smi)


def _run(jobs: dict, work: Path, shapes, smi: str) -> None:
    libs = {}
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = [pool.submit(_compile, name, src, work / f"lib{i}.so")
                   for i, (name, (src, _)) in enumerate(jobs.items())]
        for i, fut in enumerate(futures):
            name, log = fut.result()
            _report(name, log)
            libs[name] = _load(work / f"lib{i}.so")
    stream = torch.cuda.current_stream().cuda_stream
    for nb, T, B, C in shapes:
        z_dim, h_dim = ttg.adaptive_dims(C, T)
        cfg = ttg.TimeGANConfig(x_dim=C, z_dim=z_dim, h_dim=h_dim)
        params = ttg.timegan_init_stacked(
            cfg, [torch.Generator().manual_seed(b) for b in range(nb)], device="cuda")
        g = torch.Generator().manual_seed(nb + T)
        x = torch.rand((nb, B, T, C), generator=g).cuda()
        z = torch.rand((nb, B, T, z_dim), generator=g).cuda()
        k2_args = ttg.k2_inputs(params, x, z)
        dims = (k2_args[2].shape[1], k2_args[4].shape[1], k2_args[10].shape[1],
                k2_args[6].shape[2])
        with torch.no_grad():
            ref = multigru_disc_inputs_reference(*k2_args)
        h_real, h_fake = torch.empty_like(ref[0]), torch.empty_like(ref[1])
        ptrs = [a.data_ptr() for a in (*k2_args, h_real, h_fake)]
        tag = f"nb={nb} T={T} B={B} z{z_dim}/h{h_dim}"

        def run(lib):
            return lib.multigru_fwd(*ptrs, nb, T, B, *dims, stream)

        errs, takes = {}, {}
        for name, lib in libs.items():
            h_real.fill_(float("nan"))
            h_fake.fill_(float("nan"))
            code = run(lib)
            torch.cuda.synchronize()
            takes[name] = code == 0
            errs[name] = max((h_real - ref[0]).abs().max().item(),
                             (h_fake - ref[1]).abs().max().item()) if code == 0 else None
            if code:
                print(f"[variant] {tag} {name}: does not take this width (CUDA error "
                      f"{code})", flush=True)
        entries = {name: (lambda lib=lib: run(lib)) for name, lib in libs.items()
                   if takes[name]}
        with torch.no_grad():
            entries["composed route"] = lambda: (
                ttg.encode(params, x), ttg.refine_latent(params, ttg.gen_latent(params, z)))
            if ttg._takes_k2(params):
                entries["K2 route (this build)"] = lambda: ttg._k2_disc_inputs(params, x, z)
            times = {name: [] for name in entries}
            for order in (list(entries), list(entries)[::-1]):
                for name in order:
                    times[name].append(_time_ms(entries[name]))
        for name in entries:
            if name in libs and jobs[name][1]:
                ok = errs[name] <= TOL
                verdict = f"max|diff| {errs[name]:.3e}{'' if ok else ' FAILS'}"
            elif name in libs:
                verdict = "stand-in"
            else:
                verdict = "its own arithmetic"
            print(f"[variant] {tag} {name}: {statistics.mean(times[name]):.4f} ms "
                  f"({' / '.join(f'{t:.4f}' for t in times[name])}), {verdict} | {smi}",
                  flush=True)
        k1, total = _composed_split(params, x, z)
        print(f"[composed] {tag}: device time of one call {total:.4f} ms = 3 K1 forward "
              f"launches {k1:.4f} + products and the rest {total - k1:.4f} | {smi}",
              flush=True)
        for name, lib in libs.items():
            if takes[name] and hasattr(lib, "multigru_fwd_tile"):
                out = (ctypes.c_int * 9)()
                if lib.multigru_fwd_tile(nb, B, *dims, out) == 0:
                    print(f"[tile] {tag} {name}: " + ", ".join(
                        f"{k} {v}" for k, v in zip(
                            ("rows", "tiles", "threads", "smem", "clusters",
                             "resident clusters", "KL", "S", "KLZ"), out)), flush=True)
            if takes[name] and hasattr(lib, "multigru_fwd_phases"):
                run(lib)
                torch.cuda.synchronize()
                ph = (ctypes.c_longlong * 12)()
                if lib.multigru_fwd_phases(ph):
                    raise RuntimeError("multigru_fwd_phases failed")
                if not any(ph):
                    continue
                parts = []
                for r, role in enumerate(ROLES):
                    step, wait, groups, n = ph[4 * r:4 * r + 4]
                    if n:
                        parts.append(f"{role} step {step / n:.0f} = wait {wait / n:.0f} + "
                                     f"row groups {groups / n:.0f} + the rest "
                                     f"{(step - wait - groups) / n:.0f}")
                print(f"[phases] {tag} {name}: cycles a step, thread 0 of each role's "
                      f"first block: " + "; ".join(parts) + f" | {_clocks()}", flush=True)


if __name__ == "__main__":
    main()
