"""Time variants of K1's backward (``csrc/gru_seq.cu`` ``gru_seq_bwd``)
against each other on one CUDA card, in turns, at the training shapes, and
beside cuDNN's GRU backward at one bucket.

Each variant is ``gru_seq.cu`` (from this tree, or from the file given with
``--base``) built alone with nvcc into a library of its own, with a
constant changed or with one part of the step replaced by a cheap stand-in.
The stand-ins give wrong results on purpose: the time they save is what
that part costs the step. Variants that keep the arithmetic are held to
the plain PyTorch backward within 1e-4 (dxp and dh0 absolute, dW and db
relative to their largest magnitude).

Two kernel interfaces are known, so that an older tree's kernel can be
timed beside this one's: the recurrence with the gates recomputed inside
the kernel (``gru_seq_bwd(xp, w_hh_t, b_hh, h0, ys, d_ys, dxp, dhn, dh0,
...)``; the wrapper then concatenates dhp and h_prev for the dW product),
and the recurrence fed with hp = h_prev W_hhᵀ + b_hh computed before it
(``gru_seq_bwd(xp, hp, h_prev, d_ys, w_hh_t, dxp, dhp, dh0, ...)``).

    python3 -m eegsynth_torch.tools.k1_bwd_variants [--base OLD_gru_seq.cu]
        [--variants "this tree,ring 4,..."]

Prints ptxas's registers and spills of every backward instance; then, a
shape and variant a line, the errors and the mean over two passes in
opposite order of the median of 10 runs (CUDA events) of the kernel alone,
of the whole backward as the wrapper runs it, and of the wrapper's other
parts; for the ``timers`` variant the cycles a step spends in each phase;
and at one bucket, cuDNN's GRU backward timed in turns with each variant's
whole backward.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import statistics
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from eegsynth_torch import _build
from eegsynth_torch.nn.gru_sequence import (
    DW_CHUNKS, gru_sequence_bwd_reference, gru_sequence_reference, weight_grads,
)

CSRC = Path(_build.__file__).resolve().parent / "csrc"
# (nb, T, B, H): the training shapes of chip_smoke.py's BWD_SHAPES (the
# G/S/R width, the embedder's H 28, a ragged batch at the H cap), and one
# bucket of the first, where cuDNN's GRU computes the same function
SHAPES = ((18, 768, 63, 56), (18, 768, 63, 28), (3, 1024, 37, 128), (1, 768, 63, 56))
TOL = 1e-4     # as the card tests: f32 sums in another order over <= 1024 steps
REPS = 10

# The backward's coefficients with the sigmoid as 1/(1 + expf(-x)), its
# correctly rounded division included
EXPF_SIGMOID = (("  const float r = sigmoid_fwd(x[0] + hp_r);\n"
                 "  const float z = sigmoid_fwd(x[H] + hp_z);",
                 "  const float r = 1.0f / (1.0f + expf(-(x[0] + hp_r)));\n"
                 "  const float z = 1.0f / (1.0f + expf(-(x[H] + hp_z)));"),)
# Stand-in: the coefficients without their transcendentals
NO_GATES = (("  const float r = sigmoid_fwd(x[0] + hp_r);\n"
             "  const float z = sigmoid_fwd(x[H] + hp_z);\n"
             "  const float n = tanhf(x[2 * H] + r * hp_n);",
             "  const float r = 0.5f * (x[0] + hp_r);\n"
             "  const float z = 0.5f * (x[H] + hp_z);\n"
             "  const float n = 0.5f * (x[2 * H] + r * hp_n);"),)
# Stand-in: each row's sums read gate r's slice of dhp for all three gates,
# a third of the shared-memory loads
ONE_GATE_LOADS = (("reinterpret_cast<const float4*>(gv + g * P)[q]",
                   "reinterpret_cast<const float4*>(gv)[q]"),)
# KL 16 with the coefficients in a stage of their own before the row groups,
# as KL 32 and 64
SEPARATE_STAGE = (("  constexpr bool kInGroup = KL == 16 && S > 1;",
                   "  constexpr bool kInGroup = false;"),)
RING_4 = (("constexpr int kBwdRing = 8;", "constexpr int kBwdRing = 4;"),)
# clock64() around the phases of one step, summed over the steps by thread 0
# of block (0, 0) (lane 0 of j 0: it owns rows); gru_seq_bwd_phases returns
# the cycles of the copies' issue, the coefficient stage of its own (KL 32
# and 64), the row groups' loads, coefficients (KL 16) and sums, their
# reductions, the owners' updates, the whole steps, and the step count
TIMERS = (
    ('#include "tf32_wgmma.cuh"',
     '#include "tf32_wgmma.cuh"\n__device__ long long g_bwd_phase[7];'),
    ("int s, int j, int hj, int H, int t) {\n  constexpr int P = S * (KL + 4);",
     "int s, int j, int hj, int H, int t, long long (&ph)[6]) {\n"
     "  const long long c0 = clock64();\n  constexpr int P = S * (KL + 4);"),
    ("  int off = 0;  // equals first\n  reduce_rows<RG, S / 2, RG>(a, s, off);",
     "  const long long c1 = clock64();\n  int off = 0;  // equals first\n"
     "  reduce_rows<RG, S / 2, RG>(a, s, off);\n  const long long c2 = clock64();"),
    ("        st_s[r * H + j] = fmaf(dh, co[i][4], dy[i]);\n      }\n    }\n  }\n}",
     "        st_s[r * H + j] = fmaf(dh, co[i][4], dy[i]);\n      }\n    }\n  }\n"
     "  const long long c3 = clock64();\n  ph[2] += c1 - c0;\n  ph[3] += c2 - c1;\n"
     "  ph[4] += c3 - c2;\n}"),
    ("s, j, hj, H, t);", "s, j, hj, H, t, ph);"),
    ("  for (int t = T; t >= 0; --t) {\n",
     "  long long ph[6] = {0, 0, 0, 0, 0, 0};\n  for (int t = T; t >= 0; --t) {\n"
     "    const long long t0 = clock64();\n"),
    ("    if (t - kBwdRing - 1 >= 0) fetch(t - kBwdRing - 1);\n    cp_async_commit();\n",
     "    if (t - kBwdRing - 1 >= 0) fetch(t - kBwdRing - 1);\n    cp_async_commit();\n"
     "    const long long t1 = clock64();\n    ph[0] += t1 - t0;\n"),
    ("    // the step's row groups\n",
     "    ph[1] += clock64() - t1;\n    // the step's row groups\n"),
    ("    __syncthreads();  // dhp of step t - 1, its coefficients and step t - 3's inputs\n  }",
     "    __syncthreads();  // dhp of step t - 1, its coefficients and step t - 3's inputs\n"
     "    ph[5] += clock64() - t0;\n  }\n"
     "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {\n"
     "    for (int k = 0; k < 6; ++k) g_bwd_phase[k] = ph[k];\n    g_bwd_phase[6] = T + 1;\n  }"),
    ('extern "C" const char* eegsynth_cuda_error_string',
     'extern "C" int gru_seq_bwd_phases(long long* out) {\n'
     '  return static_cast<int>(cudaMemcpyFromSymbol(out, g_bwd_phase, sizeof(g_bwd_phase)));\n}'
     '\n\nextern "C" const char* eegsynth_cuda_error_string'),
)

# name: (source patches (old, new), keeps the arithmetic)
VARIANTS = {
    "this tree": ((), True),
    "ring 4": (RING_4, True),
    "expf sigmoid": (EXPF_SIGMOID, True),
    "separate stage": (SEPARATE_STAGE, True),
    "timers": (TIMERS, True),
    "no gates": (NO_GATES, False),
    "one gate's loads": (ONE_GATE_LOADS, False),
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


def _report(name: str, log: str) -> None:
    inst = spill = None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*gru_seq_bwd_kernel"
                      r"(?:ILi(\d+)ELi(\d+)ELi(\d+)E)?", line)
        if m:
            inst = (f"KL {m.group(1)}, S {m.group(2)}, H <= {m.group(3)}"
                    if m.group(1) else "one thread a (row, j)")
        elif inst and "spill" in line:
            spill = line.strip()
        elif inst and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"[ptxas] {name}: gru_seq_bwd_kernel {inst}: {regs} registers; {spill}",
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


def _check(code: int) -> None:
    if code:
        raise RuntimeError(f"launch failed: CUDA error {code}")


def _recompute_calls(lib, xp, w, b, h0, ys, dy, stream):
    """The kernel that recomputes the gates, and its wrapper's parts."""
    nb, T, B, G = xp.shape
    H = G // 3
    dxp, dhn, dh0 = torch.empty_like(xp), torch.empty_like(ys), torch.empty_like(h0)

    def kernel():
        _check(lib.gru_seq_bwd(xp.data_ptr(), w.data_ptr(), b.data_ptr(), h0.data_ptr(),
                               ys.data_ptr(), dy.data_ptr(), dxp.data_ptr(),
                               dhn.data_ptr(), dh0.data_ptr(), nb, T, B, H, stream))

    def cats():
        dhp = torch.cat([dxp[..., :2 * H], dhn], dim=-1).reshape(nb, T * B, G)
        h_prev = torch.cat([h0.unsqueeze(1), ys[:, :-1]], dim=1).reshape(nb, T * B, H)
        return dhp, h_prev

    def whole():
        kernel()
        dhp, h_prev = cats()
        return dxp, torch.matmul(h_prev.transpose(1, 2), dhp), dhp.sum(1, keepdim=True), dh0

    kernel()
    dhp, h_prev = cats()
    parts = {"two cats": cats,
             "dW + db": lambda: (torch.matmul(h_prev.transpose(1, 2), dhp),
                                 dhp.sum(1, keepdim=True))}
    return kernel, whole, parts


def _hoisted_calls(lib, xp, w, b, h0, ys, dy, stream):
    """The kernel fed with the hoisted hp = h_prev W_hhᵀ (the kernel adds
    b_hh), and its wrapper's parts. The kernel alone writes dhp to a buffer
    of its own, so hp stays intact from one timed launch to the next; the
    whole call overwrites hp with dhp, as the wrapper does. dW's T·B-deep sum
    is timed as the wrapper splits it (``weight_grads``), as one product,
    and in 64 chunks."""
    nb, T, B, G = xp.shape
    H = G // 3
    dxp, dh0 = torch.empty_like(xp), torch.empty_like(h0)

    def product():
        h_prev = torch.cat([h0.unsqueeze(1), ys[:, :T - 1]], dim=1).reshape(nb, T * B, H)
        return h_prev, torch.matmul(h_prev, w)

    def launch(hp, h_prev, dhp):
        _check(lib.gru_seq_bwd(xp.data_ptr(), hp.data_ptr(), h_prev.data_ptr(),
                               dy.data_ptr(), w.data_ptr(), b.data_ptr(), dxp.data_ptr(),
                               dhp.data_ptr(), dh0.data_ptr(), nb, T, B, H, stream))

    def whole():
        h_prev, work = product()
        launch(work, h_prev, work)
        return (dxp, *weight_grads(h_prev, work), dh0)

    h_prev, hp = product()
    dhp = torch.empty_like(hp)
    launch(hp, h_prev, dhp)
    c = math.gcd(T * B, 64)
    parts = {"h_prev + hp product": product,
             f"dW ({DW_CHUNKS} chunks) + db": lambda: weight_grads(h_prev, dhp),
             "dW in one product + db": lambda: (torch.matmul(h_prev.transpose(1, 2), dhp),
                                                dhp.sum(1, keepdim=True)),
             f"dW in {c} chunks + db": lambda: (
                 torch.matmul(h_prev.view(nb, c, -1, H).transpose(2, 3),
                              dhp.view(nb, c, -1, G)).sum(1),
                 dhp.sum(1, keepdim=True))}
    return (lambda: launch(hp, h_prev, dhp)), whole, parts


def _cudnn_bwd(xp, w, b, h0, dy):
    """cuDNN's GRU (nn.GRU, input weight I₃ₕ, zero input bias, so its input
    is xp) at one bucket: one autograd.grad call on xp, W_hh, b_hh and h0.
    cuDNN's backward also forms the input weight's gradient (a 3H x 3H
    product over T·B rows) that K1's backward has no need of."""
    H = h0.shape[-1]
    gru = torch.nn.GRU(3 * H, H).to(xp.device)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.eye(3 * H))
        gru.bias_ih_l0.zero_()
        gru.weight_hh_l0.copy_(w[0].t())
        gru.bias_hh_l0.copy_(b.reshape(-1))
    gru.flatten_parameters()
    x = xp[0].detach().requires_grad_()
    h = h0[0][None].detach().requires_grad_()
    out = gru(x, h)[0]
    leaves = [x, gru.weight_hh_l0, gru.bias_hh_l0, h]

    def backward():
        return torch.autograd.grad(out, leaves, dy[0], retain_graph=True)

    def as_k1(g):   # (dxp, dw_hh_t, db_hh, dh0) with K1's stacked layouts
        return g[0][None], g[1].t()[None], g[2].reshape(1, 1, -1), g[3]

    return backward, as_k1


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, help="gru_seq.cu of another tree, timed too")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of this tree's variants to time")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    here = (CSRC / "gru_seq.cu").read_text()
    jobs = {}
    for name in filter(None, args.variants.split(",")):
        patches, exact = VARIANTS[name]
        src = here
        for old, new in patches:
            if old not in src:
                raise RuntimeError(f"{name}: patch target not found: {old!r}")
            src = src.replace(old, new)
        jobs[name] = (src, exact)
    if args.base:
        jobs = {"base": (args.base.read_text(), True), **jobs}
    with tempfile.TemporaryDirectory(prefix="k1_bwd_variants_") as tmp:
        _run(jobs, Path(tmp), smi)


def _load(path: Path, src: str):
    lib = ctypes.CDLL(str(path))
    recompute = "float* __restrict__ dhn" in src
    lib.gru_seq_bwd.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.gru_seq_bwd.restype = ctypes.c_int
    if hasattr(lib, "gru_seq_bwd_phases"):
        lib.gru_seq_bwd_phases.argtypes = [ctypes.c_void_p]
        lib.gru_seq_bwd_phases.restype = ctypes.c_int
    return lib, (_recompute_calls if recompute else _hoisted_calls)


def _errors(got, ref) -> tuple[list[float], bool]:
    errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
    scale = [max(1.0, r.abs().max().item()) for r in ref]
    ok = (all(bool(torch.isfinite(g).all()) for g in got) and errs[0] <= TOL
          and errs[3] <= TOL and errs[1] <= TOL * scale[1] and errs[2] <= TOL * scale[2])
    return errs, ok


def _run(jobs: dict, work: Path, smi: str) -> None:
    libs = {}
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = [pool.submit(_compile, name, src, work / f"lib{i}.so")
                   for i, (name, (src, _)) in enumerate(jobs.items())]
        for i, fut in enumerate(futures):
            name, log = fut.result()
            _report(name, log)
            libs[name] = _load(work / f"lib{i}.so", jobs[name][0])
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(0)
    for nb, T, B, H in SHAPES:
        xp = torch.randn(nb, T, B, 3 * H, generator=g).cuda()
        w = (torch.randn(nb, H, 3 * H, generator=g) / H ** 0.5).cuda()
        b = (0.1 * torch.randn(nb, 1, 3 * H, generator=g)).cuda()
        h0 = (torch.rand(nb, B, H, generator=g) - 0.5).cuda()
        dy = torch.randn(nb, T, B, H, generator=g).cuda()
        with torch.no_grad():
            ys = gru_sequence_reference(xp, w, b, h0)
            ref = gru_sequence_bwd_reference(xp, w, b, h0, ys, dy)
        tag = f"nb={nb} T={T} B={B} H={H}"
        calls = {name: make(lib, xp, w, b, h0, ys, dy, stream)
                 for name, (lib, make) in libs.items()}
        if nb == 1:
            _vs_cudnn(calls, {name: jobs[name][1] for name in calls}, ref,
                      (xp, w, b, h0, dy), tag, smi)
            continue
        errs = {}
        for name, (_, whole, _) in calls.items():
            errs[name] = _errors(whole(), ref)
        times = {name: {} for name in calls}
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                kernel, whole, parts = calls[name]
                for part, fn in (("kernel", kernel), ("whole", whole), *parts.items()):
                    times[name].setdefault(part, []).append(_time_ms(fn))
        for name, (lib, _) in libs.items():
            if hasattr(lib, "gru_seq_bwd_phases"):
                calls[name][0]()
                torch.cuda.synchronize()
                ph = (ctypes.c_longlong * 7)()
                if lib.gru_seq_bwd_phases(ph):
                    raise RuntimeError("gru_seq_bwd_phases failed")
                copies, coef, group, red, own, step = (v / ph[6] for v in ph[:6])
                print(f"[phases] {tag} {name}: cycles a step, block (0, 0) thread 0: "
                      f"step {step:.0f} = copies issued {copies:.0f} + coefficient stage "
                      f"{coef:.0f} + row groups' loads, coefficients and sums {group:.0f} + "
                      f"reduction {red:.0f} + owners' update {own:.0f} + the rest (wait, "
                      f"barrier) {step - copies - coef - group - red - own:.0f} | {_clocks()}",
                      flush=True)
        for name in calls:
            (e, ok), exact = errs[name], jobs[name][1]
            verdict = (f"max|diff| dxp {e[0]:.3e} dW {e[1]:.3e} db {e[2]:.3e} dh0 "
                       f"{e[3]:.3e}{'' if ok else ' FAILS'}" if exact else "stand-in")
            parts = "; ".join(f"{part} {statistics.mean(ts):.4f} ms "
                              f"({' / '.join(f'{t:.4f}' for t in ts)})"
                              for part, ts in times[name].items())
            print(f"[variant] {tag} {name}: {parts}; {verdict} | {smi}", flush=True)


def _vs_cudnn(calls: dict, exact: dict, ref, inputs, tag: str, smi: str) -> None:
    """cuDNN's backward and each variant's whole backward in turns
    (cuDNN, the variants, the variants reversed, cuDNN)."""
    cudnn, as_k1 = _cudnn_bwd(*inputs)
    lib_errs = _errors(as_k1(cudnn()), ref)
    names = list(calls)
    lib_ms = [_time_ms(cudnn)]
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            times[name].append(_time_ms(calls[name][1]))
    lib_ms.append(_time_ms(cudnn))
    e = lib_errs[0]
    print(f"[cudnn] {tag} cuDNN GRU backward (autograd.grad on xp, W_hh, b_hh, h0; "
          f"it also forms dW_ih, 3H x 3H over T·B rows): "
          f"{statistics.mean(lib_ms):.4f} ms ({' / '.join(f'{t:.4f}' for t in lib_ms)}); "
          f"against the plain backward max|diff| dxp {e[0]:.3e} dW {e[1]:.3e} db "
          f"{e[2]:.3e} dh0 {e[3]:.3e} | {smi}", flush=True)
    for name in names:
        e, ok = _errors(calls[name][1](), ref)
        print(f"[cudnn] {tag} {name} whole backward: {statistics.mean(times[name]):.4f} ms "
              f"({' / '.join(f'{t:.4f}' for t in times[name])}), max|diff| dxp {e[0]:.3e} "
              f"dh0 {e[3]:.3e}{'' if ok or not exact[name] else ' FAILS'} | {smi}",
              flush=True)


if __name__ == "__main__":
    main()
