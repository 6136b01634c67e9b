"""Time the conv CGAN's two conv stacks on one CUDA card, in three
formulations of the same math, in float32 and bfloat16.

Counterpart of ``scripts/bench_cgan_conv.py``. The stacks are the conv
CGAN's at the training batch (``--batch``, default 64):

- the D trunk: five spectral-norm Conv1d(k4, s2, p1) 14 → 32 → … → 512 with
  LeakyReLU(0.2), time-mean pooled, on (B, 14, 768);
- the G stack: five blocks of nearest ×2 and Conv1d(k3, p1) with ReLU,
  512 → 256 → … → 16 over lengths 24 → 768.

Formulations:

- ``ncw``: ``F.conv1d`` on (B, C, L), the port's (cuDNN);
- ``nwc``: the same convolution as ``F.conv2d`` on (B, C, 1, L) in
  channels-last memory, cuDNN's NHWC kernels;
- ``im2col``: the patches of (B, L, C) as one (B·L', K·C) @ (K·C, O)
  matrix product a layer (cuBLAS).

In bfloat16 the weights (after the power iteration, which stays float32)
and the activations are cast, as ``precision_d="bf16"`` does; the pooled
features and the loss are float32. TF32 stays off (``eegsynth_torch``).
Each formulation is checked against ``ncw`` on the same weights, then
timed with CUDA events: the forward alone and the forward with the
backward (the gradient of the sum of squares in every weight and the
input), ``--iters`` calls after WARMUP, all formulations in turns.

    python3 -m eegsynth_torch.tools.bench_cgan_conv [--batch 64] [--iters 20]

Prints one line per stack, precision and formulation with the card's name
and power limit, then one JSON line of the times (ms).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from eegsynth_torch.models.cgan import DISC_CHANNELS, GEN_CHANNELS
from eegsynth_torch.nn.conv import conv1d_init, sn_conv1d_init
from eegsynth_torch.nn.spectral_norm import spectral_normalize

DISC_CH = (14, *DISC_CHANNELS)     # the 14 EEG channels in
GEN_CH = GEN_CHANNELS
SEQ_LEN, INIT_LEN = 768, 24
WARMUP, SEED = 3, 0                # calls before each timing; the weights' seed
FORMULATIONS = ("ncw", "nwc", "im2col")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def make_weights(generator: torch.Generator, device) -> tuple[list, list]:
    """(D trunk layers {"w", "b", "u"}, G stack layers {"w", "b"}) with the
    conv CGAN's init, drawn from ``generator`` and moved to ``device``."""
    d = [sn_conv1d_init(generator, DISC_CH[i], DISC_CH[i + 1], 4) for i in range(5)]
    g = [conv1d_init(generator, GEN_CH[i], GEN_CH[i + 1], 3) for i in range(5)]
    to = lambda layers: [{k: t.to(device) for k, t in p.items()} for p in layers]  # noqa: E731
    return to(d), to(g)


def to_layout(kind: str, x: torch.Tensor) -> torch.Tensor:
    """(B, C, L) → the formulation's layout."""
    if kind == "ncw":
        return x
    if kind == "nwc":
        return x.unsqueeze(2).contiguous(memory_format=torch.channels_last)
    return x.transpose(1, 2).contiguous()


def from_layout(kind: str, x: torch.Tensor) -> torch.Tensor:
    """The formulation's layout → (B, C, L)."""
    if kind == "ncw":
        return x
    if kind == "nwc":
        return x.squeeze(2)
    return x.transpose(1, 2)


def conv(kind: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
         padding: int) -> torch.Tensor:
    """One Conv1d (OIW weight ``w``) in the formulation's layout."""
    if kind == "ncw":
        return F.conv1d(x, w, stride=stride, padding=padding) + b[None, :, None]
    if kind == "nwc":
        return F.conv2d(x, w.unsqueeze(2), stride=(1, stride),
                        padding=(0, padding)) + b[None, :, None, None]
    out_ch, in_ch, k = w.shape
    patches = F.pad(x, (0, 0, padding, padding)).unfold(1, k, stride)  # (B, L', C, K)
    y = patches.reshape(-1, in_ch * k) @ w.reshape(out_ch, in_ch * k).T + b
    return y.reshape(x.shape[0], -1, out_ch)


def upsample(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "ncw":
        return x.repeat_interleave(2, dim=-1)
    if kind == "nwc":
        return x.repeat_interleave(2, dim=-1).contiguous(memory_format=torch.channels_last)
    return x.repeat_interleave(2, dim=1)


def d_trunk(kind: str, layers: list, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, 14, L) → pooled float32 features (B, 512)."""
    h = to_layout(kind, x.to(dtype))
    for p in layers:
        w = p["w"]
        w_sn = spectral_normalize(w.reshape(w.shape[0], -1), p["u"])[0].reshape(w.shape)
        h = F.leaky_relu(conv(kind, h, w_sn.to(dtype), p["b"].to(dtype), 2, 1), 0.2)
    return from_layout(kind, h).float().mean(dim=2)


def g_stack(kind: str, layers: list, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, 512, 24) → (B, 16, 768)."""
    h = to_layout(kind, h.to(dtype))
    for p in layers:
        h = torch.relu(conv(kind, upsample(kind, h), p["w"].to(dtype), p["b"].to(dtype), 1, 1))
    return from_layout(kind, h)


def flops(batch: int) -> tuple[float, float]:
    """Forward multiply-adds × 2 of the D trunk and the G stack."""
    d, L = 0.0, SEQ_LEN
    for i in range(5):
        L //= 2
        d += 2 * batch * DISC_CH[i + 1] * DISC_CH[i] * 4 * L
    g, L = 0.0, INIT_LEN
    for i in range(5):
        L *= 2
        g += 2 * batch * GEN_CH[i + 1] * GEN_CH[i] * 3 * L
    return d, g


def _forward_backward(stack, kind, layers, x, dtype):
    params = [t for p in layers for k, t in p.items() if k != "u"]
    out = stack(kind, layers, x, dtype)
    return torch.autograd.grad(out.float().pow(2).sum(), [x, *params])


def _events_ms(fn, iters: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check(batch: int, device, generator: torch.Generator) -> dict:
    """Each formulation's forward and input gradient against ``ncw`` in
    float32 and bfloat16: {(stack, precision, kind): max |diff| relative to
    the largest magnitude}."""
    d_layers, g_layers = make_weights(generator, device)
    x = torch.rand((batch, DISC_CH[0], SEQ_LEN), generator=generator).to(device)
    h = torch.randn((batch, GEN_CH[0], INIT_LEN), generator=generator).to(device)
    errors = {}
    for name, stack, layers, inp in (("D", d_trunk, d_layers, x), ("G", g_stack, g_layers, h)):
        for prec, dtype in DTYPES.items():
            ref = None
            for kind in FORMULATIONS:
                inp_k = inp.detach().requires_grad_()
                out = stack(kind, layers, inp_k, dtype).float()
                (gin,) = torch.autograd.grad(out.pow(2).sum(), inp_k)
                if ref is None:
                    ref = (out, gin)
                errors[(name, prec, kind)] = max(
                    ((a - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()
                    for a, r in zip((out, gin), ref))
    return errors


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_cgan_conv times the card: no CUDA device is available")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(SEED)
    errors = check(args.batch, device, gen)
    d_layers, g_layers = make_weights(gen, device)
    for p in d_layers + g_layers:
        p["w"].requires_grad_()
        p["b"].requires_grad_()
    x = torch.rand((args.batch, DISC_CH[0], SEQ_LEN), generator=gen).to(device)
    h = torch.randn((args.batch, GEN_CH[0], INIT_LEN), generator=gen).to(device)
    d_flops, g_flops = flops(args.batch)
    results = {}
    for name, stack, layers, inp, fl in (("D", d_trunk, d_layers, x, d_flops),
                                         ("G", g_stack, g_layers, h, g_flops)):
        inp = inp.requires_grad_()
        for prec, dtype in DTYPES.items():
            times = {}
            for _ in range(2):                 # two turns, the order reversed
                for kind in FORMULATIONS:
                    fwd = _events_ms(lambda: stack(kind, layers, inp, dtype),  # noqa: B023
                                     args.iters, WARMUP)
                    both = _events_ms(lambda: _forward_backward(  # noqa: B023
                        stack, kind, layers, inp, dtype), args.iters, WARMUP)
                    times.setdefault(kind, []).append((fwd, both))
            for kind in FORMULATIONS:
                fwd = sum(t[0] for t in times[kind]) / 2
                both = sum(t[1] for t in times[kind]) / 2
                results[f"{name}_{prec}_{kind}"] = {"fwd_ms": fwd, "fwd_bwd_ms": both,
                                                    "max_rel_err": errors[(name, prec, kind)]}
                print(f"[bench-conv] {'D trunk' if name == 'D' else 'G stack'} B={args.batch} "
                      f"{prec} {kind}: forward {fwd:.4f} ms ({fl / fwd / 1e9:.2f} TFLOP/s), "
                      f"forward+backward {both:.4f} ms ({3 * fl / both / 1e9:.2f} TFLOP/s); "
                      f"against ncw {errors[(name, prec, kind)]:.2e} | {smi}", flush=True)
    print(json.dumps({"bench_cgan_conv": results, "batch": args.batch, "card": smi}),
          flush=True)
    return results


if __name__ == "__main__":
    main()
