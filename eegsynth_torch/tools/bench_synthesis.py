"""Synthesis throughput: the TimeGAN G→S→R cascade (one-shot and streamed in
time chunks) and the conv CGAN generator; the CLI of
``scripts/bench_synthesis.py``, plus ``--device``.

    python -m eegsynth_torch.tools.bench_synthesis [--batch 512 2048 4096] \\
        [--iters 20] [--model timegan|cgan|both] [--precision f32|bf16] \\
        [--T 768] [--time_chunk 1024] [--stream_only] [--parity] [--device cuda]

Each row is timed after one warm call: on the card between CUDA events
around ``--iters`` calls (the events bracket the whole run and the host
waits for the last one), on the CPU by the host clock. Weights are random,
from a seed; the model dims stay at the trained-768 shape (adaptive_dims at
14 channels: z28/h56) whatever ``--T`` is. ``--parity`` instead compares one
one-shot run with the same noise streamed in ``--time_chunk`` chunks (the
carried hidden states) at ``--batch[0]`` and ``--T``, and asserts their
largest difference under 5e-5 (f32) or 5e-2 (bf16).
"""

from __future__ import annotations

import argparse
import time

import torch

from eegsynth_torch.models.timegan import (
    TimeGAN, TimeGANConfig, adaptive_dims, cascade_init_carry, params_tree, sample_noise,
)
from eegsynth_torch.nn.precision import cast_floating, compute_dtype

PARITY_TOL = {"f32": 5e-5, "bf16": 5e-2}
CHANNELS = 14


def timed(fn, iters: int, device: torch.device) -> float:
    """Seconds for ``iters`` calls of ``fn`` after one warm call."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return time.perf_counter() - t0


def _timegan(precision: str, device: torch.device, C: int = CHANNELS):
    """A random full-width TimeGAN's params tree in the compute dtype."""
    z_dim, h_dim = adaptive_dims(C, 768)
    cfg = TimeGANConfig(x_dim=C, z_dim=z_dim, h_dim=h_dim)
    model = TimeGAN(cfg, generator=torch.Generator().manual_seed(0), device=device)
    return cast_floating(params_tree(model), compute_dtype(precision)), cfg


def _noise(batch: int, T: int, cfg, precision: str, device, seed: int) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return sample_noise(g, batch, T, cfg.z_dim, device=device).to(compute_dtype(precision))


@torch.inference_mode()
def bench_timegan(batch: int, iters: int, T: int = 768, precision: str = "f32", *,
                  device: torch.device) -> float:
    """One-shot cascade with decode (``synthesize_from_noise``): windows/s."""
    from eegsynth_torch.train.timegan import synthesize_from_noise
    net, cfg = _timegan(precision, device)
    z = _noise(batch, T, cfg, precision, device, 1)
    dt = timed(lambda: synthesize_from_noise(net, z), iters, device)
    return batch * iters / dt


@torch.inference_mode()
def bench_timegan_stream(batch: int, T: int, time_chunk: int, precision: str = "f32",
                         reps: int = 3, *, device: torch.device) -> float:
    """The streamed path (``synthesize(time_chunk=...)``'s): carried hidden
    states over fixed-(batch, time_chunk) calls, one buffer of a chunk on
    the device whatever T is. Windows of T samples a second."""
    from eegsynth_torch.train.timegan import synthesize_from_noise
    net, cfg = _timegan(precision, device)
    zs = [_noise(batch, time_chunk, cfg, precision, device, 2 + i)
          for i in range(-(-T // time_chunk))]

    def one_pass():
        carry = cascade_init_carry(net, batch, device=device)
        for z in zs:
            _, carry = synthesize_from_noise(net, z, carry)

    dt = timed(one_pass, reps, device)
    return batch * reps / dt


@torch.inference_mode()
def parity_long(batch: int, T: int, time_chunk: int, precision: str = "f32", *,
                device: torch.device) -> float:
    """max |one-shot − chunked| on the same noise: the GRUs are causal, so
    the two streams agree to rounding."""
    from eegsynth_torch.train.timegan import synthesize_from_noise
    net, cfg = _timegan(precision, device)
    z = _noise(batch, T, cfg, precision, device, 1)
    one = synthesize_from_noise(net, z)[0]
    carry, pieces = None, []
    for t0 in range(0, T, time_chunk):
        x, carry = synthesize_from_noise(net, z[:, t0:t0 + time_chunk], carry)
        pieces.append(x)
    return float((one - torch.cat(pieces, dim=1)).abs().max())


@torch.inference_mode()
def bench_cgan(batch: int, iters: int, num_classes: int = 9, *,
               device: torch.device) -> float:
    """The conv CGAN generator at the JAX defaults, eval mode: windows/s."""
    from eegsynth_torch.train.cgan import (
        CGANHParams, build_cfg, generator_apply, generator_init,
    )
    cfg = build_cfg(CGANHParams(), num_classes)
    G, bn = generator_init(cfg, torch.Generator().manual_seed(0), device=device)
    z = torch.randn((batch, cfg.noise_dim),
                    generator=torch.Generator(device=device).manual_seed(1), device=device)
    labels = torch.arange(batch, device=device) % num_classes
    dt = timed(lambda: generator_apply(G, bn, z, labels, cfg, train=False), iters, device)
    return batch * iters / dt


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[512, 2048, 4096])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--model", type=str, default="both",
                    choices=["timegan", "cgan", "both"])
    ap.add_argument("--precision", type=str, default="f32", choices=["f32", "bf16"],
                    help="TimeGAN cascade compute precision (the cgan rows are f32)")
    ap.add_argument("--T", type=int, default=768,
                    help="sequence length; model dims stay at the trained-768 shape")
    ap.add_argument("--time_chunk", type=int, default=None,
                    help="also time the streamed carried-state path at this "
                         "chunk length")
    ap.add_argument("--stream_only", action="store_true",
                    help="skip the one-shot rows (the streamed path holds one "
                         "chunk on the device whatever T is)")
    ap.add_argument("--parity", action="store_true",
                    help="chunked-vs-one-shot equality at (--batch[0], --T, "
                         "--time_chunk) instead of timing")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    if args.parity:
        tc = args.time_chunk or 1024
        d = parity_long(args.batch[0], args.T, tc, precision=args.precision,
                        device=device)
        print(f"timegan parity batch={args.batch[0]} T={args.T} chunk={tc} "
              f"{args.precision}: max|oneshot-chunked|={d:.3e}", flush=True)
        assert d <= PARITY_TOL[args.precision], d
        return

    where = (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    for b in args.batch:
        if args.model in ("timegan", "both"):
            if not args.stream_only:
                w = bench_timegan(b, args.iters, T=args.T, precision=args.precision,
                                  device=device)
                print(f"timegan synth  batch={b:5d} T={args.T} {args.precision}: "
                      f"{w:,.0f} windows/s = {w * args.T:,.0f} samples/s | {where}",
                      flush=True)
            if args.time_chunk:
                ws = bench_timegan_stream(b, args.T, args.time_chunk,
                                          precision=args.precision, device=device)
                print(f"timegan stream batch={b:5d} T={args.T} chunk={args.time_chunk} "
                      f"{args.precision}: {ws:,.0f} windows/s = {ws * args.T:,.0f} "
                      f"samples/s | {where}", flush=True)
        if args.model in ("cgan", "both"):
            w = bench_cgan(b, args.iters, device=device)
            print(f"cgan   synth  batch={b:5d}: {w:,.0f} windows/s | {where}", flush=True)


if __name__ == "__main__":
    main()
