"""Kernel micro-benchmark across hidden sizes: one GRU layer through K1 (the
port's kernel recurrence: the register kernels up to H 128, the wide route
past it), through its plain PyTorch twin, and through cuDNN's
``torch.nn.GRU`` as the library yardstick (timed here, used nowhere in the
port); the CLI of ``scripts/bench_kernels.py`` (its ``xla`` and ``pallas``
columns are ``plain`` and ``K1`` here, and cuDNN is added).

    python -m eegsynth_torch.tools.bench_kernels [--hs 56,128,256,512] \\
        [--batch 64] [--seq 768] [--iters 20] [--backward] [--device cuda]

Each H runs a layer of H inputs and H units (square, as the script's), on
x (B, T, H) from a zero state; ``--backward`` times the gradient of
sum(ys²) with respect to the layer's four parameters instead of the forward.
Times are ms a call, the mean over ``--iters`` calls after one warm call:
between CUDA events on the card, by the host clock on the CPU.
"""

from __future__ import annotations

import argparse

import torch

from eegsynth_torch.nn.gru import GRULayer, gru_apply
from eegsynth_torch.nn.layers import xavier_uniform
from eegsynth_torch.tools.bench_synthesis import timed


def _layer(H: int, device) -> GRULayer:
    g = torch.Generator().manual_seed(0)
    ws = [xavier_uniform((3 * H, H), g) for _ in range(2)]
    bs = [0.1 * torch.randn(3 * H, generator=g) for _ in range(2)]
    return GRULayer(*(t.to(device).requires_grad_() for t in (ws[0], ws[1], bs[0], bs[1])))


def _cudnn(layer: GRULayer, H: int, device) -> torch.nn.GRU:
    gru = torch.nn.GRU(H, H, batch_first=True).to(device)
    with torch.no_grad():
        for name, t in zip(("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"),
                           layer):
            getattr(gru, name).copy_(t)
    gru.flatten_parameters()
    return gru


def _ms(fn, iters: int, device: torch.device) -> float:
    return timed(fn, iters, device) / iters * 1e3


def bench_one(H: int, B: int, T: int, iters: int, backward: bool,
              device: torch.device) -> dict:
    """ms a call of the plain twin, K1 and cuDNN at one H."""
    layer = _layer(H, device)
    x = torch.randn((B, T, H), generator=torch.Generator().manual_seed(1)).to(device)
    gru = _cudnn(layer, H, device)
    h0 = torch.zeros((1, B, H), device=device)

    def ours(impl):
        if not backward:
            def fwd():
                with torch.no_grad():
                    return gru_apply(layer, x, impl=impl)
            return fwd
        return lambda: torch.autograd.grad((gru_apply(layer, x, impl=impl) ** 2).sum(),
                                           list(layer))

    if backward:
        params = [gru.weight_ih_l0, gru.weight_hh_l0, gru.bias_ih_l0, gru.bias_hh_l0]
        lib = lambda: torch.autograd.grad((gru(x, h0)[0] ** 2).sum(), params)  # noqa: E731
    else:
        def lib():
            with torch.no_grad():
                return gru(x, h0)[0]
    return {"plain": _ms(ours("plain"), iters, device), "k1": _ms(ours("kernel"), iters, device),
            "cudnn": _ms(lib, iters, device)}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hs", type=str, default="56,128,256,512")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=768)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--backward", action="store_true",
                    help="time the gradient instead of the forward only")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device={where}  B={args.batch} T={args.seq} iters={args.iters} "
          f"mode={'fwd+bwd' if args.backward else 'fwd'}", flush=True)
    print(f"{'H':>5} {'plain ms':>10} {'K1 ms':>9} {'speedup':>8} {'cuDNN ms':>9} "
          f"{'K1/cuDNN':>9}", flush=True)
    rows = []
    for H in [int(h) for h in args.hs.split(",")]:
        r = bench_one(H, args.batch, args.seq, args.iters, args.backward, device)
        print(f"{H:>5} {r['plain']:>10.2f} {r['k1']:>9.2f} {r['plain'] / r['k1']:>7.2f}x "
              f"{r['cudnn']:>9.2f} {r['k1'] / r['cudnn']:>8.2f}x", flush=True)
        rows.append({"H": H, **r})
    return rows


if __name__ == "__main__":
    main()
