#!/usr/bin/env python3
"""Drive the port's synthesis-serving path once on one CUDA card and check it.

Run from the repository root, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero, and no phase's
failure is swallowed):

1. device  — the card's name, torch / CUDA versions, name and power limit;
2. build   — nvcc builds every kernel under eegsynth_torch/csrc/;
3. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes the serving path gives it, with times;
4. serve   — two full-width TimeGAN runs (x14/z28/h56, random weights from a
             seed) served over HTTP by eegsynth_torch.serve at
             serve_batch 256 / time_chunk 768; launch counts, seeded
             repeatability, denorm; then a per-layer breakdown of one
             request (host clock, and torch.profiler for the card's busy
             share), card-vs-CPU and chunked-vs-one-shot checks.

The last three lines are a JSON object listing each kernel (its launches in
the served run, its error against the plain version and both times), the
nvidia-smi name and power-limit line, and ``{"ok": true, "device": {...}}``.
Imports no JAX.
"""

from __future__ import annotations

import http.client
import io
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch import _build
from eegsynth_torch.convert import from_jax_params, to_jax_params
from eegsynth_torch.models.timegan import TimeGAN, TimeGANConfig, sample_noise
from eegsynth_torch.nn.gru_sequence import gru_sequence, gru_sequence_reference
from eegsynth_torch.nn.layers import xavier_uniform
from eegsynth_torch.serve import ModelRegistry, make_server
from eegsynth_torch.train.checkpoint import save_checkpoint
from eegsynth_torch.train.timegan import synthesize_from_noise

SERVE_BATCH, TIME_CHUNK = 256, 768
KERNEL_TOL = 1e-4      # f32, another summation order, up to 1024 dependent steps
CASCADE_TOL = 1e-4     # card vs CPU plain path, full cascade at the serving width
CHUNK_TOL = 1e-5       # chunked vs one-shot on the card (same kernel, same order;
                       # only cuBLAS's choice for the hoisted products may differ)
# (T, B, H, input): the serving width (generator / supervisor / recovery
# recurrence), the embedder-sized H = 28, and a ragged batch at the H cap
KERNEL_SHAPES = ((768, 256, 56, 28), (768, 256, 28, 14), (1024, 37, 128, 28))


def fail(msg: str) -> None:
    print(f"[FAIL] {msg}", flush=True)
    sys.exit(1)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        print("[FAIL] torch.cuda.is_available() is false: this check needs a "
              "CUDA card", file=sys.stderr)
        sys.exit(1)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"[device] {name} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | cards {torch.cuda.device_count()}", flush=True)
    print(smi, flush=True)
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    log = path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {line.strip()}", flush=True)


def _time_ms(fn, reps: int) -> float:
    """Median over ``reps`` runs of one call, CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _gru_inputs(T, B, H, I, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.rand((T, B, I), generator=g)
    w_ih = xavier_uniform((3 * H, I), g)
    w_hh = xavier_uniform((3 * H, H), g)
    b_ih = 0.1 * torch.randn(3 * H, generator=g)
    b_hh = 0.1 * torch.randn(1, 3 * H, generator=g)
    h0 = torch.rand((B, H), generator=g) - 0.5
    xp = torch.matmul(x, w_ih.t()) + b_ih
    return [t.to(device).contiguous() for t in (xp, w_hh.t(), b_hh, h0)]


def phase_kernels(smi: str) -> dict:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    serving = None
    worst = 0.0
    for i, (T, B, H, I) in enumerate(KERNEL_SHAPES):
        args = _gru_inputs(T, B, H, I, seed=i, device="cuda")
        with torch.inference_mode():
            got = gru_sequence(*args)
            ref = gru_sequence_reference(*args)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            ms = _time_ms(lambda: gru_sequence(*args), reps=20)
            plain_ms = _time_ms(lambda: gru_sequence_reference(*args), reps=3)
        finite = bool(torch.isfinite(got).all())
        rows = -(-B // sms)
        print(f"[kernel] gru_sequence T={T} B={B} H={H} in={I}: "
              f"max|diff|={err:.3e} (tol {KERNEL_TOL:g}) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, tile {rows} rows x {-(-B // rows)} "
              f"blocks | {smi}", flush=True)
        if not finite or err > KERNEL_TOL:
            fail(f"gru_sequence disagrees with its plain version at "
                 f"T={T} B={B} H={H}: max|diff|={err} finite={finite}")
        worst = max(worst, err)
        if serving is None:
            serving = {"ms": ms, "plain_ms": plain_ms}
    return {"max_abs_err": worst, **serving}


def _write_runs(root: Path) -> tuple[Path, Path]:
    runs, real = root / "runs", root / "real"
    real.mkdir(parents=True)
    cfg = TimeGANConfig(x_dim=14, z_dim=28, h_dim=56)
    for i, name in enumerate(("posture1_no_exo", "posture2_with_exo")):
        (runs / name).mkdir(parents=True)
        model = TimeGAN(cfg, generator=torch.Generator().manual_seed(i),
                        device="cpu")
        save_checkpoint(runs / name / "ckpt_best.npz",
                        {"model": to_jax_params(model)},
                        {"npz": f"{name}.npz", "z_dim": cfg.z_dim,
                         "h_dim": cfg.h_dim, "x_dim": cfg.x_dim, "step": 0,
                         "best": True})
        rng = np.random.default_rng(i)
        np.savez(real / f"{name}.npz",
                 X=rng.uniform(0, 1, (2, TIME_CHUNK, cfg.x_dim)).astype(np.float32),
                 fs=np.float32(128.0),
                 scale_min=rng.uniform(-50, -10, cfg.x_dim).astype(np.float32),
                 scale_range=rng.uniform(20, 100, cfg.x_dim).astype(np.float32))
    return runs, real


def _post(addr, body: dict) -> tuple[np.ndarray, float]:
    conn = http.client.HTTPConnection(*addr, timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/synthesize", body=json.dumps(body))
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    wall = time.perf_counter() - t0
    if resp.status != 200:
        fail(f"POST /synthesize {body} -> {resp.status}: {data[:300]!r}")
    if body.get("format") == "json":
        return np.asarray(json.loads(data)["X"], np.float32), wall
    with np.load(io.BytesIO(data)) as npz:
        return npz["X"], wall


def _get(addr, path: str) -> dict:
    conn = http.client.HTTPConnection(*addr, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        fail(f"GET {path} -> {resp.status}")
    return json.loads(data)


def phase_serve(smi: str, kernel_ms: float, device: str = "cuda") -> int:
    with tempfile.TemporaryDirectory() as tmp:
        runs, real = _write_runs(Path(tmp))
        t0 = time.perf_counter()
        reg = ModelRegistry(runs, real, device=device)
        print(f"[serve] loaded {sorted(reg.models)} on {reg.device} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        srv = make_server(reg, "127.0.0.1", 0, SERVE_BATCH, TIME_CHUNK)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            launches = _drive(srv.server_address, reg, smi)
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
        _breakdown(reg, smi, device, kernel_ms)
        _check_cascade(reg.models["posture1_no_exo"]["model"], device)
    return launches


def _drive(addr, reg: ModelRegistry, smi: str) -> int:
    health = _get(addr, "/healthz")
    if health != {"status": "ok", "runs": ["posture1_no_exo", "posture2_with_exo"],
                  "cgan": []}:
        fail(f"/healthz: {health}")
    info = _get(addr, "/runs")["timegan"]
    if not all(m["has_scalers"] and m["h_dim"] == 56 for m in info.values()):
        fail(f"/runs: {info}")

    r1, r2 = "posture1_no_exo", "posture2_with_exo"
    # (body, expected shape, expected launches: 3 per chunk per micro-batch)
    plan = [
        ({"run": r1, "n": 256, "seq_len": 768, "seed": 0}, (256, 768, 14), 3),
        ({"run": r1, "n": 300, "seq_len": 768, "seed": 1}, (300, 768, 14), 3 * 2),
        ({"run": r1, "n": 16, "seq_len": 8192, "seed": 2}, (16, 8192, 14), 3 * 11),
        ({"run": r2, "n": 64, "seq_len": 768, "seed": 3}, (64, 768, 14), 3),
        ({"run": r2, "n": 64, "seq_len": 768, "seed": 3, "denorm": True},
         (64, 768, 14), 3),
        ({"run": r2, "n": 4, "seq_len": 100, "seed": 4, "format": "json"},
         (4, 100, 14), 3),
        ({"run": r1, "n": 256, "seq_len": 768, "seed": 0}, (256, 768, 14), 3),
    ]
    gru_sequence.launches = 0
    outs = []
    for body, shape, want in plan:
        before = gru_sequence.launches
        X, wall = _post(addr, body)
        got = gru_sequence.launches - before
        print(f"[serve] {json.dumps(body)} -> {X.shape} in {wall * 1e3:.1f} ms, "
              f"{body['n'] / wall:.1f} windows/s, "
              f"{body['n'] * body['seq_len'] / wall:.4g} samples/s, "
              f"gru_sequence launches {got} | {smi}", flush=True)
        if X.shape != shape or X.dtype != np.float32 or not np.isfinite(X).all():
            fail(f"{body}: shape {X.shape} dtype {X.dtype} "
                 f"finite {np.isfinite(X).all()}")
        if got != want:
            fail(f"{body}: {got} gru_sequence launches, expected {want}")
        outs.append(X)
    launches = gru_sequence.launches

    if not np.array_equal(outs[0], outs[-1]):
        fail("the repeated seeded request returned a different X")
    m = reg.models[r2]
    if not np.allclose(outs[4], outs[3] * m["scale_range"] + m["scale_min"],
                       rtol=1e-6, atol=1e-5):
        fail("denorm=true is not X * scale_range + scale_min")
    print(f"[serve] repeated seed 0 request: X identical; denorm applied; "
          f"{launches} gru_sequence launches in the served run", flush=True)
    return launches


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _npz_bytes(X: np.ndarray) -> int:
    buf = io.BytesIO()
    np.savez_compressed(buf, X=X)
    return buf.getbuffer().nbytes


def _breakdown(reg: ModelRegistry, smi: str, device: str,
               kernel_ms: float) -> None:
    """Where a warm served request's time goes at n = serve_batch, seq_len =
    time_chunk (one micro-batch, one chunk), layer by layer: host clock around
    each layer, synchronised, median of 5."""
    run = "posture1_no_exo"
    model = reg.models[run]["model"]
    gen = torch.Generator(device=device).manual_seed(0)

    def timed(fn, reps=5):
        times = []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            out = fn()
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(times)

    z, noise_ms = timed(lambda: sample_noise(gen, SERVE_BATCH, TIME_CHUNK,
                                             model.cfg.z_dim, device=device))
    x, cascade_ms = timed(lambda: synthesize_from_noise(model, z)[0])
    _, d2h_ms = timed(lambda: x.cpu().numpy())
    X, synth_ms = timed(lambda: reg.synthesize(run, SERVE_BATCH, TIME_CHUNK, 0,
                                               False, SERVE_BATCH, TIME_CHUNK))
    nbytes, pack_ms = timed(lambda: _npz_bytes(X))
    print(f"[layers] n={SERVE_BATCH} seq_len={TIME_CHUNK}: noise {noise_ms:.3f} ms; "
          f"cascade {cascade_ms:.3f} ms (3 x gru_sequence ~ {3 * kernel_ms:.3f} "
          f"ms); device->host {d2h_ms:.3f} ms ({x.numel() * 4 / 1e6:.1f} MB); "
          f"registry synthesize {synth_ms:.3f} ms; npz packing {pack_ms:.3f} ms "
          f"({nbytes / 1e6:.1f} MB) | {smi}", flush=True)
    if torch.device(device).type != "cuda":
        return

    # the card's busy share over one registry synthesize, from its own trace
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_ms = timed(lambda: reg.synthesize(
            run, SERVE_BATCH, TIME_CHUNK, 0, False, SERVE_BATCH, TIME_CHUNK), reps=1)
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    dev_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    k1_ms = sum(e.self_device_time_total for e in on_card
                if "gru_seq_fwd_kernel" in e.key) / 1e3
    copy_ms = sum(e.self_device_time_total for e in on_card
                  if "Memcpy DtoH" in e.key) / 1e3
    print(f"[profile] registry synthesize n={SERVE_BATCH} seq_len={TIME_CHUNK}: "
          f"device time {dev_ms:.3f} ms in {wall_ms:.3f} ms wall "
          f"({100 * dev_ms / wall_ms:.1f} % busy): gru_sequence {k1_ms:.3f} ms, "
          f"device->host {copy_ms:.3f} ms | {smi}", flush=True)

    # long horizon: 8192 samples streamed at time_chunk 1024, carried state
    _, long_ms = timed(lambda: reg.synthesize(run, 16, 8192, 0, False,
                                              SERVE_BATCH, 1024), reps=3)
    print(f"[layers] registry synthesize n=16 seq_len=8192 time_chunk=1024 "
          f"(8 chunks of {SERVE_BATCH} rows): {long_ms:.3f} ms, "
          f"{16 * 8192 / long_ms * 1e3:.4g} samples/s | {smi}", flush=True)


def _check_cascade(model: TimeGAN, device: str) -> None:
    """The card's cascade against the CPU plain path on the same noise, and
    chunked against one-shot on the card."""
    cpu_model = from_jax_params(to_jax_params(model), device="cpu").eval()
    rng = np.random.default_rng(7)
    z = torch.from_numpy(rng.uniform(0, 1, (32, 3 * TIME_CHUNK, 28))
                         .astype(np.float32))
    x_card, _ = synthesize_from_noise(model, z.to(device))
    x_cpu, _ = synthesize_from_noise(cpu_model, z)
    err = (x_card.cpu() - x_cpu).abs().max().item()
    print(f"[check] cascade card vs CPU plain, B=32 T={3 * TIME_CHUNK}: "
          f"max|diff|={err:.3e} (tol {CASCADE_TOL:g})", flush=True)
    if not torch.isfinite(x_card).all() or err > CASCADE_TOL:
        fail(f"card cascade disagrees with the CPU plain path: {err}")

    carry, pieces = None, []
    for t0 in range(0, z.shape[1], TIME_CHUNK):
        x, carry = synthesize_from_noise(model, z[:, t0:t0 + TIME_CHUNK].to(device),
                                         carry)
        pieces.append(x)
    chunked = torch.cat(pieces, dim=1)
    err = (chunked - x_card).abs().max().item()
    print(f"[check] chunked (3 x {TIME_CHUNK}) vs one-shot on the card: "
          f"max|diff|={err:.3e} (tol {CHUNK_TOL:g}), bitwise equal "
          f"{bool(torch.equal(chunked, x_card))}", flush=True)
    if err > CHUNK_TOL:
        fail(f"chunked synthesis differs from one-shot on the card: {err}")


def main() -> None:
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    kern = phase_kernels(smi)
    launches = phase_serve(smi, kern["ms"])
    if launches < 1:
        fail("the served run launched gru_sequence no time")
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [{
        "name": "gru_sequence", "route": "cuda",
        "source": "eegsynth_torch/csrc/gru_seq.cu",
        "replaces": "eegsynth/nn/pallas_gru.py:52",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
