#!/usr/bin/env python3
"""Synthesis serving endpoint: trained TimeGAN and CGAN models resident on
the card, HTTP in front.

Counterpart of ``scripts/serve_synthesis.py``, with the same API, request
caps, error codes and flags (``--platform`` becomes ``--device``):

- loads every run's NPZ checkpoint at startup and keeps the weights resident
  on ``--device`` (no per-request host→device weight traffic),
- runs every request at one fixed shape per model: the batch is padded to
  ``--serve_batch`` and the sequence axis is streamed in ``--time_chunk``
  chunks with carried GRU state (see ``train.timegan.synthesize``), so each
  chunk is three launches of the GRU sequence kernel,
- ``--precision bf16``: TimeGAN requests run the cascade in bfloat16 around
  K1's float32 recurrences and answer float32 windows; CGAN requests stay
  float32, as in the JAX server,
- optional per-bucket denormalization with the real scalers,
- ``--cgan_root``: CGAN generators, conv or transformer
  (``<root>/<tag>/CGAN_generator_<tag>_{best,last}.npz``, the architecture
  rebuilt from the checkpoint meta, the conv generator with its bn
  statistics), served in ``serve_batch`` micro-batches in eval mode; the
  conv generator's convolutions are cuDNN's, the transformer's attention
  takes the flash kernel K3a on the card from 512 tokens (patch 1 at 768
  samples).

Socket I/O runs on one thread per connection (a slow or hung client never
blocks other requests); all device work serializes behind one lock.
Seed semantics: ``seed`` reproduces outputs for identical (run, n, seq_len)
and server shape config on the same device.

    GET  /healthz              -> {"status": "ok", "runs": [...], "cgan": [...]}
    GET  /runs                 -> per-run metadata (dims, step, scalers)
    POST /synthesize           body: {"run": "posture1_no_exo", "n": 64,
                                      "seq_len": 768, "seed": 0,
                                      "denorm": false, "format": "npz"|"json"}
        -> NPZ bytes (X float32 (n, seq_len, C)) or JSON.
    POST /synthesize_cgan      body: {"model": "no_exo", "label": 4, "n": 100,
                                      "seed": 0, "inverse_scale": false,
                                      "format": "npz"|"json"}
        -> NPZ bytes (X float32 (n, T, C)) or JSON.

Usage:
    python -m eegsynth_torch.serve --runs_dir ./timegan_runs \
        --real_dir ./preprocessed --cgan_root ./cgan_runs --port 8777 --device cuda
"""

from __future__ import annotations

import argparse
import io
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.convert import from_jax_params
from eegsynth_torch.nn.precision import compute_dtype
from eegsynth_torch.train.cgan import generate_batch, load_generator
from eegsynth_torch.train.checkpoint import (
    find_checkpoint, load_checkpoint, load_meta,
)
from eegsynth_torch.train.timegan import synthesize

# Per-request caps: the host concat of a maxed request stays ~100s of MB, and
# JSON (Python-float) responses stay small. One oversized request must not OOM
# the process holding every device-resident model.
MAX_SAMPLES_PER_REQUEST = 1 << 22        # n * seq_len (≈235 MB f32 at C=14)
MAX_JSON_ELEMENTS = 1 << 22


def _resolve_device(name: str) -> torch.device:
    """``cuda`` or ``cpu``; ``cuda`` without a usable card raises rather than
    serving on the CPU."""
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    return device


class ModelRegistry:
    """Checkpoints → device-resident models + per-run meta/scalers."""

    def __init__(self, runs_dir: Path | None, real_dir: Path | None,
                 prefer_latest: bool = False, *, device: torch.device | str,
                 cgan_root: Path | None = None):
        self.device = _resolve_device(str(device))
        self.real_dir = Path(real_dir) if real_dir is not None else None
        self.models = {}
        self.cgan = {}
        # Serializes DEVICE work only; socket I/O and host-side NPZ packing
        # stay concurrent across handler threads.
        self.device_lock = threading.Lock()
        if runs_dir is not None:
            self._load_timegan(Path(runs_dir), prefer_latest)
        if cgan_root is not None:
            self._load_cgan(Path(cgan_root))
        if not self.models and not self.cgan:
            raise SystemExit("No servable checkpoints found")

    def _load_cgan(self, root: Path):
        """<root>/<tag>/CGAN_generator_<tag>_{best,last}.npz (tag = condition
        for v1, posture{p} for v2); the best one where both exist."""
        for d in sorted(p for p in root.iterdir() if p.is_dir()):
            for which in ("best", "last"):
                fp = d / f"CGAN_generator_{d.name}_{which}.npz"
                if fp.exists():
                    G, bn, cfg, meta = load_generator(fp, device=self.device)
                    self.cgan[d.name] = {"G": G, "bn": bn, "cfg": cfg, "meta": meta}
                    break

    def _bucket_scalers(self, tag: str, label: int):
        """(scale_min, scale_range) of a CGAN (tag, label) from the real
        buckets: v1 tag = condition, label = posture − 1; v2 tag =
        posture{p}, label 0/1 = no_exo/with_exo."""
        if self.real_dir is None:
            return None
        if tag in ("no_exo", "with_exo"):
            fp = self.real_dir / f"posture{label + 1}_{tag}.npz"
        elif tag.startswith("posture"):
            fp = self.real_dir / f"{tag}_{('no_exo', 'with_exo')[label]}.npz"
        else:
            return None
        if not fp.exists():
            return None
        with np.load(fp) as real:
            if "scale_min" not in real.files:
                return None
            return (real["scale_min"].astype(np.float32),
                    real["scale_range"].astype(np.float32))

    def synthesize_cgan(self, tag: str, label: int, n: int, seed: int,
                        inverse_scale: bool, serve_batch: int) -> np.ndarray:
        """n windows (n, T, C) of class ``label``, generated in micro-batches
        of ``serve_batch`` (the last one sliced) from N(0, 1) noise of a
        generator seeded with ``seed``."""
        m = self.cgan[tag]
        pieces = []
        with self.device_lock:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            for _ in range(-(-n // serve_batch)):
                pieces.append(generate_batch(m["G"], m["bn"], m["cfg"], gen,
                                             serve_batch, label).cpu().numpy())
        X = np.concatenate(pieces, axis=0)[:n]          # (n, C, T)
        if inverse_scale:
            sc = self._bucket_scalers(tag, label)
            if sc is not None:
                X = X * sc[1][None, :, None] + sc[0][None, :, None]
        return X.transpose(0, 2, 1)                     # (n, T, C) NPZ layout

    def _load_timegan(self, runs_dir: Path, prefer_latest: bool):
        for rd in sorted(runs_dir.iterdir()):
            if not (rd.is_dir() and re.match(r"posture\d+_(with_exo|no_exo)$", rd.name)):
                continue
            best = find_checkpoint(rd, "ckpt_best")
            latest = find_checkpoint(rd, "ckpt_latest")
            ckpt = (latest if prefer_latest and latest is not None
                    else (best if best is not None else latest))
            if ckpt is None:
                continue
            meta = load_meta(ckpt)
            scale_min = scale_range = None
            fs = float(meta.get("fs", 128.0))
            if self.real_dir is not None:
                real_fp = self.real_dir / f"{rd.name}.npz"
                if real_fp.exists():
                    with np.load(real_fp) as real:
                        fs = float(real["fs"]) if "fs" in real.files else fs
                        if "scale_min" in real.files:
                            scale_min = real["scale_min"].astype(np.float32)
                            scale_range = real["scale_range"].astype(np.float32)
            trees, _ = load_checkpoint(ckpt)
            model = from_jax_params(trees["model"], device=self.device).eval()
            self.models[rd.name] = {
                "model": model, "cfg": model.cfg, "meta": meta, "fs": fs,
                "scale_min": scale_min, "scale_range": scale_range,
            }

    def synthesize(self, run: str, n: int, seq_len: int, seed: int,
                   denorm: bool, serve_batch: int, time_chunk: int,
                   precision: str = "f32") -> np.ndarray:
        m = self.models[run]
        # Pad both axes to the fixed serving shape and slice down: the GRU is
        # strictly causal, so the first seq_len steps of a longer run are
        # identical to a shorter run — every request runs at ONE
        # (serve_batch, time_chunk) shape.
        nb = -(-n // serve_batch) * serve_batch
        tb = -(-seq_len // time_chunk) * time_chunk
        with self.device_lock:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            X = synthesize(m["model"], nb, tb, generator=gen,
                           batch=serve_batch if nb > serve_batch else None,
                           time_chunk=time_chunk if tb > time_chunk else None,
                           precision=precision)[:n, :seq_len]
        if denorm and m["scale_min"] is not None:
            X = X * m["scale_range"][None, None, :] + m["scale_min"][None, None, :]
        return X


def make_handler(reg: ModelRegistry, serve_batch: int, time_chunk: int,
                 precision: str = "f32"):
    compute_dtype(precision)         # an unknown precision raises ValueError

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet access log to stdout
            print(f"[serve] {args[0] if args else ''}", flush=True)

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "runs": sorted(reg.models),
                                 "cgan": sorted(reg.cgan)})
            elif self.path == "/runs":
                self._json(200, {
                    "timegan": {
                        name: {"z_dim": m["cfg"].z_dim, "h_dim": m["cfg"].h_dim,
                               "x_dim": m["cfg"].x_dim, "fs": m["fs"],
                               "step": m["meta"].get("step"),
                               "has_scalers": m["scale_min"] is not None}
                        for name, m in reg.models.items()},
                    "cgan": {
                        name: {"arch": m["meta"].get("arch", "conv"),
                               "variant": m["meta"].get("variant", "v1"),
                               "num_classes": m["cfg"].num_classes,
                               "noise_dim": m["cfg"].noise_dim}
                        for name, m in reg.cgan.items()}})
            else:
                self._json(404, {"error": "unknown path"})

        # _post_cgan / _post_timegan return the windows, or None once they
        # have answered an error
        def _post_cgan(self, req):
            tag = req["model"]
            if tag not in reg.cgan:
                return self._json(404, {"error": f"unknown model {tag!r}",
                                        "models": sorted(reg.cgan)})
            n = int(req.get("n", 16))
            label = int(req.get("label", 0))
            cfg = reg.cgan[tag]["cfg"]
            if not (1 <= n <= 65536 and 0 <= label < cfg.num_classes):
                return self._json(400, {"error": "n or label out of range"})
            # cap on what is allocated: n padded to serve_batch multiples
            nb = -(-n // serve_batch) * serve_batch
            if nb * cfg.seq_len > MAX_SAMPLES_PER_REQUEST:
                return self._json(400, {
                    "error": f"padded n*seq_len = {nb * cfg.seq_len} > "
                             f"{MAX_SAMPLES_PER_REQUEST} (split into multiple "
                             "requests)"})
            return reg.synthesize_cgan(tag, label, n, int(req.get("seed", 0)),
                                       bool(req.get("inverse_scale", False)),
                                       serve_batch)

        def _post_timegan(self, req):
            run = req["run"]
            if run not in reg.models:
                return self._json(404, {"error": f"unknown run {run!r}",
                                        "runs": sorted(reg.models)})
            n = int(req.get("n", 16))
            seq_len = int(req.get("seq_len", 768))
            if not (1 <= n <= 65536 and 1 <= seq_len <= 1 << 20):
                return self._json(400, {"error": "n or seq_len out of range"})
            # cap on what synthesize actually allocates: both axes padded
            # up to the fixed (serve_batch, time_chunk) multiples
            nb = -(-n // serve_batch) * serve_batch
            tb = -(-seq_len // time_chunk) * time_chunk
            if nb * tb > MAX_SAMPLES_PER_REQUEST:
                return self._json(400, {
                    "error": f"padded n*seq_len = {nb * tb} > "
                             f"{MAX_SAMPLES_PER_REQUEST} "
                             "(split into multiple requests)"})
            return reg.synthesize(run, n, seq_len, int(req.get("seed", 0)),
                                  bool(req.get("denorm", False)),
                                  serve_batch, time_chunk, precision)

        def do_POST(self):
            if self.path not in ("/synthesize", "/synthesize_cgan"):
                return self._json(404, {"error": "unknown path"})
            try:
                req = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0)) or 0) or b"{}")
                post = (self._post_cgan if self.path == "/synthesize_cgan"
                        else self._post_timegan)
                X = post(req)
                if X is None:
                    return
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})
            if req.get("format", "npz") == "json":
                if X.size > MAX_JSON_ELEMENTS:
                    return self._json(400, {"error": "too large for json; use npz"})
                return self._json(200, {"shape": list(X.shape),
                                        "X": X.tolist()})
            buf = io.BytesIO()
            np.savez_compressed(buf, X=X)
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def make_server(reg: ModelRegistry, host: str, port: int, serve_batch: int,
                time_chunk: int, precision: str = "f32") -> ThreadingHTTPServer:
    """The HTTP server over ``reg`` (``port=0`` picks a free port)."""
    srv = ThreadingHTTPServer((host, port), make_handler(reg, serve_batch,
                                                         time_chunk, precision))
    srv.daemon_threads = True      # a hung client thread never blocks shutdown
    return srv


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--runs_dir", type=str, default="./timegan_runs")
    ap.add_argument("--real_dir", type=str, default="./preprocessed",
                    help="real buckets for fs/denorm scalers")
    ap.add_argument("--cgan_root", type=str, default=None,
                    help="also serve the CGAN generators (conv or "
                         "transformer) found under this root "
                         "(<root>/<tag>/CGAN_generator_<tag>_{best,last}.npz)")
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--prefer_latest", action="store_true")
    ap.add_argument("--serve_batch", type=int, default=256,
                    help="fixed batch; requests are padded/micro-batched")
    ap.add_argument("--time_chunk", type=int, default=768,
                    help="fixed sequence chunk for long requests")
    ap.add_argument("--precision", type=str, default="f32",
                    choices=["f32", "bf16"],
                    help="TimeGAN serving compute precision: bf16 runs the "
                         "cascade's projections in bfloat16 around K1's "
                         "float32 recurrences (f32 weights and outputs); the "
                         "CGAN route stays f32")
    ap.add_argument("--warmup", action="store_true",
                    help="build the kernels and run the serving shape for "
                         "every run at startup")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the models live and run; 'cuda' without a "
                         "card raises")
    args = ap.parse_args(argv)

    runs_dir = Path(args.runs_dir) if Path(args.runs_dir).is_dir() else None
    reg = ModelRegistry(runs_dir, Path(args.real_dir), args.prefer_latest,
                        device=args.device,
                        cgan_root=Path(args.cgan_root) if args.cgan_root else None)
    srv = make_server(reg, args.host, args.port, args.serve_batch,
                      args.time_chunk, args.precision)
    print(f"[serve] loaded {len(reg.models)} TimeGAN + {len(reg.cgan)} CGAN models "
          f"on {reg.device}: {sorted(reg.models) + sorted(reg.cgan)}", flush=True)
    if args.warmup:
        for name in reg.models:
            # one-shot and chunked shapes for every model
            reg.synthesize(name, 1, 2 * args.time_chunk, 0, False,
                           args.serve_batch, args.time_chunk, args.precision)
            print(f"[serve] warmed {name}", flush=True)
        for tag in reg.cgan:
            reg.synthesize_cgan(tag, 0, 1, 0, False, args.serve_batch)
            print(f"[serve] warmed cgan {tag}", flush=True)
    print(f"[serve] listening on http://{args.host}:{args.port}", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
