#!/usr/bin/env python3
"""Drive the port's main paths once on one CUDA card and check them: TimeGAN
synthesis serving, multi-bucket TimeGAN training and the eval of what it
synthesized, bf16 and long-horizon synthesis, sequential TimeGAN training
through the CLI, and CGAN training, serving and eval, transformer and conv.

Run from the repository root, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero, and no phase's
failure is swallowed):

1. device  — the card's name, torch / CUDA versions, name and power limit;
2. build   — nvcc builds every kernel under eegsynth_torch/csrc/, one
             process per source, in parallel; ptxas must report no spills
             for any instance of K1 forward or backward or of K2;
             cuobjdump -sass
             counts the
             HGMMA (wgmma) instructions of every K3a, K3b and K3c instance,
             the wide K3a, K3b and K3c (head dims past 128) included;
3. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes the main paths give it, with both times and its
             bound (FLOPs at the TF32 tensor-core rate or bytes at the HBM
             rate, the larger): K1 forward (serving and training shapes),
             K1 backward (the whole call and the kernel alone) and K2
             (training), K3a, K3b and K3c (the CGAN's 96- and 768-token
             geometries, the latter at serve_batch 256 too, a ragged T, a
             long T), K1 forward and backward at the eval scorers' H 24
             shapes and at the sequential trainer's (one bucket of B 64, T
             768 and 767); one PyTorch call computing the same function timed
             in turns with the kernel where there is one (cuDNN's GRU
             beside K1 forward and its backward beside K1 backward, at one
             bucket, memory-efficient SDPA's forward beside K3a and its
             backward beside K3b + K3c); dense attention
             beside K3a; the wide kernels (head dims past 128, all three on
             the tensor cores) the same way at head dim 256, 160 and a
             ragged 131, the wide K3a's share of its split-TF32 ceiling
             beside its share of the bound; dq
             and dk at one key (T = 1) against float64, in units of the
             terms that cancel there; "auto" attention (the tensor-core
             kernels at head dim 64, the wide ones at 160); the D-step
             inputs' composed route (3 K1 forward launches and products)
             timed in turns with K2's route at z28/h56 and z40/h80;
4. serve   — two full-width TimeGAN runs (x14/z28/h56, random weights from a
             seed) served over HTTP by eegsynth_torch.serve at
             serve_batch 256 / time_chunk 768; launch counts, seeded
             repeatability, denorm; then a per-layer breakdown of one
             request (host clock, and torch.profiler for the card's busy
             share), card-vs-CPU and chunked-vs-one-shot checks;
5. train   — train_all_buckets on 18 random buckets of (63, 768, 14)
             (x14/z28/h56, the settings of configs/timegan_config.json with
             1 AE epoch, 1 SUP epoch and 4 GAN steps); artifacts, finite
             losses, every ckpt_best served back, the launch counts of K1
             forward, K1 backward and K2 against their expected counts, the
             median GAN-step time; the same on 2 buckets of (63, 768, 20)
             (z40/h80, its D-step inputs through K2 as well) for 2 GAN
             steps; then one GAN step
             against the CPU plain path at 14 and at 20 channels, and a
             per-layer split and profiler line of one GAN step;
5b. eval   — run_timegan_eval (by condition) of the 18 trained buckets
             and their synthetic.npz: 18 pairs and the global corpus, the
             GRU(24) scorers on K1 forward and backward (the launch counts
             against their expected counts), the CSVs checked, the time
             split; one scorer stack and one pair's statistics on the card
             against the CPU;
5d. synth-bf16 — bf16 against f32 synthesis of a full-width random
             TimeGAN on the same noise at bench.py's shape (n 2048 x 768)
             and the long horizon (n 512 x 8192 one-shot, n 256 x 8192 in
             chunks of 1024): the cascade's times in turns, synthesize()
             with its device->host copy, K1 forward's launches a chunk, the
             bounds of JAX's own bf16 test, chunked bf16 against one-shot,
             the card's split between K1 and the rest; a --precision bf16
             server over HTTP against in-process bf16 synthesis;
             generate_long_synth on the 18 trained runs at --gen_len 8192
             --time_chunk 1024 --denorm (files, launches, the first run
             against synthesize + denorm, the eval picks each file);
5c. train-seq — the CLI ``python -m eegsynth_torch.train.timegan`` in
             this process: one bucket of (100, 768, 14) for 3 GAN steps at
             chunk 2, resumed to 5 (log rows under one header, ckpt_latest's
             step and optimizer count, synthetic.npz), then 2 layers with
             dropout (K1 only); each run's launch counts against their
             expected counts; one GAN step of the 2-layer stack with dropout
             masks against the CPU plain path; the GAN step rate at nb 1,
             B 64 and K2 against the composed route there; the stacked
             trainer's --ckpt_every and --resume on 2 buckets, the resumed
             log bit-identical to the uninterrupted one;
6. cgan    — train_one_condition (v1) at the JAX defaults (dim 256, depth 4,
             heads 4, patch 8, batch 64) on 9 random posture buckets for 2
             epochs with flash attention forced; artifacts, finite
             metrics.csv, the K3 launch counts per step; one CGAN step
             against the CPU plain path; a patch-1 generator served over
             /synthesize_cgan with "auto" attention (K3a launches, X against
             the CPU plain generator); a per-layer split and profiler line of
             one CGAN step; then a transformer CGAN of dim 512 with 2 heads
             (head dim 256) at patch 1 (768 tokens), batch 8, trained 1 epoch
             with "auto" attention: the wide kernels' launch counts;
6b. cgan-conv — the conv CGAN (arch "conv", the JAX default) at the JAX
             defaults: train_one_condition (v1) for 2 epochs at batch 64 on 9
             random posture buckets of 64 windows (R1 at steps 0 and 8), its
             8 artifacts, finite metrics.csv, the generator files' bn the
             trainer's, the best generator reloaded; 1 epoch with
             precision_d="bf16" (finite logs, every parameter and optimizer
             leaf float32); train_one_posture (v2) with 1 prewarm epoch and
             1 epoch; the trained generator served over /synthesize_cgan (n
             256) against the CPU generator, the seeded request repeated; one
             v1 step (R1 on) and one v2 step (keep masks) at B 8 on the card
             against the CPU; the warm step time at B 64 in f32 and bf16
             (median of the second of two 9-step epochs), a per-layer split
             and the card's busy share over one step; no hand kernel (K1, K2,
             K3) launches in the phase: the convolutions are cuDNN's;
6c. cgan-eval — inside 6b, on its runs: python -m
             eegsynth_torch.eval.cgan_drivers condition (v1, 400 generated
             windows a posture) and posture (v2, posture 1), the CSVs
             checked, the time split into generation, features, fits and
             statistics; the three metric functions on the card against
             the CPU.

The last three lines are a JSON object listing each kernel (its launches in
the main paths' runs, its error against the plain version, its time, the
plain version's, its bound and what bounds it, and the library call's time
or null),
the nvidia-smi name and power-limit line, and ``{"ok": true, "device": ...}``.
Imports no JAX.
"""

from __future__ import annotations

import csv
import dataclasses
import http.client
import io
import json
import re
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
from eegsynth_torch.convert import from_jax_params, to_jax_params, tree_to_numpy
from eegsynth_torch.data.datasets import load_condition_dataset
from eegsynth_torch.eval import cgan_eval
from eegsynth_torch.eval.cgan_drivers import main as cgan_eval_cli
from eegsynth_torch.eval.classifiers import _run_grouped as eval_run_grouped
from eegsynth_torch.eval.classifiers import discriminative_task
from eegsynth_torch.eval.drivers import (
    find_synth_npz, load_pairs_by_condition, run_timegan_eval,
)
from eegsynth_torch.eval.features import psd_features_tensor
from eegsynth_torch.eval.stats import statistical_similarity
from eegsynth_torch.generate_long_synth import main as generate_long_synth_cli
from eegsynth_torch.models.cgan_transformer import generator_apply as cgan_generator_apply
from eegsynth_torch.models.timegan import (
    TimeGAN, TimeGANConfig, adaptive_dims, encode, fused_disc_inputs, gen_latent,
    params_tree, refine_latent, sample_noise, timegan_init_stacked,
)
from eegsynth_torch.nn.attention import (
    attention_dense, flash_dkv, flash_dkv_plain, flash_dq, flash_dq_plain,
    flash_forward, flash_forward_plain, mha, set_attention_impl,
)
from eegsynth_torch.nn.gru_sequence import (
    forward_tile, gru_sequence, gru_sequence_bwd, gru_sequence_bwd_recurrence,
    gru_sequence_bwd_reference, gru_sequence_reference,
)
from eegsynth_torch.nn.layers import xavier_uniform
from eegsynth_torch.nn.multigru import (
    k2_tile, multigru_disc_inputs, multigru_disc_inputs_reference,
)
from eegsynth_torch.nn.precision import cast_floating
from eegsynth_torch.serve import ModelRegistry, make_server
from eegsynth_torch.train import cgan as cgan_train
from eegsynth_torch.train.checkpoint import load_checkpoint, save_checkpoint
from eegsynth_torch.train.optim import make_gan_opts
from eegsynth_torch.train.timegan import (
    CONFIG_KEYS, GEN_NETS, LOG_COLUMNS, TimeGANHParams, draw_gan, draw_gan_masks,
    gan_step, gather_batch, synthesize, synthesize_from_noise,
)
from eegsynth_torch.train.timegan import main as timegan_cli
from eegsynth_torch.train.timegan_multi import train_all_buckets
from eegsynth_torch.tree import tree_leaves, tree_map

SERVE_BATCH, TIME_CHUNK = 256, 768
KERNEL_TOL = 1e-4      # f32, another summation order, up to 1024 dependent steps
CASCADE_TOL = 1e-4     # card vs CPU plain path, full cascade at the serving width
CHUNK_TOL = 1e-5       # chunked vs one-shot on the card (same kernel, same order;
                       # only cuBLAS's choice for the hoisted products may differ)
# (nb, T, B, H, input): the serving width (generator / supervisor / recovery
# recurrence, nb = 1), the embedder-sized H = 28, a ragged batch at the H cap,
# the training shape: 18 buckets of B 63; then the eval's GRU(24) scorers
# (EVAL_SHAPES, nb = scorers in one stack, B = their training rows)
# Eval, 18 buckets of 63 windows of (768, 14): the discriminative stacks
# (18 pairs of 88 training rows, the global corpus's 1587) and the
# predictive ones (36 TSTR / TRTS tasks of 63 rows at T 767, the global 2 of
# 1134)
EVAL_SHAPES = ((18, 768, 88, 24, 14), (1, 768, 1587, 24, 14),
               (36, 767, 63, 24, 14), (2, 767, 1134, 24, 14))
# The sequential trainer (one bucket, B 64): every G/S/R recurrence at T 768,
# the supervisor's at T 767 (SEQ_SHAPES, also for the backward)
SEQ_SHAPES = ((1, 768, 64, 56), (1, 767, 64, 56))
KERNEL_SHAPES = ((1, 768, 256, 56, 28), (1, 768, 256, 28, 14),
                 (1, 1024, 37, 128, 28), (18, 768, 63, 56, 28), *EVAL_SHAPES,
                 *((*shape, 28) for shape in SEQ_SHAPES))
# K1 forward's and backward's instances (k-slice KL, lanes S a dot product,
# largest H): KL 16 with S 1, 2, 4 up to H 64, KL 32 with S 4 up to H 96,
# KL 64 with S 2 up to H 128
K1_INSTANCES = ("KL 16, S 1, H <= 16", "KL 16, S 2, H <= 32", "KL 16, S 4, H <= 64",
                    "KL 32, S 4, H <= 96", "KL 64, S 2, H <= 128")
# K1 backward at the training shapes: the G/S/R width, the embedder's H 28,
# a ragged (nb 3, T 1024, B 37, H 128), and the eval's; cuDNN's GRU backward
# computes the same function at one bucket of the first (BWD_CUDNN_SHAPE)
# and at the eval's shape of nb 1
BWD_SHAPES = ((18, 768, 63, 56), (18, 768, 63, 28), (3, 1024, 37, 128),
              *(shape[:4] for shape in EVAL_SHAPES), *SEQ_SHAPES)
BWD_CUDNN_SHAPE = (1, 768, 63, 56)
# K2 (nb, T, B, (He, Hg, Hs, Z)): the reference dims (the headline), and
# adaptive_dims' T > 800 dims z36/h72, 20 channels' z40/h80, the widest
# width z64/h128, a ragged narrow shape at z16/h32, and the sequential
# trainer's one bucket of B 64
MULTIGRU_SHAPES = ((18, 768, 63, (28, 56, 56, 28)), (18, 1024, 63, (36, 72, 72, 36)),
                   (18, 768, 63, (40, 80, 80, 40)), (18, 1024, 63, (64, 128, 128, 64)),
                   (3, 50, 7, (16, 32, 32, 16)), (1, 768, 64, (28, 56, 56, 28)))
# K3 (B, H, T, D): the transformer CGAN's training geometry (96 tokens at
# patch 8), its patch-1 geometry (768 tokens) at the training batch and at
# serve_batch 256, a ragged T with an odd D, and a long T
ATTN_SHAPES = ((64, 4, 96, 64), (64, 4, 768, 64), (256, 4, 768, 64), (2, 3, 200, 48),
               (8, 4, 4096, 64))
# One H100 SXM (NVIDIA's data sheet, 700 W): dense TF32 tensor-core FLOP/s,
# the fastest the card multiplies float32 inputs, and HBM3 bytes/s. Every
# kernel's bound uses both, whatever unit the kernel itself runs on.
PEAK_FLOPS, PEAK_BYTES = 495e12, 3.35e12
ATTN_HEADLINE = (64, 4, 768, 64)   # the shape of the kernels line's K3 rows
ATTN_FWD_TOL = 1e-5    # o and lse, absolute: f32 sums in another order
ATTN_BWD_RTOL = 1e-4   # dq, dk, dv, relative to the largest magnitude: sums
                       # of up to 4096 terms in another order
# The wide kernels (D > 128, all on the tensor cores: K3a in
# flash_attn_wide.cu, K3b and K3c in flash_attn_wide_bwd.cu): head dim 256
# (a transformer CGAN of dim 512 with 2 heads, patch 1: 768 tokens, batch
# 64; the headline of their rows), the "auto" shape at head dim 160, a
# ragged T with an odd D
WIDE_ATTN_SHAPES = ((64, 2, 768, 256), (1, 2, 512, 160), (2, 3, 77, 131))
# One key (T = 1): the softmax's gradient is zero and dq, dk are what is left
# of dp - delta, rounding noise that the tensor cores' split-TF32 sums do not
# share with the plain version's float32 product. There dq and dk are held
# to their function in float64 on the same inputs, within T1_RTOL of the
# size of the terms that cancel (sum_d |do_d v_d| times scale times |k| or
# |q|), as in tests/test_torch_card.py. T1_RTOL is 3.8 times the largest
# such error measured on an H100 (1.315e-7, K3b at D 128; the plain float32
# version's errors were up to 1.5e-8; PERF.md). D 160 and 256 run the wide
# K3b and K3c, whose sums over D are taken chunk by chunk
T1_SHAPES = ((1, 1, 1, 16), (1, 2, 1, 64), (2, 2, 1, 128), (1, 2, 1, 160),
             (1, 2, 1, 256))
T1_RTOL = 5e-7
# Training: 18 buckets (9 postures x 2 conditions) of 63 random windows
N_BUCKETS, N_WINDOWS, SEQ_LEN, CHANNELS = 18, 63, 768, 14
GAN_STEPS = 4
# The eval of the trained buckets: the scorers' epochs (the JAX package's
# defaults), its CSVs' metric columns in the JAX package's order, and the
# card against the CPU: a scorer stack's logits after 2 epochs (f32 over 768
# steps, as KERNEL_TOL), Welch and the correlations relative (f32 sums in
# another order), the ACF (float64 on the host in both)
EVAL_DISC_EPOCHS, EVAL_PRED_EPOCHS = 20, 50
EVAL_METRIC_COLS = ["disc_acc", "disc_auc", "rmse_tstr", "r2_tstr", "rmse_trts",
                    "r2_trts", "psd_diff", "acf_diff", "coh_diff",
                    "n_real", "n_fake", "seq_len", "n_ch"]
EVAL_LOGIT_TOL, EVAL_STAT_RTOL, EVAL_ACF_TOL = 1e-4, 1e-5, 1e-10
# The sequential trainer ([train-seq]): one bucket of 100 windows, so B 64
# leaves a padded second batch in each AE and SUP epoch; the CLI for one
# warm-up and 5 timed GAN steps at chunk 2, resumed to 9 (a short last
# chunk); a 2-layer run with dropout; one GAN step of that stack at B 8
# on the card against the CPU; the stacked trainer's ckpt_every / resume
# on 2 buckets (the state saved at step 2 of 3)
SEQ_WINDOWS, SEQ_BATCH, SEQ_RATE_STEPS, SEQ_RESUME_STEPS = 100, 64, 5, 9
SEQ_GAN_STEPS = 1 + SEQ_RATE_STEPS
SEQ_LAYERS_STEPS, SEQ_CHECK_BATCH = 2, 8
# bf16 synthesis ([synth-bf16]): bench.py's synthesis shape (n 2048 x 768,
# one-shot) and the long horizon (n 512 x 8192 one-shot, n 256 x 8192 in
# chunks of 1024), each in bf16 and in f32 on the same noise. bf16 is held
# to f32 by tests/test_precision.py's bounds on JAX's own bf16 (correlation
# over 0.999, max |diff| under 0.05), and so is a chunked bf16 run to the
# one-shot one (its carried states are K1's float32 rows; only cuBLAS's
# bfloat16 products may differ across shapes). generate_long_synth runs on
# [train]'s 18 runs at the long horizon.
SYNTH_SHAPES = ((2048, 768, None), (512, 8192, None), (256, 8192, 1024))
BF16_CORR, BF16_MAX = 0.999, 0.05
LONG_LEN, LONG_CHUNK = 8192, 1024
# Wide data: 20 channels give adaptive_dims' z40/h80 (K2's instance with KL
# 32); a short run of 2 buckets
WIDE_CHANNELS, WIDE_BUCKETS, WIDE_GAN_STEPS = 20, 2, 2
# One GAN step, card against the CPU plain path, on the same parameters and
# draws. Logged values: 1e-4 relative (f32 sums in another order over 768
# steps, in K1, K2 and the reductions). Parameters after the update: 2e-4
# absolute, a fifth of lr_g: Adam's first update is lr·g/(|g| + 1e-8), so a
# gradient within rounding error of zero may land anywhere in ±lr·|g|/1e-8.
# The optimizers' first moments after the step, (1 − b1)·g: 1e-3 of each
# leaf's largest magnitude. Unlike the parameters, they scale with |g|, so a
# gradient that is wrong in magnitude but right in sign shows here.
STEP_LOG_RTOL, STEP_PARAM_ATOL, STEP_MU_RTOL = 1e-4, 2e-4, 1e-3
# Transformer CGAN (v1) at the JAX defaults: dim 256, depth 4, heads 4,
# patch 8 (96 tokens), batch 64; 9 posture buckets of 64 random windows give
# 9 steps per epoch, so R1 fires at steps 0 and 8. The generator's attention
# is forced to flash: per step 8 K3a (4 blocks x the D step's and the G
# step's forward), 4 K3b and 4 K3c (the G step's backward); the
# discriminator launches none.
CGAN_WINDOWS, CGAN_EPOCHS = 64, 2
CGAN_K3 = (8, 4, 4)
# Head dim 256 (dim 512, 2 heads) at patch 1: 9 buckets of 8 windows, batch
# 8, one epoch of 9 steps; "auto" takes the wide kernels at 768 tokens
CGAN_WIDE_BATCH = 8
# One CGAN step on the card against the CPU plain path (B 8, full width):
# logs 1e-4 relative. For each parameter leaf, Adam's first moments (the
# gradients) within 1e-4 of the larger of the leaf's largest and 1, and
# within CGAN_MU_RTOL of the leaf's own largest: the transformer's step
# departs from its float64 step by a few 1e-6 of that, the conv step by
# some 1e-4 (float32 conditioning; the check prints both), so the conv
# model's bound is CGAN_CONV_MU_RTOL. Parameters within 1e-5, except
# elements whose sign is not held (Adam's first step moves them by about
# lr·sign(g) whatever their size): a gradient at rounding level (|g| <=
# 1e-5) or, in the conv model, within the moments' tolerance of zero. At
# most CGAN_EXCUSED_SHARE of a leaf may be excused so, unless its whole
# gradient is at rounding level on the card and on the CPU: a leaf whose
# gradient is zero by construction (a conv bias ahead of a train-mode batch
# norm, an attention key bias), named in the output.
CGAN_LOG_RTOL, CGAN_MU_RTOL, CGAN_CONV_MU_RTOL = 1e-4, 1e-4, 1e-3
CGAN_PARAM_ATOL, CGAN_GRAD_FLOOR, CGAN_EXCUSED_SHARE = 1e-5, 1e-5, 1e-2
# The conv generator's bn running statistics after that step: 1e-5 absolute
# (O(1) values, means over B·L of float32 convolutions in another order)
CGAN_BN_ATOL = 1e-5
# The conv CGAN ([cgan-conv]) at the JAX defaults' batch, on CGAN_WINDOWS
# windows a posture bucket
CGAN_CONV_BATCH = 64
# The CGAN eval ([cgan-eval]) on [cgan-conv]'s runs: the v1 CLI on one
# condition at the scripts' default 400 generated windows a posture (against
# its CGAN_WINDOWS real ones), the v2/v3 CLI per posture ("match"). Then
# the metric functions on the card against the CPU on CGAN_WINDOWS
# generated windows a posture: accuracy within one test row and AUC within
# 1e-3 (the same float64 Newton fit on features that differ by float32 FFT
# rounding), the predictive and statistics rows within 1e-5 relative and
# 1e-6 absolute (float32 FFTs, float64 fits)
CGAN_EVAL_SAMPLES, CGAN_EVAL_AUC_TOL = 400, 1e-3
CGAN_EVAL_RTOL, CGAN_EVAL_ATOL = 1e-5, 1e-6
# Serving: a patch-1 generator (768 tokens, so "auto" takes K3a) at
# serve_batch 256; the card's X against the CPU plain generator on the same
# noise for the first rows
CGAN_SERVE_TOL, CGAN_SERVE_CHECK_ROWS = 1e-4, 32


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
            if any(k in line for k in ("entry function", "registers", "spill", "smem",
                                       "Performance Loss")):
                print(f"[build] {line.strip()}", flush=True)
    report = log.read_text() if log.exists() else ""
    for kernel in ("gru_seq_fwd_kernel", "gru_seq_bwd_kernel", "multigru_fwd_kernel"):
        _check_spills(kernel, report)


def _check_spills(kernel: str, report: str) -> None:
    """K1 forward and backward and K2 hold W_hh^T (or its rows) in
    registers: every instance of ``kernel`` (KL, S, largest width) in
    ptxas's report must show no spill stores or loads, and all
    K1_INSTANCES (K2 has the same five) must be there."""
    spills: dict[str, tuple[int, int]] = {}
    name = None
    for line in report.splitlines():
        m = re.search(rf"Function properties for \S*{kernel}ILi(\d+)ELi(\d+)ELi(\d+)E", line)
        if m:
            name = f"KL {m.group(1)}, S {m.group(2)}, H <= {m.group(3)}"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills[name] = (int(m.group(1)), int(m.group(2)))
            name = None
    print(f"[build] {kernel} spill stores / loads (bytes): " + ", ".join(
        f"{k}: {v[0]} / {v[1]}" for k, v in sorted(spills.items())), flush=True)
    if sorted(spills) != sorted(K1_INSTANCES) or any(any(v) for v in spills.values()):
        fail(f"{kernel}: instances missing or spilling: {spills} "
             f"(expected {K1_INSTANCES}, no spills)")


def phase_sass() -> None:
    """The HGMMA (wgmma) instructions of every instance of the tensor-core
    flash kernels K3a, K3b and K3c, and of the wide K3a, K3b and K3c, in
    the built library, from ``cuobjdump -sass``: each instance must have
    some, or its products do not run on the tensor cores."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts: dict[str, dict[int, int]] = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(flash_(?:fwd|dq|dkv)_kernel)ILi(\d+)E", line)
            wide = re.search(r"(flash_(?:fwd|dq|dkv)_wide_tc_kernel)", line)
            name = ((m.group(1), int(m.group(2))) if m else
                    (wide.group(1), 0) if wide else None)
            if name:
                counts.setdefault(name[0], {})[name[1]] = 0
        elif name and "HGMMA" in line:
            counts[name[0]][name[1]] += 1
    for kernel in ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"):
        per_dp = counts.get(kernel, {})
        print(f"[sass] {kernel} HGMMA per instance: " + ", ".join(
            f"DP {dp}: {n}" for dp, n in sorted(per_dp.items())), flush=True)
        if sorted(per_dp) != [16, 32, 64, 128] or not all(per_dp.values()):
            fail(f"{kernel}: instances without HGMMA or missing: {per_dp}")
    for kernel in ("flash_fwd_wide_tc_kernel", "flash_dq_wide_tc_kernel",
                   "flash_dkv_wide_tc_kernel"):
        n = counts.get(kernel, {}).get(0, 0)
        print(f"[sass] {kernel} (head dims past 128) HGMMA: {n}", flush=True)
        if not n:
            fail(f"{kernel}: missing or without HGMMA")


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


def _turns_ms(kernel, library, reps: int) -> tuple[float, float]:
    """Kernel and library call timed in turns (library, kernel, kernel,
    library), each a median of ``reps``; returns the mean of each pair."""
    lib = [_time_ms(library, reps)]
    ker = [_time_ms(kernel, reps), _time_ms(kernel, reps)]
    lib.append(_time_ms(library, reps))
    return statistics.mean(ker), statistics.mean(lib)


def _bound(flops: float, *tensors: torch.Tensor) -> tuple[float, str]:
    """The least time the card could take for a function: the larger of its
    FLOPs at the dense TF32 tensor-core rate and its bytes (``tensors``: each
    input read once, each output written once) at the HBM rate. Returns
    (ms, "operations" or "bytes")."""
    ops_ms = flops / PEAK_FLOPS * 1e3
    bytes_ms = sum(t.numel() * t.element_size() for t in tensors) / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _row(ms, plain_ms, bound, library_ms=None) -> dict:
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def _roofline(name: str, row: dict, smi: str, library: str | None = None) -> None:
    lib = (f"; library {library} {row['library_ms']:.4f} ms"
           if row["library_ms"] is not None else "; no single library call")
    print(f"[bound] {name}: kernel {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}), {100 * row['bound_ms'] / row['ms']:.1f} % of the "
          f"bound{lib} | {smi}", flush=True)


def _gru_inputs(nb, T, B, H, I, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.rand((nb, T, B, I), generator=g)
    w_ih = xavier_uniform((nb, 3 * H, I), g)
    w_hh = xavier_uniform((nb, 3 * H, H), g)
    b_ih = 0.1 * torch.randn(nb, 1, 1, 3 * H, generator=g)
    b_hh = 0.1 * torch.randn(nb, 1, 3 * H, generator=g)
    h0 = torch.rand((nb, B, H), generator=g) - 0.5
    xp = torch.matmul(x, w_ih.transpose(1, 2).unsqueeze(1)) + b_ih
    return [t.to(device).contiguous() for t in (xp, w_hh.transpose(1, 2), b_hh, h0)]


def phase_kernels(smi: str) -> dict:
    """Every kernel against its plain version at the main paths' shapes.
    Returns, per kernel, the largest error and the times at its headline
    shape (K1 forward: the serving shape; the others: the training shape)."""
    return {"gru_sequence": _check_k1_fwd(smi), "gru_sequence_bwd": _check_k1_bwd(smi),
            "multigru_disc_inputs": _check_k2(smi), **_check_k3(smi),
            **_check_k3_wide(smi)}


def _cudnn_gru_module(w_hh_t, b_hh) -> torch.nn.GRU:
    """cuDNN's GRU computing K1's function: input weight I₃ₕ and zero input
    bias, so its input is xp itself; W_hh and b_hh as K1's. It runs under the
    port's allow_tf32 = False. Timed beside K1, never used by the port."""
    H = w_hh_t.shape[0]
    gru = torch.nn.GRU(3 * H, H).to(w_hh_t.device)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.eye(3 * H))
        gru.bias_ih_l0.zero_()
        gru.weight_hh_l0.copy_(w_hh_t.t())
        gru.bias_hh_l0.copy_(b_hh.reshape(-1))
    gru.flatten_parameters()
    return gru


def _cudnn_gru(xp, w_hh_t, b_hh, h0):
    """One cuDNN GRU call computing K1's ys."""
    gru = _cudnn_gru_module(w_hh_t, b_hh)
    return lambda: gru(xp, h0[None])[0]


def _check_k1_fwd(smi: str) -> dict:
    """K1 forward at each of KERNEL_SHAPES against the plain version, with
    its bound; at one bucket (nb 1, the unstacked call) cuDNN's GRU in turns
    beside it. The kernels line takes the first (serving) shape."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    head = None
    worst = 0.0
    for i, (nb, T, B, H, I) in enumerate(KERNEL_SHAPES):
        args = _gru_inputs(nb, T, B, H, I, seed=i, device="cuda")
        if nb == 1:
            args = [a[0] for a in args]         # the serving path's unstacked call
        lib_ms = None
        with torch.inference_mode():
            got = gru_sequence(*args)
            ref = gru_sequence_reference(*args)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if nb == 1:
                cudnn = _cudnn_gru(*args)
                lib_err = (cudnn() - got).abs().max().item()
                ms, lib_ms = _turns_ms(lambda: gru_sequence(*args), cudnn, reps=20)
            else:
                ms = _time_ms(lambda: gru_sequence(*args), reps=20)
            plain_ms = _time_ms(lambda: gru_sequence_reference(*args), reps=3)
        finite = bool(torch.isfinite(got).all())
        tile = forward_tile(nb, B, H)
        blocks = tile["blocks"] * nb
        print(f"[kernel] gru_sequence nb={nb} T={T} B={B} H={H} in={I}: "
              f"max|diff|={err:.3e} (tol {KERNEL_TOL:g}) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, tile {tile['rows']} rows x "
              f"{tile['blocks']} tiles x {nb} buckets = {blocks} blocks of "
              f"{tile['threads']} threads, KL {tile['kl']}, S {tile['s']}, "
              f"{tile['smem']} B shared; {'one wave' if blocks <= sms else 'past one wave'} "
              f"on {sms} SMs | {smi}", flush=True)
        if not finite or err > KERNEL_TOL:
            fail(f"gru_sequence disagrees with its plain version at "
                 f"nb={nb} T={T} B={B} H={H}: max|diff|={err} finite={finite}")
        worst = max(worst, err)
        row = _row(ms, plain_ms, _bound(2 * nb * T * B * H * 3 * H, *args, got), lib_ms)
        if nb == 1:
            print(f"[kernel] gru_sequence nb={nb} T={T} B={B} H={H} vs cuDNN GRU "
                  f"(nn.GRU, input weight I): max|diff|={lib_err:.3e}, cuDNN "
                  f"{lib_ms:.4f} ms, K1 {ms:.4f} ms (in turns) | {smi}", flush=True)
        _roofline(f"gru_sequence nb={nb} T={T} B={B} H={H}", row, smi,
                  "cuDNN GRU" if nb == 1 else None)
        head = head or row
    return {"max_abs_err": worst, **head}


def _bwd_kernel_alone(args, ys, d_ys):
    """One launch of K1's backward kernel, as the wrapper feeds it (hp from
    the batched product, h_prev), but writing dhp to a buffer of its own so
    that hp stays intact from one timed launch to the next."""
    xp, w_hh_t, b_hh, h0 = args
    nb, T, B, H = ys.shape
    h_prev = torch.cat([h0.unsqueeze(1), ys[:, :T - 1]], dim=1).reshape(nb, T * B, H)
    hp = torch.matmul(h_prev, w_hh_t)
    dhp = torch.empty_like(hp)
    return lambda: gru_sequence_bwd_recurrence(xp, hp, h_prev, d_ys, w_hh_t, b_hh, dhp)


def _bwd_errors(got, ref) -> tuple[list[float], list[float], bool]:
    """dxp and dh0 within KERNEL_TOL; dW and db within KERNEL_TOL of their
    largest magnitude (sums over T·B rows)."""
    errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
    scale = [max(1.0, r.abs().max().item()) for r in ref]
    ok = (all(bool(torch.isfinite(g).all()) for g in got) and errs[0] <= KERNEL_TOL
          and errs[3] <= KERNEL_TOL and errs[1] <= KERNEL_TOL * scale[1]
          and errs[2] <= KERNEL_TOL * scale[2])
    return errs, scale, ok


def _cudnn_gru_bwd(xp, w_hh_t, b_hh, h0, d_ys):
    """cuDNN's GRU backward computing K1's backward at one bucket: the GRU of
    _cudnn_gru_module, run once, then one autograd.grad on xp, W_hh, b_hh
    and h0 per call (cuDNN also forms the input weight's gradient, a 3H x 3H
    product over T·B rows, that K1's backward has no need of). Returns the
    call and a map of its gradients to K1's layouts."""
    gru = _cudnn_gru_module(w_hh_t, b_hh)
    x = xp.detach().requires_grad_()
    h = h0[None].detach().requires_grad_()
    out = gru(x, h)[0]
    leaves = [x, gru.weight_hh_l0, gru.bias_hh_l0, h]

    def as_k1(g):
        return g[0][None], g[1].t()[None], g[2].reshape(1, 1, -1), g[3]

    return lambda: torch.autograd.grad(out, leaves, d_ys, retain_graph=True), as_k1


def _check_k1_bwd(smi: str) -> dict:
    """At each of BWD_SHAPES the whole backward (the hp product, the kernel,
    the dW product and the db sum) and the kernel alone, against the plain
    backward, with its bound; then the whole backward at one bucket
    (BWD_CUDNN_SHAPE and the shapes of nb 1) against cuDNN's GRU backward,
    in turns. The kernels line takes the first shape."""
    head = None
    worst = 0.0
    for i, (nb, T, B, H) in enumerate(BWD_SHAPES):
        args = _gru_inputs(nb, T, B, H, 28, seed=10 + i, device="cuda")
        with torch.no_grad():
            ys = gru_sequence(*args)
            d_ys = torch.randn(ys.shape, generator=torch.Generator().manual_seed(i))
            d_ys = d_ys.cuda()
            got = gru_sequence_bwd(*args, ys, d_ys)
            ref = gru_sequence_bwd_reference(*args, ys, d_ys)
            torch.cuda.synchronize()
            errs, scale, ok = _bwd_errors(got, ref)
            ms = _time_ms(lambda: gru_sequence_bwd(*args, ys, d_ys), reps=10)
            kernel_ms = _time_ms(_bwd_kernel_alone(args, ys, d_ys), reps=10)
            plain_ms = _time_ms(lambda: gru_sequence_bwd_reference(*args, ys, d_ys),
                                reps=3)
        print(f"[kernel] gru_sequence_bwd nb={nb} T={T} B={B} H={H}: "
              f"max|diff| dxp {errs[0]:.3e} dh0 {errs[3]:.3e} (tol {KERNEL_TOL:g}); "
              f"dW {errs[1]:.3e} of {scale[1]:.3g}, db {errs[2]:.3e} of "
              f"{scale[2]:.3g} (tol {KERNEL_TOL:g} relative); whole call (hp product, "
              f"kernel, dW product, db sum) {ms:.4f} ms, kernel alone {kernel_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms | {smi}", flush=True)
        if not ok:
            fail(f"gru_sequence_bwd disagrees with its plain version at nb={nb} "
                 f"T={T} B={B} H={H}: {errs} finite="
                 f"{all(bool(torch.isfinite(g).all()) for g in got)}")
        worst = max(worst, errs[0], errs[3])
        # three products: hp, dh·W_hh, dW
        row = _row(ms, plain_ms, _bound(3 * 2 * nb * T * B * H * 3 * H, *args,
                                        ys, d_ys, *got))
        _roofline(f"gru_sequence_bwd nb={nb} T={T} B={B} H={H}", row, smi)
        head = head or row
    _k1_bwd_vs_cudnn(smi, BWD_CUDNN_SHAPE, 13)
    for i, shape in enumerate(BWD_SHAPES):
        if shape[0] == 1:
            _k1_bwd_vs_cudnn(smi, shape, 20 + i)
    return {"max_abs_err": worst, **head}


def _k1_bwd_vs_cudnn(smi: str, shape: tuple, seed: int) -> None:
    """K1's whole backward at one bucket against cuDNN's GRU backward on the
    same inputs, in turns; both held to the plain backward."""
    nb, T, B, H = shape
    args = _gru_inputs(nb, T, B, H, 28, seed=seed, device="cuda")
    with torch.no_grad():
        ys = gru_sequence(*args)
        d_ys = torch.randn(ys.shape,
                           generator=torch.Generator().manual_seed(seed)).cuda()
        ref = gru_sequence_bwd_reference(*args, ys, d_ys)
        got = gru_sequence_bwd(*args, ys, d_ys)
    cudnn, as_k1 = _cudnn_gru_bwd(*(a[0] for a in args), d_ys[0])
    lib_errs = _bwd_errors(as_k1(cudnn()), ref)[0]
    errs, _, ok = _bwd_errors(got, ref)
    with torch.no_grad():
        ms, lib_ms = _turns_ms(lambda: gru_sequence_bwd(*args, ys, d_ys), cudnn, reps=10)
    print(f"[kernel] gru_sequence_bwd nb={nb} T={T} B={B} H={H} vs cuDNN GRU backward "
          f"(autograd.grad on xp, W_hh, b_hh, h0; cuDNN also forms dW_ih): K1 whole call "
          f"{ms:.4f} ms, cuDNN {lib_ms:.4f} ms (in turns); max|diff| against the plain "
          f"backward: K1 dxp {errs[0]:.3e} dh0 {errs[3]:.3e}, cuDNN dxp {lib_errs[0]:.3e} "
          f"dh0 {lib_errs[3]:.3e} | {smi}", flush=True)
    if not ok:
        fail(f"gru_sequence_bwd disagrees with its plain version at nb={nb} T={T} "
             f"B={B} H={H}: {errs}")


def _multigru_inputs(nb, T, B, dims, seed):
    He, Hg, Hs, Z = dims
    g = torch.Generator().manual_seed(seed)

    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=g) * sc).cuda()

    weights = [r(nb, He, 3 * He, sc=He ** -0.5), r(nb, 3 * He, sc=0.1),
               r(nb, Hg, 3 * Hg, sc=Hg ** -0.5), r(nb, 3 * Hg, sc=0.1),
               r(nb, Hg, Z, sc=Hg ** -0.5), r(nb, Z, sc=0.1),
               r(nb, Z, 3 * Hs, sc=Z ** -0.5), r(nb, 3 * Hs, sc=0.1),
               r(nb, Hs, 3 * Hs, sc=Hs ** -0.5), r(nb, 3 * Hs, sc=0.1),
               r(nb, Hs, Z, sc=Hs ** -0.5), r(nb, Z, sc=0.1)]
    return [r(nb, T, B, 3 * He), r(nb, T, B, 3 * Hg), *weights]


def _check_k2(smi: str) -> dict:
    head = None
    worst = 0.0
    for i, (nb, T, B, dims) in enumerate(MULTIGRU_SHAPES):
        args = _multigru_inputs(nb, T, B, dims, seed=20 + i)
        with torch.no_grad():
            got = multigru_disc_inputs(*args)
            ref = multigru_disc_inputs_reference(*args)
            torch.cuda.synchronize()
            err = max((g - r).abs().max().item() for g, r in zip(got, ref))
            ms = _time_ms(lambda: multigru_disc_inputs(*args), reps=10)
            plain_ms = _time_ms(lambda: multigru_disc_inputs_reference(*args), reps=3)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        tile = k2_tile(nb, B, *dims)
        print(f"[kernel] multigru_disc_inputs nb={nb} T={T} B={B} "
              f"He/Hg/Hs/Z={'/'.join(map(str, dims))}: max|diff|={err:.3e} "
              f"(tol {KERNEL_TOL:g}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"tile {tile['rows']} rows x {tile['tiles']} tiles x {nb} buckets = "
              f"{tile['clusters']} clusters of 3 blocks of {tile['threads']} threads "
              f"(KL {tile['kl']}, S {tile['s']}, KLZ {tile['klz']}), {tile['smem']} B "
              f"shared a block, {tile['resident']} clusters resident at once | {smi}",
              flush=True)
        if not finite or err > KERNEL_TOL:
            fail(f"multigru_disc_inputs disagrees with its plain version at "
                 f"nb={nb} T={T} B={B} dims={dims}: max|diff|={err} finite={finite}")
        worst = max(worst, err)
        He, Hg, Hs, Z = dims
        macs = He * 3 * He + Hg * 3 * Hg + Hg * Z + Z * 3 * Hs + Hs * 3 * Hs + Hs * Z
        row = _row(ms, plain_ms, _bound(2 * nb * T * B * macs, *args, *got))
        _roofline(f"multigru_disc_inputs nb={nb} T={T} B={B} "
                  f"He/Hg/Hs/Z={'/'.join(map(str, dims))}", row, smi)
        head = head or row
    _time_composed_route(smi, *MULTIGRU_SHAPES[0][:3], (CHANNELS, WIDE_CHANNELS))
    return {"max_abs_err": worst, **head}


def _time_composed_route(smi: str, nb: int, T: int, B: int, widths: tuple) -> None:
    """The D-step inputs of nb buckets of B rows through K2's route
    (fused_disc_inputs: the two input products, K2, the transposes) and
    through the composed route (encode and refine_latent ∘ gen_latent: 3 K1
    forward launches, the projections as products) in turns, at each of
    ``widths`` channels (14: z28/h56; 20: z40/h80). No single PyTorch call
    computes K2's function; the composed route is its nearest yardstick."""
    for channels in widths:
        z_dim, h_dim = adaptive_dims(channels, T)
        cfg = TimeGANConfig(x_dim=channels, z_dim=z_dim, h_dim=h_dim)
        params = timegan_init_stacked(
            cfg, [torch.Generator().manual_seed(b) for b in range(nb)], device="cuda")
        g = torch.Generator().manual_seed(21)
        x = torch.rand((nb, B, T, channels), generator=g).cuda()
        z = torch.rand((nb, B, T, z_dim), generator=g).cuda()
        before = (gru_sequence.launches, multigru_disc_inputs.launches)
        with torch.no_grad():
            via_k2 = fused_disc_inputs(params, x, z)
            composed = encode(params, x), refine_latent(params, gen_latent(params, z))
            torch.cuda.synchronize()
            launches = (gru_sequence.launches - before[0],
                        multigru_disc_inputs.launches - before[1])
            err = max((a - b).abs().max().item() for a, b in zip(via_k2, composed))
            k2_ms, composed_ms = _turns_ms(
                lambda: fused_disc_inputs(params, x, z),
                lambda: (encode(params, x), refine_latent(params, gen_latent(params, z))),
                reps=10)
        print(f"[kernel] D-step inputs nb={nb} T={T} B={B} z{z_dim}/h{h_dim}: K2's route "
              f"{k2_ms:.4f} ms, the composed route (K1 forward x3, projections as "
              f"products) {composed_ms:.4f} ms in turns; max|diff| {err:.3e} | {smi}",
              flush=True)
        if launches != (3, 1):
            fail(f"the two D-step routes launched (K1, K2) {launches}, expected (3, 1)")
        if err > KERNEL_TOL:
            fail(f"K2's route and the composed route differ by {err} at z{z_dim}/h{h_dim}")


def _attn_inputs(B, H, T, D, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((B, H, T, D), generator=g).cuda() for _ in range(4)]


def _sdpa_calls(q, k, v, do):
    """PyTorch's memory-efficient attention on the same float32 inputs, the
    yardstick beside K3: its forward (o, lse) as one call, and its backward
    (dq, dk, dv, with delta inside) as one autograd.grad. Timed here, never
    used by the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def forward():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            q, k, v, None, True)[:2]

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad(), sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = torch.nn.functional.scaled_dot_product_attention(*leaves)

    def backward():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)
    return forward, backward


def _check_k3(smi: str) -> dict:
    """K3a (o, lse within ATTN_FWD_TOL absolute), K3b and K3c (within
    ATTN_BWD_RTOL of the largest magnitude) against their plain versions at
    ATTN_SHAPES, with each kernel's bound, and PyTorch's memory-efficient
    attention (forward beside K3a, backward beside K3b + K3c) timed in turns
    with them; then dense attention's time at 96 and 768 tokens, beside
    K3a's, for where "auto"'s 512-token threshold stands on this card."""
    heads = {}
    worst = {"flash_forward": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    for i, (B, H, T, D) in enumerate(ATTN_SHAPES):
        q, k, v, do = _attn_inputs(B, H, T, D, seed=30 + i)
        with torch.no_grad():
            o, lse = flash_forward(q, k, v)
            o_ref, lse_ref = flash_forward_plain(q, k, v)
            delta = (do * o_ref).sum(-1)
            dq = flash_dq(q, k, v, do, lse_ref, delta)
            dk, dv = flash_dkv(q, k, v, do, lse_ref, delta)
            dq_ref = flash_dq_plain(q, k, v, do, lse_ref, delta)
            dk_ref, dv_ref = flash_dkv_plain(q, k, v, do, lse_ref, delta)
            torch.cuda.synchronize()
            errs = {"flash_forward": max((o - o_ref).abs().max().item(),
                                         (lse - lse_ref).abs().max().item())}
            rel = {}
            for name, pairs in (("flash_dq", ((dq, dq_ref),)),
                                ("flash_dkv", ((dk, dk_ref), (dv, dv_ref)))):
                errs[name] = max((g - r).abs().max().item() for g, r in pairs)
                rel[name] = max((g - r).abs().max().item() / r.abs().max().item()
                                for g, r in pairs)
            finite = all(bool(torch.isfinite(t).all()) for t in (o, lse, dq, dk, dv))
            reps = 10 if T < 4096 else 5
            k3b = lambda: flash_dq(q, k, v, do, lse_ref, delta)     # noqa: E731
            k3c = lambda: flash_dkv(q, k, v, do, lse_ref, delta)    # noqa: E731
            lib_fwd, lib_bwd = _sdpa_calls(q, k, v, do)
            lib_o, lib_lse = lib_fwd()
            lib_grads = lib_bwd()
            lib_err = ((lib_o - o_ref).abs().max().item(),
                       (lib_lse[..., :T] - lse_ref).abs().max().item(),
                       max((g - r).abs().max().item() / r.abs().max().item()
                           for g, r in zip(lib_grads, (dq_ref, dk_ref, dv_ref))))
            fwd_ms, lib_fwd_ms = _turns_ms(lambda: flash_forward(q, k, v), lib_fwd, reps)
            bwd_ms, lib_bwd_ms = _turns_ms(lambda: (k3b(), k3c()), lib_bwd, reps)
            times = {
                "flash_forward": (fwd_ms, _time_ms(lambda: flash_forward_plain(q, k, v), 3)),
                "flash_dq": (_time_ms(k3b, reps),
                             _time_ms(lambda: flash_dq_plain(q, k, v, do, lse_ref,
                                                             delta), 3)),
                "flash_dkv": (_time_ms(k3c, reps),
                              _time_ms(lambda: flash_dkv_plain(q, k, v, do, lse_ref,
                                                               delta), 3))}
        prod = 2 * B * H * T * T * D                  # FLOPs of one T x T x D product
        bounds = {"flash_forward": _bound(2 * prod, q, k, v, o, lse),
                  "flash_dq": _bound(3 * prod, q, k, v, do, lse, delta, dq),
                  "flash_dkv": _bound(4 * prod, q, k, v, do, lse, delta, dk, dv)}
        library = {"flash_forward": lib_fwd_ms, "flash_dq": lib_bwd_ms,
                   "flash_dkv": lib_bwd_ms}
        for name in worst:
            ms, plain_ms = times[name]
            tol = (f"(tol {ATTN_FWD_TOL:g} on o and lse)" if name == "flash_forward"
                   else f"= {rel[name]:.3e} relative (tol {ATTN_BWD_RTOL:g})")
            row = _row(ms, plain_ms, bounds[name], library[name])
            print(f"[kernel] {name} B={B} H={H} T={T} D={D}: max|diff|={errs[name]:.3e} "
                  f"{tol} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
                  f"{100 * row['bound_ms'] / ms:.1f} % of it) | {smi}", flush=True)
            worst[name] = max(worst[name], errs[name])
            if (B, H, T, D) == ATTN_HEADLINE:
                heads[name] = row
        print(f"[kernel] memory-efficient SDPA B={B} H={H} T={T} D={D}: forward "
              f"{lib_fwd_ms:.4f} ms vs K3a {fwd_ms:.4f} ms; backward {lib_bwd_ms:.4f} "
              f"ms vs K3b + K3c {bwd_ms:.4f} ms (in turns); its o, lse, gradients "
              f"against the plain versions {lib_err[0]:.3e}, {lib_err[1]:.3e}, "
              f"{lib_err[2]:.3e} relative | {smi}", flush=True)
        if (not finite or errs["flash_forward"] > ATTN_FWD_TOL
                or rel["flash_dq"] > ATTN_BWD_RTOL or rel["flash_dkv"] > ATTN_BWD_RTOL):
            fail(f"flash attention disagrees with its plain versions at B={B} H={H} "
                 f"T={T} D={D}: {errs} relative {rel} finite={finite}")
    for name, row in heads.items():
        _roofline(f"{name} B={ATTN_HEADLINE[0]} H={ATTN_HEADLINE[1]} "
                  f"T={ATTN_HEADLINE[2]} D={ATTN_HEADLINE[3]}", row, smi,
                  "memory-efficient SDPA " + ("forward" if name == "flash_forward"
                                              else "backward (dq, dk, dv)"))
    for B, H, T, D in ((64, 4, 96, 64), (64, 4, 768, 64)):
        q, k, v, _ = _attn_inputs(B, H, T, D, seed=40)
        with torch.no_grad():
            dense_ms = _time_ms(lambda: attention_dense(q, k, v), 10)
            flash_ms = _time_ms(lambda: flash_forward(q, k, v), 10)
        print(f"[kernel] attention forward B={B} H={H} T={T} D={D}: dense "
              f"{dense_ms:.4f} ms, K3a {flash_ms:.4f} ms ('auto' takes K3a on the "
              f"card from T=512) | {smi}", flush=True)
    return {name: {"max_abs_err": worst[name], **heads[name]} for name in worst}


def _check_k3_wide(smi: str) -> dict:
    """The wide kernels (K3a, K3b, K3c for D > 128) against their plain
    versions at WIDE_ATTN_SHAPES, as _check_k3 holds the tensor-core ones,
    with memory-efficient SDPA timed in turns beside them; rows at the
    first shape."""
    heads = {}
    worst = {"flash_forward_wide": 0.0, "flash_dq_wide": 0.0, "flash_dkv_wide": 0.0}
    for i, (B, H, T, D) in enumerate(WIDE_ATTN_SHAPES):
        q, k, v, do = _attn_inputs(B, H, T, D, seed=50 + i)
        counts = [c.wide_launches for c in _k3_counters()]
        with torch.no_grad():
            o, lse = flash_forward(q, k, v)
            o_ref, lse_ref = flash_forward_plain(q, k, v)
            delta = (do * o_ref).sum(-1)
            dq = flash_dq(q, k, v, do, lse_ref, delta)
            dk, dv = flash_dkv(q, k, v, do, lse_ref, delta)
            dq_ref = flash_dq_plain(q, k, v, do, lse_ref, delta)
            dk_ref, dv_ref = flash_dkv_plain(q, k, v, do, lse_ref, delta)
            torch.cuda.synchronize()
            if [c.wide_launches - n for c, n in zip(_k3_counters(), counts)] != [1, 1, 1]:
                fail(f"the wide kernels did not run at B={B} H={H} T={T} D={D}")
            errs = {"flash_forward_wide": max((o - o_ref).abs().max().item(),
                                              (lse - lse_ref).abs().max().item())}
            rel = {}
            for name, pairs in (("flash_dq_wide", ((dq, dq_ref),)),
                                ("flash_dkv_wide", ((dk, dk_ref), (dv, dv_ref)))):
                errs[name] = max((g - r).abs().max().item() for g, r in pairs)
                rel[name] = max((g - r).abs().max().item() / r.abs().max().item()
                                for g, r in pairs)
            finite = all(bool(torch.isfinite(t).all()) for t in (o, lse, dq, dk, dv))
            k3b = lambda: flash_dq(q, k, v, do, lse_ref, delta)     # noqa: E731
            k3c = lambda: flash_dkv(q, k, v, do, lse_ref, delta)    # noqa: E731
            fwd = lambda: flash_forward(q, k, v)                    # noqa: E731
            if D % 4 == 0:       # memory-efficient SDPA takes no other D
                lib_fwd, lib_bwd = _sdpa_calls(q, k, v, do)
                fwd_ms, lib_fwd_ms = _turns_ms(fwd, lib_fwd, 5)
                bwd_ms, lib_bwd_ms = _turns_ms(lambda: (k3b(), k3c()), lib_bwd, 5)
            else:
                fwd_ms, lib_fwd_ms = _time_ms(fwd, 5), None
                bwd_ms, lib_bwd_ms = _time_ms(lambda: (k3b(), k3c()), 5), None
            times = {
                "flash_forward_wide": (fwd_ms, _time_ms(lambda: flash_forward_plain(q, k, v), 3)),
                "flash_dq_wide": (_time_ms(k3b, 5), _time_ms(
                    lambda: flash_dq_plain(q, k, v, do, lse_ref, delta), 3)),
                "flash_dkv_wide": (_time_ms(k3c, 5), _time_ms(
                    lambda: flash_dkv_plain(q, k, v, do, lse_ref, delta), 3))}
        prod = 2 * B * H * T * T * D
        bounds = {"flash_forward_wide": _bound(2 * prod, q, k, v, o, lse),
                  "flash_dq_wide": _bound(3 * prod, q, k, v, do, lse, delta, dq),
                  "flash_dkv_wide": _bound(4 * prod, q, k, v, do, lse, delta, dk, dv)}
        library = {"flash_forward_wide": lib_fwd_ms, "flash_dq_wide": lib_bwd_ms,
                   "flash_dkv_wide": lib_bwd_ms}
        for name in worst:
            ms, plain_ms = times[name]
            tol = (f"(tol {ATTN_FWD_TOL:g} on o and lse)" if name == "flash_forward_wide"
                   else f"= {rel[name]:.3e} relative (tol {ATTN_BWD_RTOL:g})")
            row = _row(ms, plain_ms, bounds[name], library[name])
            print(f"[kernel] {name} B={B} H={H} T={T} D={D}: max|diff|={errs[name]:.3e} "
                  f"{tol} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
                  f"{100 * row['bound_ms'] / ms:.1f} % of it) | {smi}", flush=True)
            worst[name] = max(worst[name], errs[name])
            if i == 0:
                heads[name] = row
        if lib_fwd_ms is not None:
            print(f"[kernel] memory-efficient SDPA B={B} H={H} T={T} D={D}: forward "
                  f"{lib_fwd_ms:.4f} ms vs wide K3a {fwd_ms:.4f} ms; backward "
                  f"{lib_bwd_ms:.4f} ms vs wide K3b + K3c {bwd_ms:.4f} ms (in turns) "
                  f"| {smi}", flush=True)
        if (not finite or errs["flash_forward_wide"] > ATTN_FWD_TOL
                or rel["flash_dq_wide"] > ATTN_BWD_RTOL
                or rel["flash_dkv_wide"] > ATTN_BWD_RTOL):
            fail(f"the wide flash kernels disagree with their plain versions at B={B} "
                 f"H={H} T={T} D={D}: {errs} relative {rel} finite={finite}")
    B, H, T, D = WIDE_ATTN_SHAPES[0]
    for name, row in heads.items():
        _roofline(f"{name} B={B} H={H} T={T} D={D}", row, smi, "memory-efficient SDPA "
                  + ("forward" if name == "flash_forward_wide" else "backward (dq, dk, dv)"))
    # split-TF32 runs each product as three TF32 passes: 3 x the FLOP bound
    row = heads["flash_forward_wide"]
    print(f"[bound] flash_forward_wide B={B} H={H} T={T} D={D}: "
          f"{100 * row['bound_ms'] / row['ms']:.1f} % of the bound, "
          f"{100 * 3 * row['bound_ms'] / row['ms']:.1f} % of the split-TF32 ceiling "
          f"{3 * row['bound_ms']:.4f} ms | {smi}", flush=True)
    return {name: {"max_abs_err": worst[name], **heads[name]} for name in worst}


def phase_t1(smi: str) -> None:
    """dq (K3b) and dk (K3c) at one key, tensor-core and wide kernels,
    against their function in float64 on the same inputs, in units of the
    terms that cancel there; the plain float32 versions' errors beside them
    (see T1_RTOL)."""
    for i, (B, H, T, D) in enumerate(T1_SHAPES):
        q, k, v, do = _attn_inputs(B, H, T, D, seed=60 + i)
        with torch.no_grad():
            o_ref, lse_ref = flash_forward_plain(q, k, v)
            delta = (do * o_ref).sum(-1)
            args = (q, k, v, do, lse_ref, delta)
            f64 = [t.double() for t in args]
            terms = (do.double().abs() * v.double().abs()).sum(-1).max().item() * D ** -0.5
            got = {"dq": (flash_dq(*args), flash_dq_plain(*args), flash_dq_plain(*f64), k),
                   "dk": (flash_dkv(*args)[0], flash_dkv_plain(*args)[0],
                          flash_dkv_plain(*f64)[0], q)}
            for name, (kern, plain, exact, other) in got.items():
                size = terms * other.abs().max().item()
                err = (kern.double() - exact).abs().max().item() / size
                plain_err = (plain.double() - exact).abs().max().item() / size
                print(f"[t1] {name} B={B} H={H} T=1 D={D}: kernel {err:.3e}, plain "
                      f"float32 {plain_err:.3e} of the cancelling terms' size "
                      f"{size:.3e} (tol {T1_RTOL:g}) | {smi}", flush=True)
                if not err <= T1_RTOL:
                    fail(f"{name} at T = 1, D = {D}: {err} of the cancelling terms")


def phase_auto_rule(smi: str) -> None:
    """"auto" attention on the card at 512 tokens: the tensor-core kernels
    at head dim 64, the wide kernels at 160, each matching dense
    attention."""
    for shape, wide in (((1, 2, 512, 64), False), ((1, 2, 512, 160), True)):
        q, k, v, _ = _attn_inputs(*shape, seed=41)
        before = (flash_forward.launches, flash_forward.wide_launches)
        with torch.no_grad():
            got = mha(q, k, v, impl="auto")
            ref = attention_dense(q, k, v)
        torch.cuda.synchronize()
        launches = (flash_forward.launches - before[0],
                    flash_forward.wide_launches - before[1])
        want = (0, 1) if wide else (1, 0)
        err = (got - ref).abs().max().item()
        print(f"[auto] mha 'auto' B, H, T, D = {shape}: flash_forward launches "
              f"{launches[0]} tensor-core, {launches[1]} wide (expected {want}), "
              f"max|diff| against dense {err:.3e} (tol {ATTN_FWD_TOL:g}) | {smi}",
              flush=True)
        if launches != want or err > ATTN_FWD_TOL:
            fail(f"'auto' attention at {shape}: launches {launches}, max|diff| {err}")


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


def _post(addr, body: dict, path: str = "/synthesize") -> tuple[np.ndarray, float]:
    conn = http.client.HTTPConnection(*addr, timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("POST", path, body=json.dumps(body))
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    wall = time.perf_counter() - t0
    if resp.status != 200:
        fail(f"POST {path} {body} -> {resp.status}: {data[:300]!r}")
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


def _write_buckets(root: Path, n_buckets: int = N_BUCKETS,
                   channels: int = CHANNELS) -> Path:
    """The first ``n_buckets`` of the 18 bucket NPZs
    posture{1..9}_{no_exo,with_exo}.npz, random (63, 768, channels) float32
    windows in [0, 1), from a seed, with fixed scalers (for --denorm)."""
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    names = [f"posture{p}_{c}" for p in range(1, 10) for c in ("no_exo", "with_exo")]
    for name in names[:n_buckets]:
        np.savez(data / f"{name}.npz",
                 X=rng.uniform(0, 1, (N_WINDOWS, SEQ_LEN, channels))
                 .astype(np.float32), fs=np.float32(128.0),
                 scale_min=np.linspace(-40, -20, channels, dtype=np.float32),
                 scale_range=np.linspace(30, 90, channels, dtype=np.float32))
    return data


def _train_hparams(**override) -> dict:
    with open(Path(__file__).resolve().parent / "configs" / "timegan_config.json") as f:
        cfg = json.load(f)
    hp = {k: typ(cfg[k]) for k, typ in CONFIG_KEYS.items() if k in cfg}
    return {**hp, **override}


def phase_train(smi: str, root: Path, device: str = "cuda",
                n_buckets: int = N_BUCKETS, channels: int = CHANNELS,
                gan_steps: int = GAN_STEPS) -> dict:
    """train_all_buckets at full width on ``n_buckets`` buckets of
    ``channels`` channels (adaptive_dims sets the widths), the buckets in
    ``root``/data and the runs in ``root``/runs; returns the launch counts
    of its run. With ``device="cpu"`` it rehearses the phase: the counts
    then stay 0."""
    hp = _train_hparams(ae_epochs=1, sup_epochs=1, gan_steps=gan_steps)
    tag = "[train]" if channels == CHANNELS else "[train-wide]"
    data = _write_buckets(root, n_buckets, channels)
    out = root / "runs"
    counters = (gru_sequence, gru_sequence_bwd, multigru_disc_inputs)
    for c in counters:
        c.launches = 0
    res = train_all_buckets(data, out, device=device, log_every=1, **hp)
    fwd, bwd, k2 = (c.launches for c in counters)
    # per AE step: E and R forward, both backward; per SUP step: E (no
    # gradient) and S forward, S backward; per GAN step: K2 for the D
    # inputs, G, S, R and E, R forward and backward; then 3 forward
    # launches per bucket for synthetic.npz (one G→S→R cascade)
    a, s_, g = res["ae_steps"], res["sup_steps"], gan_steps
    want = (2 * a + 2 * s_ + 5 * g + 3 * n_buckets, 2 * a + s_ + 5 * g, g)
    if torch.device(device).type != "cuda":
        want = (0, 0, 0)
    z_dim, h_dim = adaptive_dims(channels, SEQ_LEN)
    print(f"{tag} {n_buckets} buckets x ({N_WINDOWS}, {SEQ_LEN}, {channels}), "
          f"z{z_dim}/h{h_dim}, {a} AE + {s_} SUP + {g} GAN steps in "
          f"{res['total_seconds']:.2f} s; launches: gru_sequence {fwd} (expected "
          f"{want[0]}), gru_sequence_bwd {bwd} (expected {want[1]}), "
          f"multigru_disc_inputs {k2} (expected {want[2]}) | {smi}", flush=True)
    if (fwd, bwd, k2) != want:
        fail(f"training launch counts {(fwd, bwd, k2)} != expected {want}")
    steps = res["gan_step_seconds"]
    print(f"{tag} GAN step wall times {['%.3f' % t for t in steps]} s; "
          f"median of steps 2-{gan_steps}: {statistics.median(steps[1:]):.3f} s "
          f"= {n_buckets / statistics.median(steps[1:]):.3f} aggregate "
          f"bucket-steps/s | {smi}", flush=True)

    names = sorted(f.stem for f in data.glob("*.npz"))
    for name in names:
        run = out / name
        missing = [f for f in ("train_log.csv", "ckpt_latest.npz",
                               "ckpt_best.npz", "synthetic.npz")
                   if not (run / f).exists()]
        if missing:
            fail(f"{name}: artifacts missing {missing}")
        rows = np.loadtxt(run / "train_log.csv", delimiter=",", skiprows=1,
                          usecols=range(2, 2 + len(LOG_COLUMNS)), ndmin=2)
        if rows.shape != (gan_steps, len(LOG_COLUMNS)) or not np.isfinite(rows).all():
            fail(f"{name}: train_log.csv {rows.shape} finite "
                 f"{np.isfinite(rows).all()}")
        trees, _ = load_checkpoint(run / "ckpt_best.npz")
        if set(trees) != {"model", "optG", "optD"}:
            fail(f"{name}: ckpt_best.npz holds {sorted(trees)}")
        with np.load(run / "synthetic.npz") as syn:
            if syn["X"].shape != (N_WINDOWS, SEQ_LEN, channels) \
                    or not np.isfinite(syn["X"]).all():
                fail(f"{name}: synthetic.npz {syn['X'].shape}")
    reg = ModelRegistry(out, data, device=device)     # serves every ckpt_best
    if sorted(reg.models) != names:
        fail(f"the registry loaded {sorted(reg.models)}")
    for name in names:
        X = reg.synthesize(name, 8, SEQ_LEN, 0, False, 8, SEQ_LEN)
        if X.shape != (8, SEQ_LEN, channels) or not np.isfinite(X).all():
            fail(f"{name}: served {X.shape}")
    last = np.loadtxt(out / names[0] / "train_log.csv", delimiter=",",
                      skiprows=1, usecols=range(2, 10), ndmin=2)[-1]
    print(f"{tag} all {len(names)} buckets: train_log.csv finite, ckpt_best "
          f"served back; {names[0]} step {gan_steps}: "
          + ", ".join(f"{c}={v:.4f}" for c, v in zip(LOG_COLUMNS, last)),
          flush=True)
    return {"gru_sequence": fwd, "gru_sequence_bwd": bwd, "multigru_disc_inputs": k2}


def phase_eval(smi: str, root: Path, device: str = "cuda") -> dict:
    """run_timegan_eval (by condition) of the buckets and synthetic.npz
    files that phase_train left in ``root``: 18 pairs of 63 + 63 windows and
    the global corpus of 1134 + 1134. The CSVs (rows, columns in the JAX
    package's order, finite values, counts), K1's launch counts (one forward
    and one backward a scorer stack and epoch, one forward for its test
    rows), the time split; then one scorer stack and one pair's statistics
    on the card against the CPU. Returns the launch counts of the run."""
    pairs = load_pairs_by_condition(root / "data", root / "runs")
    counters = (gru_sequence, gru_sequence_bwd)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    res = run_timegan_eval(root / "data", root / "runs", root / "eval",
                           by_condition=True, device=device)
    wall = time.perf_counter() - t0
    fwd, bwd = (c.launches for c in counters)
    # two discriminative stacks (18 pairs; the global pair) and two
    # predictive ones (36 TSTR / TRTS tasks; the global 2)
    want = (2 * (EVAL_DISC_EPOCHS + 1) + 2 * (EVAL_PRED_EPOCHS + 1),
            2 * EVAL_DISC_EPOCHS + 2 * EVAL_PRED_EPOCHS)
    if torch.device(device).type != "cuda":
        want = (0, 0)
    split = res["seconds"]
    print(f"[eval] run_timegan_eval by condition: {len(pairs)} pairs of "
          f"({N_WINDOWS}, {SEQ_LEN}, {CHANNELS}) + the global corpus in {wall:.2f} s: "
          + "; ".join(f"{k} {v:.2f} s" for k, v in split.items())
          + f"; launches gru_sequence {fwd} (expected {want[0]}), gru_sequence_bwd "
          f"{bwd} (expected {want[1]}) | {smi}", flush=True)
    if (fwd, bwd) != want:
        fail(f"eval launch counts {(fwd, bwd)} != expected {want}")
    for name, lead, n_rows, n in (("metrics_per_posture_condition.csv",
                                   ["posture", "condition"], N_BUCKETS, N_WINDOWS),
                                  ("metrics_global.csv", [], 1, N_BUCKETS * N_WINDOWS)):
        with open(root / "eval" / name) as f:
            reader = csv.DictReader(f)
            rows = list(reader)
        values = np.array([[float(r[c]) for c in EVAL_METRIC_COLS] for r in rows])
        counts = {(int(r["n_real"]), int(r["n_fake"])) for r in rows}
        if reader.fieldnames != lead + EVAL_METRIC_COLS or len(rows) != n_rows \
                or not np.isfinite(values).all() or counts != {(n, n)}:
            fail(f"{name}: columns {reader.fieldnames}, {len(rows)} rows, counts "
                 f"{counts}, finite {np.isfinite(values).all()}")
    g = res["global"]
    print(f"[eval] CSVs: {N_BUCKETS} + 1 rows, finite; global disc_acc "
          f"{g['disc_acc']:.4f} auc {g['disc_auc']:.4f} rmse_tstr {g['rmse_tstr']:.4f} "
          f"r2_tstr {g['r2_tstr']:.4f} psd {g['psd_diff']:.3e} acf {g['acf_diff']:.4f} "
          f"coh {g['coh_diff']:.4f}", flush=True)

    # card against CPU, outside the counted run
    keys = sorted(pairs)[:2]
    tasks = [discriminative_task(*pairs[k])[0] for k in keys]
    t0 = time.perf_counter()
    card = eval_run_grouped(tasks, 2, 1e-3, True, device)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = eval_run_grouped(tasks, 2, 1e-3, True, "cpu")
    cpu_s = time.perf_counter() - t0
    err = max(float(np.abs(a - b).max()) for a, b in zip(card, host))
    got = statistical_similarity(*pairs[keys[0]], device=device)
    ref = statistical_similarity(*pairs[keys[0]], device="cpu")
    rel = [abs(got[i] - ref[i]) / abs(ref[i]) for i in (0, 2)]
    acf_err = abs(got[1] - ref[1])
    print(f"[eval] card vs CPU: one discriminative stack of {len(tasks)} pairs, 2 "
          f"epochs: logits max|diff| {err:.3e} (tol {EVAL_LOGIT_TOL:g}), {card_s:.2f} s "
          f"on the card, {cpu_s:.2f} s on the CPU; statistics of {keys[0]}: psd "
          f"{rel[0]:.3e}, coh {rel[1]:.3e} relative (tol {EVAL_STAT_RTOL:g}), acf "
          f"{acf_err:.3e} (tol {EVAL_ACF_TOL:g}) | {smi}", flush=True)
    if not err <= EVAL_LOGIT_TOL or not max(rel) <= EVAL_STAT_RTOL \
            or not acf_err <= EVAL_ACF_TOL:
        fail(f"the eval on the card disagrees with the CPU: logits {err}, "
             f"psd/coh {rel}, acf {acf_err}")
    return {"gru_sequence": fwd, "gru_sequence_bwd": bwd}


def _cascade(net, z: torch.Tensor, chunk: int | None) -> torch.Tensor:
    """The synthesis cascade on device noise z: one-shot, or in chunks of
    ``chunk`` with the carried states; x (n, T, C) float32 on the device."""
    if chunk is None:
        return synthesize_from_noise(net, z)[0]
    carry, xs = None, []
    for t0 in range(0, z.shape[1], chunk):
        x, carry = synthesize_from_noise(net, z[:, t0:t0 + chunk], carry)
        xs.append(x)
    return torch.cat(xs, 1)


def _bf16_distance(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(correlation, max |a - b|) over every element, in float64."""
    a, b = a.double().flatten(), b.double().flatten()
    return torch.corrcoef(torch.stack([a, b]))[0, 1].item(), (a - b).abs().max().item()


def _hold_bf16(what: str, corr: float, err: float) -> None:
    if not (corr > BF16_CORR and err < BF16_MAX):
        fail(f"{what}: corr {corr} (bound > {BF16_CORR}), max|diff| {err} "
             f"(bound < {BF16_MAX})")


def phase_synth_bf16(smi: str, root: Path, device: str = "cuda") -> int:
    """bf16 synthesis, serving and long-horizon generation. A full-width
    random TimeGAN at SYNTH_SHAPES in bf16 and f32 on the same noise (the
    cascade alone on device noise, then synthesize() with its noise draw and
    device->host copy; K1 forward's launches per chunk; the card's split
    between K1 and the rest from the profiler); a --precision bf16 server
    over HTTP against in-process bf16 synthesis; generate_long_synth on the
    runs phase_train left in ``root`` at the long horizon with --denorm.
    Returns K1 forward's launches in the phase. With ``device="cpu"`` it
    rehearses the phase (patch SYNTH_SHAPES and LONG_LEN down first)."""
    on_card = torch.device(device).type == "cuda"
    gru_sequence.launches = 0
    model = TimeGAN(TimeGANConfig(), generator=torch.Generator().manual_seed(21),
                    device=device).eval()
    nets = {"f32": model, "bf16": cast_floating(params_tree(model), torch.bfloat16)}
    gen = torch.Generator(device=device).manual_seed(22)
    for n, T, chunk in SYNTH_SHAPES:
        z = sample_noise(gen, n, T, model.cfg.z_dim, device=device)
        noise = {"f32": z, "bf16": z.to(torch.bfloat16)}
        want = 3 * (1 if chunk is None else -(-T // chunk)) if on_card else 0
        x, ms = {}, {}
        for precision in ("f32", "bf16", "bf16", "f32"):      # in turns
            before = gru_sequence.launches
            _sync(device)
            t0 = time.perf_counter()
            x[precision] = _cascade(nets[precision], noise[precision], chunk)
            _sync(device)
            ms.setdefault(precision, []).append((time.perf_counter() - t0) * 1e3)
            if gru_sequence.launches - before != want:
                fail(f"{precision} cascade ({n}, {T}, chunk {chunk}): "
                     f"{gru_sequence.launches - before} gru_sequence launches, "
                     f"expected {want}")
        corr, err = _bf16_distance(x["bf16"], x["f32"])
        what = f"n={n} T={T}" + ("" if chunk is None else f" time_chunk={chunk}")
        host = {}
        for precision in ("f32", "bf16"):
            _sync(device)
            t0 = time.perf_counter()
            X = synthesize(model, n, T, generator=torch.Generator(device=device)
                           .manual_seed(0), time_chunk=chunk, precision=precision)
            host[precision] = (time.perf_counter() - t0) * 1e3
            if X.shape != (n, T, CHANNELS) or X.dtype != np.float32:
                fail(f"synthesize {what} {precision}: {X.shape} {X.dtype}")
        rates = {p: n * T / min(v) * 1e3 for p, v in ms.items()}
        print(f"[synth-bf16] {what}: cascade f32 {min(ms['f32']):.3f} ms, bf16 "
              f"{min(ms['bf16']):.3f} ms (best of 2 in turns; {n / min(ms['f32']) * 1e3:.1f} "
              f"/ {n / min(ms['bf16']) * 1e3:.1f} windows/s, {rates['f32']:.4g} / "
              f"{rates['bf16']:.4g} samples/s; bf16/f32 time "
              f"{min(ms['bf16']) / min(ms['f32']):.3f}); synthesize() with noise and "
              f"device->host f32 {host['f32']:.1f} ms, bf16 {host['bf16']:.1f} ms; "
              f"gru_sequence launches {want} a run; bf16 vs f32 corr {corr:.6f} "
              f"max|diff| {err:.3e} (bounds > {BF16_CORR}, < {BF16_MAX}) | {smi}",
              flush=True)
        _hold_bf16(f"bf16 vs f32 at {what}", corr, err)
        if chunk is not None:
            one = _cascade(nets["bf16"], noise["bf16"], None)
            corr, err = _bf16_distance(x["bf16"], one)
            print(f"[synth-bf16] {what}: chunked bf16 vs one-shot bf16 corr "
                  f"{corr:.9f} max|diff| {err:.3e}, bitwise equal "
                  f"{bool(torch.equal(x['bf16'], one))}", flush=True)
            _hold_bf16(f"chunked bf16 vs one-shot at {what}", corr, err)
        del x, noise, z
    if on_card:
        _profile_synth(nets, smi)

    with tempfile.TemporaryDirectory() as tmp:
        runs, real = _write_runs(Path(tmp))
        reg = ModelRegistry(runs, real, device=device)
        srv = make_server(reg, "127.0.0.1", 0, SERVE_BATCH, TIME_CHUNK, precision="bf16")
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            first = {"run": "posture1_no_exo", "n": SERVE_BATCH, "seq_len": TIME_CHUNK,
                     "seed": 0}
            for body, chunks in ((first, 1), (first, 1),      # cold, then warm
                                 ({"run": "posture2_with_exo", "n": 16,
                                   "seq_len": LONG_LEN, "seed": 2, "denorm": True},
                                  -(-LONG_LEN // TIME_CHUNK))):
                before = gru_sequence.launches
                X, wall = _post(srv.server_address, body)
                got = gru_sequence.launches - before
                args = (body["run"], body["n"], body["seq_len"], body["seed"],
                        body.get("denorm", False), SERVE_BATCH, TIME_CHUNK)
                ref = reg.synthesize(*args, precision="bf16")
                f32 = reg.synthesize(*args)
                corr, err = _bf16_distance(torch.from_numpy(X), torch.from_numpy(f32))
                pack = {}
                for what, arr in (("bf16", X), ("f32", f32)):
                    t0 = time.perf_counter()
                    pack[what] = (_npz_bytes(arr), (time.perf_counter() - t0) * 1e3)
                print(f"[synth-bf16] --precision bf16 server {json.dumps(body)} -> "
                      f"{X.shape} in {wall * 1e3:.1f} ms, gru_sequence launches {got}; "
                      f"equal to in-process bf16 synthesize {np.array_equal(X, ref)}; "
                      f"vs f32 corr {corr:.6f} max|diff| {err:.3e}; npz packing of "
                      f"these windows {pack['bf16'][1]:.1f} ms ({pack['bf16'][0] / 1e6:.2f} "
                      f"MB), of the f32 windows {pack['f32'][1]:.1f} ms "
                      f"({pack['f32'][0] / 1e6:.2f} MB) | {smi}", flush=True)
                if (X.dtype != np.float32 or not np.array_equal(X, ref)
                        or got != (3 * chunks if on_card else 0)):
                    fail(f"bf16 server {body}: {X.dtype}, launches {got}, equal "
                         f"{np.array_equal(X, ref)}")
                # denorm scales the windows by up to ~100: the bounds are
                # those of the normalised windows
                scale = np.abs(reg.models[body["run"]]["scale_range"]).max() \
                    if body.get("denorm") else 1.0
                _hold_bf16(f"bf16 server vs f32 {body}", corr, err / scale)
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)

    before = gru_sequence.launches
    t0 = time.perf_counter()
    written = generate_long_synth_cli(
        ["--runs_dir", str(root / "runs"), "--real_dir", str(root / "data"),
         "--gen_len", str(LONG_LEN), "--time_chunk", str(LONG_CHUNK), "--denorm",
         "--device", device])
    wall = time.perf_counter() - t0
    got = gru_sequence.launches - before
    want = 3 * -(-LONG_LEN // LONG_CHUNK) * N_BUCKETS if on_card else 0
    first = sorted(written)[0]
    with np.load(written[first]) as f:
        X = f["X"]
    with np.load(root / "data" / f"{first}.npz") as f:
        mn, rg = f["scale_min"], f["scale_range"]
    best, _ = load_checkpoint(root / "runs" / first / "ckpt_best.npz")
    ref = synthesize(from_jax_params(best["model"], device=device).eval(), N_WINDOWS,
                     LONG_LEN, generator=torch.Generator(device=device).manual_seed(0),
                     time_chunk=LONG_CHUNK) * rg + mn
    print(f"[synth-bf16] generate_long_synth --gen_len {LONG_LEN} --time_chunk "
          f"{LONG_CHUNK} --denorm on {len(written)} runs in {wall:.2f} s "
          f"({N_BUCKETS * N_WINDOWS * LONG_LEN / wall:.4g} samples/s, files "
          f"included); gru_sequence launches {got} (expected {want}); {first}: "
          f"{X.shape}, equal to synthesize + denorm {np.array_equal(X, ref)} | {smi}",
          flush=True)
    if (len(written) != N_BUCKETS or got != want or not np.array_equal(X, ref)
            or X.shape != (N_WINDOWS, LONG_LEN, CHANNELS)):
        fail(f"generate_long_synth: {len(written)} files, launches {got}, "
             f"{first} {X.shape}")
    for name, path in written.items():
        with np.load(path) as f:
            if f["X"].shape != (N_WINDOWS, LONG_LEN, CHANNELS) \
                    or not np.isfinite(f["X"]).all():
                fail(f"{name}: {path.name} {f['X'].shape}")
        if find_synth_npz(root / "runs" / name) != path:
            fail(f"{name}: the eval would not pick {path.name} first")
    return gru_sequence.launches


def _profile_synth(nets: dict, smi: str) -> None:
    """The card's time in one cascade at bench.py's shape, per precision:
    K1 against the rest (projections, casts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n, T, _ = SYNTH_SHAPES[0]
    z = torch.rand((n, T, nets["f32"].cfg.z_dim), device="cuda")
    for precision, net in nets.items():
        zp = z.to(torch.bfloat16) if precision == "bf16" else z
        _cascade(net, zp, None)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _cascade(net, zp, None)
            torch.cuda.synchronize()
        on_card = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        dev = sum(e.self_device_time_total for e in on_card) / 1e3
        k1 = sum(e.self_device_time_total for e in on_card
                 if "gru_seq_fwd_kernel" in e.key) / 1e3
        top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:4]
        print(f"[profile] cascade n={n} T={T} {precision}: device time {dev:.3f} ms, "
              f"gru_sequence {k1:.3f} ms ({100 * k1 / dev:.1f} %), the rest "
              f"{dev - k1:.3f} ms; largest: " + "; ".join(
                  f"{e.key[:50]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                  for e in top) + f" | {smi}", flush=True)


def _seq_launches(n: int, layers: int, ae: int, sup: int, gan: int) -> tuple:
    """(K1 forward, K1 backward, K2) launches of one train_single_npz run of
    ``n`` windows at batch SEQ_BATCH: per AE batch E and R forward and
    backward, per SUP batch E (no gradient) and S forward, S backward, each
    once a layer; per GAN step K2 for the D inputs at one layer (E, G, S on
    K1 with dropout masks at more), G, S, R and E, R forward and backward;
    then G, S, R forward for synthetic.npz."""
    L, batches = layers, -(-n // SEQ_BATCH)
    fwd = 2 * L * batches * (ae + sup) + (5 * L + (3 * L if L > 1 else 0)) * gan + 3 * L
    bwd = 2 * L * batches * ae + L * batches * sup + 5 * L * gan
    return fwd, bwd, gan if L == 1 else 0


def _counted(run) -> tuple:
    """Run ``run`` with the launch counters set to 0; return its result and
    the (K1 forward, K1 backward, K2) launches it made."""
    counters = (gru_sequence, gru_sequence_bwd, multigru_disc_inputs)
    for c in counters:
        c.launches = 0
    res = run()
    return res, tuple(c.launches for c in counters)


def phase_train_seq(smi: str, root: Path, device: str = "cuda") -> dict:
    """The sequential trainer and the stacked trainer's new options at full
    width, through the CLI (``python -m eegsynth_torch.train.timegan``) in
    this process: one bucket of SEQ_WINDOWS random (768, 14) windows for
    SEQ_GAN_STEPS GAN steps at chunk 2, resumed to SEQ_RESUME_STEPS (log rows,
    one header, ckpt_latest's step and count, synthetic.npz); the same at 2
    layers with dropout 0.2 (K1 only, no K2); one GAN step of that stack
    with masks on the card against the CPU; the rate of the first run's
    SEQ_RATE_STEPS warm GAN steps at nb 1, B 64 and K2 against the composed
    route there; then
    --parallel_buckets --ckpt_every on 2 buckets, resumed from the saved
    state, whose logs must equal the uninterrupted run's bit for bit.
    Returns the launch counts of the CLI runs. With ``device="cpu"`` it
    rehearses the phase: the counts then stay 0."""
    cuda = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    hp = _train_hparams()
    cfg_path = root / "seq_config.json"
    cfg_path.write_text(json.dumps(hp))
    data = root / "seq_data"
    data.mkdir()
    name = "posture1_no_exo"
    rng = np.random.default_rng(3)
    np.savez(data / f"{name}.npz", X=rng.uniform(0, 1, (SEQ_WINDOWS, SEQ_LEN, CHANNELS))
             .astype(np.float32), fs=np.float32(128.0))
    total = np.zeros(3, dtype=np.int64)

    def cli(out, *flags):
        return timegan_cli(["--config", str(cfg_path), "--data_dir", str(data),
                            "--out_dir", str(out), "--device", device,
                            "--ae_epochs", "1", "--sup_epochs", "1", *flags])

    def check(tag, launches, want):
        want = want if cuda else (0, 0, 0)
        print(f"[train-seq] {tag}: launches gru_sequence {launches[0]}, "
              f"gru_sequence_bwd {launches[1]}, multigru_disc_inputs {launches[2]} "
              f"(expected {want}) | {smi}", flush=True)
        if tuple(launches) != tuple(want):
            fail(f"[train-seq] {tag}: launch counts {launches} != expected {want}")
        total[:] += launches

    t0 = time.perf_counter()
    res, launches = _counted(lambda: cli(root / "seq", "--gan_steps",
                                         str(SEQ_GAN_STEPS), "--chunk", "2"))
    check(f"{name} N={SEQ_WINDOWS} B={SEQ_BATCH}, 1 AE + 1 SUP epoch (2 batches, "
          f"the second padded) + {SEQ_GAN_STEPS} GAN steps in "
          f"{time.perf_counter() - t0:.2f} s", launches,
          _seq_launches(SEQ_WINDOWS, 1, 1, 1, SEQ_GAN_STEPS))
    t0 = time.perf_counter()
    _, launches = _counted(lambda: cli(root / "seq", "--gan_steps",
                                       str(SEQ_RESUME_STEPS), "--chunk", "2", "--resume"))
    resumed = SEQ_RESUME_STEPS - SEQ_GAN_STEPS
    check(f"--resume to {SEQ_RESUME_STEPS} in {time.perf_counter() - t0:.2f} s",
          launches, _seq_launches(SEQ_WINDOWS, 1, 0, 0, resumed))
    run = root / "seq" / name
    lines = (run / "train_log.csv").read_text().splitlines()
    steps = [ln.split(",")[0] for ln in lines[1:]]
    rows = np.array([[float(v) for v in ln.split(",")[2:]] for ln in lines[1:]])
    trees, meta = load_checkpoint(run / "ckpt_latest.npz")
    count = int(trees["optG"][1][0]["count"])
    with np.load(run / "synthetic.npz") as syn:
        X_syn = syn["X"]
    print(f"[train-seq] train_log.csv steps {','.join(steps)} under "
          f"{sum(ln.startswith('step,') for ln in lines)} header; ckpt_latest step "
          f"{meta['step']}, optG count {count}; synthetic.npz {X_syn.shape}; "
          f"step {SEQ_RESUME_STEPS}: " + ", ".join(
              f"{c}={v:.4f}" for c, v in zip(LOG_COLUMNS, rows[-1])), flush=True)
    if lines[0] != "step,phase," + ",".join(LOG_COLUMNS) or \
            steps != [str(s) for s in range(1, SEQ_RESUME_STEPS + 1)] or \
            not np.isfinite(rows).all() or meta["step"] != SEQ_RESUME_STEPS or \
            count != SEQ_RESUME_STEPS or \
            X_syn.shape != (SEQ_WINDOWS, SEQ_LEN, CHANNELS) or not np.isfinite(X_syn).all():
        fail("[train-seq] the sequential run and its resume left wrong artifacts")

    t0 = time.perf_counter()
    _, launches = _counted(lambda: cli(root / "seq2", "--gan_steps",
                                       str(SEQ_LAYERS_STEPS), "--layers", "2",
                                       "--dropout", "0.2"))
    check(f"layers 2, dropout 0.2, {SEQ_LAYERS_STEPS} GAN steps in "
          f"{time.perf_counter() - t0:.2f} s", launches,
          _seq_launches(SEQ_WINDOWS, 2, 1, 1, SEQ_LAYERS_STEPS))
    rows = np.loadtxt(root / "seq2" / name / "train_log.csv", delimiter=",",
                      skiprows=1, usecols=range(2, 10), ndmin=2)
    if rows.shape != (SEQ_LAYERS_STEPS, 8) or not np.isfinite(rows).all():
        fail(f"[train-seq] the 2-layer run logged {rows.shape}")

    warm = res[name]["gan_step_seconds"][1:]
    z_dim, h_dim = adaptive_dims(CHANNELS, SEQ_LEN)
    print(f"[train-seq] sequential GAN step nb=1 B={SEQ_BATCH} T={SEQ_LEN} "
          f"z{z_dim}/h{h_dim}: {len(warm) / sum(warm):.4f} steps/s over "
          f"{len(warm)} warm steps of the first run ({', '.join(f'{t:.3f}' for t in warm)}"
          f" s; warm-up {res[name]['gan_step_seconds'][0]:.3f} s) | {smi}", flush=True)

    _step_check(smi, device, nb=1, B=SEQ_CHECK_BATCH, layers=2, dropout=0.2,
                tag="[train-seq]")
    if cuda:
        _time_composed_route(smi, 1, SEQ_LEN, SEQ_BATCH, (CHANNELS,))

    # the stacked trainer: ckpt_every, then resume from the saved state
    stacked = root / "stacked"
    stacked.mkdir()
    data2 = _write_buckets(stacked, 2, CHANNELS)
    flags = ("--parallel_buckets", "--gan_steps", "3", "--ckpt_every", "2",
             "--data_dir", str(data2))
    t0 = time.perf_counter()
    res, launches = _counted(lambda: cli(stacked / "full", *flags))
    a = res["ae_steps"]
    check(f"--parallel_buckets --ckpt_every 2, 2 buckets, 3 GAN steps in "
          f"{time.perf_counter() - t0:.2f} s", launches,
          (4 * a + 15 + 3 * 2, 3 * a + 15, 3))
    (stacked / "resumed").mkdir()
    (stacked / "resumed" / "_multi_state.npz").write_bytes(
        (stacked / "full" / "_multi_state.npz").read_bytes())
    t0 = time.perf_counter()
    _, launches = _counted(lambda: cli(stacked / "resumed", *flags, "--resume"))
    check(f"--parallel_buckets --resume from step 2 in {time.perf_counter() - t0:.2f} s",
          launches, (5 + 3 * 2, 5, 1))
    same = [(stacked / "full" / b / "train_log.csv").read_bytes()
            == (stacked / "resumed" / b / "train_log.csv").read_bytes()
            for b in ("posture1_no_exo", "posture1_with_exo")]
    print(f"[train-seq] stacked resume: train_log.csv bit-identical to the "
          f"uninterrupted run's: {same} | {smi}", flush=True)
    if not all(same):
        fail("[train-seq] the resumed stacked run's log differs from the "
             "uninterrupted run's")
    print(f"[train-seq] phase passed in {time.perf_counter() - t_phase:.2f} s | {smi}",
          flush=True)
    return dict(zip(("gru_sequence", "gru_sequence_bwd", "multigru_disc_inputs"),
                    (int(v) for v in total)))


def _step_inputs(nb: int, B: int, seed: int, device, channels: int = CHANNELS,
                 layers: int = 1, dropout: float = 0.0):
    """Stacked models at full width for ``channels`` channels (adaptive_dims:
    z28/h56 at 14) of ``layers`` layers, fresh optimizer states, a batch and
    one step's draws, with dropout masks where ``dropout`` is live, all from
    seeds, on ``device``."""
    z_dim, h_dim = adaptive_dims(channels, SEQ_LEN)
    cfg = TimeGANConfig(x_dim=channels, z_dim=z_dim, h_dim=h_dim, num_layers=layers)
    params = timegan_init_stacked(
        cfg, [torch.Generator().manual_seed(seed + b) for b in range(nb)], device=device)
    hp = TimeGANHParams(**_train_hparams(gan_steps=GAN_STEPS, layers=layers,
                                         dropout=dropout))
    optD, optG = make_gan_opts(hp)
    d_state = optD.init(params["discriminator"])
    g_state = optG.init({k: params[k] for k in GEN_NETS})
    X = torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (nb, N_WINDOWS, SEQ_LEN, channels)).astype(np.float32)).to(device)
    gens = [torch.Generator(device=device).manual_seed(seed + b) for b in range(nb)]
    draws = draw_gan(gens, torch.full((nb,), float(N_WINDOWS), device=device), B,
                     SEQ_LEN, cfg.z_dim, device=device)
    if dropout > 0:
        draws.masks = draw_gan_masks(gens, params, B, SEQ_LEN, dropout, device=device)
    return params, hp, optD, d_state, optG, g_state, gather_batch(X, draws.idx), draws


def phase_step_check(smi: str, device: str = "cuda") -> None:
    """One GAN step on the card against the CPU plain path: nb 2, B 8, T 768,
    full width, the same parameters and draws; at 14 channels (z28/h56) and
    at 20 (z40/h80), the D-step inputs from K2 at both."""
    for channels in (CHANNELS, WIDE_CHANNELS):
        _step_check(smi, device, channels)


def _step_check(smi: str, device: str, channels: int = CHANNELS, nb: int = 2,
                B: int = 8, layers: int = 1, dropout: float = 0.0,
                tag: str = "[check]") -> None:
    """One GAN step of ``nb`` buckets at batch ``B`` on the card against the
    CPU plain path, on the same parameters, draws and dropout masks: the
    logged values, the updated parameters and both optimizers' first
    moments. Without masks the D-step inputs come from K2 (5 K1 forward
    launches and 1 K2); with them every recurrence is K1 (8 a layer)."""
    params, hp, optD, d_state, optG, g_state, x, draws = _step_inputs(
        nb, B, 7, device, channels, layers, dropout)
    cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)      # noqa: E731
    k1, k2 = gru_sequence.launches, multigru_disc_inputs.launches
    t0 = time.perf_counter()
    card_p, card_d, card_g, card_logs = gan_step(params, optD, d_state, optG,
                                                 g_state, x, draws, 1, hp)
    _sync(device)
    card_s = time.perf_counter() - t0
    k1, k2 = gru_sequence.launches - k1, multigru_disc_inputs.launches - k2
    want = (5, 1) if draws.masks is None else (8 * layers, 0)
    if torch.device(device).type != "cuda":
        want = (0, 0)
    d_cpu, g_cpu = optD.init(cpu(params["discriminator"])), \
        optG.init({k: cpu(params[k]) for k in GEN_NETS})
    draws_cpu = type(draws)(**{k: tree_map(lambda t: t.cpu(), v)
                               for k, v in vars(draws).items()})
    t0 = time.perf_counter()
    cpu_p, cpu_d, cpu_g, cpu_logs = gan_step(cpu(params), optD, d_cpu, optG, g_cpu,
                                             x.cpu(), draws_cpu, 1, hp)
    cpu_s = time.perf_counter() - t0
    log_err = ((card_logs.cpu() - cpu_logs).abs()
               / cpu_logs.abs().clamp(min=1.0)).max().item()
    p_err = max((a.cpu() - b).abs().max().item()
                for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)))
    # each leaf's error over its largest magnitude (u, with no gradient,
    # has mu 0 on both sides)
    mu_err = max(((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                 for card, host in ((card_d, cpu_d), (card_g, cpu_g))
                 for a, b in zip(tree_leaves(card.mu), tree_leaves(host.mu)))
    fmt = lambda row: ", ".join(f"{c}={v:.6f}" for c, v in zip(LOG_COLUMNS, row))  # noqa
    z_dim, h_dim = adaptive_dims(channels, SEQ_LEN)
    print(f"{tag} GAN step nb={nb} B={B} T={SEQ_LEN} x{channels}/z{z_dim}/h{h_dim}, "
          f"layers {layers}, dropout {dropout:g} ({'with' if draws.masks else 'no'} "
          f"masks), card vs CPU plain path: bucket 0 card {fmt(card_logs[0].tolist())}",
          flush=True)
    print(f"{tag}   CPU {fmt(cpu_logs[0].tolist())}", flush=True)
    print(f"{tag}   logged values max relative diff {log_err:.3e} (tol "
          f"{STEP_LOG_RTOL:g}); updated parameters max|diff| {p_err:.3e} (tol "
          f"{STEP_PARAM_ATOL:g}); Adam first moments max|diff| / leaf max "
          f"{mu_err:.3e} (tol {STEP_MU_RTOL:g}); step {card_s:.3f} s on the card, "
          f"{cpu_s:.3f} s on the CPU; launches gru_sequence {k1}, "
          f"multigru_disc_inputs {k2} (expected {want[0]}, {want[1]}) | {smi}",
          flush=True)
    if not torch.isfinite(card_logs).all() or log_err > STEP_LOG_RTOL \
            or p_err > STEP_PARAM_ATOL or not mu_err <= STEP_MU_RTOL:
        fail(f"{tag} the card's GAN step (layers {layers}) disagrees with the CPU at "
             f"{channels} channels: logs {log_err}, params {p_err}, mu {mu_err}")
    if (k1, k2) != want:
        fail(f"{tag} the GAN step (layers {layers}) at {channels} channels launched "
             f"gru_sequence {k1}, multigru_disc_inputs {k2} times, expected {want}")


def phase_train_layers(smi: str, device: str = "cuda") -> None:
    """Where one GAN step's time goes at the training shape (nb 18, B 63):
    host clock per layer, synchronised at each layer's end; then the card's
    busy share over one unsynchronised step from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params, hp, optD, d_state, optG, g_state, x, draws = _step_inputs(
        N_BUCKETS, N_WINDOWS, 11, device)
    state = [params, d_state, g_state]

    def step(timer=None):
        state[0], state[1], state[2], logs = gan_step(
            state[0], optD, state[1], optG, state[2], x, draws, 2, hp, timer)
        return logs

    step()                                                   # warm-up
    _sync(device)
    split: dict[str, float] = {}
    last = [time.perf_counter()]

    def timer(name):
        _sync(device)
        now = time.perf_counter()
        split[name] = split.get(name, 0.0) + (now - last[0]) * 1e3
        last[0] = now

    t0 = time.perf_counter()
    last[0] = t0
    step(timer)
    total = (time.perf_counter() - t0) * 1e3
    names = {"disc_inputs": "D-step inputs (K2)",
             "discriminator": "discriminator + R1 (plain GRU, double backward)",
             "g_forward": "G-step forward (K1 x5 + plain D + losses)",
             "g_backward": "G-step backward (K1 bwd x5 + plain D)",
             "optimizers": "optimizers (D and G)"}
    print(f"[layers] one GAN step nb={N_BUCKETS} B={N_WINDOWS} T={SEQ_LEN}: "
          f"{total:.1f} ms: " + "; ".join(f"{names[k]} {v:.1f} ms"
                                          for k, v in split.items())
          + f" | {smi}", flush=True)
    if torch.device(device).type != "cuda":
        return

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    dev_ms = sum(e.self_device_time_total for e in on_card) / 1e3

    def kernel_ms(tag):
        return sum(e.self_device_time_total for e in on_card if tag in e.key) / 1e3

    launches = sum(e.count for e in on_card)
    print(f"[profile] one GAN step nb={N_BUCKETS}: device time {dev_ms:.1f} ms in "
          f"{wall_ms:.1f} ms wall ({100 * dev_ms / wall_ms:.1f} % busy) over "
          f"{launches} device operations: K2 {kernel_ms('multigru_fwd_kernel'):.3f} "
          f"ms, K1 fwd {kernel_ms('gru_seq_fwd_kernel'):.3f} ms, K1 bwd "
          f"{kernel_ms('gru_seq_bwd_kernel'):.3f} ms | {smi}", flush=True)
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:6]
    print("[profile] largest device operations: " + "; ".join(
        f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.1f} ms"
        for e in top), flush=True)


# ------------------------------------------------------------------
# Transformer CGAN
# ------------------------------------------------------------------

def _write_posture_buckets(root: Path, n: int,
                           conditions: tuple[str, ...] = ("no_exo",)) -> Path:
    """posture{1..9}_{condition}.npz of random (n, 768, 14) windows for each
    condition, with the keys load_condition_dataset reads, from a seed: v1
    trains on one condition's nine postures, v2 on one posture's two
    conditions."""
    data = root / "cgan_data"
    data.mkdir()
    rng = np.random.default_rng(1)
    for condition in conditions:
        for posture in range(1, 10):
            np.savez(data / f"posture{posture}_{condition}.npz",
                     X=rng.uniform(0, 1, (n, SEQ_LEN, CHANNELS)).astype(np.float32),
                     posture=np.int32(posture), fs=np.float32(128.0),
                     scale_min=rng.uniform(-50, -10, CHANNELS).astype(np.float32),
                     scale_range=rng.uniform(20, 100, CHANNELS).astype(np.float32),
                     ch_names=np.array([f"ch{i}" for i in range(CHANNELS)]))
    return data


def _k3_counters():
    return (flash_forward, flash_dq, flash_dkv)


def phase_cgan_train(smi: str, device: str = "cuda") -> dict:
    """train_one_condition (v1) at full width with the generator's attention
    forced to flash: artifacts, finite metrics.csv, and the K3 launch counts
    of the run against CGAN_K3 per step. With ``device="cpu"`` it rehearses
    the phase (the counts then stay 0)."""
    with tempfile.TemporaryDirectory() as tmp:
        data = _write_posture_buckets(Path(tmp), CGAN_WINDOWS)
        runs = Path(tmp) / "cgan_runs"
        for c in _k3_counters():
            c.launches = 0
        set_attention_impl("flash")
        try:
            res = cgan_train.train_one_condition(
                data, runs, "no_exo", device=device, arch="transformer",
                epochs=CGAN_EPOCHS, save_every=CGAN_EPOCHS, print_every=1)
        finally:
            set_attention_impl("auto")
        got = tuple(c.launches for c in _k3_counters())
        steps = res["steps_per_epoch"] * CGAN_EPOCHS
        want = tuple(n * steps for n in CGAN_K3)
        if torch.device(device).type != "cuda":
            want = (0, 0, 0)
        secs = res["epoch_seconds"]
        print(f"[cgan-train] v1 no_exo, 9 x ({CGAN_WINDOWS}, {SEQ_LEN}, {CHANNELS}), "
              f"dim 256 depth 4 heads 4 patch 8, batch 64: {steps} steps in "
              f"{sum(secs):.2f} s (epochs {['%.3f' % t for t in secs]} s; epoch 2: "
              f"{secs[-1] / res['steps_per_epoch'] * 1e3:.1f} ms per step, R1 at steps "
              f"0 and 8); launches flash_forward {got[0]} (expected {want[0]}), "
              f"flash_dq {got[1]} (expected {want[1]}), flash_dkv {got[2]} "
              f"(expected {want[2]}) | {smi}", flush=True)
        if got != want:
            fail(f"CGAN training launch counts {got} != expected {want}")
        run = runs / "no_exo"
        names = ["hparams.json", "metrics.csv", f"checkpoint_epoch{CGAN_EPOCHS}.npz",
                 f"CGAN_generator_no_exo_epoch{CGAN_EPOCHS}.npz",
                 "CGAN_generator_no_exo_best.npz", "CGAN_generator_no_exo_last.npz",
                 "CGAN_globalD_no_exo_best.npz", "CGAN_localD_no_exo_best.npz"]
        missing = [n for n in names if not (run / n).exists()]
        if missing:
            fail(f"CGAN artifacts missing {missing}")
        rows = np.loadtxt(run / "metrics.csv", delimiter=",", skiprows=1, ndmin=2)
        if rows.shape != (CGAN_EPOCHS, 11) or not np.isfinite(rows).all():
            fail(f"CGAN metrics.csv {rows.shape} finite {np.isfinite(rows).all()}")
        G, bn, cfg, _ = cgan_train.load_generator(
            run / "CGAN_generator_no_exo_best.npz", device=device)
        x = cgan_train.generate_batch(G, bn, cfg, torch.Generator(device=device)
                                      .manual_seed(0), 16, 3)
        if x.shape != (16, CHANNELS, SEQ_LEN) or not torch.isfinite(x).all():
            fail(f"the best CGAN generator gave {tuple(x.shape)}")
        print(f"[cgan-train] artifacts written; metrics.csv epoch {CGAN_EPOCHS}: "
              f"g_loss {rows[-1, 1]:.4f}, d_loss {rows[-1, 2]:.4f}; the best "
              f"generator reloads and generates", flush=True)
    return dict(zip(("flash_forward", "flash_dq", "flash_dkv"), got))


def _perturbed_generator(cfg, g: torch.Generator) -> dict:
    """A generator on the host whose adaLN weights are 0.02·N(0, 1), not
    zero: a fresh generator's blocks are the identity, and its attention's
    gradient exactly zero, so a check from init would check nothing."""
    G, _ = cgan_train.generator_init(cfg, g, device="cpu")
    for ada in [G[f"blk{i}"]["ada"] for i in range(cfg.depth)] + [G["head_ada"]]:
        ada["w"] = 0.02 * torch.randn(ada["w"].shape, generator=g)
    return G


def _cgan_step_inputs(B: int, device, seed: int, **hp_over):
    """A full-width model (the transformer v1 unless ``hp_over`` says
    otherwise; its adaLN weights perturbed), bn state, 9 (v1) or 2 (v2)
    classes of B random windows on ``device``, and one step's draws made
    on the host and moved to ``device``."""
    hp = cgan_train.CGANHParams(**{"arch": "transformer", **hp_over, "batch_size": B})
    K = 9 if hp.variant == "v1" else 2
    cfg = cgan_train.build_cfg(hp, K)
    g = torch.Generator().manual_seed(seed)
    if hp.arch == "transformer":
        G, bn = _perturbed_generator(cfg, g), {}
    else:
        G, bn = cgan_train.generator_init(cfg, g, device="cpu")
    D = {k: cgan_train.disc_init(cfg, g, device="cpu") for k in ("dg", "dl")}
    X = torch.rand((K * B, CHANNELS, SEQ_LEN), generator=g)
    table = torch.arange(K * B).reshape(K, B)
    counts = torch.full((K,), float(B))
    draws = cgan_train.draw_cgan_step(g, hp, cfg, table, counts, prewarm=False,
                                      device="cpu")
    to = lambda tree: tree_map(lambda t: t.to(device), tree)  # noqa: E731
    return (hp, cfg, to(G), to(bn), to(D), X.to(device),
            cgan_train.draws_to(draws, device))


def _run_cgan_step(hp, cfg, G, bn, D, X, draws, step_idx, timer=None):
    optG = cgan_train.Adam(hp.lr_g, hp.beta1, hp.beta2)
    optD = cgan_train.Adam(hp.lr_d, hp.beta1, hp.beta2)
    return cgan_train.cgan_step(G, bn, D, G, optG.init(G), optD.init(D), X, draws,
                                step_idx, 0.1, cfg=cfg, hp=hp, optG=optG, optD=optD,
                                prewarm=False, timer=timer)


def phase_cgan_step_check(smi: str, device: str = "cuda") -> None:
    """One CGAN step (R1 on, flash forced) on the card against the same step
    on the CPU with the plain versions: B 8, full width, the same draws."""
    set_attention_impl("flash")
    try:
        _cgan_step_check(smi, device, "v1 B=8 dim 256 depth 4, R1 on, flash forced",
                         seed=4)
    finally:
        set_attention_impl("auto")


def _leaf_names(tree, prefix: str = "") -> list[str]:
    """The dotted path of each leaf of ``tree``, in tree_leaves' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}{i}.")]
    return [] if tree is None else [prefix[:-1]]


def _f64(x):
    """``x`` (a tensor, a tree or the step's draws) with every floating
    tensor in float64."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _f64(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(_f64(v) for v in x)
    if isinstance(x, dict):
        return {k: _f64(v) for k, v in x.items()}
    return x


def _cgan_step_check(smi: str, device: str, what: str, seed: int, **hp_over) -> None:
    """One CGAN step (step index 0: R1 fires) on ``device`` against the
    same step on the CPU with the plain versions, B 8, full width, the same
    draws: the logs, each parameter leaf and its Adam first moments, and the
    bn state within the CGAN_* tolerances. The same step in float64 on the
    CPU says how far the CPU's float32 step itself is from exact."""
    hp, cfg, G, bn, D, X, draws = _cgan_step_inputs(8, device, seed, **hp_over)
    conv = hp.arch != "transformer"
    mu_rtol = CGAN_CONV_MU_RTOL if conv else CGAN_MU_RTOL
    cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    t0 = time.perf_counter()
    card = _run_cgan_step(hp, cfg, G, bn, D, X, draws, 0)
    _sync(device)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_draws = cgan_train.draws_to(draws, "cpu")
    host = _run_cgan_step(hp, cfg, cpu(G), cpu(bn), cpu(D), X.cpu(), host_draws, 0)
    cpu_s = time.perf_counter() - t0
    exact = _run_cgan_step(hp, cfg, _f64(cpu(G)), _f64(cpu(bn)), _f64(cpu(D)),
                           X.cpu().double(), _f64(host_draws), 0)
    logs, ref = card[-1].cpu(), host[-1]
    log_err = ((logs - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    mu_err = host_err = p_err = rounding_g = 0.0
    excused, rounding = [], []
    for net, i in (("G", 0), ("D", 2)):
        state, ref_state, exact_state = card[4 + i // 2], host[4 + i // 2], exact[4 + i // 2]
        for name, p, pr, m, mr, m64 in zip(
                _leaf_names(host[i]), tree_leaves(card[i]), tree_leaves(host[i]),
                tree_leaves(state.mu), tree_leaves(ref_state.mu),
                tree_leaves(exact_state.mu)):
            m, p = m.cpu(), p.cpu()
            far = (p - pr).abs() > CGAN_PARAM_ATOL
            g_scale = mr.abs().max().item() / (1 - hp.beta1)
            if g_scale <= CGAN_GRAD_FLOOR:
                rounding_g = max(rounding_g, m.abs().max().item() / (1 - hp.beta1))
                if far.any():
                    rounding.append(f"{net}.{name} {int(far.sum())}/{far.numel()}")
                continue
            scale = mr.abs().max().item()
            tol = min(CGAN_MU_RTOL * max(1.0, scale), mu_rtol * scale)
            mu_err = max(mu_err, (m - mr).abs().max().item() / tol)
            host_err = max(host_err, (mr.double() - m64).abs().max().item() / scale)
            floor = max(CGAN_GRAD_FLOOR, tol / (1 - hp.beta1)) if conv else CGAN_GRAD_FLOOR
            small = mr.abs() / (1 - hp.beta1) <= floor
            if (far & ~small).any():
                p_err = max(p_err, (p - pr).abs()[far & ~small].max().item())
            n = int((far & small).sum())
            if n:
                excused.append((n / far.numel(), n, f"{net}.{name} {n}/{far.numel()}"))
    excused.sort(reverse=True)
    share = excused[0][0] if excused else 0.0
    bn_err = max([(a.cpu() - b).abs().max().item()
                  for a, b in zip(tree_leaves(card[1]), tree_leaves(host[1]))] or [0.0])
    print(f"[check] CGAN step {what}, card vs "
          f"CPU plain path: logs card {[round(v, 6) for v in logs.tolist()]}, CPU "
          f"{[round(v, 6) for v in ref.tolist()]}", flush=True)
    print(f"[check]   logs max relative diff {log_err:.3e} (tol {CGAN_LOG_RTOL:g}); "
          f"Adam first moments at {mu_err:.3f} of their tolerance (must be <= 1: per "
          f"leaf {mu_rtol:g} of its largest, {CGAN_MU_RTOL:g} of the larger of that and "
          f"1; the CPU's float32 step departs from its float64 step by {host_err:.3e} of "
          f"a leaf's largest); "
          f"parameters beyond {CGAN_PARAM_ATOL:g}: {p_err:.3e} (must be 0); "
          f"{sum(n for _, n, _ in excused)} elements "
          f"with |g| <= " + ("the moments' tolerance" if conv else f"{CGAN_GRAD_FLOOR:g}")
          + " excused, per leaf: "
          f"{', '.join(e for *_, e in excused) or 'none'} (at most "
          f"{CGAN_EXCUSED_SHARE:g} of a leaf: {share:.2e}); leaves at rounding level "
          f"(|g| <= {CGAN_GRAD_FLOOR:g} on both, card {rounding_g:.2e}; zero by "
          f"construction) moved by ±lr on their noise's sign: "
          f"{', '.join(rounding) or 'none'}; "
          + (f"bn state {bn_err:.3e} (tol {CGAN_BN_ATOL:g}); " if card[1] else "")
          + f"step {card_s:.3f} s on the card, {cpu_s:.3f} s on the CPU | {smi}",
          flush=True)
    if (not torch.isfinite(logs).all() or log_err > CGAN_LOG_RTOL or mu_err > 1
            or p_err > 0 or share > CGAN_EXCUSED_SHARE or rounding_g > CGAN_GRAD_FLOOR
            or bn_err > CGAN_BN_ATOL):
        fail(f"the card's CGAN step ({what}) disagrees with the CPU: logs {log_err}, "
             f"moments {mu_err} of their tolerance, params {p_err}, excused share {share}, "
             f"rounding-level gradient {rounding_g}, bn {bn_err}")


def phase_cgan_serve(smi: str, device: str = "cuda") -> int:
    """A patch-1 transformer generator (768 tokens) served over HTTP with
    "auto" attention: K3a must fire depth x micro-batches times; the card's X
    against the CPU plain generator on the same noise. Returns the K3a
    launches of the served run."""
    hp = cgan_train.CGANHParams(arch="transformer", tf_patch=1)
    cfg = cgan_train.build_cfg(hp, 9)
    G = _perturbed_generator(cfg, torch.Generator().manual_seed(5))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "cgan"
        (root / "no_exo").mkdir(parents=True)
        save_checkpoint(root / "no_exo" / "CGAN_generator_no_exo_best.npz",
                        {"model": tree_to_numpy(G), "bn": {}},
                        cgan_train.generator_meta(hp, 9, "no_exo"))
        reg = ModelRegistry(None, None, device=device, cgan_root=root)
        srv = make_server(reg, "127.0.0.1", 0, SERVE_BATCH, TIME_CHUNK)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            health = _get(srv.server_address, "/healthz")
            if health != {"status": "ok", "runs": [], "cgan": ["no_exo"]}:
                fail(f"/healthz: {health}")
            body = {"model": "no_exo", "label": 4, "n": SERVE_BATCH, "seed": 3}
            walls = []
            for _ in range(3):       # three identical requests; the last is read
                flash_forward.launches = 0
                X, wall = _post(srv.server_address, body, "/synthesize_cgan")
                walls.append(wall)
            launches = flash_forward.launches
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
    want = cfg.depth if torch.device(device).type == "cuda" else 0
    print(f"[serve-cgan] POST /synthesize_cgan {json.dumps(body)} -> {X.shape}, "
          f"patch 1 ({cfg.tokens} tokens), 'auto' attention: "
          f"{['%.1f' % (w * 1e3) for w in walls]} ms, "
          f"{SERVE_BATCH / walls[-1]:.1f} windows/s warm; flash_forward launches "
          f"{launches} (expected {want}) | {smi}", flush=True)
    if X.shape != (SERVE_BATCH, SEQ_LEN, CHANNELS) or not np.isfinite(X).all():
        fail(f"/synthesize_cgan returned {X.shape}")
    if launches != want:
        fail(f"/synthesize_cgan launched flash_forward {launches} times, "
             f"expected {want}")
    gen = torch.Generator(device=device).manual_seed(body["seed"])
    z = torch.randn((SERVE_BATCH, cfg.noise_dim), generator=gen, device=device)
    rows = min(CGAN_SERVE_CHECK_ROWS, SERVE_BATCH)
    with torch.inference_mode():
        ref = cgan_generator_apply(G, {}, z[:rows].cpu(),
                                   torch.full((rows,), body["label"]), cfg,
                                   train=False)[0]
    err = np.abs(X[:rows] - ref.numpy().transpose(0, 2, 1)).max()
    print(f"[serve-cgan] served X vs the CPU plain generator on the same noise, "
          f"first {rows} rows: max|diff|={err:.3e} (tol {CGAN_SERVE_TOL:g})",
          flush=True)
    if err > CGAN_SERVE_TOL:
        fail(f"served CGAN X disagrees with the CPU plain generator: {err}")
    return launches


def phase_cgan_wide(smi: str, device: str = "cuda") -> dict:
    """train_one_condition (v1) of a transformer CGAN with head dim 256
    (dim 512, 2 heads) at patch 1 (768 tokens), batch 8, 1 epoch, "auto"
    attention: the generator's attention runs the wide kernels (per step as
    CGAN_K3), the tensor-core ones never. Returns the wide launch counts."""
    with tempfile.TemporaryDirectory() as tmp:
        data = _write_posture_buckets(Path(tmp), CGAN_WIDE_BATCH)
        runs = Path(tmp) / "cgan_runs"
        for c in _k3_counters():
            c.launches = c.wide_launches = 0
        res = cgan_train.train_one_condition(
            data, runs, "no_exo", device=device, arch="transformer", epochs=1,
            save_every=1, print_every=1, batch_size=CGAN_WIDE_BATCH, tf_dim=512,
            tf_heads=2, tf_patch=1)
        wide = tuple(c.wide_launches for c in _k3_counters())
        tc = tuple(c.launches for c in _k3_counters())
        steps = res["steps_per_epoch"]
        want = tuple(n * steps for n in CGAN_K3)
        if torch.device(device).type != "cuda":
            want = (0, 0, 0)
        print(f"[cgan-wide] v1 no_exo, 9 x ({CGAN_WIDE_BATCH}, {SEQ_LEN}, {CHANNELS}), "
              f"dim 512 depth 4 heads 2 (head dim 256) patch 1 (768 tokens), batch "
              f"{CGAN_WIDE_BATCH}, 'auto' attention: {steps} steps in "
              f"{sum(res['epoch_seconds']):.2f} s; wide launches flash_forward "
              f"{wide[0]}, flash_dq {wide[1]}, flash_dkv {wide[2]} (expected {want}); "
              f"tensor-core launches {tc} (expected (0, 0, 0)) | {smi}", flush=True)
        if wide != want or tc != (0, 0, 0):
            fail(f"the wide CGAN run launched wide {wide}, tensor-core {tc}; "
                 f"expected wide {want}")
        rows = np.loadtxt(runs / "no_exo" / "metrics.csv", delimiter=",", skiprows=1,
                          ndmin=2)
        if rows.shape != (1, 11) or not np.isfinite(rows).all() or not \
                (runs / "no_exo" / "CGAN_generator_no_exo_best.npz").exists():
            fail(f"wide CGAN metrics.csv {rows.shape} finite {np.isfinite(rows).all()}")
    return dict(zip(("flash_forward_wide", "flash_dq_wide", "flash_dkv_wide"), wide))


def _layer_split(run_step, device: str) -> tuple[float, dict]:
    """(total ms, {layer: ms}) of ``run_step(timer)``, host clock,
    synchronised at each layer's end."""
    split: dict[str, float] = {}
    last = [time.perf_counter()]

    def timer(name):
        _sync(device)
        now = time.perf_counter()
        split[name] = split.get(name, 0.0) + (now - last[0]) * 1e3
        last[0] = now

    t0 = last[0] = time.perf_counter()
    run_step(timer)
    return (time.perf_counter() - t0) * 1e3, split


def _profile_step(run_step) -> tuple[list, float, float]:
    """torch.profiler over one ``run_step()`` on the card: (its device
    operations, their device time in ms, the wall time in ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    return on_card, sum(e.self_device_time_total for e in on_card) / 1e3, wall_ms


def phase_cgan_layers(smi: str, device: str = "cuda") -> None:
    """Where one training step's time goes at the training shape (B 64,
    full width, flash forced): host clock per layer, synchronised at each
    layer's end, for a step without R1 and one with; then the card's busy
    share and the K3 kernels' device time over one step (no R1)."""
    hp, cfg, G, bn, D, X, draws = _cgan_step_inputs(64, device, seed=6)
    set_attention_impl("flash")
    try:
        _run_cgan_step(hp, cfg, G, bn, D, X, draws, 1)             # warm-up
        _sync(device)
        for step_idx, what in ((1, "no R1"), (0, "R1")):
            total, split = _layer_split(
                lambda timer: _run_cgan_step(hp, cfg, G, bn, D, X, draws,  # noqa: B023
                                             step_idx, timer), device)
            names = {"d_step": "D step (G forward: 4 K3a; 4 D passes, dense attention"
                               + (", R1 double backward" if step_idx == 0 else "") + ")",
                     "g_forward": "G-step forward (4 K3a, D passes, losses)",
                     "g_backward": "G-step backward (4 K3b + 4 K3c)",
                     "optimizers": "Adam G and D, EMA"}
            print(f"[layers] one CGAN step B=64 dim 256 depth 4, {what}: {total:.1f} ms: "
                  + "; ".join(f"{names[k]} {v:.1f} ms" for k, v in split.items())
                  + f" | {smi}", flush=True)
        if torch.device(device).type != "cuda":
            return
        on_card, dev_ms, wall_ms = _profile_step(
            lambda: _run_cgan_step(hp, cfg, G, bn, D, X, draws, 1))
    finally:
        set_attention_impl("auto")

    def kernel_ms(tag):
        return sum(e.self_device_time_total for e in on_card if tag in e.key) / 1e3

    # K3c's time includes its split pre-pass (flash_dkv_split_kernel)
    k3 = [kernel_ms(t) for t in ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_")]
    print(f"[profile] one CGAN step B=64 (no R1): device time {dev_ms:.1f} ms in "
          f"{wall_ms:.1f} ms wall ({100 * dev_ms / wall_ms:.1f} % busy) over "
          f"{sum(e.count for e in on_card)} device operations: K3a {k3[0]:.3f} ms, "
          f"K3b {k3[1]:.3f} ms, K3c {k3[2]:.3f} ms ({100 * sum(k3) / dev_ms:.1f} % of "
          f"device time) | {smi}", flush=True)
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:6]
    print("[profile] largest device operations: " + "; ".join(
        f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.1f} ms"
        for e in top), flush=True)


def _hand_kernel_counts() -> dict:
    """Every hand kernel's launch counter: K1 forward and backward, K2, and
    K3a / K3b / K3c on the tensor cores and past head dim 128."""
    counts = {"gru_sequence": gru_sequence.launches,
              "gru_sequence_bwd": gru_sequence_bwd.launches,
              "multigru_disc_inputs": multigru_disc_inputs.launches}
    for c in _k3_counters():
        counts[c.__name__] = c.launches
        counts[c.__name__ + "_wide"] = c.wide_launches
    return counts


def _zero_hand_kernel_counts() -> None:
    gru_sequence.launches = gru_sequence_bwd.launches = 0
    multigru_disc_inputs.launches = 0
    for c in _k3_counters():
        c.launches = c.wide_launches = 0


def _all_f32(trees) -> bool:
    return all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
               for t in tree_leaves(trees))


def _conv_artifacts(run: Path, res: dict, epochs: int, tag: str = "no_exo") -> np.ndarray:
    """The 8 artifacts of a run, its metrics.csv finite; the epoch and last
    generator files hold the bn the trainer returned, the best one a
    finite bn of the conv generator's layout. Returns the metrics rows."""
    names = ["hparams.json", "metrics.csv", f"checkpoint_epoch{epochs}.npz",
             f"CGAN_generator_{tag}_epoch{epochs}.npz", f"CGAN_generator_{tag}_best.npz",
             f"CGAN_generator_{tag}_last.npz", f"CGAN_globalD_{tag}_best.npz",
             f"CGAN_localD_{tag}_best.npz"]
    missing = [n for n in names if not (run / n).exists()]
    if missing:
        fail(f"conv CGAN artifacts missing {missing}")
    rows = np.loadtxt(run / "metrics.csv", delimiter=",", skiprows=1, ndmin=2)
    if rows.shape[1] != 11 or not np.isfinite(rows).all():
        fail(f"conv CGAN metrics.csv {rows.shape} finite {np.isfinite(rows).all()}")
    want = tree_to_numpy(res["bn"])
    for which in (f"epoch{epochs}", "last", "best"):
        trees, _ = load_checkpoint(run / f"CGAN_generator_{tag}_{which}.npz")
        got = trees["bn"]
        if sorted(got) != [f"up{i}" for i in range(1, 6)] or not all(
                np.isfinite(a).all() for a in tree_leaves(got)):
            fail(f"{which} generator's bn {sorted(got)}")
        if which != "best" and not all(np.array_equal(a, b) for a, b in
                                       zip(tree_leaves(got), tree_leaves(want))):
            fail(f"the {which} generator's bn is not the trainer's")
    return rows


def _conv_step_ms(device: str, precision: str) -> tuple[float, list]:
    """Two epochs of 9 steps at B 64 on one model (R1 at steps 0 and 8 of
    each, as the trainer), each step synchronised: the median of the
    second epoch's step times (ms) and all of them."""
    hp = cgan_train.CGANHParams(precision_d=precision, batch_size=CGAN_CONV_BATCH)
    cfg = cgan_train.build_cfg(hp, 9)
    g = torch.Generator().manual_seed(7)
    G, bn = cgan_train.generator_init(cfg, g, device=device)
    D = {k: cgan_train.disc_init(cfg, g, device=device) for k in ("dg", "dl")}
    optG = cgan_train.Adam(hp.lr_g, hp.beta1, hp.beta2)
    optD = cgan_train.Adam(hp.lr_d, hp.beta1, hp.beta2)
    ema, gs, ds = G, optG.init(G), optD.init(D)
    X = torch.rand((9 * CGAN_WINDOWS, CHANNELS, SEQ_LEN), generator=g).to(device)
    table = torch.arange(9 * CGAN_WINDOWS, device=device).reshape(9, CGAN_WINDOWS)
    counts = torch.full((9,), float(CGAN_WINDOWS), device=device)
    gen = torch.Generator(device=device).manual_seed(8)
    times = []
    for _ in range(2):
        for step_idx in range(9):
            draws = cgan_train.draw_cgan_step(gen, hp, cfg, table, counts,
                                              prewarm=False, device=device)
            _sync(device)
            t0 = time.perf_counter()
            G, bn, D, ema, gs, ds, logs = cgan_train.cgan_step(
                G, bn, D, ema, gs, ds, X, draws, step_idx, 0.1, cfg=cfg, hp=hp,
                optG=optG, optD=optD, prewarm=False)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
    if not torch.isfinite(logs).all():
        fail(f"the timed conv steps ({precision}) gave logs {logs.tolist()}")
    return statistics.median(times[9:]), times


def phase_cgan_conv(smi: str, device: str = "cuda") -> None:
    """The conv CGAN (the JAX default, arch "conv") at the JAX defaults:
    v1 trained 2 epochs at B 64 on 9 random posture buckets (artifacts, bn
    in the generator files, the best generator reloaded), 1 epoch with
    precision_d="bf16" (finite logs, every leaf float32), v2 with 1 prewarm
    epoch and 1 epoch; one v1 step (R1 on) and one v2 step (keep masks) on
    the card against the CPU; the trained generator served over
    /synthesize_cgan against the CPU generator; the warm step time in f32
    and bf16 with a per-layer split and the card's busy share. No hand
    kernel may launch in the phase: the convolutions are cuDNN's. With
    ``device="cpu"`` it rehearses the phase (no timing on the profiler)."""
    t_phase = time.perf_counter()
    _zero_hand_kernel_counts()
    with tempfile.TemporaryDirectory() as tmp:
        data = _write_posture_buckets(Path(tmp), CGAN_WINDOWS, ("no_exo", "with_exo"))
        runs = Path(tmp) / "conv_runs"
        res = cgan_train.train_one_condition(
            data, runs, "no_exo", device=device, epochs=CGAN_EPOCHS,
            save_every=CGAN_EPOCHS, print_every=1, batch_size=CGAN_CONV_BATCH)
        run = runs / "no_exo"
        rows = _conv_artifacts(run, res, CGAN_EPOCHS)
        steps = res["steps_per_epoch"] * CGAN_EPOCHS
        G, bn, cfg, meta = cgan_train.load_generator(run / "CGAN_generator_no_exo_best.npz",
                                                     device=device)
        x = cgan_train.generate_batch(G, bn, cfg, torch.Generator(device=device)
                                      .manual_seed(0), 16, 3)
        if (meta["arch"] != "conv" or x.shape != (16, CHANNELS, SEQ_LEN)
                or not (x.min() >= 0 and x.max() <= 1)):
            fail(f"the best conv generator ({meta.get('arch')}) gave {tuple(x.shape)} "
                 f"in [{x.min().item()}, {x.max().item()}]")
        secs = res["epoch_seconds"]
        print(f"[cgan-conv] v1 no_exo arch conv, 9 x ({CGAN_WINDOWS}, {SEQ_LEN}, "
              f"{CHANNELS}), G 512->16 channels, D 14->512, batch {CGAN_CONV_BATCH}: "
              f"{steps} steps in "
              f"{sum(secs):.2f} s (epochs {['%.3f' % t for t in secs]} s; R1 at steps 0 "
              f"and 8); 8 artifacts, metrics.csv finite (epoch {CGAN_EPOCHS}: g_loss "
              f"{rows[-1, 1]:.4f}, d_loss {rows[-1, 2]:.4f}), the generator files' bn "
              f"the trainer's, the best generator reloads: {tuple(x.shape)} in [0, 1] "
              f"| {smi}", flush=True)
        res16 = cgan_train.train_one_condition(
            data, Path(tmp) / "conv_bf16", "no_exo", device=device, epochs=1,
            save_every=1, print_every=1, precision_d="bf16", batch_size=CGAN_CONV_BATCH)
        rows16 = _conv_artifacts(Path(tmp) / "conv_bf16" / "no_exo", res16, 1)
        leaves = (res16["G"], res16["bn"], res16["D"], res16["ema"], res16["g_state"].mu,
                  res16["g_state"].nu, res16["d_state"].mu, res16["d_state"].nu)
        if not _all_f32(leaves):
            fail("the bf16 D run left a parameter or moment that is not finite float32")
        print(f"[cgan-conv] precision_d bf16, 1 epoch: {res16['steps_per_epoch']} steps "
              f"in {res16['epoch_seconds'][0]:.2f} s; logs finite (g_loss "
              f"{rows16[-1, 1]:.4f}, d_loss {rows16[-1, 2]:.4f}); every parameter and "
              f"optimizer leaf float32 | {smi}", flush=True)
        res2 = cgan_train.train_one_posture(data, Path(tmp) / "conv_v2", 1, device=device,
                                            prewarm=1, epochs=1, save_every=2,
                                            print_every=1, batch_size=CGAN_CONV_BATCH)
        rows2 = _conv_artifacts(Path(tmp) / "conv_v2" / "posture1", res2, 2, "posture1")
        if rows2.shape[0] != 2 or rows2[0, 2] != 0 or rows2[0, 3:].any():
            fail(f"v2 metrics.csv {rows2.tolist()}: the prewarm epoch must not update D")
        print(f"[cgan-conv] v2 posture1 (2 x {CGAN_WINDOWS} windows), 1 prewarm epoch + 1: "
              f"{res2['g_state'].count} G and {res2['d_state'].count} D updates, "
              f"artifacts and metrics.csv as expected | {smi}", flush=True)
        served = _conv_serve(smi, run, device)
        phase_cgan_eval(smi, Path(tmp), device)
    for variant, what in (("v1", "conv v1 B=8, R1 on"), ("v2", "conv v2 B=8, keep masks")):
        _cgan_step_check(smi, device, what, seed=9, arch="conv",
                         **(cgan_train.V2_OVERRIDES if variant == "v2" else {}))
    ms = {}
    for precision in ("f32", "bf16"):
        ms[precision], times = _conv_step_ms(device, precision)
        print(f"[cgan-conv] warm conv step B={CGAN_CONV_BATCH} {precision}: median of the second epoch "
              f"{ms[precision]:.2f} ms ({1e3 / ms[precision]:.2f} steps/s); steps "
              f"{['%.1f' % t for t in times]} ms | {smi}", flush=True)
    hp, cfg, G, bn, D, X, draws = _cgan_step_inputs(CGAN_CONV_BATCH, device, 10,
                                                    arch="conv")
    _run_cgan_step(hp, cfg, G, bn, D, X, draws, 1)                 # warm-up
    for step_idx, what in ((1, "no R1"), (0, "R1")):
        total, split = _layer_split(
            lambda timer: _run_cgan_step(hp, cfg, G, bn, D, X, draws,  # noqa: B023
                                         step_idx, timer), device)
        names = {"d_step": "D step (G forward in train mode; 4 D passes"
                           + (", R1 double backward" if step_idx == 0 else "") + ")",
                 "g_forward": "G-step forward (G, 2 D passes, features, losses)",
                 "g_backward": "G-step backward", "optimizers": "Adam G and D, EMA"}
        print(f"[layers] one conv CGAN step B={CGAN_CONV_BATCH} f32, {what}: {total:.1f} ms: "
              + "; ".join(f"{names[k]} {v:.1f} ms" for k, v in split.items())
              + f" | {smi}", flush=True)
    if torch.device(device).type == "cuda":
        on_card, dev_ms, wall_ms = _profile_step(
            lambda: _run_cgan_step(hp, cfg, G, bn, D, X, draws, 1))
        conv_ms = sum(e.self_device_time_total for e in on_card
                      if "conv" in e.key.lower() or "cudnn" in e.key.lower()
                      or "xmma" in e.key.lower() or "sm90" in e.key.lower()) / 1e3
        print(f"[profile] one conv CGAN step B=64 f32 (no R1): device time {dev_ms:.1f} ms "
              f"in {wall_ms:.1f} ms wall ({100 * dev_ms / wall_ms:.1f} % busy) over "
              f"{sum(e.count for e in on_card)} device operations; convolution kernels "
              f"{conv_ms:.1f} ms | {smi}", flush=True)
        top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:6]
        print("[profile] largest device operations: " + "; ".join(
            f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.1f} ms"
            for e in top), flush=True)
    counts = _hand_kernel_counts()
    print(f"[cgan-conv] hand-kernel launches over the phase: {counts} (all must be 0); "
          f"the phase took {time.perf_counter() - t_phase:.1f} s | {smi}", flush=True)
    if any(counts.values()):
        fail(f"the conv CGAN phase launched a hand kernel: {counts}")
    if served < 1:
        fail("the conv generator served no request")


def _read_csv(path: Path) -> tuple[list[str], np.ndarray]:
    """A metric CSV's header and its numeric columns (after level, posture
    and, for the predictive one, split)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    skip = 3 if rows[0][2] == "split" else 2
    return rows[0], np.array([[float(v) for v in r[skip:]] for r in rows[1:]])


CGAN_CSV_HEADERS = {"metrics_discriminative.csv": ["level", "posture", "acc", "auc"],
                    "metrics_predictive.csv": ["level", "posture", "split", "rmse", "r2"],
                    "metrics_stats.csv": ["level", "posture", "psd_l1", "acf_l1", "coh_l1"]}


def _check_cgan_csvs(out: Path, n_real: int, n_gen: int, n_postures: int) -> None:
    """The CSV trio of one evaluation of ``n_postures`` postures, ``n_real``
    and ``n_gen`` windows a posture: the JAX package's headers, finite
    values, one global row and one a posture over the guards (20 windows
    for the discriminative rows, 10 a side for the others; two a posture in
    the predictive one)."""
    for name, header in CGAN_CSV_HEADERS.items():
        got, values = _read_csv(out / name)
        guarded = (n_real + n_gen >= 20 if name == "metrics_discriminative.csv"
                   else min(n_real, n_gen) >= 10)
        rows = (2 if name == "metrics_predictive.csv" else 1) * (
            1 + n_postures * guarded)
        if got != header or values.shape[0] != rows or not np.isfinite(values).all():
            fail(f"{out / name}: header {got}, {values.shape[0]} rows (expected "
                 f"{rows}), finite {np.isfinite(values).all()}")


def _rows_within(what: str, card: list, host: list, n_test: dict) -> float:
    """Largest departure of the card's metric rows from the CPU's, each in
    units of its tolerance; fails past 1."""
    worst = 0.0
    if len(card) != len(host):
        fail(f"{what}: {len(card)} rows on the card, {len(host)} on the CPU")
    for c, h in zip(card, host):
        for k, v in h.items():
            if k in ("level", "posture", "split"):
                if c[k] != v:
                    fail(f"{what}: {k} {c[k]} != {v}")
                continue
            tol = {"acc": 1.0 / n_test.get(h["posture"], 1),
                   "auc": CGAN_EVAL_AUC_TOL}.get(k, CGAN_EVAL_ATOL + CGAN_EVAL_RTOL * abs(v))
            worst = max(worst, abs(c[k] - v) / tol)
    if worst > 1.0:
        fail(f"{what}: the card's rows depart from the CPU's by {worst:.3f} of "
             f"their tolerance")
    return worst


def phase_cgan_eval(smi: str, root: Path, device: str = "cuda") -> None:
    """Both CGAN eval CLIs (eegsynth_torch.eval.cgan_drivers) on the conv
    runs phase_cgan_conv left in ``root``: ``condition`` on no_exo (v1, the
    scripts' 400 generated windows a posture) and ``posture`` on the v2
    run of posture 1; the CSVs checked; the time split into generation,
    features, fits and statistics (the features timed alone at the same
    shape); then the three metric functions on the card against the CPU."""
    data = root / "cgan_data"
    t0 = time.perf_counter()
    secs = cgan_eval_cli(["condition", "--data-dir", str(data), "--runs-root",
                          str(root / "conv_runs"), "--save-root", str(root / "cgan_eval"),
                          "--condition", "no_exo", "--samples-per-posture",
                          str(CGAN_EVAL_SAMPLES), "--device", device])["no_exo"]
    wall = time.perf_counter() - t0
    _check_cgan_csvs(root / "cgan_eval" / "no_exo", CGAN_WINDOWS, CGAN_EVAL_SAMPLES, 9)
    n_feat = 9 * (CGAN_WINDOWS + CGAN_EVAL_SAMPLES)
    x = np.random.default_rng(0).uniform(0, 1, (n_feat, CHANNELS, SEQ_LEN)) \
        .astype(np.float32)
    feat_s = []
    for _ in range(3):
        _sync(device)
        t1 = time.perf_counter()
        psd_features_tensor(x, device=device)
        _sync(device)
        feat_s.append(time.perf_counter() - t1)
    del x
    feat = min(feat_s)
    fits = secs["discriminative"] - feat + secs["predictive"]
    print(f"[cgan-eval] condition no_exo (v1 conv generator), 9 x {CGAN_WINDOWS} real "
          f"+ 9 x {CGAN_EVAL_SAMPLES} generated windows: {wall:.2f} s; generation "
          f"{secs['generation']:.3f} s, discriminative {secs['discriminative']:.3f} s "
          f"(features of {n_feat} host windows alone {feat:.4f} s), predictive "
          f"{secs['predictive']:.3f} s, statistics {secs['statistics']:.3f} s; fits "
          f"(logistic + ridge) {fits:.3f} s; CSVs checked, finite | {smi}",
          flush=True)

    t0 = time.perf_counter()
    done = cgan_eval_cli(["posture", "--data-dir", str(data), "--runs-root",
                          str(root / "conv_v2"), "--save-root",
                          str(root / "cgan_eval_posture"), "--device", device])
    wall = time.perf_counter() - t0
    if done != [1]:
        fail(f"the posture eval evaluated postures {done}, expected [1]")
    for sub in ("posture1", "global"):
        _check_cgan_csvs(root / "cgan_eval_posture" / sub, 2 * CGAN_WINDOWS,
                         2 * CGAN_WINDOWS, 1)
    print(f"[cgan-eval] posture (v2 conv generator of posture 1, 'match': "
          f"{CGAN_WINDOWS} + {CGAN_WINDOWS} windows a side) and global/ in {wall:.2f} s; "
          f"postures 2-9 skipped (no generator); CSVs finite | {smi}", flush=True)

    # card against CPU on the same arrays, outside the CLIs
    np.random.seed(0)
    Xr, yr, _ = load_condition_dataset(data, "no_exo")
    G, bn, cfg, _ = cgan_train.load_generator(
        root / "conv_runs" / "no_exo" / "CGAN_generator_no_exo_best.npz", device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    Xg = np.concatenate([cgan_train.generate_batch(G, bn, cfg, gen, CGAN_WINDOWS, p)
                         .cpu().numpy() for p in range(9)])
    yg = np.repeat(np.arange(1, 10), CGAN_WINDOWS)
    n_test = {0: int(np.ceil(0.3 * (len(Xr) + len(Xg))))}
    n_test.update({p: int(np.ceil(0.3 * 2 * CGAN_WINDOWS)) for p in range(1, 10)})
    worst, times = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (("discriminative", cgan_eval.discriminative_metrics),
                         ("predictive", cgan_eval.predictive_scores),
                         ("statistics", cgan_eval.stats_similarity)):
            rows = {}
            for dev in (device, "cpu"):
                t1 = time.perf_counter()
                rows[dev] = fn(Xr, Xg, yr, yg, Path(tmp) / f"{name}.csv", device=dev)
                times[(name, dev)] = time.perf_counter() - t1
            worst[name] = _rows_within(name, rows[device], rows["cpu"], n_test)
    print(f"[cgan-eval] card vs CPU, 9 x {CGAN_WINDOWS} real + 9 x {CGAN_WINDOWS} "
          f"generated: " + "; ".join(
              f"{k} {v:.3f} of the tolerance ({times[(k, device)]:.3f} s on the card, "
              f"{times[(k, 'cpu')]:.3f} s on the CPU)" for k, v in worst.items())
          + f" | {smi}", flush=True)


def _conv_serve(smi: str, run: Path, device: str) -> int:
    """The run's best conv generator served over HTTP at serve_batch 256:
    POST /synthesize_cgan n 256, one label, three times; the same seed
    gives the same X, and X is the CPU generator's on the same noise
    (first rows). Returns the requests answered."""
    root = run.parent
    reg = ModelRegistry(None, None, device=device, cgan_root=root)
    srv = make_server(reg, "127.0.0.1", 0, SERVE_BATCH, TIME_CHUNK)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        runs = _get(srv.server_address, "/runs")["cgan"]
        if runs.get("no_exo", {}).get("arch") != "conv":
            fail(f"/runs: {runs}")
        body = {"model": "no_exo", "label": 4, "n": SERVE_BATCH, "seed": 3}
        outs, walls = [], []
        for _ in range(3):
            X, wall = _post(srv.server_address, body, "/synthesize_cgan")
            outs.append(X)
            walls.append(wall)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    X = outs[-1]
    if X.shape != (SERVE_BATCH, SEQ_LEN, CHANNELS) or not np.isfinite(X).all():
        fail(f"/synthesize_cgan (conv) returned {X.shape}")
    if not all(np.array_equal(o, X) for o in outs):
        fail("the seeded conv /synthesize_cgan request did not repeat")
    G, bn, cfg, _ = cgan_train.load_generator(root / "no_exo" / "CGAN_generator_no_exo_best.npz",
                                              device="cpu")
    gen = torch.Generator(device=device).manual_seed(body["seed"])
    z = torch.randn((SERVE_BATCH, cfg.noise_dim), generator=gen, device=device)
    rows = min(CGAN_SERVE_CHECK_ROWS, SERVE_BATCH)
    with torch.inference_mode():
        ref = cgan_train.generator_apply(G, bn, z[:rows].cpu(),
                                         torch.full((rows,), body["label"]), cfg,
                                         train=False)[0]
    err = np.abs(X[:rows] - ref.numpy().transpose(0, 2, 1)).max()
    print(f"[serve-cgan] conv: POST /synthesize_cgan {json.dumps(body)} -> {X.shape}: "
          f"{['%.1f' % (w * 1e3) for w in walls]} ms, {SERVE_BATCH / walls[-1]:.1f} "
          f"windows/s warm; the seeded request repeats; X vs the CPU generator on the "
          f"same noise, first {rows} rows: max|diff|={err:.3e} (tol {CGAN_SERVE_TOL:g}) "
          f"| {smi}", flush=True)
    if err > CGAN_SERVE_TOL:
        fail(f"served conv CGAN X disagrees with the CPU generator: {err}")
    return len(outs)


def main() -> None:
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    phase_sass()
    kern = phase_kernels(smi)
    phase_t1(smi)
    phase_auto_rule(smi)
    serve_launches = phase_serve(smi, kern["gru_sequence"]["ms"])
    if serve_launches < 1:
        fail("the served run launched gru_sequence no time")
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = phase_train(smi, Path(tmp))
        eval_launches = phase_eval(smi, Path(tmp))
        synth_launches = phase_synth_bf16(smi, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        seq_launches = phase_train_seq(smi, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        wide_launches = phase_train(smi, Path(tmp), n_buckets=WIDE_BUCKETS,
                                    channels=WIDE_CHANNELS, gan_steps=WIDE_GAN_STEPS)
    phase_step_check(smi)
    phase_train_layers(smi)
    cgan_launches = phase_cgan_train(smi)
    phase_cgan_step_check(smi)
    cgan_serve_launches = phase_cgan_serve(smi)
    phase_cgan_layers(smi)
    wide_attn_launches = phase_cgan_wide(smi)
    phase_cgan_conv(smi)
    launches = {**cgan_launches, **wide_attn_launches,
                "gru_sequence": serve_launches + train_launches["gru_sequence"]
                + eval_launches["gru_sequence"] + synth_launches
                + seq_launches["gru_sequence"] + wide_launches["gru_sequence"],
                "gru_sequence_bwd": train_launches["gru_sequence_bwd"]
                + eval_launches["gru_sequence_bwd"] + seq_launches["gru_sequence_bwd"]
                + wide_launches["gru_sequence_bwd"],
                "multigru_disc_inputs": train_launches["multigru_disc_inputs"]
                + seq_launches["multigru_disc_inputs"]
                + wide_launches["multigru_disc_inputs"],
                "flash_forward": cgan_launches["flash_forward"] + cgan_serve_launches}
    for k, n in launches.items():
        if n < 1:
            fail(f"the main paths launched {k} no time")
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    sources = {"gru_sequence": ("eegsynth_torch/csrc/gru_seq.cu",
                                "eegsynth/nn/pallas_gru.py:52"),
               "gru_sequence_bwd": ("eegsynth_torch/csrc/gru_seq.cu",
                                    "eegsynth/nn/pallas_gru.py:81"),
               "multigru_disc_inputs": ("eegsynth_torch/csrc/multigru.cu",
                                        "eegsynth/nn/pallas_multigru.py:156"),
               "flash_forward": ("eegsynth_torch/csrc/flash_attn_tc.cu",
                                 "eegsynth/nn/attention.py:130"),
               "flash_dq": ("eegsynth_torch/csrc/flash_attn_tc.cu",
                            "eegsynth/nn/attention.py:231"),
               "flash_dkv": ("eegsynth_torch/csrc/flash_attn_tc.cu",
                             "eegsynth/nn/attention.py:248"),
               "flash_forward_wide": ("eegsynth_torch/csrc/flash_attn_wide.cu",
                                      "eegsynth/nn/attention.py:130"),
               "flash_dq_wide": ("eegsynth_torch/csrc/flash_attn_wide_bwd.cu",
                                 "eegsynth/nn/attention.py:231"),
               "flash_dkv_wide": ("eegsynth_torch/csrc/flash_attn_wide_bwd.cu",
                                  "eegsynth/nn/attention.py:248")}
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[k], **kern[k]}
        for k, (src, rep) in sources.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
