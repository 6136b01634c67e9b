#!/usr/bin/env python3
"""Drive the port's main paths once on one CUDA card and check them: TimeGAN
synthesis serving, multi-bucket TimeGAN training and the eval of what it
synthesized, bf16 and long-horizon synthesis, sequential TimeGAN training
through the CLI, the TimeGAN weight sweep, tuning, controls and
--profile_dir, a TimeGAN past h_dim 128, the reference-checkpoint
converter, the bench tools, CGAN training, serving and eval, transformer
and conv, with the posture stack and the CGAN weight sweep, preprocessing
of raw CSVs and the mental-fatigue reports, the figures, and the one-command
pipeline.

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
             timed in turns with K2's route at z28/h56 and z40/h80; the IIR
             filter kernel (no Pallas kernel: the JAX package's lax.scan) at
             orders 2 and 8, float64 and float32, over a 60 s trial against
             its plain version and over an hour against scipy's lfilter, with
             its step-chain floor; K1's wide route (H past 128, forward and
             backward; the forward on a thread-block cluster up to its cap,
             the streaming kernel past it) against its plain versions at H
             129, 256 and 512 (nb 2, odd B and T) and at the cluster
             route's cap and past it, each line with its route, cluster C
             and rows R and the cluster's step-chain floor, and against
             cuDNN's GRU forward and backward at (1, 768, 64, 256), 512 and
             1024, the cluster forward in turns with the streaming one and
             beside every cluster plan that fits;
4. serve   — two full-width TimeGAN runs (x14/z28/h56, random weights from a
             seed) served over HTTP by eegsynth_torch.serve at
             serve_batch 256 / time_chunk 768; launch counts, seeded
             repeatability, denorm; then a per-layer breakdown of one
             request (host clock, and torch.profiler for the card's busy
             share), card-vs-CPU and chunked-vs-one-shot checks;
5. train   — train_all_buckets on 18 random buckets of (63, 768, 14)
             (x14/z28/h56, the settings of configs/timegan_config.json with
             1 AE epoch, 1 SUP epoch and 3 GAN steps); artifacts, finite
             losses, every ckpt_best served back, the launch counts of K1
             forward, K1 backward and K2 against their expected counts, the
             median GAN-step time; the same on 2 buckets of (63, 768, 20)
             (z40/h80, its D-step inputs through K2 as well) for 2 GAN
             steps; then one GAN step
             against the CPU plain path at 14 and at 20 channels, and a
             per-layer split of one GAN step at nb 18 and its profiler
             line at nb 2 (the same operations);
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
             --time_chunk 1024 --denorm --n 8 (files, launches, the first run
             against synthesize + denorm, the eval picks each file);
5c. train-seq — the CLI ``python -m eegsynth_torch.train.timegan`` in
             this process: one bucket of (100, 768, 14) for 3 GAN steps at
             chunk 2, resumed to 4 (log rows under one header, ckpt_latest's
             step and optimizer count, synthetic.npz), then 2 layers with
             dropout (K1 only); each run's launch counts against their
             expected counts; one GAN step of the 2-layer stack with dropout
             masks against the CPU plain path; the GAN step rate at nb 1,
             B 64 and K2 against the composed route there; the stacked
             trainer's --ckpt_every and --resume on 2 buckets, the resumed
             log bit-identical to the uninterrupted one;
5e. timegan-sweep — one random bucket of (63, 768, 14) through three
             CLIs in this process: ``timegan_sweep`` (S 3, two equal points,
             1 AE + 1 SUP epoch + 2 GAN steps, the statistics),
             ``tune_bucket_weights`` (2 candidates x 2 replicas, 1 GAN
             step) and ``disc_controls`` (two noise arms and half, 3 scorer
             epochs); launch counts exact; whether the equal sweep points
             are bitwise equal on the card; one stacked GAN step at nb 2
             with per-member G weights against the CPU plain path;
5f. profile-dir — ``--profile_dir`` of the TimeGAN CLI, sequential (one
             bucket) and --parallel_buckets (two), one traced GAN step
             each: the Chrome trace parses, and the hand kernels it holds
             (events, device time) against the launches;
5g. timegan-wide — a TimeGAN at x14/z64/h256 through train/timegan.py's
             step functions: one AE and one SUP step, 2 GAN steps at B 16,
             T 768, synthesize(); the wide K1 forward (on its cluster kernel)
             and backward launched, no K2; one GAN step at B 4, T 96 against
             the CPU;
5h. convert — ``python -m eegsynth_torch.convert_torch_ckpt``: a
             reference-shaped TimeGAN checkpoint and conv generator made in
             torch, converted and served over HTTP (the TimeGAN equal to the
             port's model loaded from the same state_dict, the generator to
             the reference forward), generate_long_synth on the converted
             run, --reverse bit for bit;
5i. bench-tools — ``tools.bench_synthesis`` (--parity at n 256 x 8192,
             one row of each model), ``tools.bench_serve`` (4 clients and the
             hung client for 5 s against the server, 0 errors),
             ``tools.bench_kernels`` (H 56, 128, 256, 512 and 1024, forward
             and backward: the wide forward on clusters and, at 1024, the
             streaming one);
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
             the CPU;
6d. cgan-multi — the conv v2 posture stack at B 64 on nine random
             postures, one epoch, through ``python -m
             eegsynth_torch.train.cgan_posture`` with --parallel-postures
             and for one posture without; the artifacts; a stack member's
             step (B 8) against its lone step on the card and on the CPU;
6e. cgan-sweep — ``python -m eegsynth_torch.train.cgan_sweep``: the
             transformer default (dim 256, depth 4, patch 8, tf_remat on)
             at S 3 with two equal points, then conv at S 1, one epoch at
             B 64 each, scored; whether the equal points are bitwise equal
             on the card; a weighted remat step (R1 on) against the CPU;
             the peak memory of one step at S 3 with and without remat.
7. preprocess — ``python -m eegsynth_torch.preprocess`` in this process
             over a raw tree like the reference's 6s_window/ (3 participants
             x 9 postures x 2 conditions, 30 s at 128 Hz, participant 2 at
             50 Hz mains; a rest file, a 5 s trial and a 10-channel trial to
             skip), on the card (the IIR kernel, 4 launches a filtered
             file) and on the CPU: every bucket, prep_index.csv and the skips
             card against CPU; seconds, files/s, the kernel's share;
7b. fatigue — ``python -m eegsynth_torch.fatigue_report``'s five
             subcommands (bandpower, indices, paired, ttest --export-csv
             --scaling p95, participants --inverse-scale) on [preprocess]'s
             buckets, count-matched synthetic windows and its raw tree, on
             the card and on the CPU: every CSV cell card against CPU; the
             seconds of each; the card run's 342 figures, each decoded, not
             blank, of its size, named as the CPU run names them (whose
             figures are recorded, not drawn);
8. figures — 18 pairs of 200 real and 200 synthetic windows (768, 14),
             the synthetic from the TimeGAN cascade on K1 (3 launches a
             pair); ``python -m eegsynth_torch.visualization --zooms
             --paired-legend`` (t-SNE of 6000 of 7200 windows x 10,752
             features, 18 zoom pairs), the eval's pca_tsne_plots at
             --tsne_max 6000, ``python -m eegsynth_torch.preprocessing_plots``
             on one of [preprocess]'s CSVs; every PNG decoded, not blank, of
             its size; PCA (1000 rows) and t-SNE (600 rows) on the card
             against the CPU; the seconds of PCA, t-SNE (iterations, ms an
             iteration) and drawing plus deflate. ``visualization_cgan`` runs
             inside [cgan-conv] on its v2 generator, the CGAN eval's and the
             TimeGAN eval's figures inside [cgan-eval] and [eval].
9. pipeline — ``python -m eegsynth_torch.pipeline`` from a raw tree (3
             participants x 2 postures x 2 conditions of 30 s): the six
             stages as subprocesses of the port's CLIs on the card, every
             manifest status ok, a second call skipping all six;
             ``python -m eegsynth_torch.check_shape`` on its files.

The last three lines are a JSON object listing each kernel (its launches in
the main paths' runs, its error against the plain version, its time, the
plain version's, its bound and what bounds it, and the library call's time
or null),
the nvidia-smi name and power-limit line, and ``{"ok": true, "device": ...}``.
Imports no JAX.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import http.client
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch import EPOC_CHANNELS, _build
from eegsynth_torch.check_shape import main as check_shape_cli
from eegsynth_torch.convert import (
    from_jax_params, to_jax_params, tree_to_numpy, unstack_params,
)
from eegsynth_torch.convert_torch_ckpt import main as convert_cli
from eegsynth_torch.data.datasets import load_condition_dataset
from eegsynth_torch.data.filters import design_filters
from eegsynth_torch.eval import cgan_eval
from eegsynth_torch.eval.cgan_drivers import main as cgan_eval_cli
from eegsynth_torch.eval.classifiers import _run_grouped as eval_run_grouped
from eegsynth_torch.eval.classifiers import discriminative_task
from eegsynth_torch.eval.disc_controls import main as controls_cli
from eegsynth_torch.eval.drivers import (
    find_synth_npz, load_pairs_by_condition, pca_tsne_plots, run_timegan_eval,
)
from eegsynth_torch.eval.features import psd_features_tensor
from eegsynth_torch.eval.stats import statistical_similarity
from eegsynth_torch.fatigue_report import main as fatigue_cli
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
    MAX_HIDDEN, MAX_WIDE_HIDDEN, cluster_card, cluster_chain_probe, cluster_fits,
    cluster_plan, forward_tile, gru_sequence, gru_sequence_bwd, gru_sequence_bwd_recurrence, gru_sequence_bwd_reference, gru_sequence_bwd_wide, gru_sequence_reference,
    gru_sequence_wide, wide_tile,
)
from eegsynth_torch.nn.layers import xavier_uniform
from eegsynth_torch.nn.multigru import (
    k2_tile, multigru_disc_inputs, multigru_disc_inputs_reference,
)
from eegsynth_torch.nn.precision import cast_floating
from eegsynth_torch.ops.filtering import lfilter, lfilter_reference, lfilter_zi
from eegsynth_torch.pipeline import main as pipeline_cli
from eegsynth_torch.preprocess import main as preprocess_cli
from eegsynth_torch.preprocessing_plots import main as preprocessing_plots_cli
from eegsynth_torch.serve import ModelRegistry, make_server
from eegsynth_torch.train import cgan as cgan_train
from eegsynth_torch.train import cgan_multi, cgan_sweep
from eegsynth_torch.train.cgan_posture import main as cgan_posture_cli
from eegsynth_torch.train.cgan_sweep import main as cgan_sweep_cli
from eegsynth_torch.train.checkpoint import load_checkpoint, save_checkpoint
from eegsynth_torch.train.optim import Optimizer, make_gan_opts
from eegsynth_torch.train.timegan import (
    CONFIG_KEYS, GEN_NETS, LOG_COLUMNS, TimeGANHParams, draw_gan, draw_gan_masks,
    gan_step, gather_batch, pre_phase_step, synthesize, synthesize_from_noise,
)
from eegsynth_torch.train.timegan import main as timegan_cli
from eegsynth_torch.train.timegan_multi import train_all_buckets
from eegsynth_torch.train.timegan_sweep import main as timegan_sweep_cli
from eegsynth_torch.train.timegan_sweep import timegan_weight_matrix
from eegsynth_torch.tune_bucket_weights import main as tune_cli
from eegsynth_torch.tools import bench_kernels, bench_serve, bench_synthesis
from eegsynth_torch.tools.raw_tree import write_raw_tree
from eegsynth_torch.tree import tree_leaves, tree_map
from eegsynth_torch.visualization import main as visualization_cli
from eegsynth_torch.visualization_cgan import main as visualization_cgan_cli
from eegsynth_torch.viz import embed, raster

SERVE_BATCH, TIME_CHUNK = 256, 768
KERNEL_TOL = 1e-4      # f32, another summation order, up to 1024 dependent steps
PLAIN_REPS = 1         # K1's and K2's plain versions (0.1-0.5 s a call): one timed
                       # call after the check's own call, which is its warm-up;
                       # they are oracles, not yardsticks
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
# K1's wide route (H past 128: the forward on a thread-block cluster in
# gru_seq_cluster.cu up to the H a cluster holds, the streaming kernels of
# gru_seq_wide.cu above it and for the backward): the first width past the
# register kernels' cap, H 256 and 512 (bench_kernels' sweep) at nb 2 with
# odd T and B, and the cluster route's last H and the next (found from the
# card's numbers), against the plain versions; at one bucket of the
# sequential trainer's B 64 and T 768, H 256 (the headline: the TimeGAN of
# [timegan-wide]), 512 and 1024 (the streaming forward's headline: the
# widest H of bench_kernels' sweep here), against cuDNN's GRU forward and
# backward in turns, the cluster forward also against the streaming one
WIDE_K1_SHAPES = ((2, 301, 37, 129), (2, 303, 33, 256), (2, 151, 37, 512))
WIDE_K1_CAP_SHAPES = ((2, 151, 37), (1, 101, 9))   # (nb, T, B) at the cap and past it
WIDE_K1_CUDNN_SHAPES = ((1, 768, 64, 256), (1, 768, 64, 512), (1, 768, 64, 1024))
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
PROFILE_BUCKETS = 2    # [layers]' profiler pass: the op count does not depend on nb
GAN_STEPS = 3
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
# warm-up and 2 timed GAN steps at chunk 2 (a short last chunk), resumed to
# 4; a 2-layer run with dropout for 1 GAN step; one GAN step of that stack
# at B 8 on the card against the CPU; the stacked trainer's ckpt_every /
# resume on 2 buckets (the state saved at step 1 of 2)
SEQ_WINDOWS, SEQ_BATCH, SEQ_RATE_STEPS, SEQ_RESUME_STEPS = 100, 64, 2, 4
SEQ_GAN_STEPS = 1 + SEQ_RATE_STEPS
SEQ_LAYERS_STEPS, SEQ_CHECK_BATCH = 1, 8
# bf16 synthesis ([synth-bf16]): bench.py's synthesis shape (n 2048 x 768,
# one-shot) and the long horizon (n 512 x 8192 one-shot, n 256 x 8192 in
# chunks of 1024), each in bf16 and in f32 on the same noise. bf16 is held
# to f32 by tests/test_precision.py's bounds on JAX's own bf16 (correlation
# over 0.999, max |diff| under 0.05), and so is a chunked bf16 run to the
# one-shot one (its carried states are K1's float32 rows; only cuBLAS's
# bfloat16 products may differ across shapes). generate_long_synth runs on
# [train]'s 18 runs at the long horizon, LONG_N windows a run (its time is
# nearly all np.savez_compressed: 63 windows a run took 33-35 s).
SYNTH_SHAPES = ((2048, 768, None), (512, 8192, None), (256, 8192, 1024))
BF16_CORR, BF16_MAX = 0.999, 0.05
LONG_LEN, LONG_CHUNK, LONG_N = 8192, 1024, 8
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
# The TimeGAN weight sweep ([timegan-sweep]) on one bucket of N_WINDOWS
# windows: S 3 with two equal points, 2 GAN steps; tuning at 2 candidates x
# 2 replicas (nb 4) for 1 GAN step; the controls' two noise arms and half,
# one seed, a few scorer epochs. [profile-dir]: the traced CLI runs' GAN
# steps, on windows of PROFILE_SEQ_LEN samples (the widths stay z28/h56): a
# traced GAN step at T 768 wrote a trace of 500 MB (129 MB at T 192), since
# the plain discriminator issues its operations step by step
SWEEP_GRID = [{}, {}, {"gamma_acf": 0.1}]
SWEEP_GAN_STEPS = 2
TUNE_GRID, TUNE_REPLICAS, TUNE_GAN_STEPS = [{}, {"gamma_acf": 0.1}], 2, 1
CONTROL_SIGMAS, CONTROL_EPOCHS = (0.001, 0.01), 3
PROFILE_GAN_STEPS, PROFILE_SEQ_LEN = 1, 96
# The CGAN sweep ([cgan-sweep]): S 3 with two equal points, scored at
# CGAN_SWEEP_SAMPLES generated windows a posture
CGAN_SWEEP_GRID = [{}, {}, {"psd_weight": 2.0, "fm_weight": 10.0}]
CGAN_SWEEP_SAMPLES = 64
# The IIR kernel (csrc/iir_filter.cu) at preprocessing's filters, fs 128: the
# notch (order 2) and the 4th-order Butterworth band-pass (order 8) over one
# 60 s trial with the band-pass's odd extension (7680 + 2 x 27 rows) and over
# one hour (460,800 + 54), 14 columns, float64 (preprocessing's) and float32.
# Relative to the largest output: the kernel rounds each operation as the
# plain version does, so any difference is a fault, not an order of sums
IIR_FS = 128.0
IIR_SHAPES = ((7734, 14), (460854, 14))
IIR_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# One H100 SXM (NVIDIA's data sheet, 700 W): FP64 and FP32 FLOP/s outside the
# tensor cores, the IIR kernel's units
PEAK_FLOPS_F64, PEAK_FLOPS_F32 = 34e12, 67e12
# The step-chain floor: z0 -> y (add) -> a1 * y (mul) -> z0' (sub) a step, at
# an assumed dependent-issue latency in cycles (not measured)
IIR_CHAIN_OPS = 3
IIR_LATENCY = {torch.float64: 8, torch.float32: 4}
# [preprocess]: a raw tree like the reference's 6s_window/ (participants and
# seconds a trial: 3 and 30, where they were 4 and 60, to pay for the figures
# inside the script's time, since the CPU run's plain recurrence scales with
# both); card against CPU: X in [0, 1] float32 within an ulp or two of its
# float64 filtering, the float32 scalers relative
RAW_PARTICIPANTS, RAW_SECONDS = 3, 30.0
PREP_X_ATOL, PREP_SCALE_RTOL = 2e-6, 1e-6
# [fatigue]: every CSV cell card against CPU (float64 spectra, sums in
# another order)
CSV_RTOL, CSV_ATOL = 1e-9, 1e-12
# [figures]: 18 (posture, condition) pairs of FIG_WINDOWS real and as many
# synthetic windows (768, 14), the synthetic drawn by a full-width TimeGAN's
# cascade on K1; the cluster figures at the CLI's default t-SNE cap; the card
# against the CPU: PCA on FIG_PCA_ROWS of the rows (float64, an eigenproblem
# in another order: relative to each component's largest score), t-SNE on
# FIG_TSNE_ROWS (its KL relative, trustworthiness at 10 neighbours absolute)
FIG_WINDOWS, FIG_TSNE_MAX = 200, 6000
FIG_PCA_ROWS, FIG_PCA_RTOL = 1000, 1e-6
FIG_TSNE_ROWS, FIG_TSNE_KL_RTOL, FIG_TSNE_TW_TOL = 600, 0.05, 0.02

# [timegan-wide]: a TimeGAN at x14/z64/h256 (a TimeGANConfig the JAX package
# builds; its generator and supervisor recurrences run K1's wide route, the
# embedder's and recovery's at H 64 the register kernels) on one random
# bucket: one AE and one SUP step, TG_WIDE_GAN_STEPS GAN steps at B
# TG_WIDE_BATCH, T 768, then synthesis; one GAN step at B 4, T
# TG_WIDE_CHECK_T on the card against the CPU (the step tolerances)
TG_WIDE_DIMS = (14, 64, 256)
TG_WIDE_WINDOWS, TG_WIDE_BATCH, TG_WIDE_GAN_STEPS, TG_WIDE_CHECK_T = 32, 16, 2, 96
# [convert]: a reference-shaped TimeGAN checkpoint (x14/z28/h56) and conv
# generator (9 classes, the legacy key names) made in torch, converted,
# served; the served conv generator against a functional torch version of
# the reference's forward on the card (float32 convolutions in another
# order: CGAN_SERVE_TOL)
CONVERT_N, CONVERT_LEN = 64, 1536
# [pipeline]: every stage from a raw tree (participants x 2 postures x 2
# conditions of PIPE_SECONDS), tiny depth: 1 AE, 1 SUP epoch, 2 GAN steps
PIPE_PARTICIPANTS, PIPE_POSTURES, PIPE_SECONDS = 3, (1, 2), 30.0
PIPE_CONFIG = {"ae_epochs": 1, "sup_epochs": 1, "gan_steps": 2, "chunk": 2,
               "batch_size": 8}
# [bench-tools]: bench_synthesis' parity at the long horizon and one row of
# each model at bench.py's batch; bench_serve's closed loop (4 clients, the
# hung client) for BENCH_SERVE_SECONDS; bench_kernels' default sweep (H 56,
# 128, 256, 512 at B 64, T 768) and H 1024, past the cluster forward's cap
BENCH_SYNTH_RUNS = (["--parity", "--batch", "256", "--T", "8192", "--time_chunk", "1024"],
                    ["--batch", "2048", "--iters", "5"])
BENCH_SERVE_SECONDS = 5.0
BENCH_KERNEL_HS = [56, 128, 256, 512, 1024]
BENCH_KERNEL_ARGS = ["--iters", "3", "--hs", ",".join(map(str, BENCH_KERNEL_HS))]


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


def _time_ms(fn, reps: int, warm: bool = True) -> float:
    """Median over ``reps`` runs of one call, CUDA events, after a warm-up
    (``warm`` False: the caller has just made that call)."""
    if warm:
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


@dataclasses.dataclass
class _CardOp:
    """One device operation of a profiled run: its name, launches and
    device time in µs, under key_averages()' names."""
    key: str
    count: int
    self_device_time_total: float


def _on_card(prof) -> list[_CardOp]:
    """The device operations of a finished torch.profiler run, summed by
    name from its raw events. key_averages() gives the same sums, but first
    builds a Python event for every operation: 27 s for 300,000 operations
    in a CPU test, and one TimeGAN GAN step issues 215,000."""
    from torch.autograd import DeviceType
    ops: dict[str, _CardOp] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            op = ops.setdefault(e.name(), _CardOp(e.name(), 0, 0.0))
            op.count += 1
            op.self_device_time_total += e.duration_ns() / 1e3
    return list(ops.values())


def _in_turns(fns: dict, reps: int) -> dict:
    """Each call's median of ``reps``, timed in turns (a, b, ..., b, a);
    the mean of its two medians."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        times[name].append(_time_ms(fns[name], reps))
    return {name: statistics.mean(t) for name, t in times.items()}


def _turns_ms(kernel, library, reps: int) -> tuple[float, float]:
    """Kernel and library call timed in turns (library, kernel, kernel,
    library), each a median of ``reps``; returns the mean of each pair."""
    times = _in_turns({"library": library, "kernel": kernel}, reps)
    return times["kernel"], times["library"]


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
    """K1's inputs, drawn on ``device`` (on the host, the largest shapes'
    draws and products took seconds each)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((nb, T, B, I), generator=g, device=device)
    w_ih = xavier_uniform((nb, 3 * H, I), g)
    w_hh = xavier_uniform((nb, 3 * H, H), g)
    b_ih = 0.1 * torch.randn(nb, 1, 1, 3 * H, generator=g, device=device)
    b_hh = 0.1 * torch.randn(nb, 1, 3 * H, generator=g, device=device)
    h0 = torch.rand((nb, B, H), generator=g, device=device) - 0.5
    xp = torch.matmul(x, w_ih.transpose(1, 2).unsqueeze(1)) + b_ih
    return [t.contiguous() for t in (xp, w_hh.transpose(1, 2), b_hh, h0)]


def phase_kernels(smi: str) -> dict:
    """Every kernel against its plain version at the main paths' shapes.
    Returns, per kernel, the largest error and the times at its headline
    shape (K1 forward: the serving shape; the others: the training shape)."""
    rows, seconds = {}, {}
    # (tag, the kernel's name, or None where the check returns rows by name)
    for tag, name, check in (("K1 forward", "gru_sequence", _check_k1_fwd),
                             ("K1 backward", "gru_sequence_bwd", _check_k1_bwd),
                             ("wide K1", None, _check_k1_wide),
                             ("K2", "multigru_disc_inputs", _check_k2),
                             ("K3", None, _check_k3), ("wide K3", None, _check_k3_wide),
                             ("IIR", "iir_filter", _check_iir)):
        t0 = time.perf_counter()
        out = check(smi)
        seconds[tag] = round(time.perf_counter() - t0, 2)
        rows.update(out if name is None else {name: out})
    print(f"[kernels] seconds by check: {seconds} | {smi}", flush=True)
    return rows


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
            plain_ms = _time_ms(lambda: gru_sequence_reference(*args), reps=PLAIN_REPS,
                                warm=False)
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
            d_ys = torch.randn(ys.shape, device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(i))
            got = gru_sequence_bwd(*args, ys, d_ys)
            ref = gru_sequence_bwd_reference(*args, ys, d_ys)
            torch.cuda.synchronize()
            errs, scale, ok = _bwd_errors(got, ref)
            ms = _time_ms(lambda: gru_sequence_bwd(*args, ys, d_ys), reps=10)
            kernel_ms = _time_ms(_bwd_kernel_alone(args, ys, d_ys), reps=10)
            plain_ms = _time_ms(lambda: gru_sequence_bwd_reference(*args, ys, d_ys),
                                reps=PLAIN_REPS, warm=False)
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
        d_ys = torch.randn(ys.shape, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(seed))
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


def _wide_route_counts() -> tuple:
    """K1 forward, K1 backward, the wide route's cluster forward, its
    streaming forward, the wide backward."""
    return (gru_sequence.launches, gru_sequence_bwd.launches,
            gru_sequence_wide.cluster_launches, gru_sequence_wide.launches,
            gru_sequence_bwd_wide.launches)


def _cluster_cap() -> int:
    """The largest H on the cluster forward with this card's numbers."""
    card = cluster_card()
    return max(H for H in range(MAX_HIDDEN + 1, MAX_WIDE_HIDDEN + 1)
               if cluster_plan(1, 1, H, card)["route"] == "cluster")


def _cluster_plans(args, plan: dict) -> str:
    """Every cluster that fits (cluster_fits), timed at these inputs:
    ``C<c> R<r> ms`` each, the plan's pick marked *."""
    out = []
    for C, R, g, _ in cluster_fits(args[3].shape[2], cluster_card()):
        one = {"route": "cluster", "C": C, "R": R, **g}
        ms = _time_ms(lambda: gru_sequence_wide(*args, plan=one), reps=3)  # noqa: B023
        out.append(f"C{C} R{R}{'*' if (C, R) == (plan['C'], plan['R']) else ''} {ms:.4f}")
    return "; ".join(out)


def _check_k1_wide(smi: str) -> dict:
    """K1's wide route, forward and backward (the whole call: the hp
    product, the kernel, the dW product), at WIDE_K1_SHAPES and at the
    cluster route's cap and past it against the plain versions, then at
    WIDE_K1_CUDNN_SHAPES against the plain versions and cuDNN's GRU
    (forward, and backward by autograd.grad) in turns; each shape's route,
    cluster C and rows R; on the cluster route the step-chain floor (the
    probe of the same plan: the exchange and the wait alone) and, at one
    bucket, every cluster plan that fits; and on the same inputs the
    streaming forward in turns (the kernel the route had before the
    cluster).
    The kernels line takes (1, 768, 64, 256) for the cluster forward and the
    backward and (1, 768, 64, 1024) for the streaming forward."""
    cap = _cluster_cap()
    shapes = (WIDE_K1_SHAPES + tuple((*s, H) for s, H in zip(WIDE_K1_CAP_SHAPES, (cap, cap + 1)))
              + WIDE_K1_CUDNN_SHAPES)
    rows, worst = {}, {"gru_sequence_wide_cluster": 0.0, "gru_sequence_wide": 0.0,
                       "gru_sequence_bwd_wide": 0.0}
    for i, (nb, T, B, H) in enumerate(shapes):
        args = _gru_inputs(nb, T, B, H, 28, seed=40 + i, device="cuda")
        tile = wide_tile(nb, B, H)
        cluster = tile["route"] == "cluster"
        name = "gru_sequence_wide_cluster" if cluster else "gru_sequence_wide"
        with torch.no_grad():
            before = _wide_route_counts()
            ys = gru_sequence(*args)
            d_ys = torch.randn(ys.shape, device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(i))
            got = gru_sequence_bwd(*args, ys, d_ys)
            torch.cuda.synchronize()
            routes = [a - b for a, b in zip(_wide_route_counts(), before)]
            ref_ys = gru_sequence_reference(*args)
            ref = gru_sequence_bwd_reference(*args, ys, d_ys)
            err = (ys - ref_ys).abs().max().item()
            errs, scale, ok = _bwd_errors(got, ref)
            fwd = {"kernel": lambda: gru_sequence(*args)}
            if cluster:
                fwd["streaming"] = lambda: gru_sequence_wide(*args, plan={"route": "stream"})
            if nb == 1:
                one = [a[0] for a in args]
                fwd["cuDNN"] = _cudnn_gru(*one)
                lib_err = (fwd["cuDNN"]() - ys[0]).abs().max().item()
            times = _in_turns(fwd, reps=5)
            ms, lib_ms = times["kernel"], times.get("cuDNN")
            floor_ms = (_time_ms(lambda: cluster_chain_probe(*args, tile["plan"]), reps=5)
                        if cluster else None)
            if nb != 1:
                bwd_ms = _time_ms(lambda: gru_sequence_bwd(*args, ys, d_ys), reps=5)
            plain_ms = _time_ms(lambda: gru_sequence_reference(*args), reps=PLAIN_REPS,
                                warm=False)
            plain_bwd_ms = _time_ms(lambda: gru_sequence_bwd_reference(*args, ys, d_ys),
                                    reps=PLAIN_REPS, warm=False)
        lib_bwd_ms = None
        if nb == 1:
            cudnn_bwd, as_k1 = _cudnn_gru_bwd(*(a[0] for a in args), d_ys[0])
            lib_bwd_err = _bwd_errors(as_k1(cudnn_bwd()), ref)[0]
            with torch.no_grad():
                bwd_ms, lib_bwd_ms = _turns_ms(lambda: gru_sequence_bwd(*args, ys, d_ys),
                                               cudnn_bwd, reps=3)
        plan = tile["plan"]
        route = (f"cluster C {plan['C']} x R {plan['R']} rows (S {plan['S']}, KL "
                 f"{plan['KL']}, U {plan['U']}, {plan['threads']} threads, {plan['smem']} B "
                 f"shared; {plan['clusters']} clusters, {plan['resident']} resident, "
                 f"{plan['waves']} wave(s)); step-chain floor {floor_ms:.4f} ms; the "
                 f"streaming forward on the same inputs {times['streaming']:.4f} ms in turns"
                 if cluster else f"streaming, {tile['rows']} rows x {tile['blocks']} tiles x "
                 f"{nb} buckets of {tile['threads']} threads, {tile['fwd_smem']} B shared")
        print(f"[kernel] gru_sequence_wide nb={nb} T={T} B={B} H={H}: route {route}; "
              f"max|diff| ys {err:.3e}, dxp {errs[0]:.3e} dh0 {errs[3]:.3e} (tol "
              f"{KERNEL_TOL:g}); dW {errs[1]:.3e} of {scale[1]:.3g}, db {errs[2]:.3e} of "
              f"{scale[2]:.3g} (tol {KERNEL_TOL:g} relative); launches K1 fwd / bwd / "
              f"cluster fwd / streaming fwd / wide bwd {routes}; forward {ms:.4f} ms "
              f"(plain {plain_ms:.4f}), backward whole call {bwd_ms:.4f} ms (plain "
              f"{plain_bwd_ms:.4f}); backward tile {tile['rows']} rows x {tile['blocks']} "
              f"tiles of {tile['threads']} threads, {tile['bwd_smem']} B shared | {smi}",
              flush=True)
        if nb == 1:
            stream = (f", the streaming forward {times['streaming']:.4f} ms"
                      if "streaming" in times else "")
            print(f"[kernel] gru_sequence_wide nb=1 T={T} B={B} H={H} vs cuDNN GRU: "
                  f"forward {ms:.4f}{stream} against {lib_ms:.4f} ms (max|diff| "
                  f"{lib_err:.3e}), backward {bwd_ms:.4f} against {lib_bwd_ms:.4f} ms "
                  f"(cuDNN dxp {lib_bwd_err[0]:.3e}), in turns | {smi}", flush=True)
        if cluster and nb == 1:
            print(f"[kernel] gru_sequence_wide_cluster nb=1 T={T} B={B} H={H} plans (ms): "
                  f"{_cluster_plans(args, plan)} | {smi}", flush=True)
        want = [0, 0, 1, 0, 1] if cluster else [0, 0, 0, 1, 1]
        if routes != want:
            fail(f"the wide route at nb={nb} B={B} H={H} launched {routes} (K1 fwd, bwd, "
                 f"cluster fwd, streaming fwd, wide bwd), expected {want}")
        if not ok or not bool(torch.isfinite(ys).all()) or err > KERNEL_TOL:
            fail(f"K1's wide route disagrees with its plain version at nb={nb} T={T} "
                 f"B={B} H={H}: ys {err}, backward {errs}")
        worst[name] = max(worst[name], err)
        worst["gru_sequence_bwd_wide"] = max(worst["gru_sequence_bwd_wide"], errs[0], errs[3])
        fwd_row = _row(ms, plain_ms, _bound(2 * nb * T * B * H * 3 * H, *args, ys), lib_ms)
        bwd_row = _row(bwd_ms, plain_bwd_ms, _bound(3 * 2 * nb * T * B * H * 3 * H, *args,
                                                   ys, d_ys, *got), lib_bwd_ms)
        label = f"nb={nb} T={T} B={B} H={H}"
        _roofline(f"{name} {label}", fwd_row, smi, "cuDNN GRU" if nb == 1 else None)
        if cluster:
            print(f"[bound] {name} {label}: step-chain floor {floor_ms:.4f} ms (the "
                  f"exchange and the wait alone, {T} steps on clusters of {plan['C']}), "
                  f"bound {fwd_row['bound_ms']:.4f} ms ({fwd_row['bound_by']}); kernel "
                  f"{ms:.4f} ms, {ms / floor_ms:.2f}x the floor | {smi}", flush=True)
        _roofline(f"gru_sequence_bwd_wide {label}", bwd_row, smi,
                  "cuDNN GRU backward" if nb == 1 else None)
        if (nb, T, B, H) == WIDE_K1_CUDNN_SHAPES[0]:
            rows.update({name: fwd_row, "gru_sequence_bwd_wide": bwd_row})
        elif (nb, T, B, H) == WIDE_K1_CUDNN_SHAPES[-1]:
            rows[name] = fwd_row
    if set(rows) != set(worst):
        fail(f"the wide route's headline shapes took {sorted(rows)}: the cluster route at "
             f"H {WIDE_K1_CUDNN_SHAPES[0][3]}, the streaming one at "
             f"{WIDE_K1_CUDNN_SHAPES[-1][3]} expected (cap {cap})")
    for name, err in worst.items():
        rows[name]["max_abs_err"] = err
    return rows


def _multigru_inputs(nb, T, B, dims, seed):
    """K2's inputs, drawn on the card (its two input products at T 1024 and
    the widest width are 670 M floats)."""
    He, Hg, Hs, Z = dims
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, sc=1.0):
        return torch.randn(shape, generator=g, device="cuda") * sc

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
            plain_ms = _time_ms(lambda: multigru_disc_inputs_reference(*args),
                                reps=PLAIN_REPS, warm=False)
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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_ms = timed(lambda: reg.synthesize(
            run, SERVE_BATCH, TIME_CHUNK, 0, False, SERVE_BATCH, TIME_CHUNK), reps=1)
    on_card = _on_card(prof)
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
                   channels: int = CHANNELS, seq_len: int | None = None) -> Path:
    """The first ``n_buckets`` of the 18 bucket NPZs
    posture{1..9}_{no_exo,with_exo}.npz, random (63, seq_len, channels)
    float32 windows in [0, 1) (seq_len SEQ_LEN by default), from a seed,
    with fixed scalers (for --denorm)."""
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    names = [f"posture{p}_{c}" for p in range(1, 10) for c in ("no_exo", "with_exo")]
    for name in names[:n_buckets]:
        np.savez(data / f"{name}.npz",
                 X=rng.uniform(0, 1, (N_WINDOWS, seq_len or SEQ_LEN, channels))
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
         "--n", str(LONG_N), "--device", device])
    wall = time.perf_counter() - t0
    got = gru_sequence.launches - before
    want = 3 * -(-LONG_LEN // LONG_CHUNK) * N_BUCKETS if on_card else 0
    first = sorted(written)[0]
    with np.load(written[first]) as f:
        X = f["X"]
    with np.load(root / "data" / f"{first}.npz") as f:
        mn, rg = f["scale_min"], f["scale_range"]
    best, _ = load_checkpoint(root / "runs" / first / "ckpt_best.npz")
    ref = synthesize(from_jax_params(best["model"], device=device).eval(), LONG_N,
                     LONG_LEN, generator=torch.Generator(device=device).manual_seed(0),
                     time_chunk=LONG_CHUNK) * rg + mn
    print(f"[synth-bf16] generate_long_synth --gen_len {LONG_LEN} --time_chunk "
          f"{LONG_CHUNK} --denorm --n {LONG_N} on {len(written)} runs in {wall:.2f} s "
          f"({N_BUCKETS * LONG_N * LONG_LEN / wall:.4g} samples/s, files "
          f"included); gru_sequence launches {got} (expected {want}); {first}: "
          f"{X.shape}, equal to synthesize + denorm {np.array_equal(X, ref)} | {smi}",
          flush=True)
    if (len(written) != N_BUCKETS or got != want or not np.array_equal(X, ref)
            or X.shape != (LONG_N, LONG_LEN, CHANNELS)):
        fail(f"generate_long_synth: {len(written)} files, launches {got}, "
             f"{first} {X.shape}")
    for name, path in written.items():
        with np.load(path) as f:
            if f["X"].shape != (LONG_N, LONG_LEN, CHANNELS) \
                    or not np.isfinite(f["X"]).all():
                fail(f"{name}: {path.name} {f['X'].shape}")
        if find_synth_npz(root / "runs" / name) != path:
            fail(f"{name}: the eval would not pick {path.name} first")
    return gru_sequence.launches


def _profile_synth(nets: dict, smi: str) -> None:
    """The card's time in one cascade at bench.py's shape, per precision:
    K1 against the rest (projections, casts)."""
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
        on_card = _on_card(prof)
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
    flags = ("--parallel_buckets", "--gan_steps", "2", "--ckpt_every", "1",
             "--data_dir", str(data2))
    t0 = time.perf_counter()
    res, launches = _counted(lambda: cli(stacked / "full", *flags))
    a = res["ae_steps"]
    check(f"--parallel_buckets --ckpt_every 1, 2 buckets, 2 GAN steps in "
          f"{time.perf_counter() - t0:.2f} s", launches,
          (4 * a + 10 + 3 * 2, 3 * a + 10, 2))
    (stacked / "resumed").mkdir()
    (stacked / "resumed" / "_multi_state.npz").write_bytes(
        (stacked / "full" / "_multi_state.npz").read_bytes())
    t0 = time.perf_counter()
    _, launches = _counted(lambda: cli(stacked / "resumed", *flags, "--resume"))
    check(f"--parallel_buckets --resume from step 1 in {time.perf_counter() - t0:.2f} s",
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
                tag: str = "[check]", weights: torch.Tensor | None = None) -> None:
    """One GAN step of ``nb`` buckets at batch ``B`` on the card against the
    CPU plain path, on the same parameters, draws and dropout masks: the
    logged values, the updated parameters and both optimizers' first
    moments. Without masks the D-step inputs come from K2 (5 K1 forward
    launches and 1 K2); with them every recurrence is K1 (8 a layer).
    ``weights`` (nb, 4) are per-bucket G-loss weights (the sweep's)."""
    params, hp, optD, d_state, optG, g_state, x, draws = _step_inputs(
        nb, B, 7, device, channels, layers, dropout)
    w_card = None if weights is None else weights.to(device)
    cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)      # noqa: E731
    k1, k2 = gru_sequence.launches, multigru_disc_inputs.launches
    t0 = time.perf_counter()
    card_p, card_d, card_g, card_logs = gan_step(params, optD, d_state, optG,
                                                 g_state, x, draws, 1, hp,
                                                 weights=w_card)
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
                                             x.cpu(), draws_cpu, 1, hp,
                                             weights=None if weights is None
                                             else weights.cpu())
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
          f"masks{'' if weights is None else ', per-bucket G weights'}), card vs "
          f"CPU plain path: bucket 0 card {fmt(card_logs[0].tolist())}", flush=True)
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
    busy share over one unsynchronised step from torch.profiler, at nb
    PROFILE_BUCKETS (the same operations at a smaller batch of buckets)."""
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
          + f" (host split at nb {N_BUCKETS}; the profiler pass below at nb "
          f"{PROFILE_BUCKETS}) | {smi}", flush=True)
    if torch.device(device).type != "cuda":
        return

    # the profiler pass at nb PROFILE_BUCKETS (the step's operation count does
    # not depend on nb, its device time does), tracing the card alone (the
    # host-side events of the step's ~215,000 operations took most of the
    # phase's time to collect) and summed from the raw events (_on_card)
    params, hp, optD, d_state, optG, g_state, x, draws = _step_inputs(
        PROFILE_BUCKETS, N_WINDOWS, 11, device)
    state[:] = [params, d_state, g_state]
    step()                                                   # warm-up
    _sync(device)
    t_pass = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = _on_card(prof)
    pass_s = time.perf_counter() - t_pass
    dev_ms = sum(e.self_device_time_total for e in on_card) / 1e3

    def kernel_ms(tag):
        return sum(e.self_device_time_total for e in on_card if tag in e.key) / 1e3

    launches = sum(e.count for e in on_card)
    print(f"[profile] one GAN step nb={PROFILE_BUCKETS}: device time {dev_ms:.1f} ms in "
          f"{wall_ms:.1f} ms wall ({100 * dev_ms / wall_ms:.1f} % busy) over "
          f"{launches} device operations: K2 {kernel_ms('multigru_fwd_kernel'):.3f} "
          f"ms, K1 fwd {kernel_ms('gru_seq_fwd_kernel'):.3f} ms, K1 bwd "
          f"{kernel_ms('gru_seq_bwd_kernel'):.3f} ms; the pass with its trace's "
          f"collection and aggregation {pass_s:.2f} s | {smi}", flush=True)
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


def _run_cgan_step(hp, cfg, G, bn, D, X, draws, step_idx, timer=None, weights=None):
    optG = cgan_train.Adam(hp.lr_g, hp.beta1, hp.beta2)
    optD = cgan_train.Adam(hp.lr_d, hp.beta1, hp.beta2)
    return cgan_train.cgan_step(G, bn, D, G, optG.init(G), optD.init(D), X, draws,
                                step_idx, 0.1, cfg=cfg, hp=hp, optG=optG, optD=optD,
                                prewarm=False, timer=timer, weights=weights)


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


def _cgan_step_check(smi: str, device: str, what: str, seed: int,
                     weights: torch.Tensor | None = None, **hp_over) -> None:
    """One CGAN step (step index 0: R1 fires) on ``device`` against the
    same step on the CPU with the plain versions, B 8, full width, the same
    draws (and G-loss ``weights``, if given): the logs, each parameter leaf
    and its Adam first moments, and the bn state within the CGAN_*
    tolerances. The same step in float64 on the CPU says how far the CPU's
    float32 step itself is from exact."""
    hp, cfg, G, bn, D, X, draws = _cgan_step_inputs(8, device, seed, **hp_over)
    cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    t0 = time.perf_counter()
    card = _run_cgan_step(hp, cfg, G, bn, D, X, draws, 0,
                          weights=None if weights is None else weights.to(device))
    _sync(device)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_draws = cgan_train.draws_to(draws, "cpu")
    host = _run_cgan_step(hp, cfg, cpu(G), cpu(bn), cpu(D), X.cpu(), host_draws, 0,
                          weights=weights)
    cpu_s = time.perf_counter() - t0
    exact = _run_cgan_step(hp, cfg, _f64(cpu(G)), _f64(cpu(bn)), _f64(cpu(D)),
                           X.cpu().double(), _f64(host_draws), 0,
                           weights=None if weights is None else weights.double())
    _hold_cgan_step(smi, f"CGAN step {what}, card vs CPU plain path", hp, card, host,
                    exact, f"step {card_s:.3f} s on the card, {cpu_s:.3f} s on the CPU")


def _hold_cgan_step(smi: str, what: str, hp, card, host, exact=None,
                    extra: str = "") -> None:
    """``card`` (one cgan_step's outputs) against ``host`` (the reference
    step's) by the CGAN_* rule: the logs, each parameter leaf and its Adam
    first moments, and the bn state; ``exact``, the same step in float64,
    says how far the reference's float32 step is from exact."""
    conv = hp.arch != "transformer"
    mu_rtol = CGAN_CONV_MU_RTOL if conv else CGAN_MU_RTOL
    logs, ref = card[-1].cpu(), host[-1].cpu()
    log_err = ((logs - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    mu_err = host_err = p_err = rounding_g = 0.0
    excused, rounding = [], []
    for net, i in (("G", 0), ("D", 2)):
        state, ref_state = card[4 + i // 2], host[4 + i // 2]
        exact_mu = (tree_leaves(exact[4 + i // 2].mu) if exact is not None
                    else [None] * len(tree_leaves(ref_state.mu)))
        for name, p, pr, m, mr, m64 in zip(
                _leaf_names(host[i]), tree_leaves(card[i]), tree_leaves(host[i]),
                tree_leaves(state.mu), tree_leaves(ref_state.mu), exact_mu):
            m, p, pr, mr = m.cpu(), p.cpu(), pr.cpu(), mr.cpu()
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
            if m64 is not None:
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
    bn_err = max([(a.cpu() - b.cpu()).abs().max().item()
                  for a, b in zip(tree_leaves(card[1]), tree_leaves(host[1]))] or [0.0])
    print(f"[check] {what}: logs {[round(v, 6) for v in logs.tolist()]}, reference "
          f"{[round(v, 6) for v in ref.tolist()]}", flush=True)
    print(f"[check]   logs max relative diff {log_err:.3e} (tol {CGAN_LOG_RTOL:g}); "
          f"Adam first moments at {mu_err:.3f} of their tolerance (must be <= 1: per "
          f"leaf {mu_rtol:g} of its largest, {CGAN_MU_RTOL:g} of the larger of that and "
          f"1" + ("" if exact is None else f"; the reference's float32 step departs "
                  f"from its float64 step by {host_err:.3e} of a leaf's largest")
          + "); "
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
          + f"{extra} | {smi}", flush=True)
    if (not torch.isfinite(logs).all() or log_err > CGAN_LOG_RTOL or mu_err > 1
            or p_err > 0 or share > CGAN_EXCUSED_SHARE or rounding_g > CGAN_GRAD_FLOOR
            or bn_err > CGAN_BN_ATOL):
        fail(f"{what}: the steps disagree: logs {log_err}, "
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
        # save_every 2 > epochs: no full-state checkpoint (at dim 512 its
        # compressed write took most of the phase's ~60 s)
        res = cgan_train.train_one_condition(
            data, runs, "no_exo", device=device, arch="transformer", epochs=1,
            save_every=2, print_every=1, batch_size=CGAN_WIDE_BATCH, tf_dim=512,
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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = _on_card(prof)
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
        _cgan_figures(smi, Path(tmp), device)
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
    scatter = {"pca_scatter.png": None, "tsne_scatter.png": None, "tsne_real_gen.png": None}
    _check_pngs("cgan eval condition", root / "cgan_eval" / "no_exo", scatter)
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
          f"(logistic + ridge) {fits:.3f} s; scatter plots (PCA, PCA-50 -> t-SNE of "
          f"{9 * (CGAN_WINDOWS + CGAN_EVAL_SAMPLES)} feature rows) {secs['figures']:.3f} s; "
          f"CSVs checked, finite; 3 PNGs checked | {smi}", flush=True)

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
    _check_pngs("cgan eval posture", root / "cgan_eval_posture", {
        f"global/{k}": v for k, v in scatter.items()})
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


# ------------------------------------------------------------------
# Sweeps and stacks
# ------------------------------------------------------------------

def _same_npz(a: Path, b: Path) -> bool:
    """Whether NPZ files ``a`` and ``b`` hold the same arrays bit for bit
    (the meta blob aside)."""
    with np.load(a) as x, np.load(b) as y:
        return x.files == y.files and all(np.array_equal(x[k], y[k])
                                          for k in x.files if k != "__meta__")


def _bucket_launches(nb: int, ae: int, sup: int, gan: int) -> tuple:
    """(K1 forward, K1 backward, K2) launches of a stacked run of ``nb``
    members without dropout: per AE step E and R forward and backward, per
    SUP step E (no gradient) and S forward, S backward; per GAN step K2 for
    the D inputs, G, S, R and E, R forward and backward; then 3 forward
    launches per member for its synthetic.npz."""
    return 2 * ae + 2 * sup + 5 * gan + 3 * nb, 2 * ae + sup + 5 * gan, gan


def phase_timegan_sweep(smi: str, root: Path, device: str = "cuda") -> dict:
    """The TimeGAN weight sweep, bucket-weight tuning and the discriminative
    controls at full width on one random bucket of (63, 768, 14), each
    through its CLI in this process: ``timegan_sweep`` with SWEEP_GRID (S 3,
    two equal points) and the sweep statistics; ``tune_bucket_weights``
    with 2 candidates x 2 replicas (nb 4); ``disc_controls`` with two noise
    arms and ``half``. Their launch counts exact; whether the equal points
    are bitwise equal on the card; one stacked GAN step at nb 2 with a
    per-member weight matrix on the card against the CPU. Returns the
    launch counts of the CLI runs."""
    cuda = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    data = root / "sweep_data"
    data.mkdir()
    npz = data / "posture2_with_exo.npz"
    np.savez(npz, X=np.random.default_rng(5).uniform(
        0, 1, (N_WINDOWS, SEQ_LEN, CHANNELS)).astype(np.float32), fs=np.float32(128.0))
    hp = _train_hparams(ae_epochs=1, sup_epochs=1, gan_steps=SWEEP_GAN_STEPS)
    cfg_path = root / "sweep_config.json"
    cfg_path.write_text(json.dumps(hp))
    pre = -(-N_WINDOWS // min(hp["batch_size"], N_WINDOWS))    # steps an epoch
    total = np.zeros(3, dtype=np.int64)

    def check(tag, launches, want):
        want = want if cuda else (0, 0, 0)
        print(f"[timegan-sweep] {tag}: launches gru_sequence {launches[0]}, "
              f"gru_sequence_bwd {launches[1]}, multigru_disc_inputs {launches[2]} "
              f"(expected {want}) | {smi}", flush=True)
        if tuple(launches) != tuple(want):
            fail(f"[timegan-sweep] {tag}: launch counts {launches} != expected {want}")
        total[:] += launches

    S = len(SWEEP_GRID)
    t0 = time.perf_counter()
    res, launches = _counted(lambda: timegan_sweep_cli(
        ["--npz", str(npz), "--out", str(root / "tsweep"), "--grid",
         json.dumps(SWEEP_GRID), "--config", str(cfg_path), "--device", device]))
    check(f"timegan_sweep S {S} ({SWEEP_GRID}), 1 AE + 1 SUP epoch + "
          f"{SWEEP_GAN_STEPS} GAN steps, statistics, in {time.perf_counter() - t0:.2f} s",
          launches, _bucket_launches(S, pre, pre, SWEEP_GAN_STEPS))
    names = ("ckpt_latest.npz", "ckpt_best.npz", "synthetic.npz")
    points = [root / "tsweep" / f"sweep{i}" for i in range(S)]
    saved = json.loads((root / "tsweep" / "sweep_results.json").read_text())
    if len(saved) != S or not all(
            (d / n).exists() for d in points for n in (*names, "hparams.json")) \
            or not all(np.isfinite(list(r["stats"].values())).all() for r in saved):
        fail(f"[timegan-sweep] the sweep's artifacts: {saved}")
    equal = all(_same_npz(points[0] / n, points[1] / n) for n in names)
    differs = not all(_same_npz(points[0] / n, points[2] / n) for n in names)
    print(f"[timegan-sweep] equal-weight points sweep0 and sweep1 bitwise equal on the "
          f"card (checkpoints and synthetic.npz): {equal}; sweep2 differs from sweep0: "
          f"{differs}; final G "
          f"{[round(r['final_g'], 6) for r in saved]}; statistics "
          + "; ".join(f"{Path(r['dir']).name} psd {r['stats']['psd_diff']:.3e} acf "
                      f"{r['stats']['acf_diff']:.4f} coh {r['stats']['coh_diff']:.4f}"
                      for r in saved) + f" | {smi}", flush=True)
    # two points with unequal weights (the sweep's first and last)
    W = torch.from_numpy(timegan_weight_matrix(TimeGANHParams(**hp), SWEEP_GRID))[[0, -1]]
    _step_check(smi, device, nb=2, B=8, tag="[timegan-sweep]", weights=W)

    tune_cfg = root / "tune_config.json"
    tune_cfg.write_text(json.dumps({**hp, "gan_steps": TUNE_GAN_STEPS}))
    t0 = time.perf_counter()
    out, launches = _counted(lambda: tune_cli(
        ["--npz", str(npz), "--out", str(root / "tune"), "--grid", json.dumps(TUNE_GRID),
         "--replicas", str(TUNE_REPLICAS), "--config", str(tune_cfg), "--device",
         device]))
    nb = len(TUNE_GRID) * TUNE_REPLICAS
    check(f"tune_bucket_weights {len(TUNE_GRID)} candidates x {TUNE_REPLICAS} "
          f"replicas (nb {nb}), {TUNE_GAN_STEPS} GAN step, in "
          f"{time.perf_counter() - t0:.2f} s", launches,
          _bucket_launches(nb, pre, pre, TUNE_GAN_STEPS))
    rows = json.loads((root / "tune" / "results.json").read_text())
    if len(rows) != nb or out["best"] not in rows or not all(
            np.isfinite([r["psd"], r["acf"], r["coh"]]).all() for r in rows):
        fail(f"[timegan-sweep] tuning's results.json: {rows}")
    print(f"[timegan-sweep] tuning results.json: {[r['name'] for r in rows]}; best-of-k "
          f"on acf: {out['best']['name']} ({out['best']['acf']:.4f}) | {smi}", flush=True)

    t0 = time.perf_counter()
    ctl, launches = _counted(lambda: controls_cli(
        ["--real_dir", str(data), "--out", str(root / "controls"), "--sigmas",
         *map(str, CONTROL_SIGMAS), "--seeds", "0", "--epochs", str(CONTROL_EPOCHS),
         "--device", device]))
    # the scorers of one shape train as one stack: the noise arms' (63 + 63
    # rows) and half's (31 + 31), one K1 forward and backward an epoch each,
    # and one more forward for the test rows
    stacks = len({N_WINDOWS, N_WINDOWS // 2})
    check(f"disc_controls, one bucket, {len(CONTROL_SIGMAS)} noise arms + half, one "
          f"seed, {CONTROL_EPOCHS} scorer epochs ({stacks} scorer stacks), in "
          f"{time.perf_counter() - t0:.2f} s", launches,
          (stacks * (CONTROL_EPOCHS + 1), stacks * CONTROL_EPOCHS, 0))
    lines = (root / "controls" / "controls.csv").read_text().splitlines()
    if lines[0] != "bucket,N,arm,seed,acc,auc" or len(lines) != 2 + len(CONTROL_SIGMAS):
        fail(f"[timegan-sweep] controls.csv: {lines}")
    print(f"[timegan-sweep] controls.csv: " + "; ".join(
        f"{r[2]} acc {r[4]:.3f} auc {r[5]:.3f}" for r in ctl)
        + f"; phase passed in {time.perf_counter() - t_phase:.2f} s | {smi}", flush=True)
    return dict(zip(("gru_sequence", "gru_sequence_bwd", "multigru_disc_inputs"),
                    (int(v) for v in total)))


def _trace_kernels(path: Path) -> dict:
    """{hand kernel: (events, device ms)} of the kernel events of a Chrome
    trace, by the kernels' symbol names."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for tag in ("gru_seq_fwd_kernel", "gru_seq_bwd_kernel", "multigru_fwd_kernel"):
        hits = [e for e in events if e.get("cat") == "kernel" and tag in e.get("name", "")]
        out[tag] = (len(hits), sum(float(e.get("dur", 0.0)) for e in hits) / 1e3)
    return out


def phase_profile_dir(smi: str, root: Path, device: str = "cuda") -> dict:
    """``--profile_dir`` of the CLI ``python -m eegsynth_torch.train.timegan``
    in both modes: the sequential trainer on one bucket and
    ``--parallel_buckets`` on two, each for PROFILE_GAN_STEPS GAN steps, on
    windows of PROFILE_SEQ_LEN samples.
    Each trace must parse as JSON; the hand kernels it holds (events and
    device time, by symbol name) against the run's launch counts. Returns
    the launch counts of the runs."""
    cuda = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    total = np.zeros(3, dtype=np.int64)
    base = root / "profile"
    base.mkdir()
    data2 = _write_buckets(base, 2, seq_len=PROFILE_SEQ_LEN)
    data1 = base / "one"
    data1.mkdir()
    (data1 / "posture1_no_exo.npz").write_bytes((data2 / "posture1_no_exo.npz").read_bytes())
    hp = _train_hparams()
    cfg_path = base / "config.json"
    cfg_path.write_text(json.dumps(hp))
    pre = -(-N_WINDOWS // min(hp["batch_size"], N_WINDOWS))
    for tag, data, flags, nb in (("sequential", data1, [], 1),
                                 ("--parallel_buckets", data2, ["--parallel_buckets"], 2)):
        prof = base / f"trace_{nb}"
        t0 = time.perf_counter()
        _, launches = _counted(lambda: timegan_cli(     # noqa: B023
            ["--config", str(cfg_path), "--data_dir", str(data),  # noqa: B023
             "--out_dir", str(base / f"runs_{nb}"), "--device", device,  # noqa: B023
             "--ae_epochs", "1", "--sup_epochs", "1", "--gan_steps",
             str(PROFILE_GAN_STEPS), "--profile_dir", str(prof), *flags]))  # noqa: B023
        secs = time.perf_counter() - t0
        want = (_seq_launches(N_WINDOWS, 1, 1, 1, PROFILE_GAN_STEPS) if nb == 1 else
                _bucket_launches(nb, pre, pre, PROFILE_GAN_STEPS)) if cuda else (0, 0, 0)
        traces = sorted(prof.glob("*_gan.trace.json"))
        if tuple(launches) != tuple(want) or len(traces) != 1:
            fail(f"[profile-dir] {tag}: launches {launches} (expected {want}), traces "
                 f"{[t.name for t in traces]}")
        total[:] += launches
        got = _trace_kernels(traces[0])
        # in the traced GAN phase: K2 once a step, K1 forward 5 a step and
        # backward 5 a step (the D inputs of the sequential trainer at one
        # layer also come from K2)
        print(f"[profile-dir] {tag}, {nb} bucket(s) of ({N_WINDOWS}, {PROFILE_SEQ_LEN}, "
              f"{CHANNELS}), {PROFILE_GAN_STEPS} GAN steps "
              f"traced, the run in {secs:.2f} s: {traces[0].name} "
              f"{traces[0].stat().st_size / 1e6:.1f} MB parses as JSON; hand kernels "
              f"in the trace (events, device ms): " + ", ".join(
                  f"{k} {n}, {ms:.3f}" for k, (n, ms) in got.items())
              + f"; the whole run launched gru_sequence {launches[0]}, "
              f"gru_sequence_bwd {launches[1]}, multigru_disc_inputs {launches[2]} "
              f"(expected {want}), its GAN phase K2 {PROFILE_GAN_STEPS}, K1 forward "
              f"{5 * PROFILE_GAN_STEPS}, K1 backward {5 * PROFILE_GAN_STEPS} times "
              f"| {smi}", flush=True)
        if cuda and got["multigru_fwd_kernel"][0] == 0:
            print(f"[profile-dir] {tag}: the trace holds no K2 event (a cluster "
                  f"launch) though the GAN phase launched it | {smi}", flush=True)
    print(f"[profile-dir] phase passed in {time.perf_counter() - t_phase:.2f} s | {smi}",
          flush=True)
    return dict(zip(("gru_sequence", "gru_sequence_bwd", "multigru_disc_inputs"),
                    (int(v) for v in total)))


def phase_cgan_multi(smi: str, device: str = "cuda") -> None:
    """The v2 posture stack at the JAX defaults (conv, B 64) on nine random
    postures of 2 x CGAN_WINDOWS windows, one epoch, through the CLI
    ``python -m eegsynth_torch.train.cgan_posture`` with
    ``--parallel-postures`` and, for posture 1, without; the artifacts;
    then two members (postures 1 and 2) at B 8: member 1's stacked step on
    the card against its lone step on the card and against the lone step on
    the CPU (the CGAN_* per-leaf rule). No hand kernel may launch."""
    t_phase = time.perf_counter()
    _zero_hand_kernel_counts()
    with tempfile.TemporaryDirectory() as tmp:
        data = _write_posture_buckets(Path(tmp), CGAN_WINDOWS, ("no_exo", "with_exo"))
        cli = ["--data-dir", str(data), "--epochs", "1", "--prewarm", "0",
               "--batch-size", str(CGAN_CONV_BATCH), "--save-every", "1", "--device",
               device]
        t0 = time.perf_counter()
        res = cgan_posture_cli([*cli, "--runs-root", f"{tmp}/par", "--parallel-postures"])
        secs = time.perf_counter() - t0
        missing = [f"posture{p}/{n}" for p in range(1, 10) for n in (
            "hparams.json", "metrics.csv", f"CGAN_generator_posture{p}_best.npz",
            f"CGAN_generator_posture{p}_last.npz", f"CGAN_generator_posture{p}_epoch1.npz",
            f"CGAN_globalD_posture{p}_best.npz", f"CGAN_localD_posture{p}_best.npz")
            if not (Path(tmp) / "par" / f"posture{p}" / n).exists()]
        rows = np.loadtxt(Path(tmp) / "par" / "posture9" / "metrics.csv", delimiter=",",
                          skiprows=1, ndmin=2)
        if missing or rows.shape != (1, 11) or not np.isfinite(res["best_g"]).all():
            fail(f"[cgan-multi] the stacked run: missing {missing}, posture9 metrics "
                 f"{rows.shape}, best G {res['best_g']}")
        steps = res["steps_per_epoch"]
        print(f"[cgan-multi] cgan_posture --parallel-postures: 9 postures x {steps} "
              f"steps (conv v2, B {CGAN_CONV_BATCH}, 2 x {CGAN_WINDOWS} windows a "
              f"posture) in {secs:.2f} s (epoch {res['epoch_seconds'][0]:.2f} s: "
              f"{res['epoch_seconds'][0] / (9 * steps) * 1e3:.1f} ms a member step); "
              f"every posture's 7 artifacts; best G {np.round(res['best_g'], 3).tolist()} "
              f"| {smi}", flush=True)
        t0 = time.perf_counter()
        seq = cgan_posture_cli([*cli, "--runs-root", f"{tmp}/seq", "--posture", "1"])
        if not (Path(tmp) / "seq" / "posture1" / "checkpoint_epoch1.npz").exists() \
                or not np.isfinite(seq[1]["best_g"]):
            fail("[cgan-multi] cgan_posture without --parallel-postures")
        print(f"[cgan-multi] cgan_posture --posture 1 (train_one_posture): "
              f"{seq[1]['steps_per_epoch']} steps in {time.perf_counter() - t0:.2f} s; "
              f"artifacts written | {smi}", flush=True)

    hp = cgan_train.CGANHParams(**{**cgan_train.V2_OVERRIDES, "batch_size": 8})
    cfg = cgan_train.build_cfg(hp, 2)
    optG = cgan_train.Adam(hp.lr_g, hp.beta1, hp.beta2)
    optD = cgan_train.Adam(hp.lr_d, hp.beta1, hp.beta2)
    g = torch.Generator().manual_seed(12)
    X = torch.rand((2, 16, CHANNELS, SEQ_LEN), generator=g)
    tables = torch.arange(16).reshape(2, 8).expand(2, 2, 8).contiguous()
    counts = torch.full((2, 2), 8.0)

    def members(dev):
        return [cgan_multi.init_member(cfg, hp.seed, p, optG, optD, device=dev)
                for p in (1, 2)]

    def gens(dev):
        return [torch.Generator(device=dev).manual_seed(40 + p) for p in (1, 2)]

    stack = members(device)
    cgan_multi.stack_step(stack, X.to(device), tables.to(device), counts.to(device),
                          gens(device), 0, 0.1, cfg=cfg, hp=hp, optG=optG, optD=optD,
                          prewarm=False)
    lone = members(device)[0]
    gen = gens(device)[0]
    draws = cgan_train.draw_cgan_step(gen, hp, cfg, tables[0].to(device),
                                      counts[0].to(device), prewarm=False, device=device)
    outs = {}
    for where, dev in (("card", device), ("CPU", "cpu")):
        m = lone if dev == device else members("cpu")[0]
        outs[where] = cgan_train.cgan_step(
            m.G, m.bn, m.D, m.ema, m.g_state, m.d_state, X[0].to(dev),
            cgan_train.draws_to(draws, dev), 0, 0.1, cfg=cfg, hp=hp, optG=optG,
            optD=optD, prewarm=False)
    got = stack[0]
    member = (got.G, got.bn, got.D, got.ema, got.g_state, got.d_state,
              outs["card"][6])
    _hold_cgan_step(smi, "[cgan-multi] posture stack member 1 (conv v2 B=8, R1 on) on "
                    "the card against its lone step on the card", hp, member, outs["card"])
    _hold_cgan_step(smi, "[cgan-multi] posture stack member 1 (conv v2 B=8, R1 on) on "
                    "the card against its lone step on the CPU plain path", hp, member,
                    outs["CPU"])
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(member[:4]),
                                                 tree_leaves(outs["card"][:4])))
    counts_now = _hand_kernel_counts()
    print(f"[cgan-multi] member 1 bitwise equal to its lone step on the card: {same}; "
          f"hand-kernel launches over the phase {counts_now} (all must be 0); the phase "
          f"took {time.perf_counter() - t_phase:.1f} s | {smi}", flush=True)
    if any(counts_now.values()):
        fail(f"[cgan-multi] the conv posture stack launched hand kernels: {counts_now}")


def _sweep_step_memory(device: str, remat: bool) -> tuple[float, float]:
    """One step of a transformer sweep at the JAX defaults, B 64, the
    CGAN_SWEEP_GRID points run in turn with their own weight vectors (R1 fires):
    (torch.cuda.max_memory_allocated in MB over the step, the step in ms)."""
    hp = cgan_train.CGANHParams(arch="transformer", tf_remat=remat,
                                batch_size=CGAN_CONV_BATCH)
    cfg = cgan_train.build_cfg(hp, 9)
    g = torch.Generator().manual_seed(13)
    G, bn = cgan_train.generator_init(cfg, g, device=device)
    D = {k: cgan_train.disc_init(cfg, g, device=device) for k in ("dg", "dl")}
    optG = cgan_train.Adam(hp.lr_g, hp.beta1, hp.beta2)
    optD = cgan_train.Adam(hp.lr_d, hp.beta1, hp.beta2)
    X = torch.rand((9 * CGAN_WINDOWS, CHANNELS, SEQ_LEN), generator=g).to(device)
    table = torch.arange(9 * CGAN_WINDOWS, device=device).reshape(9, CGAN_WINDOWS)
    counts = torch.full((9,), float(CGAN_WINDOWS), device=device)
    W = torch.from_numpy(cgan_sweep.weight_matrix(hp, CGAN_SWEEP_GRID)).to(device)
    states = [(G, bn, D, G, optG.init(G), optD.init(D)) for _ in CGAN_SWEEP_GRID]
    draws = cgan_train.draw_cgan_step(torch.Generator(device=device).manual_seed(14),
                                      hp, cfg, table, counts, prewarm=False,
                                      device=device)
    _sync(device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i, st in enumerate(states):
        states[i] = cgan_train.cgan_step(*st, X, draws, 0, 0.1, cfg=cfg, hp=hp,
                                         optG=optG, optD=optD, prewarm=False,
                                         weights=W[i])[:6]
    _sync(device)
    return torch.cuda.max_memory_allocated() / 2**20, (time.perf_counter() - t0) * 1e3


def phase_cgan_sweep(smi: str, device: str = "cuda") -> None:
    """The CGAN weight sweep through its CLI ``python -m
    eegsynth_torch.train.cgan_sweep`` on nine random posture buckets of
    CGAN_WINDOWS windows: the transformer default (dim 256, depth 4, patch
    8) with tf_remat on, S 3 (CGAN_SWEEP_GRID, two equal points), one epoch
    at B 64, scored at CGAN_SWEEP_SAMPLES windows a posture; then the conv
    model at S 1; whether the equal points are bitwise equal on the card;
    one weighted remat transformer step (R1 on) on the card against the
    CPU; torch.cuda.max_memory_allocated of one step at S 3 with and without
    remat. At 96 tokens "auto" attention launches no K3, and the conv path
    no hand kernel."""
    cuda = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    batch = cgan_train.CGANHParams().batch_size
    _zero_hand_kernel_counts()
    with tempfile.TemporaryDirectory() as tmp:
        data = _write_posture_buckets(Path(tmp), CGAN_WINDOWS)
        for arch, grid in (("transformer", CGAN_SWEEP_GRID), ("conv", [{}])):
            out = Path(tmp) / arch
            t0 = time.perf_counter()
            res = cgan_sweep_cli(["--data-dir", str(data), "--out", str(out), "--grid",
                                  json.dumps(grid), "--epochs", "1", "--arch", arch,
                                  "--samples-per-posture", str(CGAN_SWEEP_SAMPLES),
                                  "--device", device])
            secs = time.perf_counter() - t0
            hps = [json.loads((out / f"sweep{i}" / "hparams.json").read_text())
                   for i in range(len(grid))]
            ok = (len(res) == len(grid) and all(h["tf_remat"] == (arch == "transformer")
                                                for h in hps)
                  and all(np.isfinite([r["best_g"], r["stats"]["psd_l1"],
                                       r["disc"]["acc"]]).all() for r in res)
                  and (out / "sweep_results.json").exists())
            print(f"[cgan-sweep] cgan_sweep --arch {arch}"
                  f"{' (tf_remat on)' if arch == 'transformer' else ''}, S {len(grid)}, "
                  f"one epoch of {9 * CGAN_WINDOWS // batch} steps at B {batch} (the "
                  f"CLI's), scored at {CGAN_SWEEP_SAMPLES} windows a posture, "
                  f"in {secs:.2f} s; best G {[round(r['best_g'], 4) for r in res]}; "
                  f"psd_l1 {[round(r['stats']['psd_l1'], 3) for r in res]}, logreg acc "
                  f"{[round(r['disc']['acc'], 3) for r in res]} | {smi}", flush=True)
            if not ok:
                fail(f"[cgan-sweep] the {arch} sweep's results: {res}")
        last = [Path(tmp) / "transformer" / f"sweep{i}" / f"CGAN_generator_sweep{i}_last.npz"
                for i in range(3)]
        equal, differs = _same_npz(last[0], last[1]), not _same_npz(last[0], last[2])
        print(f"[cgan-sweep] equal-weight points sweep0 and sweep1 bitwise equal on the "
              f"card (last generators): {equal}; sweep2 differs: {differs} | {smi}",
              flush=True)
    hp0 = cgan_train.CGANHParams(arch="transformer")
    W = torch.from_numpy(cgan_sweep.weight_matrix(hp0, CGAN_SWEEP_GRID))
    _cgan_step_check(smi, device, "v1 B=8 dim 256 depth 4, tf_remat, R1 on, sweep "
                     "point 2's weights", seed=15, weights=W[2], tf_remat=True)
    if cuda:
        mem = {remat: _sweep_step_memory(device, remat) for remat in (False, True)}
        print(f"[cgan-sweep] one transformer sweep step, S {len(CGAN_SWEEP_GRID)}, B "
              f"{CGAN_CONV_BATCH}, dim 256 depth 4, R1 on: torch.cuda.max_memory_allocated "
              f"{mem[False][0]:.1f} MB without remat, {mem[True][0]:.1f} MB with "
              f"({mem[True][0] / mem[False][0]:.3f}x); the step {mem[False][1]:.1f} / "
              f"{mem[True][1]:.1f} ms | {smi}", flush=True)
    counts_now = _hand_kernel_counts()
    print(f"[cgan-sweep] hand-kernel launches over the phase {counts_now} (all must be "
          f"0 at 96 tokens); the phase took {time.perf_counter() - t_phase:.1f} s | {smi}",
          flush=True)
    if any(counts_now.values()):
        fail(f"[cgan-sweep] the sweep launched hand kernels: {counts_now}")


# ------------------------------------------------------------------
# Preprocessing and the mental-fatigue analysis
# ------------------------------------------------------------------

def _iir_inputs(T: int, M: int, order: int, dtype, seed: int):
    """The notch (order 2) or band-pass (order 8) of preprocessing at fs 128,
    a random walk x (T, M) and filtfilt's seed zi = lfilter_zi · x[0], on the
    card; b and a as numpy float64."""
    (b_bp, a_bp), (b_n, a_n) = design_filters(IIR_FS)
    b, a = (b_bp, a_bp) if order == 8 else (b_n, a_n)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((T, M))
                         .cumsum(axis=0)).to(dtype)
    zi = torch.as_tensor(lfilter_zi(b, a)).to(dtype)[:, None] * x[0]
    return b, a, x.cuda(), zi.cuda()


def _sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return float(out.splitlines()[0])


def _check_iir(smi: str) -> dict:
    """The IIR kernel against its plain version (the loop over time, on the
    card) at one 60 s trial's padded length, and against scipy's lfilter
    on the host (the same operations in the same order, equal to the plain
    version bit for bit: tests/test_torch_filtering.py) at one hour's, where
    the plain version would take millions of launches; orders 2 and 8, float64
    and float32. Each with its time, the byte and operation bounds and the
    step-chain floor. The kernels line takes (7734, 14), order 8, float64."""
    import scipy.signal

    clock = _sm_clock_mhz()
    head, worst = None, 0.0
    for T, M in IIR_SHAPES:
        for dtype in (torch.float64, torch.float32):
            for order in (8, 2):
                b, a, x, zi = _iir_inputs(T, M, order, dtype, seed=T + order)
                got = lfilter(b, a, x, zi=zi)
                np_dtype = np.float64 if dtype == torch.float64 else np.float32
                t0 = time.perf_counter()
                ref, _ = scipy.signal.lfilter(b.astype(np_dtype), a.astype(np_dtype),
                                              x.cpu().numpy(), axis=0,
                                              zi=zi.cpu().numpy())
                scipy_ms = (time.perf_counter() - t0) * 1e3
                ref = torch.from_numpy(ref).cuda()
                plain_ms = None
                if T == IIR_SHAPES[0][0]:
                    bt, at = (torch.as_tensor(c).to(dtype) for c in (b, a))
                    ref = lfilter_reference(bt, at, x, zi)
                    plain_ms = _time_ms(lambda: lfilter_reference(bt, at, x, zi), reps=1,
                                        warm=False)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                rel = err / ref.abs().max().item()
                ms = _time_ms(lambda: lfilter(b, a, x, zi=zi), reps=20 if T < 10 ** 5 else 5)
                flops = T * M * (4 * order + 2)
                peak = PEAK_FLOPS_F64 if dtype == torch.float64 else PEAK_FLOPS_F32
                ops_ms = flops / peak * 1e3
                bytes_ms = sum(t.numel() * t.element_size() for t in (x, zi, got)) \
                    / PEAK_BYTES * 1e3
                bound = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
                chain_ms = T * IIR_CHAIN_OPS * IIR_LATENCY[dtype] / (clock * 1e6) * 1e3
                tag = f"iir_filter T={T} M={M} order {order} {str(dtype)[6:]}"
                against = "plain (on the card)" if plain_ms is not None else \
                    "scipy.signal.lfilter (host)"
                plain = f"plain {plain_ms:.4f} ms, " if plain_ms is not None else \
                    "plain not timed (T x 3 launches), "
                print(f"[kernel] {tag}: max|diff| / max|{against}| = {rel:.3e} (tol "
                      f"{IIR_RTOL[dtype]:g}) kernel {ms:.4f} ms, {plain}scipy.signal."
                      f"lfilter on the host {scipy_ms:.4f} ms | {smi}", flush=True)
                if not bool(torch.isfinite(got).all()) or rel > IIR_RTOL[dtype]:
                    fail(f"iir_filter disagrees with {against} at {tag}: "
                         f"relative max|diff| {rel}")
                worst = max(worst, err)
                row = _row(ms, plain_ms, bound)
                _roofline(tag, row, smi)
                print(f"[bound] {tag}: step-chain floor {chain_ms:.4f} ms ({T} steps x "
                      f"{IIR_CHAIN_OPS} dependent operations x {IIR_LATENCY[dtype]} "
                      f"cycles assumed, at the {clock:.0f} MHz maximum SM clock): kernel "
                      f"at {100 * chain_ms / ms:.1f} % of it; bytes {bytes_ms:.5f} ms, "
                      f"operations {ops_ms:.5f} ms | {smi}", flush=True)
                if head is None:
                    head = row
    return {"max_abs_err": worst, **head}


def _hold_prep(card: Path, host: Path) -> int:
    """Card buckets against the CPU's: the same files and keys, X within
    PREP_X_ATOL, the scalers within PREP_SCALE_RTOL, everything else equal,
    prep_index.csv equal but for the directory. Returns the bucket count."""
    names = sorted(p.name for p in card.glob("*.npz"))
    if not names or names != sorted(p.name for p in host.glob("*.npz")):
        fail(f"[preprocess] buckets differ: {names} against "
             f"{sorted(p.name for p in host.glob('*.npz'))}")
    for name in names:
        with np.load(card / name, allow_pickle=True) as c, \
                np.load(host / name, allow_pickle=True) as h:
            if c.files != h.files:
                fail(f"[preprocess] {name}: keys {c.files} against {h.files}")
            for key in c.files:
                a, b = c[key], h[key]
                if a.dtype != b.dtype or a.shape != b.shape:
                    fail(f"[preprocess] {name}[{key}]: {a.dtype} {a.shape} against "
                         f"{b.dtype} {b.shape}")
                if key == "X":
                    ok = np.abs(a - b).max() <= PREP_X_ATOL
                elif key in ("scale_min", "scale_range"):
                    ok = (np.abs(a - b) <= PREP_SCALE_RTOL * np.abs(b)).all()
                else:
                    ok = np.array_equal(a, b)
                if not ok:
                    fail(f"[preprocess] {name}[{key}] differs between the card and "
                         f"the CPU")
    index = [(d / "prep_index.csv").read_text().replace(str(d), "<out>")
             for d in (card, host)]
    if index[0] != index[1]:
        fail("[preprocess] prep_index.csv differs between the card and the CPU")
    return len(names)


def phase_preprocess(smi: str, root: Path, device: str = "cuda") -> int:
    """``python -m eegsynth_torch.preprocess`` in this process over a raw tree
    like the reference's 6s_window/, on the card and then on the CPU; every
    bucket card against CPU; the IIR kernel's launches (4 a processed file)
    and its share of the card run. Returns the card run's launches."""
    from torch.profiler import ProfilerActivity, profile

    raw = root / "raw"
    t0 = time.perf_counter()
    files = write_raw_tree(raw, participants=RAW_PARTICIPANTS, seconds=RAW_SECONDS)
    print(f"[preprocess] wrote {len(files)} CSVs ({RAW_PARTICIPANTS} participants x 9 "
          f"postures x 2 conditions of {RAW_SECONDS:g} s at 128 Hz, participant 2 "
          f"at 50 Hz mains; a rest file, a 5 s trial, a 10-channel trial) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    runs = []
    for i, dev in enumerate((device, "cpu")):
        out = root / ("prep_card", "prep_host")[i]
        on_card = torch.device(dev).type == "cuda"
        lfilter.launches = 0
        buf = io.StringIO()
        t_block = time.perf_counter()
        with contextlib.ExitStack() as stack:
            stack.enter_context(contextlib.redirect_stdout(buf))
            prof = stack.enter_context(profile(activities=[ProfilerActivity.CUDA])) \
                if on_card else None
            t0 = time.perf_counter()
            rows = preprocess_cli(["--root", str(raw), "--out", str(out),
                                   "--device", dev])
            _sync(dev)
            secs = time.perf_counter() - t0
        block = time.perf_counter() - t_block
        launches = lfilter.launches
        log = buf.getvalue().replace(str(out), "<out>").splitlines()
        # filtered: the files written into buckets and the one skipped
        # after filtering for its channel count
        done = sum(line.startswith("done ") or "cannot concatenate" in line
                   for line in log)
        kernel_ms = None
        if prof is not None:
            kernel_ms = sum(e.self_device_time_total for e in _on_card(prof)
                            if "iir_filter_kernel" in e.key) / 1e3
        runs.append((out, rows, log, secs, launches, done, kernel_ms, block - secs))
    (card, rows_c, log_c, s_c, n_c, done_c, k_ms, prof_s), \
        (host, rows_h, log_h, s_h, n_h, done_h, _, _) = runs
    skips = [line for line in log_c if line.startswith("[SKIP]")]
    if log_c != log_h or len(skips) != 2 or done_c != done_h:
        fail(f"[preprocess] the card's and the CPU's runs logged differently or "
             f"skipped {len(skips)} files, not 2 (the 5 s and the 10-channel "
             f"trials; the rest file is no trial): {skips}")
    if torch.device(device).type == "cuda" and (n_c != 4 * done_c or n_h != 0):
        fail(f"[preprocess] iir_filter launched {n_c} times on the card for {done_c} "
             f"filtered files (expected {4 * done_c}) and {n_h} on the CPU")
    t0 = time.perf_counter()
    n_buckets = _hold_prep(card, host)
    hold_s = time.perf_counter() - t0
    share = (f"kernel device time {k_ms:.2f} ms, {100 * k_ms / (s_c * 1e3):.3f} % of "
             "the run" if k_ms else "kernel share not measured")
    print(f"[preprocess] card: {done_c} files filtered, {len(skips)} skipped, "
          f"{n_buckets} buckets in {s_c:.2f} s ({done_c / s_c:.2f} files/s), "
          f"iir_filter launches {n_c} (4 a filtered file), {share}; CPU (plain "
          f"recurrence): {s_h:.2f} s ({done_h / s_h:.2f} files/s); every bucket card "
          f"= CPU (X within {PREP_X_ATOL:g}, scalers {PREP_SCALE_RTOL:g} relative, "
          f"prep_index.csv and the skips equal; {hold_s:.2f} s); the profiler's "
          f"start and stop {prof_s:.2f} s | {smi}", flush=True)
    return n_c


def _csv_cells_within(ours: Path, ref: Path) -> int:
    """Every cell of two CSVs: strings equal, numbers within CSV_RTOL
    relative (CSV_ATOL absolute), NaN where NaN. Returns the cell count."""
    rows = []
    for path in (ours, ref):
        with open(path, newline="") as f:
            rows.append(list(csv.reader(f)))
    a, b = rows
    if len(a) != len(b) or any(len(x) != len(y) for x, y in zip(a, b)):
        fail(f"[fatigue] {ours.name}: shapes differ")
    n = 0
    for x, y in zip(a, b):
        for cx, cy in zip(x, y):
            n += 1
            try:
                fx, fy = float(cx), float(cy)
            except ValueError:
                if cx != cy:
                    fail(f"[fatigue] {ours.name}: {cx!r} against {cy!r}")
                continue
            if np.isnan(fy) != np.isnan(fx) or (
                    not np.isnan(fy) and abs(fx - fy) > CSV_ATOL + CSV_RTOL * abs(fy)):
                fail(f"[fatigue] {ours.name}: {cx} against {cy}")
    return n


def _fatigue_size(name: str) -> tuple[int, int]:
    """The pixel size of a fatigue_report figure (its figsize at dpi 200)."""
    for suffix, inches in (("_PSD_mean.png", (8, 5)), ("_bandpowers.png", (14, 6)),
                           ("_Workload_thetaF_over_alphaPO.png", (5, 5)),
                           ("_tbr_4group.png", (14, 6)), ("_participant_tbr.png", (14, 6))):
        if name.endswith(suffix):
            return inches[0] * 200, inches[1] * 200
    return 12 * 200, 6 * 200        # the region-grouped bars


def phase_fatigue(smi: str, root: Path, device: str = "cuda") -> None:
    """``python -m eegsynth_torch.fatigue_report``'s five subcommands in this
    process on the card, then on the CPU: real/ the card's buckets from
    [preprocess], synthetic/ count-matched random windows in [0, 1] under the
    bucket names, runs/ the same as posture{p}_{cond}/synthetic.npz; every
    CSV cell card against CPU."""
    base = root / "fatigue"
    real, syn = base / "root" / "real", base / "root" / "synthetic"
    real.mkdir(parents=True)
    syn.mkdir(parents=True)
    rng = np.random.default_rng(31)
    for fp in sorted((root / "prep_card").glob("*.npz")):
        shutil.copy(fp, real / fp.name)
        with np.load(fp, allow_pickle=True) as z:
            X = rng.uniform(0, 1, z["X"].shape).astype(np.float32)
            fs = z["fs"]
        np.savez(syn / fp.name, X=X, fs=fs)
        (base / "runs" / fp.stem).mkdir(parents=True)
        np.savez(base / "runs" / fp.stem / "synthetic.npz", X=X, fs=fs)
    tree = ["--root", str(base / "root")]
    commands = {"bandpower": ["bandpower", *tree], "indices": ["indices", *tree],
                "paired": ["paired", *tree],
                "ttest": ["ttest", *tree, "--export-csv", "--scaling", "p95"],
                "participants": ["participants", "--data-root", str(root / "raw"),
                                 "--synth-dir", str(base / "runs"), "--real-dir",
                                 str(real), "--inverse-scale"]}
    seconds, drawn, recorded = {}, {}, {name: [] for name in commands}
    for i, dev in enumerate((device, "cpu")):
        for name, argv in commands.items():
            out = base / ("card", "host")[i] / name
            _reset_fig_stats()
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
                if i == 1:      # the CPU run is the CSVs' reference: its figures
                    stack.enter_context(_figures_recorded(recorded[name]))  # are named
                fatigue_cli([*argv, "--out", str(out), "--device", dev])
            _sync(dev)
            seconds[(i, name)] = time.perf_counter() - t0
            if i == 0:
                drawn[name] = (raster.STATS["figures"], raster.STATS["draw_s"],
                               raster.STATS["png_s"])
    n_files = n_cells = n_pngs = 0
    for name in commands:
        card, host = base / "card" / name, base / "host" / name
        files = sorted(p.relative_to(card) for p in card.rglob("*.csv"))
        if not files or files != sorted(p.relative_to(host) for p in host.rglob("*.csv")):
            fail(f"[fatigue] {name}: the card wrote {files}, the CPU "
                 f"{sorted(p.relative_to(host) for p in host.rglob('*.csv'))}")
        for rel in files:
            n_cells += _csv_cells_within(card / rel, host / rel)
        n_files += len(files)
        pngs = {str(p.relative_to(host)): _fatigue_size(p.name) for p in recorded[name]}
        if name in ("bandpower", "indices", "ttest", "participants") and not pngs:
            fail(f"[fatigue] {name}: no figure")
        n_pngs += _check_pngs(f"fatigue {name}", card, pngs)
    print(f"[fatigue] five subcommands, {n_files} CSVs and {n_cells} cells card = CPU "
          f"(numbers within {CSV_RTOL:g} relative); seconds card / CPU: " + ", ".join(
              f"{name} {seconds[(0, name)]:.2f} / {seconds[(1, name)]:.2f}"
              for name in commands) + f" | {smi}", flush=True)
    print(f"[figures] fatigue_report figures on the card, {n_pngs} PNGs (the CPU run's "
          f"names; each decoded, not blank): " + ", ".join(
              f"{name} {n} figures, drawing {d:.2f} s + deflate {z:.2f} s"
              for name, (n, d, z) in drawn.items() if n) + f" | {smi}", flush=True)


def _png_info(path: Path) -> tuple[int, int, int]:
    """(width, height, distinct colours) of a PNG the raster layer wrote
    (8-bit RGB, filter 0), decoded with zlib; fails if it does not
    decode."""
    data = path.read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path}: not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = body
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = int.from_bytes(head[:4], "big"), int.from_bytes(head[4:8], "big")
    if head[8:10] != b"\x08\x02":
        fail(f"{path}: not 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    px = rows[:, 1:].reshape(-1, 3)[::7].astype(np.uint32)
    colours = len(np.unique((px[:, 0] << 16) | (px[:, 1] << 8) | px[:, 2]))
    return w, h, colours


def _check_pngs(what: str, out: Path, sizes: dict) -> int:
    """Every PNG under ``out`` is one of ``sizes`` (relative name → (w, h),
    or None for a cropped figure), all of them there, each decodes and is
    not blank. Returns the count."""
    got = sorted(str(p.relative_to(out)) for p in out.rglob("*.png"))
    if got != sorted(sizes):
        fail(f"[figures] {what}: wrote {got}, expected {sorted(sizes)}")
    for name, size in sizes.items():
        w, h, colours = _png_info(out / name)
        if (size is not None and (w, h) != size) or colours < 3:
            fail(f"[figures] {what}: {name} is {w} x {h} with {colours} colours "
                 f"(expected {size}, not blank)")
    return len(got)


def _fig_stats() -> str:
    e, r = embed.STATS, raster.STATS
    per = 1e3 * e["tsne_s"] / max(1, e["tsne_iters"])
    return (f"PCA {e['pca_s']:.2f} s ({e['pca_calls']} calls), t-SNE {e['tsne_s']:.2f} s "
            f"({e['tsne_calls']} runs, {e['tsne_iters']} iterations, {per:.3f} ms an "
            f"iteration), drawing {r['draw_s']:.2f} s + deflate {r['png_s']:.2f} s "
            f"({r['figures']} figures)")


def _reset_fig_stats() -> None:
    embed.reset_stats()
    raster.reset_stats()


@contextlib.contextmanager
def _figures_recorded(paths: list):
    """Figures are recorded, not drawn (the CPU reference runs of phases
    whose figures the card run draws)."""
    real = raster.Figure.savefig
    raster.Figure.savefig = lambda self, path, *a, **k: paths.append(Path(path))
    try:
        yield
    finally:
        raster.Figure.savefig = real


def _figure_pairs(root: Path, device: str) -> int:
    """real/posture{p}_{cond}.npz of FIG_WINDOWS (768, 14) windows in [0, 1]
    (a sine of the pair's own frequency on every channel plus noise) and
    runs/posture{p}_{cond}/synthetic.npz drawn by a full-width random
    TimeGAN (x14/z28/h56, seeded per pair) on ``device``. Returns K1's
    launches."""
    real, runs = root / "real", root / "runs"
    real.mkdir(parents=True)
    rng = np.random.default_rng(41)
    t = np.arange(SEQ_LEN) / 128.0
    cfg = TimeGANConfig(x_dim=CHANNELS, z_dim=28, h_dim=56)
    gru_sequence.launches = 0
    for i, name in enumerate(f"posture{p}_{c}" for p in range(1, 10)
                             for c in ("no_exo", "with_exo")):
        phase = rng.uniform(0, 2 * np.pi, (FIG_WINDOWS, 1, CHANNELS))
        X = 0.5 + 0.25 * np.sin(2 * np.pi * (2 + i) * t[None, :, None] + phase) \
            + 0.05 * rng.standard_normal((FIG_WINDOWS, SEQ_LEN, CHANNELS))
        np.savez(real / f"{name}.npz", X=np.clip(X, 0, 1).astype(np.float32),
                 fs=np.float32(128.0), ch_names=np.array(EPOC_CHANNELS))
        model = TimeGAN(cfg, generator=torch.Generator().manual_seed(100 + i), device=device)
        fake = synthesize(model, FIG_WINDOWS, SEQ_LEN,
                          generator=torch.Generator(device=device).manual_seed(i))
        (runs / name).mkdir(parents=True)
        np.savez(runs / name / "synthetic.npz", X=fake)
    return gru_sequence.launches


def phase_figures(smi: str, root: Path, device: str = "cuda") -> int:
    """The figures at full width: 18 pairs of FIG_WINDOWS real and
    synthetic windows (768, 14), the synthetic from the TimeGAN cascade on
    K1; ``python -m eegsynth_torch.visualization --zooms --paired-legend``
    at the default t-SNE cap (FIG_TSNE_MAX of 7200 windows of 10,752
    features); the eval's pca_tsne_plots at --tsne_max FIG_TSNE_MAX;
    ``python -m eegsynth_torch.preprocessing_plots`` on one of
    [preprocess]'s CSVs; every PNG decodes, is not blank and has its size;
    PCA and t-SNE on the card against the CPU. Returns K1's launches."""
    fig = root / "figures"
    t0 = time.perf_counter()
    k1 = _figure_pairs(fig, device)
    want_k1 = 3 * N_BUCKETS if torch.device(device).type == "cuda" else 0
    print(f"[figures] 18 pairs of {FIG_WINDOWS} real + {FIG_WINDOWS} synthetic windows "
          f"({SEQ_LEN}, {CHANNELS}) in {time.perf_counter() - t0:.2f} s; gru_sequence "
          f"launches {k1} (expected {want_k1}) | {smi}", flush=True)
    if k1 != want_k1:
        fail(f"[figures] the synthetic windows launched K1 {k1} times, not {want_k1}")

    zoom = (1080, 827)      # 6.0 x 4.6 in at 180 dpi
    _reset_fig_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        visualization_cli(["--real_dir", str(fig / "real"), "--synth_dir",
                           str(fig / "runs"), "--out", str(fig / "viz"), "--zooms",
                           "--paired-legend", "--device", device])
    secs = time.perf_counter() - t0
    sizes = {"pca_combined.png": (1462, 986), "tsne_combined.png": (1462, 986)}
    sizes.update({f"zoom_p{p}_{c}_{k}.png": zoom for p in range(1, 10)
                  for c in ("no_exo", "with_exo") for k in ("pca", "tsne")})
    n = _check_pngs("visualization", fig / "viz", sizes)
    print(f"[figures] visualization --zooms --paired-legend (t-SNE of "
          f"{min(FIG_TSNE_MAX, 2 * N_BUCKETS * FIG_WINDOWS)} of "
          f"{2 * N_BUCKETS * FIG_WINDOWS} windows x {SEQ_LEN * CHANNELS} features, 18 "
          f"zoom pairs): {secs:.2f} s; {_fig_stats()}; {n} PNGs checked | {smi}",
          flush=True)

    pairs = load_pairs_by_condition(fig / "real", fig / "runs")
    keys = sorted(pairs)
    R = np.concatenate([pairs[k][0] for k in keys])
    F = np.concatenate([pairs[k][1] for k in keys])
    labels = np.array([k[0] for k in keys for _ in range(FIG_WINDOWS)] * 2)
    domain = np.array([1] * len(R) + [0] * len(F))
    (fig / "eval").mkdir()
    _reset_fig_stats()
    t0 = time.perf_counter()
    pca_tsne_plots(fig / "eval", R, F, labels, domain, FIG_TSNE_MAX, device=device)
    secs = time.perf_counter() - t0
    n = _check_pngs("pca_tsne_plots", fig / "eval",
                    {"pca_global.png": (1120, 800), "tsne_global.png": (1120, 800)})
    print(f"[figures] eval pca_tsne_plots --tsne_max {FIG_TSNE_MAX} ({len(R) + len(F)} "
          f"windows x {SEQ_LEN * CHANNELS} features, t-SNE without a PCA-50 step): "
          f"{secs:.2f} s; {_fig_stats()}; {n} PNGs checked | {smi}", flush=True)

    csv_path = sorted((root / "raw").rglob("*.csv"))[0]
    _reset_fig_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        preprocessing_plots_cli(["--csv", str(csv_path), "--out", str(fig / "prep"),
                                 "--device", device])
    secs = time.perf_counter() - t0
    stages = ["1_raw_signal", "1_raw_spec", "2_notch_signal", "2_notch_spec", "2_notch_psd",
              "3_bandpass_signal", "3_bandpass_spec", "3_bandpass_psd",
              "4_resampled_signal", "4_resampled_spec", "4_resampled_psd",
              "5_artifact_signal", "5_artifact_spec", "5_artifact_psd", "6_epoch_signal",
              "6_epoch_spec", "6_epoch_psd", "7_features_spec"]
    sizes = {f"{s}.png": (2000, 600) if "psd" not in s else (1600, 600) for s in stages}
    sizes.update({"7_features_bandpower.png": (1200, 800),
                  "8_labels_timeline.png": (2400, 600), "8_labels_tracks.png": (2400, 560),
                  "8_labels_epoch_grid.png": (int(max(6, 0.6 * int(RAW_SECONDS // 6)) * 200),
                                              360),
                  "8_labels_card.png": (840, 560)})
    n = _check_pngs("preprocessing_plots", fig / "prep", sizes)
    print(f"[figures] preprocessing_plots on {csv_path.name} ({RAW_SECONDS:g} s at 128 Hz): "
          f"{secs:.2f} s; {_fig_stats()}; {n} PNGs checked | {smi}", flush=True)

    # the card against the CPU, outside the CLIs
    X = torch.as_tensor(np.concatenate([R, F]).reshape(len(R) + len(F), -1)[::7][:FIG_PCA_ROWS])
    got = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        got[dev] = (embed.pca(X.to(dev), 2).cpu().numpy(), time.perf_counter() - t0)
    err = (np.abs(got[device][0] - got["cpu"][0]).max(0)
           / np.abs(got["cpu"][0]).max(0)).max()
    Xt = embed.pca(X[:FIG_TSNE_ROWS], 50)
    runs_t = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        res = embed.tsne(Xt.to(dev), perplexity=30.0)
        runs_t[dev] = (res, time.perf_counter() - t0)
    kl = {d: r.kl_divergence for d, (r, _) in runs_t.items()}
    tw = {d: embed.trustworthiness(Xt, r.embedding.cpu(), 10) for d, (r, _) in runs_t.items()}
    kl_rel = abs(kl[device] - kl["cpu"]) / kl["cpu"]
    print(f"[figures] card vs CPU: PCA-2 of {len(X)} rows x {X.shape[1]}: max |diff| "
          f"{err:.3e} of each component's largest score (tol {FIG_PCA_RTOL:g}), "
          f"{got[device][1]:.3f} s on the card, {got['cpu'][1]:.3f} s on the CPU; t-SNE "
          f"of {FIG_TSNE_ROWS} (PCA-50): KL {kl[device]:.5f} / {kl['cpu']:.5f} (relative "
          f"{kl_rel:.3e}, tol {FIG_TSNE_KL_RTOL:g}), trustworthiness@10 {tw[device]:.5f} / "
          f"{tw['cpu']:.5f} (tol {FIG_TSNE_TW_TOL:g}), {runs_t[device][0].n_iter + 1} / "
          f"{runs_t['cpu'][0].n_iter + 1} iterations in {runs_t[device][1]:.2f} / "
          f"{runs_t['cpu'][1]:.2f} s | {smi}", flush=True)
    if not (err <= FIG_PCA_RTOL and kl_rel <= FIG_TSNE_KL_RTOL
            and abs(tw[device] - tw["cpu"]) <= FIG_TSNE_TW_TOL):
        fail(f"[figures] the card's embeddings disagree with the CPU's: PCA {err}, KL "
             f"{kl_rel}, trustworthiness {tw}")
    return k1


def _cgan_figures(smi: str, root: Path, device: str) -> None:
    """``python -m eegsynth_torch.visualization_cgan`` on [cgan-conv]'s
    posture buckets and its v2 generator of posture 1 (postures 2-9 have
    none and are skipped): pca_36.png, tsne_36.png and posture 1's four
    zooms, each decoded, not blank and of its size."""
    _reset_fig_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        visualization_cgan_cli(["--data-dir", str(root / "cgan_data"), "--runs-root",
                                str(root / "conv_v2"), "--out", str(root / "cgan_viz"),
                                "--device", device])
    secs = time.perf_counter() - t0
    sizes = {"pca_36.png": (1462, 986), "tsne_36.png": (1462, 986)}
    sizes.update({f"zooms/zoom_p1_{c}_{k}.png": (1080, 827)
                  for c in ("no_exo", "with_exo") for k in ("pca", "tsne")})
    n = _check_pngs("visualization_cgan", root / "cgan_viz", sizes)
    print(f"[figures] visualization_cgan (v2 conv generator of posture 1, 2 x "
          f"{CGAN_WINDOWS} windows a side): {secs:.2f} s; {_fig_stats()}; {n} PNGs "
          f"checked | {smi}", flush=True)


def _wide_counts() -> tuple:
    """_wide_route_counts, then K2."""
    return (*_wide_route_counts(), multigru_disc_inputs.launches)


def _since(before: tuple) -> list:
    return [a - b for a, b in zip(_wide_counts(), before)]


def phase_timegan_wide(smi: str, device: str = "cuda") -> dict:
    """A TimeGAN at x14/z64/h256 through train/timegan.py's step functions
    on the card: one AE and one SUP step, TG_WIDE_GAN_STEPS GAN steps on a
    random bucket of (TG_WIDE_WINDOWS, 768, 14), then synthesize() of 64
    windows; K1's wide route launched (the forward on its cluster kernel,
    the streaming backward), no K2 (the D-step inputs take the composed
    route past H 128), finite losses and windows;
    then one GAN step at B 4, T TG_WIDE_CHECK_T on the card against the CPU.
    Returns the launches of the training and synthesis run."""
    x_dim, z_dim, h_dim = TG_WIDE_DIMS
    cfg = TimeGANConfig(x_dim=x_dim, z_dim=z_dim, h_dim=h_dim)
    params = timegan_init_stacked(cfg, [torch.Generator().manual_seed(0)], device=device)
    hp = TimeGANHParams(**_train_hparams(gan_steps=TG_WIDE_GAN_STEPS,
                                         batch_size=TG_WIDE_BATCH))
    B = TG_WIDE_BATCH
    X = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, TG_WIDE_WINDOWS, SEQ_LEN, x_dim)).astype(np.float32)).to(device)
    before = _wide_counts()
    t0 = time.perf_counter()
    losses = {}
    for which in ("ae", "sup"):
        opt = Optimizer(hp.lr_g, hp.grad_clip, hp.beta1, hp.beta2)
        state = opt.init({"embedder": params["embedder"], "recovery": params["recovery"]}
                         if which == "ae" else params["supervisor"])
        x = gather_batch(X, torch.arange(B, device=device)[None])
        params, state, loss = pre_phase_step(params, opt, state, x, which)
        losses[which] = loss.item()
    optD, optG = make_gan_opts(hp)
    d_state = optD.init(params["discriminator"])
    g_state = optG.init({k: params[k] for k in GEN_NETS})
    gens = [torch.Generator(device=device).manual_seed(1)]
    logs = []
    for step in range(1, TG_WIDE_GAN_STEPS + 1):
        draws = draw_gan(gens, torch.full((1,), float(TG_WIDE_WINDOWS), device=device), B,
                         SEQ_LEN, z_dim, device=device)
        params, d_state, g_state, step_logs = gan_step(
            params, optD, d_state, optG, g_state, gather_batch(X, draws.idx), draws, step, hp)
        logs.append(step_logs[0].tolist())
    _sync(device)
    train_s = time.perf_counter() - t0
    model = from_jax_params(unstack_params(params, 0), device=device).eval()
    t0 = time.perf_counter()
    windows = synthesize(model, 64, SEQ_LEN,
                         generator=torch.Generator(device=device).manual_seed(2))
    synth_s = time.perf_counter() - t0
    k1, k1_bwd, cluster, wide, wide_bwd, k2 = _since(before)
    fmt = lambda row: ", ".join(f"{c}={v:.5f}" for c, v in zip(LOG_COLUMNS, row))  # noqa
    print(f"[timegan-wide] x{x_dim}/z{z_dim}/h{h_dim}, B {B}, T {SEQ_LEN}: AE loss "
          f"{losses['ae']:.6f}, SUP loss {losses['sup']:.6f}; GAN step {TG_WIDE_GAN_STEPS}: "
          f"{fmt(logs[-1])}; AE + SUP + {TG_WIDE_GAN_STEPS} GAN steps {train_s:.2f} s, "
          f"synthesize(64 x {SEQ_LEN}) {synth_s:.2f} s -> {windows.shape}; launches K1 "
          f"forward {k1}, backward {k1_bwd}, wide forward on clusters {cluster}, "
          f"streaming {wide}, wide backward {wide_bwd}, K2 {k2} | {smi}", flush=True)
    if not (np.isfinite(logs).all() and all(np.isfinite(v) for v in losses.values())):
        fail(f"[timegan-wide] non-finite losses: {losses}, {logs}")
    if windows.shape != (64, SEQ_LEN, x_dim) or not np.isfinite(windows).all():
        fail(f"[timegan-wide] synthesize gave {windows.shape}, finite "
             f"{np.isfinite(windows).all()}")
    on_card = torch.device(device).type == "cuda"
    if on_card and (cluster < 1 or wide != 0 or wide_bwd < 1 or k2 != 0):
        fail(f"[timegan-wide] launches: wide forward on clusters {cluster}, streaming "
             f"{wide}, wide backward {wide_bwd}, K2 {k2}; expected the cluster forward, "
             "the wide backward, no streaming forward and no K2")
    _wide_step_check(smi, device)
    return {"gru_sequence": k1, "gru_sequence_bwd": k1_bwd,
            "gru_sequence_wide_cluster": cluster, "gru_sequence_wide": wide,
            "gru_sequence_bwd_wide": wide_bwd}


def _wide_step_check(smi: str, device: str, B: int = 4) -> None:
    """One GAN step of the x14/z64/h256 TimeGAN at T TG_WIDE_CHECK_T on the
    card against the CPU plain path, on the same parameters and draws: the
    step check's tolerances on the logged values, parameters and Adam's
    first moments."""
    x_dim, z_dim, h_dim = TG_WIDE_DIMS
    T = TG_WIDE_CHECK_T
    cfg = TimeGANConfig(x_dim=x_dim, z_dim=z_dim, h_dim=h_dim)
    params = timegan_init_stacked(cfg, [torch.Generator().manual_seed(3)], device="cpu")
    hp = TimeGANHParams(**_train_hparams(gan_steps=GAN_STEPS, batch_size=B))
    optD, optG = make_gan_opts(hp)
    X = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (1, 16, T, x_dim))
                         .astype(np.float32))
    draws = draw_gan([torch.Generator().manual_seed(3)], torch.full((1,), 16.0), B, T,
                     z_dim, device="cpu")
    x = gather_batch(X, draws.idx)

    def step(dev):
        p = tree_map(lambda t: t.to(dev), params)
        d = type(draws)(**{k: tree_map(lambda t: t.to(dev), v)
                           for k, v in vars(draws).items()})
        return gan_step(p, optD, optD.init(p["discriminator"]), optG,
                        optG.init({k: p[k] for k in GEN_NETS}), x.to(dev), d, 1, hp)

    before = _wide_counts()
    card = step(device)
    _sync(device)
    launched = _since(before)
    host = step("cpu")
    log_err = ((card[3].cpu() - host[3]).abs() / host[3].abs().clamp(min=1.0)).max().item()
    p_err = max((a.cpu() - b).abs().max().item()
                for a, b in zip(tree_leaves(card[0]), tree_leaves(host[0])))
    mu_err = max(((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                 for i in (1, 2)
                 for a, b in zip(tree_leaves(card[i].mu), tree_leaves(host[i].mu)))
    print(f"[timegan-wide] one GAN step at B {B}, T {T}, card vs CPU: logged values "
          f"{log_err:.3e} (tol {STEP_LOG_RTOL:g}), parameters {p_err:.3e} (tol "
          f"{STEP_PARAM_ATOL:g}), Adam first moments {mu_err:.3e} (tol {STEP_MU_RTOL:g}); "
          f"launches K1 fwd / bwd / cluster fwd / streaming fwd / wide bwd / K2 {launched} "
          f"| {smi}", flush=True)
    if log_err > STEP_LOG_RTOL or p_err > STEP_PARAM_ATOL or not mu_err <= STEP_MU_RTOL:
        fail(f"[timegan-wide] the card's GAN step disagrees with the CPU: logs {log_err}, "
             f"params {p_err}, mu {mu_err}")


def _reference_generator_sd(num_classes: int, seed: int) -> dict:
    """A reference conv generator's state_dict at full width, random, under
    the older key names the reference loader renames (u<i>., out.,
    .cbn.emb.), with nonzero BatchNorm statistics."""
    g = torch.Generator().manual_seed(seed)
    chans = (512, 256, 128, 64, 32, 16)
    sd = {"proj.weight": 0.05 * torch.randn(512 * 24, 100 + num_classes, generator=g),
          "proj.bias": 0.05 * torch.randn(512 * 24, generator=g)}
    for i in range(1, 6):
        ci, co = chans[i - 1], chans[i]
        sd[f"u{i}.conv.weight"] = 0.05 * torch.randn(co, ci, 3, generator=g)
        sd[f"u{i}.conv.bias"] = 0.05 * torch.randn(co, generator=g)
        sd[f"u{i}.cbn.emb.weight"] = torch.cat(
            [1 + 0.1 * torch.randn(num_classes, co, generator=g),
             0.1 * torch.randn(num_classes, co, generator=g)], dim=1)
        sd[f"u{i}.cbn.bn.running_mean"] = 0.1 * torch.randn(co, generator=g)
        sd[f"u{i}.cbn.bn.running_var"] = 1 + 0.3 * torch.rand(co, generator=g)
        sd[f"u{i}.cbn.bn.num_batches_tracked"] = torch.tensor(7)
    sd["out.weight"] = 0.05 * torch.randn(14, 16, 3, generator=g)
    sd["out.bias"] = 0.05 * torch.randn(14, generator=g)
    return sd


def _reference_generator_forward(sd: dict, z, labels, num_classes: int):
    """The reference Generator's eval-mode forward, written out in torch
    functions on its own state_dict (legacy names): Linear → five (nearest
    x2, conv k3, affine-free BN on the running statistics, class scale and
    shift, ReLU) → conv k3 → sigmoid. (B, 14, 768)."""
    F = torch.nn.functional
    h = F.linear(torch.cat([z, F.one_hot(labels, num_classes).float()], dim=1),
                 sd["proj.weight"], sd["proj.bias"]).view(-1, 512, 24)
    for i in range(1, 6):
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = F.conv1d(h, sd[f"u{i}.conv.weight"], sd[f"u{i}.conv.bias"], padding=1)
        h = F.batch_norm(h, sd[f"u{i}.cbn.bn.running_mean"],
                         sd[f"u{i}.cbn.bn.running_var"], training=False)
        gb = F.embedding(labels, sd[f"u{i}.cbn.emb.weight"])
        nf = h.shape[1]
        h = F.relu(gb[:, :nf, None] * h + gb[:, nf:, None])
    return torch.sigmoid(F.conv1d(h, sd["out.weight"], sd["out.bias"], padding=1))


def phase_convert(smi: str, root: Path, device: str = "cuda") -> int:
    """``python -m eegsynth_torch.convert_torch_ckpt`` in this process: a
    reference-shaped TimeGAN checkpoint (ckpt_best.pt and ckpt_latest.pt of
    one run, x14/z28/h56) and a conv generator (CGAN_generator_no_exo_best.pth,
    legacy key names) made in torch and converted; both served over HTTP on
    the card. The served TimeGAN windows equal, bit for bit, those of the
    port's TimeGAN loaded from the same state_dict; the served CGAN windows
    the reference forward's on the same noise. generate_long_synth on the
    converted run; then --reverse, whose files hold the original tensors
    bit for bit. Returns K1's launches in the served and generated runs."""
    run = "posture1_no_exo"
    cfg = TimeGANConfig(x_dim=14, z_dim=28, h_dim=56)
    g = torch.Generator().manual_seed(5)
    sd = {k: (v + 0.05 * torch.randn(v.shape, generator=g) if "bias" in k else v)
          for k, v in TimeGAN(cfg, generator=g, device="cpu").state_dict().items()}
    ref, ref_cgan = root / "ref_runs", root / "ref_cgan"
    (ref / run).mkdir(parents=True)
    for i, name in enumerate(("ckpt_best.pt", "ckpt_latest.pt")):
        torch.save({"step": 10 * (i + 1), "model": sd, "optG": {}, "optD": {},
                    "meta": {"npz": f"{run}.npz", "z_dim": 28, "h_dim": 56}}, ref / run / name)
    gen_sd = _reference_generator_sd(9, 6)
    (ref_cgan / "no_exo").mkdir(parents=True)
    torch.save(gen_sd, ref_cgan / "no_exo" / "CGAN_generator_no_exo_best.pth")
    conv, conv_cgan = root / "converted", root / "converted_cgan"
    t0 = time.perf_counter()
    convert_cli(["--runs_dir", str(ref), "--out_dir", str(conv)])
    convert_cli(["--family", "cgan", "--runs_dir", str(ref_cgan), "--out_dir", str(conv_cgan)])
    convert_s = time.perf_counter() - t0

    gru_sequence.launches = 0
    reg = ModelRegistry(conv, None, True, device=device, cgan_root=conv_cgan)
    srv = make_server(reg, "127.0.0.1", 0, SERVE_BATCH, TIME_CHUNK)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        X, wall = _post(srv.server_address, {"run": run, "n": CONVERT_N,
                                             "seq_len": CONVERT_LEN, "seed": 3})
        Xc, wall_c = _post(srv.server_address, {"model": "no_exo", "label": 4,
                                                "n": CONVERT_N, "seed": 3}, "/synthesize_cgan")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    launches = gru_sequence.launches
    direct = TimeGAN(cfg, generator=torch.Generator().manual_seed(99), device="cpu")
    direct.load_state_dict(sd)
    reg.models[run]["model"] = direct.to(device).eval()
    X_direct = reg.synthesize(run, CONVERT_N, CONVERT_LEN, 3, False, SERVE_BATCH, TIME_CHUNK)
    with torch.inference_mode():
        gen = torch.Generator(device=device).manual_seed(3)
        z = torch.randn((SERVE_BATCH, 100), generator=gen, device=device)
        labels = torch.full((SERVE_BATCH,), 4, dtype=torch.long, device=device)
        want_c = _reference_generator_forward({k: v.to(device) for k, v in gen_sd.items()},
                                              z, labels, 9)[:CONVERT_N]
    c_err = float(np.abs(Xc - want_c.cpu().numpy().transpose(0, 2, 1)).max())
    print(f"[convert] converted 2 TimeGAN checkpoints and 1 conv generator in "
          f"{convert_s:.2f} s; served {run} {X.shape} in {wall * 1e3:.1f} ms: equal to the "
          f"port's TimeGAN loaded from the same state_dict: {np.array_equal(X, X_direct)}; "
          f"served no_exo {Xc.shape} in {wall_c * 1e3:.1f} ms: max|diff| against the "
          f"reference forward {c_err:.3e} (tol {CGAN_SERVE_TOL:g}); K1 launches {launches} "
          f"| {smi}", flush=True)
    if X.shape != (CONVERT_N, CONVERT_LEN, 14) or not np.array_equal(X, X_direct):
        fail("[convert] the converted TimeGAN does not serve what the model loaded from "
             "the same state_dict synthesizes")
    if Xc.shape != (CONVERT_N, SEQ_LEN, 14) or not c_err <= CGAN_SERVE_TOL:
        fail(f"[convert] the converted conv generator is off the reference forward: {c_err}")

    before = gru_sequence.launches
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        generate_long_synth_cli(["--runs_dir", str(conv), "--real_dir", str(root / "none"),
                                 "--gen_len", str(2 * SEQ_LEN), "--n", "8",
                                 "--time_chunk", str(SEQ_LEN), "--device", device])
    with np.load(conv / run / "synthetic_long.npz") as z_long:
        long = z_long["X"]
    launches += gru_sequence.launches - before
    if long.shape != (8, 2 * SEQ_LEN, 14) or not np.isfinite(long).all():
        fail(f"[convert] generate_long_synth on the converted run gave {long.shape}")

    rev, rev_cgan = root / "reverse", root / "reverse_cgan"
    convert_cli(["--reverse", "--runs_dir", str(conv), "--out_dir", str(rev),
                 "--which", "latest"])
    convert_cli(["--reverse", "--family", "cgan", "--runs_dir", str(conv_cgan),
                 "--out_dir", str(rev_cgan)])
    back = torch.load(rev / run / "ckpt_latest.pt", weights_only=True)
    back_g = torch.load(rev_cgan / "no_exo" / "CGAN_generator_no_exo_best.pth",
                        weights_only=True)
    renamed = {k.replace("u", "up", 1) if re.match(r"u\d\.", k) else
               "to_" + k if k.startswith("out.") else k: v for k, v in gen_sd.items()}
    renamed = {k.replace(".cbn.emb.", ".cbn.embed."): v for k, v in renamed.items()}
    same_tg = all(torch.equal(back["model"][k], v) for k, v in sd.items())
    same_g = sorted(back_g) == sorted(renamed) and all(
        torch.equal(back_g[k], v) for k, v in renamed.items() if "num_batches" not in k)
    print(f"[convert] --reverse: ckpt_latest.pt step {back['step']}, {len(back['model'])} "
          f"tensors, the original's bit for bit: {same_tg}; the generator's {len(back_g)} "
          f"tensors bit for bit: {same_g}; generate_long_synth {long.shape}", flush=True)
    if not (same_tg and same_g and back["step"] == 20):
        fail("[convert] --reverse does not give back the original tensors")
    return launches


@contextlib.contextmanager
def _stdout_to(path: Path, mode: str = "w"):
    """This process's standard output, and its children's, into ``path``
    (the stages' logs); on a failure inside, the log's tail is printed."""
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        with open(path, mode) as f:
            os.dup2(f.fileno(), 1)
            try:
                yield
            finally:
                sys.stdout.flush()
                os.dup2(saved, 1)
    except BaseException:
        print("".join(path.read_text().splitlines(keepends=True)[-40:]), flush=True)
        raise
    finally:
        os.close(saved)


def phase_pipeline(smi: str, root: Path, device: str = "cuda") -> None:
    """``python -m eegsynth_torch.pipeline`` in this process from a raw tree:
    all six stages, each a subprocess of the port's CLI on ``device``, at
    tiny depth (synthesis at the windows' own length, which the figures'
    pairs need); every manifest status ok; a second call skips all six.
    ``python -m eegsynth_torch.check_shape`` on a bucket and a synthetic
    file of the run."""
    raw, work = root / "pipe_raw", root / "pipe_work"
    write_raw_tree(raw, participants=PIPE_PARTICIPANTS, postures=PIPE_POSTURES,
                   seconds=PIPE_SECONDS)
    cfg = root / "pipe_config.json"
    cfg.write_text(json.dumps(PIPE_CONFIG))
    args = ["--raw_root", str(raw), "--work_dir", str(work), "--config", str(cfg),
            "--device", device, "--gen_len", str(SEQ_LEN), "--n", "8",
            "--stage-arg", "viz:--tsne_perplexity=5"]
    log = root / "pipeline.log"
    t0 = time.perf_counter()
    with _stdout_to(log):
        pipeline_cli(args)
    first_s = time.perf_counter() - t0
    manifest = json.loads((work / "pipeline_manifest.json").read_text())
    stages = {s: v["status"] for s, v in manifest["stages"].items()}
    t0 = time.perf_counter()
    with _stdout_to(log, "a"):
        pipeline_cli(args)
    again_s = time.perf_counter() - t0
    rerun = {s: v["status"] for s, v in
             json.loads((work / "pipeline_manifest.json").read_text())["stages"].items()}
    print(f"[pipeline] {len(stages)} stages in {first_s:.2f} s: "
          + ", ".join(f"{s} {v['status']} {v.get('seconds')} s"
                      for s, v in manifest["stages"].items())
          + f"; eval_global disc_acc {manifest.get('eval_global', {}).get('disc_acc')}; "
          f"the second call {again_s:.2f} s: {rerun} | {smi}", flush=True)
    order = ["preprocess", "train", "synth", "eval", "fatigue", "viz"]
    if list(stages) != order or set(stages.values()) != {"ok"}:
        fail(f"[pipeline] stages {stages}")
    if list(rerun) != order or set(rerun.values()) != {"skipped"}:
        fail(f"[pipeline] the second call did not skip every stage: {rerun}")
    files = [work / "preprocessed" / "posture1_no_exo.npz",
             work / "timegan_runs" / "posture1_no_exo" / "synthetic_long.npz"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check_shape_cli([str(f) for f in files])
    lines = out.getvalue().splitlines()
    print("[pipeline] check_shape: " + " | ".join(lines), flush=True)
    if f"  X: shape=(8, {SEQ_LEN}, 14) dtype=float32" not in lines:
        fail(f"[pipeline] check_shape printed {lines}")


def phase_bench_tools(smi: str, root: Path, device: str = "cuda") -> dict:
    """The three bench tools through their CLIs in this process:
    bench_synthesis --parity and one row of each model; bench_serve for
    BENCH_SERVE_SECONDS with 4 clients and the hung client against the
    port's server on two full-width TimeGAN runs, 0 errors; bench_kernels'
    default sweep and H 1024 (past the cluster forward's cap: the streaming
    forward), forward and backward. Returns the launches of K1 in the served
    run and of the wide route in bench_kernels.""" 
    for args in BENCH_SYNTH_RUNS:
        bench_synthesis.main(args + ["--device", device])
    runs, real = _write_runs(root / "bench_serve")
    reg = ModelRegistry(runs, real, device=device)
    srv = make_server(reg, "127.0.0.1", 0, SERVE_BATCH, TIME_CHUNK)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    gru_sequence.launches = 0
    try:
        with contextlib.redirect_stderr(io.StringIO()):   # the hung client's traceback
            out = bench_serve.main(["--port", str(srv.server_address[1]), "--clients", "4",
                                    "--seconds", str(BENCH_SERVE_SECONDS), "--n", "64",
                                    "--timegan-runs", "posture1_no_exo,posture2_with_exo"])
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    launches = gru_sequence.launches
    print(f"[bench-tools] bench_serve: {json.dumps(out)}; K1 launches {launches} | {smi}",
          flush=True)
    if out["errors"] != 0 or out["requests"] < 4:
        fail(f"[bench-tools] bench_serve: {out}")
    before = _wide_route_counts()
    for extra in ([], ["--backward"]):
        rows = bench_kernels.main(BENCH_KERNEL_ARGS + ["--device", device] + extra)
        print(f"[bench-tools] bench_kernels{' --backward' if extra else ''}: "
              f"{json.dumps(rows)} | {smi}", flush=True)
        if [r["H"] for r in rows] != BENCH_KERNEL_HS:
            fail(f"[bench-tools] bench_kernels rows {rows}")
    _, _, cluster, stream, wide_bwd = (a - b for a, b in zip(_wide_route_counts(), before))
    print(f"[bench-tools] bench_kernels launched the wide forward on clusters {cluster} "
          f"times, streaming {stream}, the wide backward {wide_bwd} | {smi}", flush=True)
    return {"gru_sequence": launches, "gru_sequence_wide_cluster": cluster,
            "gru_sequence_wide": stream, "gru_sequence_bwd_wide": wide_bwd}


def main() -> None:
    t_start = time.perf_counter()
    seconds = {}

    def timed(tag, phase, *args, **kw):
        t0 = time.perf_counter()
        out = phase(*args, **kw)
        seconds[tag] = round(time.perf_counter() - t0, 2)
        return out

    name, smi = phase_device()
    timed("build", phase_build)
    timed("sass", phase_sass)
    kern = timed("kernels", phase_kernels, smi)
    timed("t1", phase_t1, smi)
    timed("auto", phase_auto_rule, smi)
    serve_launches = timed("serve", phase_serve, smi, kern["gru_sequence"]["ms"])
    if serve_launches < 1:
        fail("the served run launched gru_sequence no time")
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = timed("train", phase_train, smi, Path(tmp))
        eval_launches = timed("eval", phase_eval, smi, Path(tmp))
        synth_launches = timed("synth-bf16", phase_synth_bf16, smi, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        seq_launches = timed("train-seq", phase_train_seq, smi, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        sweep_launches = timed("timegan-sweep", phase_timegan_sweep, smi, Path(tmp))
        profile_launches = timed("profile-dir", phase_profile_dir, smi, Path(tmp))
    tg_wide_launches = timed("timegan-wide", phase_timegan_wide, smi)
    with tempfile.TemporaryDirectory() as tmp:
        convert_launches = timed("convert", phase_convert, smi, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        bench_launches = timed("bench-tools", phase_bench_tools, smi, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        wide_launches = timed("train-wide", phase_train, smi, Path(tmp),
                              n_buckets=WIDE_BUCKETS, channels=WIDE_CHANNELS,
                              gan_steps=WIDE_GAN_STEPS)
    timed("check", phase_step_check, smi)
    timed("layers", phase_train_layers, smi)
    cgan_launches = timed("cgan-train", phase_cgan_train, smi)
    timed("cgan-check", phase_cgan_step_check, smi)
    cgan_serve_launches = timed("cgan-serve", phase_cgan_serve, smi)
    timed("cgan-layers", phase_cgan_layers, smi)
    wide_attn_launches = timed("cgan-wide", phase_cgan_wide, smi)
    timed("cgan-conv", phase_cgan_conv, smi)
    timed("cgan-multi", phase_cgan_multi, smi)
    timed("cgan-sweep", phase_cgan_sweep, smi)
    with tempfile.TemporaryDirectory() as tmp:
        iir_launches = timed("preprocess", phase_preprocess, smi, Path(tmp))
        timed("fatigue", phase_fatigue, smi, Path(tmp))
        figure_launches = timed("figures", phase_figures, smi, Path(tmp))
        timed("pipeline", phase_pipeline, smi, Path(tmp))
    runs = (train_launches, eval_launches, seq_launches, wide_launches,
            sweep_launches, profile_launches, tg_wide_launches, bench_launches)
    launches = {**cgan_launches, **wide_attn_launches,
                **{k: sum(r.get(k, 0) for r in runs)
                   for k in ("gru_sequence", "gru_sequence_bwd", "gru_sequence_wide_cluster",
                             "gru_sequence_wide", "gru_sequence_bwd_wide",
                             "multigru_disc_inputs")}}
    launches["gru_sequence"] += (serve_launches + synth_launches + figure_launches
                                 + convert_launches)
    launches["flash_forward"] = cgan_launches["flash_forward"] + cgan_serve_launches
    launches["iir_filter"] = iir_launches
    for k, n in launches.items():
        if n < 1:
            fail(f"the main paths launched {k} no time")
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s; seconds "
          f"by phase: {seconds}", flush=True)
    sources = {"gru_sequence": ("eegsynth_torch/csrc/gru_seq.cu",
                                "eegsynth/nn/pallas_gru.py:52"),
               "gru_sequence_bwd": ("eegsynth_torch/csrc/gru_seq.cu",
                                    "eegsynth/nn/pallas_gru.py:81"),
               "gru_sequence_wide_cluster": ("eegsynth_torch/csrc/gru_seq_cluster.cu",
                                             "eegsynth/nn/pallas_gru.py:52"),
               "gru_sequence_wide": ("eegsynth_torch/csrc/gru_seq_wide.cu",
                                     "eegsynth/nn/pallas_gru.py:52"),
               "gru_sequence_bwd_wide": ("eegsynth_torch/csrc/gru_seq_wide.cu",
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
                                  "eegsynth/nn/attention.py:248"),
               "iir_filter": ("eegsynth_torch/csrc/iir_filter.cu",
                              "eegsynth/ops/filtering.py:76")}
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
