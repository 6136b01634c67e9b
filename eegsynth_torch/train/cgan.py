"""CGAN training and generation, both reference flavours, both
architectures.

Counterpart of ``eegsynth/train/cgan.py``. ``arch="conv"`` (the default) is
the reference's own CGAN (``models/cgan.py``: an upsampling conv generator
with class-conditional BN, spectral-norm conv discriminators);
``arch="transformer"`` is the JAX package's extra
(``models/cgan_transformer.py``). The loop does not depend on the
architecture:

- v1: one model per condition, posture-conditional (9 classes), balanced
  posture sampling, hinge + ACGAN + R1 every ``r1_every`` steps +
  DiffAugment + feature matching + posture-conditional PSD/coherence/
  covariance losses, EMA, Adam for G and D, per-epoch ``metrics.csv``,
  checkpoints, best and last generators (:func:`train_one_condition`);
- v2: one model per posture, condition-conditional (2 classes), half and
  half condition sampling, the first 256 samples as the local crop, 24
  random coherence pairs, amplitude calibration, prewarm epochs in which G
  trains on structure, feature matching and amplitude only
  (:func:`train_one_posture`).

A step is :func:`cgan_step`: the D update, then the G update and the EMA,
as ``one_step`` of the JAX package. Randomness is passed in: every draw of
one step comes from :func:`draw_cgan_step` on a ``torch.Generator``, and the
parity tests feed the step JAX's own draws. Parameters and optimizer
moments are trees in the JAX layout, so checkpoints and tests map leaf for
leaf. The spectral-norm ``u`` vectors are state that advances along the
step: the fake pass of the D loss runs on the ``u`` of the real pass, the
advanced ``u`` is written back after the optimizer update, and the G step
advances it once more. The conv generator's batch-norm running statistics
advance in every generator pass in train mode: once in each of the
``d_steps`` D updates and once in the G step. Every generator file and
full-state checkpoint holds them (``"bn"``), and the best snapshot carries
the live statistics of its epoch, as the JAX package does (the reference
snapshots the stale initial buffers into its EMA copy).

``precision_d="bf16"`` runs the conv trunks of the D update's four
discriminator passes in bfloat16 by explicit casts, as the JAX package
does; the power iterations, the head, the losses, R1, the gradient penalty
and the G step stay float32, and every parameter and optimizer moment is
float32. The convolutions are cuDNN's on the card: the conv path launches
no hand kernel.

The transformer generator's attention runs through ``nn/attention.py``'s
``mha``: on the card, K3a in both forward passes and K3b / K3c in the G
step's backward when T/patch ≥ 512 or flash is forced
(``set_attention_impl("flash")``).
The discriminator pins dense attention: R1 (``autograd.grad`` with
``create_graph=True``) differentiates it twice.

Not ported: ``tf_remat`` raises ``NotImplementedError``; Orbax
checkpoints, ``async_ckpt``, ``mesh`` and multihost are on ROADMAP's
do-not-port list (NPZ is the only checkpoint format);
``epochs_per_dispatch`` is kept for config compatibility and changes
nothing; ``--amp-d`` is a no-op flag, as in the JAX package
(``--precision-d bf16`` is the control).

    python -m eegsynth_torch.train.cgan \\
        --data-dir ./preprocessed --save-root ./cgan_runs --condition no_exo \\
        --device cuda
    python -m eegsynth_torch.train.cgan generate --condition no_exo \\
        --data-dir ./preprocessed --save-root ./cgan_runs --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.convert import tree_to_numpy
from eegsynth_torch.data.datasets import (
    NUM_POSTURES, build_label_table, load_condition_dataset,
    load_posture_both_conditions,
)
from eegsynth_torch.losses.augment import AugmentDraws, diffaugment_1d, draw_augment
from eegsynth_torch.losses.gan import (
    amp_calib_loss, cross_entropy, d_bce, d_hinge, d_wgan, feature_matching,
    g_bce, g_hinge, g_wgan, gradient_penalty,
)
from eegsynth_torch.losses.spectral import (
    coh_loss_random, cov_loss, draw_coh_pairs, log_psd_loss,
    posture_conditional_losses, psd_loss,
)
from eegsynth_torch.models import cgan as _conv_model
from eegsynth_torch.models import cgan_transformer as _tf_model
from eegsynth_torch.models.cgan import DISC_CHANNELS, CGANConfig
from eegsynth_torch.models.cgan_transformer import TransformerCGANConfig
from eegsynth_torch.nn import precision
from eegsynth_torch.train import checkpoint as ckpt_io
from eegsynth_torch.train.optim import Adam, OptState
from eegsynth_torch.tree import tree_leaves, tree_map


# Both architectures share the apply contracts, so the loop below does not
# depend on the architecture.

def _model(cfg):
    return _tf_model if getattr(cfg, "arch", "conv") == "transformer" else _conv_model


def generator_init(cfg, generator: torch.Generator, *, device: torch.device | str):
    """(params, bn state) of ``cfg``'s generator; the transformer's state
    is empty."""
    return _model(cfg).generator_init(cfg, generator, device=device)


def generator_apply(G, bn, z, labels, cfg, train=True):
    return _model(cfg).generator_apply(G, bn, z, labels, cfg, train=train)


def disc_init(cfg, generator: torch.Generator, *, device: torch.device | str):
    return _model(cfg).disc_init(cfg, generator, device=device)


def disc_apply(params, x, labels, cfg, train=True, dropout_keep=None,
               compute_dtype=None):
    """(score, logits, features, params with advanced ``u``);
    ``compute_dtype`` reaches only the conv trunk (the transformer keeps
    float32, and its hparams refuse ``precision_d="bf16"``)."""
    return _model(cfg).disc_apply(params, x, labels, cfg, train, dropout_keep,
                                  compute_dtype=compute_dtype)


def disc_features(params, x, cfg, train=True):
    return _model(cfg).disc_features(params, x, train=train, cfg=cfg)


def feature_dim(cfg) -> int:
    """The width of the discriminator's pooled features (v2's keep masks)."""
    return cfg.dim if _model(cfg) is _tf_model else DISC_CHANNELS[-1]


@dataclasses.dataclass(frozen=True)
class CGANHParams:
    """v1 defaults; ``V2_OVERRIDES`` holds v2's. The fields and defaults are
    the JAX package's, except ``ckpt_format``: NPZ is the port's only
    format."""
    epochs: int = 800            # v2: 600
    prewarm: int = 0             # v2: 5
    batch_size: int = 64
    noise_dim: int = 100
    lr_g: float = 3e-4           # v2: 6e-4
    lr_d: float = 1e-4           # v2: 8e-5
    beta1: float = 0.5
    beta2: float = 0.999
    d_steps: int = 1
    proj_scale: float = 0.25     # v2: 0.10
    acgan_weight: float = 1.5    # v2: 1.25
    g_acgan_weight: float = 2.0  # v2: 1.5
    r1_gamma: float | None = None  # None → 0.5, or 0.0 for wgan-gp
    r1_every: int = 8
    inst_noise_start: float = 0.20
    inst_noise_end: float = 0.02  # v2: 0.06
    use_diffaugment: bool = True
    diffaugment_p: float = 0.25  # v2: 0.5
    psd_weight: float = 0.5      # v2: 0.3
    coh_weight: float = 0.25     # v2: 0.8
    cov_weight: float = 0.25     # v2: 0.3
    amp_weight: float = 0.0      # v2: 0.5
    coh_pairs: int = 24
    local_crop: int = 256
    fm_weight: float = 15.0      # v2: 50.0
    log_psd_weight: float = 0.0
    ema: bool = True
    ema_decay: float = 0.999
    lr_decay: float = 1.0
    lr_decay_step: int = 200
    save_every: int = 100
    print_every: int = 20
    epochs_per_dispatch: int = 25  # kept for config compatibility; unused
    ckpt_format: str = "npz"
    async_ckpt: bool | None = None
    seed: int = 42
    variant: str = "v1"          # "v1" | "v2"
    arch: str = "conv"           # "conv" (reference parity) | "transformer"
    gan_loss: str = "hinge"      # "hinge" | "bce" | "wgan-gp"
    gp_weight: float = 10.0      # wgan-gp only
    tf_dim: int = 256
    tf_depth: int = 4
    tf_heads: int = 4
    tf_patch: int = 8
    tf_remat: bool = False       # not ported yet
    precision_d: str = "f32"     # "bf16": the D update's conv trunks in bfloat16

    def __post_init__(self):
        if self.r1_gamma is None:
            object.__setattr__(self, "r1_gamma",
                               0.0 if self.gan_loss == "wgan-gp" else 0.5)
        if self.precision_d not in ("f32", "bf16"):
            raise ValueError(f"precision_d must be 'f32' or 'bf16', "
                             f"got {self.precision_d!r}")
        if self.precision_d == "bf16" and self.arch == "transformer":
            raise ValueError("precision_d='bf16' applies to the conv "
                             "discriminators only (the transformer D keeps "
                             "f32 LayerNorms)")


V2_OVERRIDES = dict(epochs=600, prewarm=5, lr_g=6e-4, lr_d=8e-5, proj_scale=0.10,
                    acgan_weight=1.25, g_acgan_weight=1.5, inst_noise_end=0.06,
                    diffaugment_p=0.5, psd_weight=0.3, coh_weight=0.8,
                    cov_weight=0.3, amp_weight=0.5, fm_weight=50.0, variant="v2")

METRICS_HEADER_V1 = ("epoch,g_loss,d_loss,d_g_real_acc,d_g_fake_acc,d_l_real_acc,"
                     "d_l_fake_acc,acgan_real_global,acgan_fake_global,"
                     "acgan_real_local,acgan_fake_local\n")
METRICS_HEADER_V2 = ("epoch,g_loss,d_loss,Dg_R,Dg_F,Dl_R,Dl_F,ACg_R,ACg_F,ACl_R,ACl_F\n")

_ADVERSARIAL = {"hinge": (d_hinge, g_hinge), "bce": (d_bce, g_bce),
                "wgan-gp": (d_wgan, g_wgan)}


def _adversarial(gan_loss: str):
    """(D loss, G loss) of ``gan_loss``."""
    if gan_loss not in _ADVERSARIAL:
        raise ValueError(f"gan_loss must be one of {sorted(_ADVERSARIAL)}, "
                         f"got {gan_loss!r}")
    return _ADVERSARIAL[gan_loss]


def sigma_at(hp: CGANHParams, total_epochs: int, e: int) -> float:
    """Linear instance-noise schedule over the epochs."""
    t = e / max(1, total_epochs - 1)
    return (1 - t) * hp.inst_noise_start + t * hp.inst_noise_end


def make_lr(hp: CGANHParams, updates_per_epoch: int, base: float,
            epoch_offset: int = 0):
    """StepLR stepped once per epoch, as a function of the optimizer's
    update count; ``epoch_offset`` counts epochs without updates (the v2
    prewarm skips D). A float when the rate does not decay."""
    if hp.lr_decay >= 1.0:
        return base
    return lambda count: base * hp.lr_decay ** (
        ((count // updates_per_epoch) + epoch_offset) // hp.lr_decay_step)


def generator_meta(hp: CGANHParams, num_classes: int, tag: str) -> dict:
    """Checkpoint meta that rebuilds the generator (:func:`load_generator`)."""
    meta = {"tag": tag, "variant": hp.variant, "num_classes": num_classes,
            "noise_dim": hp.noise_dim, "arch": hp.arch,
            "proj_scale": hp.proj_scale}
    if hp.arch == "transformer":
        meta.update(tf_dim=hp.tf_dim, tf_depth=hp.tf_depth,
                    tf_heads=hp.tf_heads, tf_patch=hp.tf_patch)
    return meta


def build_cfg(hp: CGANHParams, num_classes: int) -> CGANConfig:
    """The model configuration of ``hp``: the conv model, or the
    transformer for ``arch="transformer"``."""
    if hp.arch != "transformer":
        return CGANConfig(noise_dim=hp.noise_dim, num_classes=num_classes,
                          proj_scale=hp.proj_scale, variant=hp.variant)
    return TransformerCGANConfig(
        noise_dim=hp.noise_dim, num_classes=num_classes,
        proj_scale=hp.proj_scale, variant=hp.variant, dim=hp.tf_dim,
        depth=hp.tf_depth, heads=hp.tf_heads, patch=hp.tf_patch,
        remat=hp.tf_remat)


# ------------------------------------------------------------------
# One step's draws
# ------------------------------------------------------------------

@dataclasses.dataclass
class DDraws:
    """The draws of one D update (``kd = ks[0:12]`` of the JAX step)."""
    rows: torch.Tensor            # (B,) int64 dataset rows
    labels: torch.Tensor          # (B,) int64 classes 0..K-1
    z: torch.Tensor               # (B, noise) N(0, 1)
    noise_real: torch.Tensor      # (B, C, T) N(0, 1) instance noise
    noise_fake: torch.Tensor      # (B, C, T)
    aug_real: AugmentDraws | None  # None without DiffAugment
    aug_fake: AugmentDraws | None
    crop_real: torch.Tensor | None  # () int64 local-crop start (v1)
    crop_fake: torch.Tensor | None
    keep: list | None             # v2: 4 dropout keep masks (B, feature_dim)
    gp_eps: tuple | None          # wgan-gp: ε (B, 1, 1) global, local


@dataclasses.dataclass
class GDraws:
    """The draws of the G update (``ks[12..19]`` of the JAX step)."""
    rows: torch.Tensor
    labels: torch.Tensor
    z: torch.Tensor
    noise: torch.Tensor
    aug: AugmentDraws | None
    crop: torch.Tensor | None
    keep: list | None             # v2: 2 dropout keep masks
    pairs: torch.Tensor | None    # v2: (coh_pairs, 2) coherence pairs


@dataclasses.dataclass
class CGANDraws:
    d: list                       # d_steps DDraws; empty in prewarm epochs
    g: GDraws


def draws_to(draws, device: torch.device | str):
    """A copy of ``draws`` (any of the draw dataclasses, nested) with every
    tensor on ``device``: the same step's draws for another device."""
    if isinstance(draws, torch.Tensor):
        return draws.to(device)
    if dataclasses.is_dataclass(draws):
        return type(draws)(**{f.name: draws_to(getattr(draws, f.name), device)
                              for f in dataclasses.fields(draws)})
    if isinstance(draws, (list, tuple)):
        return type(draws)(draws_to(d, device) for d in draws)
    return draws


def sample_balanced(generator: torch.Generator, table: torch.Tensor,
                    counts: torch.Tensor, B: int, variant: str, *,
                    device: torch.device | str):
    """(rows (B,), labels (B,)): v1 draws each class uniformly, then a row
    ``floor(u · count)`` of the class's wrapped table row; v2 takes exactly
    half and half of the two classes, permuted."""
    kw = {"generator": generator, "device": device}
    if variant == "v1":
        labels = torch.randint(0, table.shape[0], (B,), **kw)
    else:
        half = torch.cat([torch.zeros(B // 2, dtype=torch.long, device=device),
                          torch.ones(B - B // 2, dtype=torch.long, device=device)])
        labels = half[torch.randperm(B, **kw)]
    u = torch.rand((B,), **kw)
    offs = torch.floor(u * counts[labels]).long()
    return table[labels, offs].long(), labels


def _crop_start(generator, hp: CGANHParams, T: int, device):
    L = min(hp.local_crop, T)
    if hp.variant == "v2" or T == L:
        return None
    return torch.randint(0, T - L + 1, (), generator=generator, device=device)


def crop(x: torch.Tensor, start: torch.Tensor | None, L: int) -> torch.Tensor:
    """The local discriminator's input: ``L`` samples from ``start``, or the
    first ``L`` when ``start`` is None (v2, or T == L)."""
    L = min(L, x.shape[2])
    if start is None:
        return x[:, :, :L]
    return x.index_select(2, start + torch.arange(L, device=x.device))


def draw_cgan_step(generator: torch.Generator, hp: CGANHParams,
                   cfg: CGANConfig, table: torch.Tensor, counts: torch.Tensor,
                   *, prewarm: bool, device: torch.device | str) -> CGANDraws:
    """Every random draw of one :func:`cgan_step`, from ``generator`` (which
    must live on ``device``)."""
    B, C, T = hp.batch_size, cfg.channels, cfg.seq_len
    kw = {"generator": generator, "device": device}
    v2 = hp.variant == "v2"

    def keeps(n):
        return ([torch.rand((B, feature_dim(cfg)), **kw) < 1.0 - cfg.dropout
                 for _ in range(n)]
                if v2 and cfg.dropout > 0 else None)

    def augment():
        return (draw_augment(generator, B, T, hp.diffaugment_p, device=device)
                if hp.use_diffaugment else None)

    d = []
    for _ in range(0 if prewarm else max(1, hp.d_steps)):
        rows, labels = sample_balanced(generator, table, counts, B, hp.variant,
                                       device=device)
        d.append(DDraws(
            rows=rows, labels=labels, z=torch.randn((B, hp.noise_dim), **kw),
            noise_real=torch.randn((B, C, T), **kw),
            noise_fake=torch.randn((B, C, T), **kw),
            aug_real=augment(), aug_fake=augment(),
            crop_real=_crop_start(generator, hp, T, device),
            crop_fake=_crop_start(generator, hp, T, device),
            keep=keeps(4),
            gp_eps=((torch.rand((B, 1, 1), **kw), torch.rand((B, 1, 1), **kw))
                    if hp.gan_loss == "wgan-gp" and hp.gp_weight > 0 else None)))
    rows, labels = sample_balanced(generator, table, counts, B, hp.variant,
                                   device=device)
    g = GDraws(rows=rows, labels=labels, z=torch.randn((B, hp.noise_dim), **kw),
               noise=torch.randn((B, C, T), **kw), aug=augment(),
               crop=_crop_start(generator, hp, T, device), keep=keeps(2),
               pairs=(draw_coh_pairs(generator, hp.coh_pairs, device=device)
                      if v2 else None))
    return CGANDraws(d=d, g=g)


# ------------------------------------------------------------------
# One step
# ------------------------------------------------------------------

def _trainable(tree, key=None):
    """Detached leaves that require grad, except the spectral-norm ``u``
    vectors (state, not weights: JAX keeps them out with stop_gradient)."""
    if isinstance(tree, dict):
        return {k: _trainable(v, k) for k, v in tree.items()}
    return tree.detach() if key == "u" else tree.detach().requires_grad_()


def _grads(loss: torch.Tensor, tree):
    """d loss / d leaf for every leaf; zeros where no gradient reaches it."""
    leaves = tree_leaves(tree)
    live = [t for t in leaves if t.requires_grad]
    got = dict(zip(map(id, live),
                   torch.autograd.grad(loss, live, allow_unused=True)))
    return tree_map(lambda t: g if (g := got.get(id(t))) is not None
                    else torch.zeros_like(t), tree)


def _copy_u(dst, src):
    """``dst`` with the ``u`` leaves of ``src`` (the advanced power-iteration
    vectors written back after an optimizer update)."""
    if isinstance(dst, dict):
        return {k: (src[k].detach() if k == "u" else _copy_u(v, src[k]))
                for k, v in dst.items()}
    return dst


def _r1_penalty(d_params, x_in, labels, cfg):
    """0.5 · mean_b ‖∂Σscore/∂x‖² in eval mode, differentiable in the
    discriminator's parameters."""
    x = x_in.detach().requires_grad_()
    score = disc_apply(d_params, x, labels, cfg, train=False)[0]
    (g,) = torch.autograd.grad(score.sum(), x, create_graph=True)
    return 0.5 * g.reshape(g.shape[0], -1).pow(2).sum(dim=1).mean()


def _d_update(G, bn, D, d_state, X, dd: DDraws, step_idx: int, sigma: float,
              cfg, hp: CGANHParams, optD: Adam):
    """One D update: (D, d_state, bn, loss, diagnostics). The generator's
    pass in train mode advances the bn statistics."""
    d_adv = _adversarial(hp.gan_loss)[0]
    # bfloat16 conv trunks in the four passes below only: R1 and the
    # gradient penalty stay float32
    d_cd = None if hp.precision_d == "f32" else precision.compute_dtype(hp.precision_d)
    labels = dd.labels
    real = X[dd.rows]
    with torch.no_grad():
        fake, bn = generator_apply(G, bn, dd.z, labels, cfg, train=True)
    real_in = torch.clamp(real + sigma * dd.noise_real, 0, 1)
    fake_in = torch.clamp(fake + sigma * dd.noise_fake, 0, 1)
    if hp.use_diffaugment:
        real_in = diffaugment_1d(real_in, dd.aug_real)
        fake_in = diffaugment_1d(fake_in, dd.aug_fake)
    real_loc = crop(real_in, dd.crop_real, hp.local_crop)
    fake_loc = crop(fake_in, dd.crop_fake, hp.local_crop)
    keep = dd.keep or [None] * 4

    Dr = _trainable(D)
    rs_g, rlog_g, _, Dg1 = disc_apply(Dr["dg"], real_in, labels, cfg, True, keep[0], d_cd)
    fs_g, flog_g, _, Dg2 = disc_apply(Dg1, fake_in, labels, cfg, True, keep[1], d_cd)
    rs_l, rlog_l, _, Dl1 = disc_apply(Dr["dl"], real_loc, labels, cfg, True, keep[2], d_cd)
    fs_l, flog_l, _, Dl2 = disc_apply(Dl1, fake_loc, labels, cfg, True, keep[3], d_cd)
    loss = (d_adv(rs_g, fs_g) + d_adv(rs_l, fs_l)
            + hp.acgan_weight * (cross_entropy(rlog_g, labels)
                                 + cross_entropy(rlog_l, labels)))
    if hp.gan_loss == "wgan-gp" and hp.gp_weight > 0:
        gp = (gradient_penalty(lambda xx: disc_apply(Dr["dg"], xx, labels, cfg,
                                                     train=False)[0],
                               dd.gp_eps[0], real_in, fake_in)
              + gradient_penalty(lambda xx: disc_apply(Dr["dl"], xx, labels, cfg,
                                                       train=False)[0],
                                 dd.gp_eps[1], real_loc, fake_loc))
        loss = loss + hp.gp_weight * gp
    if hp.r1_gamma > 0 and step_idx % max(1, hp.r1_every) == 0:
        loss = loss + hp.r1_gamma * (_r1_penalty(Dr["dg"], real_in, labels, cfg)
                                     + _r1_penalty(Dr["dl"], real_loc, labels, cfg))
    with torch.no_grad():
        diag = torch.stack([hit.float().mean() for hit in (
            rs_g > 0, fs_g < 0, rs_l > 0, fs_l < 0,
            rlog_g.argmax(1) == labels, flog_g.argmax(1) == labels,
            rlog_l.argmax(1) == labels, flog_l.argmax(1) == labels)])
    grads = _grads(loss, Dr)
    D_new, d_state = optD.update(grads, d_state, tree_map(torch.detach, D))
    return _copy_u(D_new, {"dg": Dg2, "dl": Dl2}), d_state, bn, loss.detach(), diag


def cgan_step(G, bn, D, ema, g_state: OptState, d_state: OptState,
              X: torch.Tensor, draws: CGANDraws, step_idx: int, sigma: float, *,
              cfg: CGANConfig, hp: CGANHParams, optG: Adam,
              optD: Adam, prewarm: bool, timer=None):
    """One training step: the D update(s), then the G update and the EMA.

    ``X`` (N, C, T) is the training set on the device, ``draws`` come from
    :func:`draw_cgan_step`, ``step_idx`` is the step's index within its epoch
    (R1 fires when ``step_idx % r1_every == 0``) and ``sigma`` the epoch's
    instance-noise std. Returns ``(G, bn, D, ema, g_state, d_state, logs)``
    with logs (10,): the eight D diagnostics (global/local real and fake
    accuracy, then the ACGAN accuracies), the G loss and the D loss. In a
    prewarm epoch D is not updated, the diagnostics and the D loss are 0 and
    the G loss has no adversarial term. ``bn`` advances in every D update
    and in the G step. ``timer``, if given, is called with a layer name
    after each layer."""
    mark = timer or (lambda name: None)
    device = X.device
    diag = torch.zeros((8,), device=device)
    d_loss = torch.zeros((), device=device)
    for dd in draws.d:
        D, d_state, bn, d_loss, diag = _d_update(G, bn, D, d_state, X, dd, step_idx,
                                                 sigma, cfg, hp, optD)
    mark("d_step")

    g_adv = _adversarial(hp.gan_loss)[1]
    gd = draws.g
    real_g, labels_g = X[gd.rows], gd.labels
    Gr = _trainable(G)
    fake2, bn_new = generator_apply(Gr, bn, gd.z, labels_g, cfg, train=True)
    fake2_in = torch.clamp(fake2 + sigma * gd.noise, 0, 1)
    if hp.use_diffaugment:
        fake2_in = diffaugment_1d(fake2_in, gd.aug)
    keep = gd.keep or [None, None]
    gs_g, glog_g, ffeat, Dg1 = disc_apply(D["dg"], fake2_in, labels_g, cfg, True, keep[0])
    fake2_loc = crop(fake2_in, gd.crop, hp.local_crop)
    gs_l, glog_l, _, Dl1 = disc_apply(D["dl"], fake2_loc, labels_g, cfg, True, keep[1])
    loss = torch.zeros((), device=device)
    if not prewarm:
        loss = (g_adv(gs_g) + g_adv(gs_l)
                + hp.g_acgan_weight * (cross_entropy(glog_g, labels_g)
                                       + cross_entropy(glog_l, labels_g)))
    rfeat, _ = disc_features(D["dg"], real_g, cfg, train=False)
    loss = loss + hp.fm_weight * feature_matching(ffeat, rfeat)
    if hp.variant == "v1":
        loss = loss + posture_conditional_losses(
            real_g, fake2, labels_g, cfg.num_classes, hp.psd_weight,
            hp.coh_weight, hp.cov_weight, hp.log_psd_weight)
    else:
        loss = loss + hp.psd_weight * psd_loss(real_g, fake2)
        loss = loss + hp.coh_weight * coh_loss_random(gd.pairs, real_g, fake2)
        loss = loss + hp.cov_weight * cov_loss(real_g, fake2)
        loss = loss + hp.amp_weight * amp_calib_loss(real_g, fake2)
        if hp.log_psd_weight > 0:
            loss = loss + hp.log_psd_weight * log_psd_loss(real_g, fake2)
    mark("g_forward")
    g_grads = _grads(loss, Gr)
    mark("g_backward")
    G, g_state = optG.update(g_grads, g_state, tree_map(torch.detach, G))
    D = _copy_u(D, {"dg": Dg1, "dl": Dl1})
    if hp.ema:
        ema = tree_map(lambda e, g: hp.ema_decay * e + (1.0 - hp.ema_decay) * g,
                       ema, G)
    mark("optimizers")
    logs = torch.cat([diag, torch.stack([loss.detach(), d_loss])])
    return G, bn_new, D, ema, g_state, d_state, logs


# ------------------------------------------------------------------
# Training loop
# ------------------------------------------------------------------

_INIT_G, _INIT_DG, _INIT_DL, _STEPS = range(4)   # seed streams


def _stream_seed(seed: int, stream: int, extra: int = 0) -> int:
    state = np.random.SeedSequence([seed, stream, extra]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def _load_like(template, tree, *, device, what: str):
    """``tree`` (numpy leaves from a checkpoint) in ``template``'s structure
    on ``device``; raises on a missing key or a shape that differs."""
    if isinstance(template, dict):
        missing = sorted(set(template) - set(tree))
        if missing:
            raise KeyError(f"{what}: checkpoint lacks {missing}")
        return {k: _load_like(template[k], tree[k], device=device, what=f"{what}.{k}")
                for k in template}
    arr = np.asarray(tree)
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"{what}: shape {arr.shape} in the checkpoint, "
                         f"{tuple(template.shape)} in the model")
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)


def _opt_state_like(params, tree, *, device, what: str) -> OptState:
    """An optax Adam state tree from a checkpoint (``[ScaleByAdamState,
    ...]``) as an :class:`OptState` whose moments follow ``params``."""
    adam = tree[0]
    return OptState(int(np.asarray(adam["count"])),
                    _load_like(params, adam["mu"], device=device, what=f"{what}.mu"),
                    _load_like(params, adam["nu"], device=device, what=f"{what}.nu"))


def _train_cgan(X_np: np.ndarray, y_np: np.ndarray, cfg: CGANConfig,
                hp: CGANHParams, save_dir: Path, tag: str, label_base: int, *,
                device: torch.device | str, resume: str = "", log=print) -> dict:
    """The training loop of both flavours: ``tag`` is the condition (v1) or
    ``posture{p}`` (v2)."""
    if hp.ckpt_format != "npz":
        raise ValueError(f"ckpt_format={hp.ckpt_format!r}: eegsynth_torch writes "
                         "NPZ checkpoints only")
    if hp.async_ckpt:
        raise ValueError("async_ckpt needs Orbax checkpoints, which eegsynth_torch "
                         "does not write")
    _adversarial(hp.gan_loss)
    device = torch.device(device)
    save_dir.mkdir(parents=True, exist_ok=True)
    with open(save_dir / "hparams.json", "w") as f:
        json.dump({**dataclasses.asdict(hp), "tag": tag}, f, indent=2)

    def init_gen(stream):
        return torch.Generator().manual_seed(_stream_seed(hp.seed, stream))

    G, bn = generator_init(cfg, init_gen(_INIT_G), device=device)
    D = {"dg": disc_init(cfg, init_gen(_INIT_DG), device=device),
         "dl": disc_init(cfg, init_gen(_INIT_DL), device=device)}
    ema = tree_map(torch.clone, G)
    steps = max(1, X_np.shape[0] // hp.batch_size)
    optG = Adam(make_lr(hp, steps, hp.lr_g), hp.beta1, hp.beta2)
    optD = Adam(make_lr(hp, steps * max(1, hp.d_steps), hp.lr_d,
                        epoch_offset=hp.prewarm), hp.beta1, hp.beta2)
    g_state, d_state = optG.init(G), optD.init(D)

    start_epoch, best_g = 0, float("inf")
    if resume:
        trees, meta = ckpt_io.load_checkpoint(resume)
        G = _load_like(G, trees["G"], device=device, what="G")
        bn = _load_like(bn, trees.get("bn", {}), device=device, what="bn")
        D = _load_like(D, trees["D"], device=device, what="D")
        ema = _load_like(G, trees["ema"], device=device, what="ema")
        g_state = _opt_state_like(G, trees["optG"], device=device, what="optG")
        d_state = _opt_state_like(D, trees["optD"], device=device, what="optD")
        start_epoch = int(meta.get("epoch", 0))
        best_g = float(meta.get("best_g", meta.get("g_loss", best_g)))
        log(f"[{tag}] Resumed from {resume} @ epoch {start_epoch}")
    # a fresh stream per start epoch: a resumed run does not replay the draws
    # of the epochs it skipped
    gen = torch.Generator(device=device).manual_seed(
        _stream_seed(hp.seed, _STEPS, start_epoch))

    table_np, counts_np = build_label_table(y_np, cfg.num_classes, label_base)
    X = torch.from_numpy(np.ascontiguousarray(X_np)).to(device)
    table = torch.from_numpy(table_np.astype(np.int64)).to(device)
    counts = torch.from_numpy(counts_np.astype(np.float32)).to(device)

    total_epochs = hp.prewarm + hp.epochs
    log(f"[{tag}] Training {total_epochs} epochs, steps/epoch ≈ {steps} | {device}")
    metrics_csv = save_dir / "metrics.csv"
    if not metrics_csv.exists():
        metrics_csv.write_text(METRICS_HEADER_V2 if hp.variant == "v2"
                               else METRICS_HEADER_V1)

    def save_generator(path, params, bn_state):
        ckpt_io.save_checkpoint(path, {"model": tree_to_numpy(params),
                                       "bn": tree_to_numpy(bn_state)},
                                generator_meta(hp, cfg.num_classes, tag))

    # the best snapshot holds the live bn statistics of its epoch
    best = {"G": ema if hp.ema else G, "bn": bn, "dg": D["dg"], "dl": D["dl"]}
    best_dirty = False

    def flush_best():
        nonlocal best_dirty
        if not best_dirty:
            return
        save_generator(save_dir / f"CGAN_generator_{tag}_best.npz", best["G"],
                       best["bn"])
        for which, key in (("globalD", "dg"), ("localD", "dl")):
            ckpt_io.save_checkpoint(save_dir / f"CGAN_{which}_{tag}_best.npz",
                                    {"model": tree_to_numpy(best[key])}, {"tag": tag})
        best_dirty = False

    t0 = time.perf_counter()
    epoch_seconds = []
    g_loss = d_loss = float("nan")
    for ep in range(start_epoch, total_epochs):
        t_ep = time.perf_counter()
        prewarm = ep < hp.prewarm
        sigma = sigma_at(hp, total_epochs, ep)
        logs = []
        for step_idx in range(steps):
            draws = draw_cgan_step(gen, hp, cfg, table, counts, prewarm=prewarm,
                                   device=device)
            G, bn, D, ema, g_state, d_state, lg = cgan_step(
                G, bn, D, ema, g_state, d_state, X, draws, step_idx, sigma,
                cfg=cfg, hp=hp, optG=optG, optD=optD, prewarm=prewarm)
            logs.append(lg)
        logs = torch.stack(logs).cpu().numpy()             # (steps, 10)
        epoch_seconds.append(time.perf_counter() - t_ep)
        diag = logs[:, :8].mean(axis=0)
        g_loss, d_loss = float(logs[-1, 8]), float(logs[-1, 9])
        if (ep + 1) % hp.print_every == 0 or ep == 0:
            log(f"[{tag}] Ep {ep + 1}/{total_epochs} | D={d_loss:.4f} G={g_loss:.4f} | "
                f"Dg(R/F)={diag[0]:.2f}/{diag[1]:.2f} Dl(R/F)={diag[2]:.2f}/{diag[3]:.2f} | "
                f"ACGAN G(R/F)={diag[4]:.2f}/{diag[5]:.2f} L(R/F)={diag[6]:.2f}/{diag[7]:.2f}")
        with open(metrics_csv, "a") as f:
            f.write(f"{ep + 1},{g_loss},{d_loss}," + ",".join(f"{v}" for v in diag) + "\n")
        # best on the last step's G loss, in adversarial epochs only
        if not prewarm and math.isfinite(g_loss) and g_loss < best_g:
            best_g, best_dirty = g_loss, True
            best = {"G": ema if hp.ema else G, "bn": bn, "dg": D["dg"], "dl": D["dl"]}

        done = ep + 1
        if done % hp.save_every == 0:
            opt_trees = {"optG": tree_to_numpy(optG.state_tree(g_state)),
                         "optD": tree_to_numpy(optD.state_tree(d_state))}
            ckpt_io.save_checkpoint(
                save_dir / f"checkpoint_epoch{done}.npz",
                {"G": tree_to_numpy(G), "bn": tree_to_numpy(bn), "D": tree_to_numpy(D),
                 "ema": tree_to_numpy(ema), **opt_trees},
                {"epoch": done, "g_loss": g_loss, "d_loss": d_loss,
                 "best_g": best_g, "tag": tag})
            save_generator(save_dir / f"CGAN_generator_{tag}_epoch{done}.npz", G, bn)
            flush_best()

    flush_best()
    save_generator(save_dir / f"CGAN_generator_{tag}_last.npz", ema if hp.ema else G, bn)
    dt = time.perf_counter() - t0
    sps = (total_epochs - start_epoch) * steps / dt if dt > 0 else float("nan")
    log(f"[{tag}] Done. Best G loss: {best_g:.4f} ({sps:.2f} steps/s)")
    return {"best_g": best_g, "steps_per_sec": sps, "epoch_seconds": epoch_seconds,
            "steps_per_epoch": steps, "G": G, "bn": bn, "ema": ema, "D": D,
            "g_state": g_state, "d_state": d_state, "cfg": cfg}


def train_one_condition(data_dir, save_root, condition: str, log=print,
                        resume: str = "", *, device: torch.device | str,
                        **hparams) -> dict:
    """v1: the posture-conditional model of one condition."""
    hp = CGANHParams(**{"variant": "v1", **hparams})
    cfg = build_cfg(hp, NUM_POSTURES)
    np.random.seed(hp.seed)
    X, y, meta = load_condition_dataset(data_dir, condition)
    res = _train_cgan(X, y, cfg, hp, Path(save_root) / condition, condition,
                      label_base=1, device=device, resume=resume, log=log)
    res["meta"] = meta
    return res


def train_one_posture(data_dir, runs_root, posture: int, log=print, *,
                      device: torch.device | str, **hparams) -> dict:
    """v2: the condition-conditional model of one posture."""
    hp = CGANHParams(**{**V2_OVERRIDES, **hparams, "variant": "v2"})
    cfg = build_cfg(hp, 2)
    np.random.seed(hp.seed)
    X, y, meta = load_posture_both_conditions(data_dir, posture)
    res = _train_cgan(X, y, cfg, hp, Path(runs_root) / f"posture{posture}",
                      f"posture{posture}", label_base=0, device=device, log=log)
    res["meta"] = meta
    return res


def load_generator(path, num_classes: int | None = None, variant: str = "v1", *,
                   device: torch.device | str):
    """Rebuild a saved generator from its meta: (params, bn, cfg, meta). A
    generator without an "arch" key, or with "conv", is the conv model, with
    its bn statistics."""
    meta = ckpt_io.load_meta(path)
    var = str(meta.get("variant", variant))
    arch = str(meta.get("arch", "conv"))
    hp = CGANHParams(
        noise_dim=int(meta.get("noise_dim", 100)), variant=var,
        proj_scale=float(meta.get("proj_scale", 0.10 if var == "v2" else 0.25)),
        arch=arch, tf_dim=int(meta.get("tf_dim", 256)),
        tf_depth=int(meta.get("tf_depth", 4)), tf_heads=int(meta.get("tf_heads", 4)),
        tf_patch=int(meta.get("tf_patch", 8)))
    cfg = build_cfg(hp, int(meta.get("num_classes", num_classes or NUM_POSTURES)))
    template, bn_t = generator_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    trees, _ = ckpt_io.load_checkpoint(path)
    return (_load_like(template, trees["model"], device=device, what="model"),
            _load_like(bn_t, trees.get("bn", {}), device=device, what="bn"), cfg, meta)


@torch.inference_mode()
def generate_batch(G, bn, cfg: CGANConfig, generator: torch.Generator,
                   n: int, label: int) -> torch.Tensor:
    """n samples (n, C, T) of one class from N(0, 1) noise drawn on
    ``generator`` (which must live on the parameters' device). The
    generator runs in eval mode (the conv model's BN on its running
    statistics), so each row depends on its own noise only."""
    device = tree_leaves(G)[0].device
    z = torch.randn((n, cfg.noise_dim), generator=generator, device=device)
    labels = torch.full((n,), label, dtype=torch.long, device=device)
    return generator_apply(G, bn, z, labels, cfg, train=False)[0]


# ------------------------------------------------------------------
# CLI (scripts/train_cgan.py's flags, plus --device)
# ------------------------------------------------------------------

HP_FLAGS = {
    "epochs": int, "batch_size": int, "noise_dim": int, "lr_g": float,
    "lr_d": float, "beta1": float, "beta2": float, "d_steps": int,
    "proj_scale": float, "acgan_weight": float, "g_acgan_weight": float,
    "r1_gamma": float, "r1_every": int, "inst_noise_start": float,
    "inst_noise_end": float, "diffaugment_p": float, "psd_weight": float,
    "coh_weight": float, "cov_weight": float, "amp_weight": float,
    "coh_pairs": int, "local_crop": int, "log_psd_weight": float,
    "fm_weight": float, "ema_decay": float, "lr_decay": float,
    "lr_decay_step": int, "save_every": int, "print_every": int,
    "epochs_per_dispatch": int, "seed": int,
    "arch": str, "tf_dim": int, "tf_depth": int, "tf_heads": int, "tf_patch": int,
    "ckpt_format": str, "precision_d": str,
}
"""The hyperparameter flags of ``scripts/train_cgan.py``, with their types."""


def _parse(argv):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter,
                                description="CGAN training, conv or transformer "
                                            "(the port of scripts/train_cgan.py)")
    sub = p.add_subparsers(dest="cmd", required=False)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--data-dir", type=str, default=None,
                   help="default: config data_dir key, else ./preprocessed")
    p.add_argument("--save-root", type=str, default=None,
                   help="default: config save_root key, else ./cgan_runs")
    p.add_argument("--condition", type=str, default="both",
                   choices=["both", "with_exo", "no_exo"])
    for k, typ in HP_FLAGS.items():
        p.add_argument(f"--{k.replace('_', '-')}", dest=k, type=typ, default=None)
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--no-diffaugment", action="store_true")
    p.add_argument("--ema", action="store_true", default=True,
                   help="EMA generator (always on; disable with --no-ema)")
    p.add_argument("--use-diffaugment", action="store_true", default=True,
                   help="DiffAugment-1D (always on; disable with --no-diffaugment)")
    p.add_argument("--loss", type=str, default=None,
                   choices=["hinge", "wgan-gp", "bce"],
                   help="default: config gan_loss key, else hinge")
    p.add_argument("--gp-weight", type=float, default=None,
                   help="gradient-penalty weight (wgan-gp only; default: config "
                        "gp_weight key, else 10.0)")
    p.add_argument("--amp-d", action="store_true", default=True,
                   help="kept for CLI parity; changes nothing")
    p.add_argument("--resume", type=str, default="",
                   help="an NPZ full-state checkpoint written by either package")
    p.add_argument("--async-ckpt", dest="async_ckpt",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="Orbax only: refused (NPZ checkpoints are synchronous)")
    p.add_argument("--mesh", action="store_true", help="not ported: refused")
    p.add_argument("--multihost", action="store_true", help="not ported: refused")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")

    g = sub.add_parser("generate", formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    g.add_argument("--data-dir", type=str, default="./preprocessed")
    g.add_argument("--save-root", type=str, default="./cgan_runs")
    g.add_argument("--condition", type=str, required=True, choices=["with_exo", "no_exo"])
    g.add_argument("--model-path", type=str, default="")
    g.add_argument("--noise-dim", type=int, default=100,
                   help="unused: noise_dim is read from the checkpoint meta")
    g.add_argument("--num-per-posture", type=int, default=100)
    g.add_argument("--inverse-scale", action="store_true")
    g.add_argument("--seed", type=int, default=123)
    g.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    return device


def generate_for_condition(args) -> Path:
    """Per-posture synthesis from the best generator, optional inverse
    scaling, the reference's NPZ contract. Returns the output directory."""
    device = _device(args.device)
    _, _, meta = load_condition_dataset(args.data_dir, args.condition)
    gpath = (Path(args.model_path) if args.model_path else
             Path(args.save_root) / args.condition /
             f"CGAN_generator_{args.condition}_best.npz")
    G, bn, cfg, _ = load_generator(gpath, num_classes=NUM_POSTURES, device=device)
    print(f"[{args.condition}] Loaded generator: {gpath}")
    out_dir = Path(args.save_root) / args.condition / f"generated_{int(time.time())}"
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for posture in range(1, NUM_POSTURES + 1):
        synth = generate_batch(G, bn, cfg, gen, args.num_per_posture,
                               posture - 1).cpu().numpy()
        minv = meta[posture]["scale_min"][None, :, None]
        rngv = meta[posture]["scale_range"][None, :, None]
        X_out = synth * rngv + minv if args.inverse_scale else synth
        fp = out_dir / f"synth_posture{posture}_{args.condition}.npz"
        np.savez_compressed(fp, X=X_out.transpose(0, 2, 1).astype(np.float32),
                            posture=np.int32(posture), condition=str(args.condition),
                            ch_names=np.array(meta[posture]["ch_names"], dtype=object),
                            fs=np.float32(meta[posture]["fs"]),
                            note="CGAN generation")
        print(f"[{args.condition}] Saved {args.num_per_posture} -> {fp}")
    print(f"[{args.condition}] Generation complete: {out_dir}")
    return out_dir


def main(argv: list[str] | None = None):
    args = _parse(argv)
    if args.cmd == "generate":
        return generate_for_condition(args)
    if args.mesh or args.multihost:
        raise SystemExit("--mesh / --multihost: eegsynth_torch trains on one card")
    cfg = {}
    if args.config:
        with open(args.config, encoding="utf-8") as f:
            cfg = json.load(f)
    hp = {}
    for k, typ in HP_FLAGS.items():
        flag = getattr(args, k)
        if flag is not None:
            hp[k] = flag
        elif k in cfg:
            hp[k] = typ(cfg[k])
    if args.no_ema:
        hp["ema"] = False
    if args.no_diffaugment:
        hp["use_diffaugment"] = False
    for k, typ, flag in (("gan_loss", str, args.loss),
                         ("gp_weight", float, args.gp_weight)):
        if flag is not None:
            hp[k] = flag
        elif k in cfg:
            hp[k] = typ(cfg[k])
    if args.async_ckpt is not None:
        hp["async_ckpt"] = args.async_ckpt
    device = _device(args.device)
    data_dir = args.data_dir or cfg.get("data_dir", "./preprocessed")
    save_root = args.save_root or cfg.get("save_root", "./cgan_runs")
    results = {}
    for cond in ("with_exo", "no_exo"):
        if args.condition in ("both", cond):
            results[cond] = train_one_condition(data_dir, save_root, cond,
                                                resume=args.resume, device=device, **hp)
    return results


if __name__ == "__main__":
    main()
