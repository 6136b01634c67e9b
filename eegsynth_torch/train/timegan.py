"""TimeGAN training: the sequential trainer, its steps, and synthesis.

Counterpart of ``eegsynth/train/timegan.py``:

- :class:`TimeGANHParams`, the trainers' knobs with the same fields and
  defaults;
- :func:`pre_phase_step`, one autoencoder or supervisor step, and
  :func:`ae_epoch` / :func:`sup_epoch`, one epoch of padded batches with
  per-sample weights (``make_ae_epoch`` / ``make_sup_epoch``);
- :func:`gan_step`, one joint GAN step (``one_step`` of ``make_gan_chunk``),
  for every stacked bucket at once;
- :func:`train_single_npz`, the sequential trainer of one bucket, and the
  CLI of ``scripts/train_timegan.py`` (:func:`main`; ``--parallel_buckets``
  runs ``timegan_multi.train_all_buckets``);
- ``synthesize``: Z → decode(refine(gen(Z))), in float32 or bfloat16.

Every step runs on stacked buckets (a leading axis ``nb``); the sequential
trainer is the stacked machinery at nb 1. Randomness is passed in: a step
takes its batch, noise and dropout masks as arguments (:class:`GANDraws`);
the trainers draw them from one ``torch.Generator`` per bucket, and the
parity tests from JAX's own key splits. Every loss and log is per bucket,
shape (nb,); gradients are taken of their sum, which keeps them per bucket
because no parameter is shared across buckets.

R1 is the direct penalty, ``autograd.grad(..., create_graph=True)`` through
the discriminator's plain recurrence: the ``_R1_FWD_OVER_REV=False`` branch
of the JAX package, with the same value and θ-gradient as its default
forward-over-reverse surrogate.

``profile_dir`` wraps the GAN phase, and only that phase, in a
``torch.profiler`` trace (:func:`gan_profile`), as the JAX trainers wrap it
in ``jax.profiler.trace``.

Not ported: ``mesh``, multihost and Orbax checkpoints.

    python -m eegsynth_torch.train.timegan --config configs/timegan_config.json \\
        --data_dir ./preprocessed --out_dir ./timegan_runs [--parallel_buckets]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from eegsynth_torch.convert import from_jax_params, restore_like, unstack_params
from eegsynth_torch.data.io import bucket_paths, load_bucket
from eegsynth_torch.losses.timegan import (
    acf_loss, add_instance_noise, bce, cov_loss, recon_loss, sample_mean,
    smooth_labels, sup_loss, throttle_scale,
)
from eegsynth_torch.models.timegan import (
    Carry, Params, TimeGAN, TimeGANConfig, _fusable, adaptive_dims,
    cascade_init_carry, decode, discriminate, encode, fused_disc_inputs,
    fused_gen_refine, gen_latent, gen_refine_carry, params_tree,
    reconstruct, refine_latent, sample_noise, split_masks, timegan_init_stacked,
)
from eegsynth_torch.nn.precision import cast_floating, compute_dtype
from eegsynth_torch.train import checkpoint as ckpt_io
from eegsynth_torch.train.optim import Optimizer, OptState, make_gan_opts
from eegsynth_torch.tree import take, tree_map


@dataclasses.dataclass(frozen=True)
class TimeGANHParams:
    """The trainers' knobs (train_timegan.py:281-303); defaults match the
    committed timegan_config.json and the JAX package's ``TimeGANHParams``.

    ``fused_step`` and ``pallas_multigru`` are kept for config compatibility
    and change nothing here: on the card the D-step inputs run kernel K2
    (single-layer stacks with projections, every ``adaptive_dims`` width,
    without live dropout; K1 launches otherwise), and the G-step
    recurrences kernel K1. ``chunk`` (GAN steps per device dispatch in JAX)
    keeps its host meaning in the sequential trainer, the cadence of log
    rows and checkpoint checks; the port takes one step per call. Dropout
    is live only for ``layers > 1`` (torch applies it between layers)."""
    batch_size: int = 64
    ae_epochs: int = 120
    sup_epochs: int = 150
    gan_steps: int = 8000
    lr_g: float = 1e-3
    lr_d: float = 3e-4
    beta1: float = 0.5
    beta2: float = 0.9
    alpha_sup: float = 3.0
    beta_rec: float = 0.15
    label_smooth: float = 0.2
    inst_noise_start: float = 0.25
    inst_noise_end: float = 0.05
    grad_clip: float = 0.5
    layers: int = 1
    dropout: float = 0.2
    seed: int = 42
    r1_gamma: float = 1.0
    d_min_acc: float = 0.45
    d_max_acc: float = 0.68
    gamma_cov: float = 0.03
    gamma_acf: float = 0.02
    acf_max_lag: int = 48
    chunk: int = 500
    fused_step: bool = False
    pallas_multigru: bool = False
    epoch_cycle: bool = False


GEN_NETS = ("generator", "supervisor", "embedder", "recovery")
LOG_COLUMNS = ("loss_D", "acc_D", "loss_G", "loss_adv", "loss_sup", "loss_rec",
               "loss_cov", "loss_acf")
TIMEGAN_G_WEIGHT_NAMES = ("alpha_sup", "beta_rec", "gamma_cov", "gamma_acf")
"""The G-loss weights a per-bucket (nb, 4) matrix may set, in this order."""

_INIT, _AE, _SUP, _GAN, _SYNTH = range(5)   # seed streams per bucket
_RESUME_TAG = 0x5EED0000                    # a resumed GAN phase's stream


def bucket_seed(seed: int, b: int, stream: int, *more: int) -> int:
    """A 63-bit seed for bucket ``b``'s ``stream`` (init, phases, synthesis),
    optionally refined by ``more`` (nonzero: numpy's SeedSequence gives a
    trailing 0 the seed of the shorter list)."""
    state = np.random.SeedSequence([seed, b, stream, *more]).generate_state(
        2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def bucket_generators(seed: int, nb: int, stream: int, device,
                      *more: int) -> list[torch.Generator]:
    """One generator per bucket for ``stream``, on ``device``."""
    return [torch.Generator(device=device).manual_seed(
        bucket_seed(seed, b, stream, *more)) for b in range(nb)]


def dropout_rate(hp: TimeGANHParams) -> float:
    """The live inter-layer dropout rate: ``hp.dropout`` for multi-layer
    stacks, else 0 (torch applies dropout between layers only; JAX
    ``_dropout_cfg``)."""
    return hp.dropout if hp.dropout > 0.0 and hp.layers > 1 else 0.0


def _requires_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(), tree)


def _grads(loss: torch.Tensor, tree):
    leaves = []
    tree_map(leaves.append, tree)            # tree_map's own leaf order
    grads = iter(torch.autograd.grad(loss.sum(), leaves))
    return tree_map(lambda _: next(grads), tree)


def gather_batch(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (nb, B) of each bucket of X (nb, N, T, C) → (nb, B, T, C)."""
    return X[torch.arange(X.shape[0], device=X.device)[:, None], idx]


def draw_masks(generators: list[torch.Generator], params: Params, stacks: tuple,
               B: int, rate: float, *,
               device: torch.device | str) -> list[torch.Tensor]:
    """Boolean keep-masks (nb, B, T, H), Bernoulli(1 − rate), one per layer
    boundary of each (network, T) of ``stacks`` in the order they run;
    bucket b's from ``generators[b]``."""
    out = []
    for net, T in stacks:
        for layer in params[net]["gru"][:-1]:
            shape = (B, T, layer["w_hh"].shape[-1])
            out.append(torch.stack([
                torch.rand(shape, generator=g, device=device) < 1.0 - rate
                for g in generators]))
    return out


def pre_phase_step(params: Params, opt: Optimizer, state: OptState,
                   x: torch.Tensor, which: str, w: torch.Tensor | None = None,
                   dropout: float = 0.0, masks: list | None = None):
    """One autoencoder (``which="ae"``) or supervisor (``"sup"``) step for
    every stacked bucket on its batch x (nb, B, T, C): returns
    (params, state, loss (nb,)).

    AE: recon loss of embedder → recovery, Adam on both. SUP: the embedder's
    latents (no gradient, but train mode: dropout stays live, as in torch)
    and the supervisor's next-step MSE on T − 1 steps, Adam on the
    supervisor. ``w`` (nb, B) weighs each sample (the padded rows of an
    epoch's last batch weigh 0); ``masks`` are the dropout masks of the
    embedder's layer boundaries, then the recovery's (AE) or the
    supervisor's (SUP). The stacked trainer passes neither."""
    if which == "ae":
        sub = _requires_grad({"embedder": params["embedder"],
                              "recovery": params["recovery"]})
        loss = recon_loss(x, reconstruct({**params, **sub}, x, dropout, masks),
                          weight=w)
    elif which == "sup":
        m_e, m_s = split_masks(masks, len(params["embedder"]["gru"]) - 1)
        with torch.no_grad():
            h = encode(params, x, dropout, m_e)
        sub = _requires_grad(params["supervisor"])
        h_pred = refine_latent({**params, "supervisor": sub}, h[:, :, :-1],
                               dropout, m_s)
        loss = sample_mean((h_pred - h[:, :, 1:]) ** 2, w)
    else:
        raise ValueError(f"which must be 'ae' or 'sup', got {which!r}")
    new, state = opt.update(_grads(loss, sub), state, tree_map(torch.detach, sub))
    params = {**params, **new} if which == "ae" else {**params, "supervisor": new}
    return params, state, loss.detach()


def padded_batches(generator: torch.Generator, n: int, B: int, *,
                   device: torch.device | str):
    """One shuffled epoch of ``n`` rows in fixed-size batches (JAX
    ``_padded_batches``, DataLoader(shuffle=True, drop_last=False)): a
    permutation padded with row 0 at weight 0, as (idx (n_batches, B) int64,
    w (n_batches, B) float32)."""
    n_batches = -(-n // B)
    pad = n_batches * B - n
    perm = torch.randperm(n, generator=generator, device=device)
    idx = torch.cat([perm, perm.new_zeros(pad)])
    w = torch.cat([torch.ones(n, device=device), torch.zeros(pad, device=device)])
    return idx.reshape(n_batches, B), w.reshape(n_batches, B)


def _epoch(which: str, params: Params, opt: Optimizer, state: OptState,
           X: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
           dropout: float, masks: list | None):
    total = 0.0
    for i in range(idx.shape[0]):
        params, state, loss = pre_phase_step(
            params, opt, state, gather_batch(X, idx[i]), which, w[i], dropout,
            None if masks is None else masks[i])
        total = total + loss * w[i].sum(dim=-1)
    return params, state, total / w.sum(dim=(0, 2))


def ae_epoch(params: Params, opt: Optimizer, state: OptState, X: torch.Tensor,
             idx: torch.Tensor, w: torch.Tensor, dropout: float = 0.0,
             masks: list | None = None):
    """One autoencoder epoch (``make_ae_epoch``): batch i of every bucket is
    rows ``idx[i]`` (nb, B) of X (nb, N, T, C), weighed by ``w[i]``, with
    dropout ``masks[i]`` (:func:`pre_phase_step`). Returns (params, state,
    epoch loss (nb,)): Σ_i loss_i · Σ w_i / n."""
    return _epoch("ae", params, opt, state, X, idx, w, dropout, masks)


def sup_epoch(params: Params, opt: Optimizer, state: OptState, X: torch.Tensor,
              idx: torch.Tensor, w: torch.Tensor, dropout: float = 0.0,
              masks: list | None = None):
    """One supervisor epoch (``make_sup_epoch``), as :func:`ae_epoch`."""
    return _epoch("sup", params, opt, state, X, idx, w, dropout, masks)


MASK_SITES = {"d_encode": ("embedder",), "d_gen": ("generator",),
              "d_refine": ("supervisor",), "d_real": ("discriminator",),
              "d_fake": ("discriminator",), "g_gen": ("generator",),
              "g_refine": ("supervisor",), "g_disc": ("discriminator",),
              "g_reconstruct": ("embedder", "recovery"),
              "g_decode": ("recovery",)}
"""The forwards of a GAN step that take dropout masks, in the order of JAX's
``dks`` (``eegsynth/train/timegan.py:349-353``), with the networks each
runs. JAX's ``dks[5]``, R1, runs the discriminator in eval mode: no mask."""


@dataclasses.dataclass
class GANDraws:
    """The randomness of one GAN step, per bucket (``one_step``'s key splits
    at ``eegsynth/train/timegan.py:348``)."""
    idx: torch.Tensor       # (nb, B) int64 batch rows
    z: torch.Tensor         # (nb, B, T, z) U[0,1) noise of the D step
    eps_real: torch.Tensor  # (nb, B, T, z) N(0,1) instance noise on h_real
    eps_fake: torch.Tensor  # (nb, B, T, z) N(0,1) instance noise on h_fake
    u_real: torch.Tensor    # (nb, B, 1) U[0,1) label smoothing, real
    u_fake: torch.Tensor    # (nb, B, 1) U[0,1) label smoothing, fake
    z2: torch.Tensor        # (nb, B, T, z) U[0,1) noise of the G step
    eps_g: torch.Tensor     # (nb, B, T, z) N(0,1) instance noise on h_hat
    masks: dict | None = None   # MASK_SITES → keep-masks; None: no dropout


def draw_batch_idx(generators: list[torch.Generator], n_valid: torch.Tensor,
                   B: int, *, device: torch.device | str) -> torch.Tensor:
    """(nb, B) batch rows ``floor(U · n_valid)``, drawn with replacement from
    each bucket's valid prefix by its own generator (the stacked trainer)."""
    u = torch.stack([torch.rand(B, generator=g, device=device) for g in generators])
    idx = torch.floor(u * n_valid[:, None]).long()
    return torch.minimum(idx, (n_valid[:, None] - 1).long())


def draw_perm_idx(generators: list[torch.Generator], n: int, B: int, *,
                  device: torch.device | str) -> torch.Tensor:
    """(nb, B) batch rows drawn without replacement, ``randperm(n)[:B]``
    (the sequential trainer, JAX ``:362-364``)."""
    return torch.stack([torch.randperm(n, generator=g, device=device)[:B]
                        for g in generators])


def epoch_cycle_next(perm: torch.Tensor | None, cursor: int, B: int, fresh):
    """One draw of the epoch-cycled loader (``hp.epoch_cycle``, JAX
    ``_epoch_cycle_next``): at cursor 0 a new epoch, ``perm = fresh()``; each
    step takes the next consecutive slice of B rows of ``perm`` (…, n),
    dropping the short tail. Returns (idx, perm, cursor)."""
    if cursor == 0:
        perm = fresh()
    steps_per_epoch = max(1, perm.shape[-1] // B)
    return (perm[..., cursor * B:(cursor + 1) * B], perm,
            (cursor + 1) % steps_per_epoch)


def draw_gan(generators: list[torch.Generator], n_valid: torch.Tensor | None,
             B: int, T: int, z_dim: int, *, device: torch.device | str,
             idx: torch.Tensor | None = None) -> GANDraws:
    """One step's draws, each bucket from its own generator (which must live
    on ``device``): the batch rows with replacement over ``n_valid``, unless
    the caller drew ``idx``, then the noise."""
    def per_bucket(fn):
        return torch.stack([fn(g) for g in generators])

    kw = {"device": device}
    shape = (B, T, z_dim)
    return GANDraws(
        idx=(draw_batch_idx(generators, n_valid, B, device=device)
             if idx is None else idx),
        z=per_bucket(lambda g: torch.rand(shape, generator=g, **kw)),
        eps_real=per_bucket(lambda g: torch.randn(shape, generator=g, **kw)),
        eps_fake=per_bucket(lambda g: torch.randn(shape, generator=g, **kw)),
        u_real=per_bucket(lambda g: torch.rand((B, 1), generator=g, **kw)),
        u_fake=per_bucket(lambda g: torch.rand((B, 1), generator=g, **kw)),
        z2=per_bucket(lambda g: torch.rand(shape, generator=g, **kw)),
        eps_g=per_bucket(lambda g: torch.randn(shape, generator=g, **kw)))


def draw_gan_masks(generators: list[torch.Generator], params: Params, B: int,
                   T: int, rate: float, *, device: torch.device | str) -> dict:
    """The dropout masks of one GAN step, site by site (:data:`MASK_SITES`),
    drawn after the step's other draws."""
    return {site: draw_masks(generators, params, tuple((net, T) for net in nets), B,
                             rate, device=device)
            for site, nets in MASK_SITES.items()}


def instance_noise_std(hp: TimeGANHParams, step: int) -> float:
    """max(end, start − (step−1)·decay) on the global 1-based step, in
    float32 as the JAX step computes it."""
    decay = (hp.inst_noise_start - hp.inst_noise_end) / max(1, hp.gan_steps)
    f32 = np.float32
    return float(max(f32(hp.inst_noise_end),
                     f32(hp.inst_noise_start) - f32(step - 1) * f32(decay)))


def gan_step(params: Params, optD: Optimizer, d_state: OptState,
             optG: Optimizer, g_state: OptState, x: torch.Tensor,
             draws: GANDraws, step: int, hp: TimeGANHParams,
             timer=None, weights: torch.Tensor | None = None):
    """One joint GAN step (D step, then G step) for every stacked bucket on
    its batch x (nb, B, T, C). Returns (params, d_state, g_state, logs
    (nb, 8)) with the log columns of ``LOG_COLUMNS``.

    D step: h_real, h_fake (no gradient) from ``fused_disc_inputs`` (kernel
    K2, or K1 launches for stacks without projections or of several
    layers), or, with dropout masks, from the composed networks, each with
    its masks (JAX's route when dropout is live); instance noise, smoothed
    BCE on ``d_real`` (the stored ``u``) and ``d_fake`` (the ``u``
    ``d_real`` produced), R1 on the noisy real latents in eval mode (no
    mask) with the pre-step ``u``, the accuracy throttle; the updated D
    keeps the ``u`` from after ``d_fake``. G step: the G→S→R cascade and
    E→R on K1 (3 + 2 launches a layer), each with its masks, the D forward in train mode with the updated D (no gradient
    reaches D), which advances ``u`` once more, and that ``u`` is stored.

    ``weights`` (nb, 4), in ``TIMEGAN_G_WEIGHT_NAMES`` order, replaces the
    hp's G-loss weights per bucket; the cov and ACF terms are then always
    computed (JAX ``with_weights``). Without it a term whose weight is 0
    logs 0. ``timer``, if given, is called with a layer name after each
    layer (the smoke's breakdown)."""
    mark = timer or (lambda name: None)
    target_acc = 0.5 * (hp.d_min_acc + hp.d_max_acc)
    band = max(0.0, hp.d_max_acc - hp.d_min_acc)
    inst = instance_noise_std(hp, step)
    rate = hp.dropout
    masks = draws.masks or {}

    # ---------------- D step ----------------
    if draws.masks is None:
        h_real, h_fake = fused_disc_inputs(params, x, draws.z)
    else:
        with torch.no_grad():
            h_real = encode(params, x, rate, masks["d_encode"])
            h_fake = refine_latent(
                params, gen_latent(params, draws.z, rate, masks["d_gen"]), rate,
                masks["d_refine"])
    mark("disc_inputs")
    h_real_n = add_instance_noise(h_real, draws.eps_real, inst)
    h_fake_n = add_instance_noise(h_fake, draws.eps_fake, inst)
    y_real, y_fake = smooth_labels(draws.u_real, draws.u_fake, hp.label_smooth)
    d0 = params["discriminator"]
    u0 = d0["fc"]["u"]
    d_rg = _requires_grad({"gru": d0["gru"], "fc": {k: d0["fc"][k] for k in ("w", "b")}})
    d_real, u1 = discriminate(d_rg, h_real_n, u0, True, rate, masks.get("d_real"))
    d_fake, u2 = discriminate(d_rg, h_fake_n, u1, True, rate, masks.get("d_fake"))
    d_loss = 0.5 * (bce(d_real, y_real) + bce(d_fake, y_fake))
    if hp.r1_gamma > 0.0:
        h = h_real_n.detach().requires_grad_()
        score, _ = discriminate(d_rg, h, u0, train=False)
        (grad_h,) = torch.autograd.grad(score.sum(), h, create_graph=True)
        r1 = grad_h.pow(2).sum(dim=(-2, -1)).mean(dim=-1)     # mean_b ||∇_h D||²
        d_loss = d_loss + 0.5 * hp.r1_gamma * r1
    with torch.no_grad():
        d_acc = 0.5 * ((d_real > 0.5).float().mean(dim=(-2, -1))
                       + (d_fake < 0.5).float().mean(dim=(-2, -1)))
    if band > 0:
        d_loss = d_loss * throttle_scale(d_acc, target_acc, band)
    grads = _grads(d_loss, d_rg)
    mark("discriminator")
    # optax's tree holds u too; it gets no gradient, and the step keeps u2
    d_tree = {"gru": d0["gru"], "fc": dict(d0["fc"])}
    grads["fc"]["u"] = torch.zeros_like(u0)
    d_new, d_state = optD.update(grads, d_state, d_tree)
    d_new["fc"]["u"] = u2
    mark("optimizers")

    # ---------------- G step ----------------
    gser = _requires_grad({k: params[k] for k in GEN_NETS})
    p = {**params, **gser}
    h_hat = refine_latent(p, gen_latent(p, draws.z2, rate, masks.get("g_gen")),
                          rate, masks.get("g_refine"))
    x_rec = reconstruct(p, x, rate, masks.get("g_reconstruct"))
    x_hat = decode(p, h_hat, rate, masks.get("g_decode"))
    mark("g_forward")
    d_fake_g, u3 = discriminate(d_new, add_instance_noise(h_hat, draws.eps_g, inst),
                                u2, True, rate, masks.get("g_disc"))
    g_adv = bce(d_fake_g, torch.ones_like(d_fake_g))
    g_sup = sup_loss(h_hat)
    g_rec = recon_loss(x, x_rec)
    zero = torch.zeros_like(g_adv)
    if weights is None:
        a_sup, b_rec, c_cov, c_acf = (hp.alpha_sup, hp.beta_rec, hp.gamma_cov,
                                      hp.gamma_acf)
        g_cov = cov_loss(x_hat, x) if hp.gamma_cov > 0 else zero
        g_acf = acf_loss(x_hat, x, hp.acf_max_lag) if hp.gamma_acf > 0 else zero
    else:
        a_sup, b_rec, c_cov, c_acf = weights.unbind(-1)
        g_cov, g_acf = cov_loss(x_hat, x), acf_loss(x_hat, x, hp.acf_max_lag)
    g_total = g_adv + a_sup * g_sup + b_rec * g_rec + c_cov * g_cov + c_acf * g_acf
    mark("g_forward")
    g_grads = _grads(g_total, gser)
    mark("g_backward")
    gser, g_state = optG.update(g_grads, g_state, tree_map(torch.detach, gser))
    d_new["fc"]["u"] = u3.detach()
    mark("optimizers")

    logs = torch.stack([d_loss, d_acc, g_total, g_adv, g_sup, g_rec, g_cov,
                        g_acf], dim=-1).detach()
    return {**params, **gser, "discriminator": d_new}, d_state, g_state, logs


@dataclasses.dataclass
class BestTracker:
    """Best-by-G-total per bucket, on the post-update parameters of every
    step (JAX ``one_step``'s exact per-step tracking)."""
    params: Params
    loss: torch.Tensor     # (nb,) float32, inf before the first step
    step: torch.Tensor     # (nb,) int64, 0 before the first step

    @classmethod
    def start(cls, params: Params) -> "BestTracker":
        nb = params["embedder"]["gru"][0]["w_hh"].shape[0]
        device = params["embedder"]["gru"][0]["w_hh"].device
        return cls(params, torch.full((nb,), float("inf"), device=device),
                   torch.zeros((nb,), dtype=torch.long, device=device))

    def update(self, params: Params, logs: torch.Tensor, step: int) -> None:
        is_best = logs[:, 2] < self.loss
        self.params = tree_map(
            lambda new, old: torch.where(
                is_best.view((-1,) + (1,) * (new.dim() - 1)), new, old),
            params, self.params)
        self.loss = torch.where(is_best, logs[:, 2], self.loss)
        self.step = torch.where(is_best, torch.full_like(self.step, step), self.step)


@torch.inference_mode()
def synthesize_from_noise(model: TimeGAN | Params, z: torch.Tensor,
                          carry: Carry | None = None):
    """One dispatch of the synthesis cascade on given noise z (B, T, z_dim).

    Returns ``(x_hat (B, T, C) float32, carry_out)``; ``carry=None`` starts
    from zero hidden states (the JAX ``_synth_run``), a carry continues a
    chunked run (``_synth_step``). ``model`` may be a params tree cast to
    bfloat16 (``nn.precision.cast_floating``) with z cast likewise: the
    cascade then computes in bfloat16 around K1's float32 recurrences, the
    carry stays float32 and x_hat returns in float32, as the JAX package's
    do. Multi-layer stacks take the composed path, one-shot only, and return
    ``carry_out=None``."""
    if not _fusable(model):
        if carry is not None:
            raise ValueError("a carried state needs single-layer GRU stacks")
        return fused_gen_refine(model, z, with_decode=True)[1].float(), None
    if carry is None:
        carry = cascade_init_carry(model, z.shape[0], device=z.device)
    carry, (_, x_hat) = gen_refine_carry(model, z, carry, with_decode=True)
    return x_hat.float(), carry


@torch.inference_mode()
def synthesize(model: TimeGAN, n: int, seq_len: int, *,
               generator: torch.Generator, batch: int | None = None,
               time_chunk: int | None = None,
               precision: str = "f32") -> np.ndarray:
    """``n`` windows of ``seq_len`` steps as a float32 numpy array (n, seq_len, C).

    Noise is U[0,1) drawn from ``generator``, which must live on the model's
    device. ``batch`` micro-batches n at one fixed shape: every micro-batch
    draws a full ``batch`` of noise and the last is sliced. ``time_chunk``
    streams the sequence axis with the GRU hidden states carried across
    fixed-(batch, time_chunk) dispatches; the last chunk draws a full
    ``time_chunk`` of noise, then slices. Chunk outputs land on the host, so
    device memory stays bounded at one chunk. The same generator state
    reproduces outputs only for identical (n, seq_len, batch, time_chunk).
    Multi-layer stacks run one-shot.

    ``precision="bf16"`` runs the cascade in bfloat16 (the JAX
    ``synthesize(precision="bf16")``): the model's weights are cast once per
    call, the noise is drawn in float32 and cast, the recurrences run in
    float32 on K1 (see :func:`synthesize_from_noise`), and the windows return
    in float32. An unknown precision raises ``ValueError``."""
    dtype = compute_dtype(precision)
    device = next(model.parameters()).device
    net = cast_floating(params_tree(model), dtype)     # no copy in float32
    z_dim = model.cfg.z_dim
    chunked = (time_chunk is not None and time_chunk < seq_len
               and _fusable(model))

    def noise(b: int, t: int) -> torch.Tensor:
        return sample_noise(generator, b, t, z_dim, device=device).to(dtype)

    def run_batch(b: int) -> np.ndarray:
        if not chunked:
            return synthesize_from_noise(net, noise(b, seq_len))[0].cpu().numpy()
        carry, pieces = None, []
        for t0 in range(0, seq_len, time_chunk):
            x, carry = synthesize_from_noise(net, noise(b, time_chunk), carry)
            pieces.append(x[:, :min(time_chunk, seq_len - t0)].cpu().numpy())
        return np.concatenate(pieces, axis=1)

    if batch is None or batch >= n:
        return run_batch(n)
    return np.concatenate([run_batch(batch)[:min(batch, n - i)]
                           for i in range(0, n, batch)], axis=0)


@contextlib.contextmanager
def gan_profile(profile_dir, name: str, device: torch.device):
    """A ``torch.profiler`` trace of the enclosed steps, with CPU activity
    and, on the card, CUDA activity, written as a Chrome trace to
    ``profile_dir/<name>_gan.trace.json``; nothing when ``profile_dir`` is
    None."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}_gan.trace.json"
    prof.export_chrome_trace(str(path))
    print(f"[profile] GAN phase trace: {path}", flush=True)


LOG_HEADER = "step,phase," + ",".join(LOG_COLUMNS) + "\n"
CKPT_EVERY = 500
"""``ckpt_latest`` is written whenever a multiple of this many GAN steps was
crossed (the reference's cadence, train_timegan.py:407), and at the end."""


def train_single_npz(npz_path, out_dir, *, device: torch.device | str,
                     log_every: int = 100, resume: bool = False,
                     ckpt_format: str = "npz", profile_dir=None,
                     **hparams) -> dict:
    """Train one TimeGAN on one (posture, condition) bucket NPZ (JAX
    ``train_single_npz``), the stacked machinery at nb 1.

    Phases: AE (``ae_epochs``) and SUP (``sup_epochs``) epochs of padded
    batches, each with a fresh optimizer; then ``gan_steps`` GAN steps at
    B = min(batch_size, N), batches drawn without replacement (or
    epoch-cycled). Every ``chunk`` steps the rows go to ``train_log.csv``
    (the JAX header, ``repr(float)`` values), ``ckpt_latest.npz`` is written
    when a multiple of 500 was crossed and at the end, ``ckpt_best.npz`` when
    the best step (by G total) advanced. Then ``synthetic.npz`` of N windows.

    ``resume`` continues from ``ckpt_latest.npz`` (skipping phases 1-2):
    model, both optimizers with their update counts, the step, and the best
    state from ``ckpt_best.npz``; the GAN stream is seeded from (seed, step),
    so the resumed run draws afresh; the log is appended to. Checkpoints are
    NPZ, readable by the JAX package; ``ckpt_format="orbax"`` raises.

    ``profile_dir`` writes a Chrome trace of the GAN phase there
    (``<npz stem>_gan.trace.json``, :func:`gan_profile`).

    Randomness: the weights and each phase's draws come from generators
    seeded from (seed, stream), bucket 0 of the stacked trainer's streams;
    they do not reproduce JAX's threefry streams."""
    if ckpt_format != "npz":
        raise ValueError(f"ckpt_format={ckpt_format!r}: eegsynth_torch writes "
                         "NPZ checkpoints only, the format both packages share")
    device = torch.device(device)
    npz_path, out_dir = Path(npz_path), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    hp = TimeGANHParams(**hparams)
    bucket = load_bucket(npz_path)
    N, T, C = bucket.X.shape
    z_dim, h_dim = adaptive_dims(C, T)
    cfg = TimeGANConfig(x_dim=C, z_dim=z_dim, h_dim=h_dim, num_layers=hp.layers,
                        dropout=hp.dropout)
    rate = dropout_rate(hp)
    log_file = out_dir / "train_log.csv"
    ckpt_latest = out_dir / "ckpt_latest.npz"
    if resume:
        ckpt_latest = ckpt_io.find_checkpoint(out_dir, "ckpt_latest") or ckpt_latest
    resuming = resume and ckpt_latest.exists()
    if not resuming:
        log_file.write_text(LOG_HEADER)
    print(f"==> {npz_path.name} | N={N} T={T} C={C}  z_dim={z_dim} h_dim={h_dim} "
          f"| {device}", flush=True)

    params = timegan_init_stacked(cfg, bucket_generators(hp.seed, 1, _INIT, "cpu"),
                                  device=device)
    X = torch.from_numpy(bucket.X).to(device)[None]          # (1, N, T, C)
    B = min(hp.batch_size, N)

    # Phases 1 + 2 (a resumed run restores their outcome instead); the
    # dropout masks of the stacks each runs, the supervisor on T - 1 steps
    phases = (("AE", _AE, ae_epoch, hp.ae_epochs, "recon",
               (("embedder", T), ("recovery", T))),
              ("SUP", _SUP, sup_epoch, hp.sup_epochs, "sup",
               (("embedder", T), ("supervisor", T - 1))))
    for tag, stream, epoch_fn, epochs, label, stacks in () if resuming else phases:
        opt = Optimizer(hp.lr_g, hp.grad_clip, hp.beta1, hp.beta2)
        state = opt.init({"embedder": params["embedder"], "recovery": params["recovery"]}
                         if tag == "AE" else params["supervisor"])
        gens = bucket_generators(hp.seed, 1, stream, device)
        for ep in range(1, epochs + 1):
            idx, w = padded_batches(gens[0], N, B, device=device)
            masks = None
            if rate > 0:
                masks = [draw_masks(gens, params, stacks, B, rate, device=device)
                         for _ in range(idx.shape[0])]
            params, state, loss = epoch_fn(params, opt, state, X, idx[:, None],
                                           w[:, None], rate, masks)
            print(f"[{tag}] epoch {ep}/{epochs}  {label}={loss.item():.5f}", flush=True)

    optD, optG = make_gan_opts(hp)
    d_state = optD.init(params["discriminator"])
    g_state = optG.init({k: params[k] for k in GEN_NETS})
    start_step = 0
    if resuming:
        trees, meta = ckpt_io.load_checkpoint(ckpt_latest)
        params = restore_like(params, trees["model"])
        g_state = optG.restore(trees["optG"], g_state)
        d_state = optD.restore(trees["optD"], d_state)
        start_step = int(meta.get("step", 0))
    best = BestTracker.start(params)
    if resuming:
        best_path = ckpt_io.find_checkpoint(out_dir, "ckpt_best")
        if best_path is not None:
            btrees, bmeta = ckpt_io.load_checkpoint(best_path)
            best.params = restore_like(params, btrees["model"])
            best.loss.fill_(float(bmeta.get("best_loss", np.inf)))
            best.step.fill_(int(bmeta.get("step", 0)))
        print(f"[resume] {npz_path.name} from step {start_step}", flush=True)
    gens = bucket_generators(hp.seed, 1, _GAN, device,
                             *((_RESUME_TAG + start_step,) if resuming else ()))
    meta = {"npz": npz_path.name, "z_dim": z_dim, "h_dim": h_dim, "x_dim": C,
            "layers": hp.layers, "fs": bucket.fs}

    def save(path, p, step, extra=None):
        """Bucket 0 of the stacked state as one model's checkpoint, the
        layout the JAX package's templates load."""
        ckpt_io.save_checkpoint(
            path, {"model": unstack_params(p, 0),
                   "optG": take(optG.state_tree(g_state), 0),
                   "optD": take(optD.state_tree(d_state), 0)},
            {**meta, "step": int(step), **(extra or {})})

    def fresh_perm():
        return torch.randperm(N, generator=gens[0], device=device)[None]

    step_seconds = []
    t_start = time.perf_counter()
    done = start_step
    last_saved_best = int(best.step[0]) if resuming else -1
    with gan_profile(profile_dir, npz_path.stem, device):
        while done < hp.gan_steps:
            n_steps = min(hp.chunk, hp.gan_steps - done)
            perm, cursor = None, 0             # the epoch cycle restarts every chunk
            rows = []
            for step in range(done + 1, done + n_steps + 1):
                t_step = time.perf_counter()
                if hp.epoch_cycle:
                    idx, perm, cursor = epoch_cycle_next(perm, cursor, B, fresh_perm)
                else:
                    idx = draw_perm_idx(gens, N, B, device=device)
                draws = draw_gan(gens, None, B, T, z_dim, device=device, idx=idx)
                if rate > 0:
                    draws.masks = draw_gan_masks(gens, params, B, T, rate, device=device)
                params, d_state, g_state, lg = gan_step(
                    params, optD, d_state, optG, g_state, gather_batch(X, idx), draws,
                    step, hp)
                best.update(params, lg, step)
                rows.append(lg[0])
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                step_seconds.append(time.perf_counter() - t_step)
            logs = torch.stack(rows).cpu().numpy()
            with open(log_file, "a") as f:
                for i, row in enumerate(logs):
                    s = done + i + 1
                    f.write(f"{s},GAN," + ",".join(repr(float(v)) for v in row) + "\n")
                    if s % log_every == 0:
                        print(f"[GAN] step {s}/{hp.gan_steps}  D:loss={row[0]:.4f} "
                              f"acc≈{row[1]:.2f}  G:total={row[2]:.4f} (adv={row[3]:.4f}, "
                              f"sup={row[4]:.4f}, rec={row[5]:.4f}, cov={row[6]:.4f}, "
                              f"acf={row[7]:.4f})", flush=True)
            done += n_steps
            if done // CKPT_EVERY > (done - n_steps) // CKPT_EVERY or done == hp.gan_steps:
                save(out_dir / "ckpt_latest.npz", params, done)
            best_step = int(best.step[0])
            if best_step != last_saved_best:
                save(out_dir / "ckpt_best.npz", best.params, best_step,
                     {"best": True, "best_loss": float(best.loss[0])})
                last_saved_best = best_step
    gan_seconds = time.perf_counter() - t_start
    steps_per_sec = ((hp.gan_steps - start_step) / gan_seconds
                     if gan_seconds > 0 else float("nan"))
    print(f"[GAN] {hp.gan_steps} steps in {gan_seconds:.1f}s → {steps_per_sec:.2f} "
          "steps/s", flush=True)

    gen = torch.Generator(device=device).manual_seed(bucket_seed(hp.seed, 0, _SYNTH))
    X_hat = synthesize(from_jax_params(unstack_params(params, 0), device=device).eval(),
                       N, T, generator=gen)
    np.savez_compressed(out_dir / "synthetic.npz", X=X_hat.astype(np.float32))
    print(f"Saved synthetic: {out_dir / 'synthetic.npz'}", flush=True)
    return {"steps_per_sec": steps_per_sec, "gan_seconds": gan_seconds,
            "gan_step_seconds": step_seconds, "best_step": int(best.step[0]),
            "best_loss": float(best.loss[0])}


CONFIG_KEYS = {
    "batch_size": int, "ae_epochs": int, "sup_epochs": int, "gan_steps": int,
    "lr_g": float, "lr_d": float, "beta1": float, "beta2": float,
    "alpha_sup": float, "beta_rec": float, "label_smooth": float,
    "inst_noise_start": float, "inst_noise_end": float, "grad_clip": float,
    "layers": int, "dropout": float, "seed": int, "r1_gamma": float,
    "d_min_acc": float, "d_max_acc": float, "gamma_cov": float,
    "gamma_acf": float, "acf_max_lag": int, "chunk": int,
}
"""The config keys of ``scripts/train_timegan.py``, with their types."""

_REFUSED = {
    "mesh": "one card: the batch is not sharded",
    "multihost": "one card, one process",
    "async_ckpt": "checkpoints are NPZ, written synchronously",
    "dispatch_budget": "a guard for the remote TPU runtime's dispatch watchdog",
    "max_stack": "a guard for the remote TPU runtime's dispatch watchdog",
}
"""Flags of ``scripts/train_timegan.py`` with no counterpart here, and why."""


def main(argv: list[str] | None = None):
    """The CLI of ``scripts/train_timegan.py``: ``train_single_npz`` per
    bucket into ``out_dir/<stem>``, or with ``--parallel_buckets`` every
    bucket stacked (``timegan_multi.train_all_buckets``). Returns the
    trainer's result (per bucket name for the sequential trainer)."""
    ap = argparse.ArgumentParser(
        description="TimeGAN training, one model per (posture, condition) "
                    "bucket NPZ (the port of scripts/train_timegan.py)")
    ap.add_argument("--config", type=str, default=None,
                    help="JSON config, the schema of configs/timegan_config.json")
    ap.add_argument("--data_dir", type=str, default=None)
    ap.add_argument("--out_dir", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--log_every", type=int, default=100)
    ap.add_argument("--parallel_buckets", action="store_true",
                    help="train every bucket at once, stacked")
    ap.add_argument("--resume", action="store_true",
                    help="sequential: continue each run from its "
                         "ckpt_latest.npz; stacked: from out_dir/_multi_state.npz")
    ap.add_argument("--epoch_cycle", action="store_true",
                    help="sequential only: epoch-cycled GAN batches")
    ap.add_argument("--bucket_weights", type=str, default=None,
                    help="stacked only: per-bucket G-loss weights, inline JSON "
                         'or a JSON file: {"<bucket>": {"gamma_acf": 0.1}}')
    ap.add_argument("--ckpt_every", type=int, default=None,
                    help="stacked only: save the stacked state to "
                         "out_dir/_multi_state.npz every this many GAN steps")
    ap.add_argument("--ckpt_format", choices=("npz", "orbax"), default=None,
                    help="sequential only; npz is the only format written")
    ap.add_argument("--fused_step", action="store_true", default=None,
                    help="accepted; changes nothing here")
    ap.add_argument("--no_fused_step", action="store_true",
                    help="accepted; changes nothing here")
    ap.add_argument("--pallas_multigru", action="store_true",
                    help="accepted; changes nothing here")
    ap.add_argument("--mesh", action="store_true", help="refused")
    ap.add_argument("--multihost", action="store_true", help="refused")
    ap.add_argument("--async_ckpt", action=argparse.BooleanOptionalAction,
                    default=None, help="refused")
    ap.add_argument("--dispatch_budget", type=int, default=None, help="refused")
    ap.add_argument("--max_stack", type=int, default=None, help="refused")
    ap.add_argument("--profile_dir", type=str, default=None,
                    help="write a torch.profiler Chrome trace of the GAN phase here")
    for k, typ in CONFIG_KEYS.items():
        ap.add_argument(f"--{k}", type=typ, default=None)
    args = ap.parse_args(argv)

    for flag, why in _REFUSED.items():
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f"--{flag} has no counterpart in eegsynth_torch: {why}")
    if args.ckpt_format == "orbax":
        raise SystemExit("--ckpt_format orbax has no counterpart in eegsynth_torch: "
                         "checkpoints are NPZ, the format both packages share")
    cfg = {}
    if args.config:
        with open(args.config, encoding="utf-8") as f:
            cfg = json.load(f)
    data_dir = Path(args.data_dir or cfg.get("data_dir", "./preprocessed"))
    out_root = Path(args.out_dir or cfg.get("out_dir", "./timegan_runs"))
    hp = {k: typ(getattr(args, k) if getattr(args, k) is not None else cfg[k])
          for k, typ in CONFIG_KEYS.items()
          if getattr(args, k) is not None or k in cfg}
    if args.no_fused_step:
        hp["fused_step"] = False
    elif args.fused_step:
        hp["fused_step"] = True
    if args.pallas_multigru:
        hp["pallas_multigru"] = True
    if args.epoch_cycle:
        hp["epoch_cycle"] = True
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    files = bucket_paths(data_dir)
    if not files:
        raise SystemExit(f"No NPZs found in {data_dir}. Run preprocessing first.")
    out_root.mkdir(parents=True, exist_ok=True)
    print(f"Found {len(files)} datasets → training {len(files)} models on {device}.",
          flush=True)

    if args.parallel_buckets:
        if args.ckpt_format is not None:
            raise SystemExit("--ckpt_format applies to the sequential trainer only "
                             "(the stacked trainer writes NPZ at run end)")
        bucket_weights = None
        if args.bucket_weights:
            bw = args.bucket_weights
            if Path(bw).is_file():
                with open(bw, encoding="utf-8") as f:
                    bucket_weights = json.load(f)
            else:
                bucket_weights = json.loads(bw)
            bucket_weights = {k: v for k, v in bucket_weights.items()
                              if not k.startswith("_")}        # "_comment" keys
        from eegsynth_torch.train.timegan_multi import train_all_buckets
        res = train_all_buckets(data_dir, out_root, device=device,
                                log_every=args.log_every,
                                bucket_weights=bucket_weights,
                                ckpt_every=args.ckpt_every, resume=args.resume,
                                profile_dir=args.profile_dir, **hp)
        print(f"\nAggregate: {res['aggregate_steps_per_sec']:.1f} GAN steps/s "
              f"across {res['n_buckets']} buckets ({res['total_seconds']:.1f}s total)")
    else:
        for flag in ("bucket_weights", "ckpt_every"):
            if getattr(args, flag) is not None:
                raise SystemExit(f"--{flag} requires --parallel_buckets (the "
                                 "sequential trainer takes plain --alpha_sup / "
                                 "--beta_rec / --gamma_cov / --gamma_acf per run "
                                 "and saves ckpt_latest.npz every 500 steps)")
        res = {}
        for fp in files:
            run_dir = out_root / fp.stem
            print(f"\n=== Training {fp.name} → {run_dir} ===", flush=True)
            res[fp.stem] = train_single_npz(fp, run_dir, device=device,
                                            log_every=args.log_every,
                                            resume=args.resume,
                                            profile_dir=args.profile_dir, **hp)
    print("\nAll models trained. Checkpoints, logs, and synthetic data are under:",
          out_root, flush=True)
    return res


if __name__ == "__main__":
    main()
