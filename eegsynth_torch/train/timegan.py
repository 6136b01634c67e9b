"""TimeGAN training steps and synthesis.

Counterpart of ``eegsynth/train/timegan.py``:

- :class:`TimeGANHParams`, the trainers' knobs with the same fields and
  defaults;
- :func:`pre_phase_step`, one autoencoder or supervisor step of the stacked
  multi-bucket trainer (``_make_pre_phase`` in
  ``eegsynth/train/timegan_multi.py``);
- :func:`gan_step`, one joint GAN step (``one_step`` of ``make_gan_chunk``) on
  the ``fused_step`` path that the multi-bucket trainer runs, for every
  stacked bucket at once;
- ``synthesize``: Z → decode(refine(gen(Z))).

Randomness is passed in: a step takes its batch and its noise as arguments
(:class:`GANDraws`); the trainer draws them from one ``torch.Generator`` per
bucket, and the parity tests from JAX's own key splits. Every loss and log is
per bucket, shape (nb,); gradients are taken of their sum, which keeps them
per bucket because no parameter is shared across buckets.

R1 is the direct penalty, ``autograd.grad(..., create_graph=True)`` through
the discriminator's plain recurrence: the ``_R1_FWD_OVER_REV=False`` branch
of the JAX package, with the same value and θ-gradient as its default
forward-over-reverse surrogate.

Only ``precision="f32"`` synthesis is ported; the JAX ``mesh`` option has no
counterpart on one card. The sequential trainer ``train_single_npz`` is not
ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from eegsynth_torch.losses.timegan import (
    acf_loss, add_instance_noise, bce, cov_loss, recon_loss, smooth_labels,
    sup_loss, throttle_scale,
)
from eegsynth_torch.models.timegan import (
    Carry, Params, TimeGAN, _fusable, cascade_init_carry, discriminate, encode,
    fused_disc_inputs, fused_gen_refine, fused_reconstruct, gen_refine_carry,
    reconstruct, refine_latent, sample_noise,
)
from eegsynth_torch.train.optim import Optimizer, OptState
from eegsynth_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class TimeGANHParams:
    """The trainers' knobs (train_timegan.py:281-303); defaults match the
    committed timegan_config.json and the JAX package's ``TimeGANHParams``.

    ``fused_step`` and ``pallas_multigru`` are kept for config compatibility
    and change nothing here: on the card the stacked trainer's D-step inputs
    run kernel K2 (single-layer stacks with projections, every
    ``adaptive_dims`` width; three K1 launches otherwise), and its G-step
    recurrences kernel K1. ``chunk`` (GAN
    steps per device dispatch in JAX) has no counterpart either: the port
    takes one step per call."""
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


def pre_phase_step(params: Params, opt: Optimizer, state: OptState,
                   x: torch.Tensor, which: str):
    """One autoencoder (``which="ae"``) or supervisor (``"sup"``) step for
    every stacked bucket on its batch x (nb, B, T, C): returns
    (params, state, loss (nb,)).

    AE: recon loss of embedder → recovery, Adam on both. SUP: the embedder's
    latents (no gradient) and the supervisor's next-step MSE, Adam on the
    supervisor."""
    if which == "ae":
        sub = _requires_grad({"embedder": params["embedder"],
                              "recovery": params["recovery"]})
        loss = recon_loss(x, reconstruct({**params, **sub}, x))
    elif which == "sup":
        with torch.no_grad():
            h = encode(params, x)
        sub = _requires_grad(params["supervisor"])
        h_pred = refine_latent({**params, "supervisor": sub}, h[:, :, :-1])
        loss = ((h_pred - h[:, :, 1:]) ** 2).mean(dim=(-3, -2, -1))
    else:
        raise ValueError(f"which must be 'ae' or 'sup', got {which!r}")
    new, state = opt.update(_grads(loss, sub), state, tree_map(torch.detach, sub))
    params = {**params, **new} if which == "ae" else {**params, "supervisor": new}
    return params, state, loss.detach()


@dataclasses.dataclass
class GANDraws:
    """The randomness of one GAN step, per bucket (``one_step``'s key splits
    at ``eegsynth/train/timegan.py:348``)."""
    idx: torch.Tensor       # (nb, B) int64 batch rows, drawn with replacement
    z: torch.Tensor         # (nb, B, T, z) U[0,1) noise of the D step
    eps_real: torch.Tensor  # (nb, B, T, z) N(0,1) instance noise on h_real
    eps_fake: torch.Tensor  # (nb, B, T, z) N(0,1) instance noise on h_fake
    u_real: torch.Tensor    # (nb, B, 1) U[0,1) label smoothing, real
    u_fake: torch.Tensor    # (nb, B, 1) U[0,1) label smoothing, fake
    z2: torch.Tensor        # (nb, B, T, z) U[0,1) noise of the G step
    eps_g: torch.Tensor     # (nb, B, T, z) N(0,1) instance noise on h_hat


def draw_batch_idx(generators: list[torch.Generator], n_valid: torch.Tensor,
                   B: int, *, device: torch.device | str) -> torch.Tensor:
    """(nb, B) batch rows ``floor(U · n_valid)``, drawn with replacement from
    each bucket's valid prefix by its own generator."""
    u = torch.stack([torch.rand(B, generator=g, device=device) for g in generators])
    idx = torch.floor(u * n_valid[:, None]).long()
    return torch.minimum(idx, (n_valid[:, None] - 1).long())


def draw_gan(generators: list[torch.Generator], n_valid: torch.Tensor, B: int,
             T: int, z_dim: int, *, device: torch.device | str) -> GANDraws:
    """One step's draws, each bucket from its own generator (which must live
    on ``device``)."""
    def per_bucket(fn):
        return torch.stack([fn(g) for g in generators])

    kw = {"device": device}
    shape = (B, T, z_dim)
    return GANDraws(
        idx=draw_batch_idx(generators, n_valid, B, device=device),
        z=per_bucket(lambda g: torch.rand(shape, generator=g, **kw)),
        eps_real=per_bucket(lambda g: torch.randn(shape, generator=g, **kw)),
        eps_fake=per_bucket(lambda g: torch.randn(shape, generator=g, **kw)),
        u_real=per_bucket(lambda g: torch.rand((B, 1), generator=g, **kw)),
        u_fake=per_bucket(lambda g: torch.rand((B, 1), generator=g, **kw)),
        z2=per_bucket(lambda g: torch.rand(shape, generator=g, **kw)),
        eps_g=per_bucket(lambda g: torch.randn(shape, generator=g, **kw)))


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
             timer=None):
    """One joint GAN step (D step, then G step) for every stacked bucket on
    its batch x (nb, B, T, C). Returns (params, d_state, g_state, logs
    (nb, 8)) with the log columns of ``LOG_COLUMNS``.

    D step: h_real, h_fake from kernel K2, or from three K1 launches for
    stacks without projections or of several layers (no gradient;
    ``fused_disc_inputs``),
    instance noise, smoothed BCE on ``d_real`` (the stored ``u``) and
    ``d_fake`` (the ``u`` ``d_real`` produced), R1 on the noisy real latents in eval mode with the
    pre-step ``u``, the accuracy throttle; the updated D keeps the ``u`` from
    after ``d_fake``. G step: the G→S→R cascade and E→R on K1, the D forward
    in train mode with the updated D (no gradient reaches D), which advances
    ``u`` once more, and that ``u`` is stored. ``timer``, if given, is called
    with a layer name after each layer (the smoke's breakdown)."""
    mark = timer or (lambda name: None)
    target_acc = 0.5 * (hp.d_min_acc + hp.d_max_acc)
    band = max(0.0, hp.d_max_acc - hp.d_min_acc)
    inst = instance_noise_std(hp, step)
    B = x.shape[1]

    # ---------------- D step ----------------
    h_real, h_fake = fused_disc_inputs(params, x, draws.z)
    mark("disc_inputs")
    h_real_n = add_instance_noise(h_real, draws.eps_real, inst)
    h_fake_n = add_instance_noise(h_fake, draws.eps_fake, inst)
    y_real, y_fake = smooth_labels(draws.u_real, draws.u_fake, hp.label_smooth)
    d0 = params["discriminator"]
    u0 = d0["fc"]["u"]
    d_rg = _requires_grad({"gru": d0["gru"], "fc": {k: d0["fc"][k] for k in ("w", "b")}})
    d_real, u1 = discriminate(d_rg, h_real_n, u0, train=True)
    d_fake, u2 = discriminate(d_rg, h_fake_n, u1, train=True)
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
    h_hat, x_hat = fused_gen_refine(p, draws.z2, with_decode=True)
    x_rec = fused_reconstruct(p, x)
    mark("g_forward")
    d_fake_g, u3 = discriminate(d_new, add_instance_noise(h_hat, draws.eps_g, inst),
                                u2, train=True)
    g_adv = bce(d_fake_g, torch.ones_like(d_fake_g))
    g_sup = sup_loss(h_hat)
    g_rec = recon_loss(x, x_rec)
    zero = torch.zeros_like(g_adv)
    g_cov = cov_loss(x_hat, x) if hp.gamma_cov > 0 else zero
    g_acf = acf_loss(x_hat, x, hp.acf_max_lag) if hp.gamma_acf > 0 else zero
    g_total = (g_adv + hp.alpha_sup * g_sup + hp.beta_rec * g_rec
               + hp.gamma_cov * g_cov + hp.gamma_acf * g_acf)
    mark("g_forward")
    g_grads = _grads(g_total, gser)
    mark("g_backward")
    gser, g_state = optG.update(g_grads, g_state, tree_map(torch.detach, gser))
    d_new["fc"]["u"] = u3.detach()
    mark("optimizers")

    logs = torch.stack([d_loss, d_acc, g_total, g_adv, g_sup, g_rec, g_cov,
                        g_acf], dim=-1).detach()
    return {**params, **gser, "discriminator": d_new}, d_state, g_state, logs


@torch.inference_mode()
def synthesize_from_noise(model: TimeGAN, z: torch.Tensor,
                          carry: Carry | None = None):
    """One dispatch of the synthesis cascade on given noise z (B, T, z_dim).

    Returns ``(x_hat (B, T, C), carry_out)``; ``carry=None`` starts from zero
    hidden states (the JAX ``_synth_run``), a carry continues a chunked run
    (``_synth_step``). Multi-layer stacks take the composed path, one-shot
    only, and return ``carry_out=None``."""
    if not _fusable(model):
        if carry is not None:
            raise ValueError("a carried state needs single-layer GRU stacks")
        return fused_gen_refine(model, z, with_decode=True)[1], None
    if carry is None:
        carry = cascade_init_carry(model, z.shape[0], device=z.device)
    carry, (_, x_hat) = gen_refine_carry(model, z, carry, with_decode=True)
    return x_hat, carry


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
    Multi-layer stacks run one-shot."""
    if precision != "f32":
        raise NotImplementedError(f"precision={precision!r}: only 'f32' "
                                  "synthesis is ported")
    device = next(model.parameters()).device
    z_dim = model.cfg.z_dim
    chunked = (time_chunk is not None and time_chunk < seq_len
               and _fusable(model))

    def run_batch(b: int) -> np.ndarray:
        if not chunked:
            z = sample_noise(generator, b, seq_len, z_dim, device=device)
            return synthesize_from_noise(model, z)[0].cpu().numpy()
        carry, pieces = None, []
        for t0 in range(0, seq_len, time_chunk):
            z = sample_noise(generator, b, time_chunk, z_dim, device=device)
            x, carry = synthesize_from_noise(model, z, carry)
            pieces.append(x[:, :min(time_chunk, seq_len - t0)].cpu().numpy())
        return np.concatenate(pieces, axis=1)

    if batch is None or batch >= n:
        return run_batch(n)
    return np.concatenate([run_batch(batch)[:min(batch, n - i)]
                           for i in range(0, n, batch)], axis=0)
