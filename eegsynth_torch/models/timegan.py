"""TimeGAN: embedder / recovery / generator / supervisor / discriminator.

Counterpart of ``eegsynth/models/timegan.py``, in two forms that share one
set of functions:

- ``TimeGAN``, ``nn.Module``s whose parameter names are the reference torch
  state_dict's (``generator.rnn.rnn.weight_ih_l0``, ``recovery.out.weight``,
  ``discriminator.fc.weight_orig`` / ``weight_u``, …): one model, what the
  serving path loads;
- a params tree in the JAX package's layout (``p["generator"]["gru"][0]
  ["w_hh"]``, ``p["discriminator"]["fc"]["u"]``, ``proj`` ``None`` when
  h_dim == z_dim), every leaf stacked over a leading bucket axis ``nb``: the
  multi-bucket trainer's models, the counterpart of ``jax.vmap`` over buckets
  (:func:`timegan_init_stacked`). :func:`params_tree` gives a module's live
  parameters in the same layout, so every function below takes either.

- Embedder      X (…,B,T,C) → H (…,B,T,z)   GRU(x_dim→z_dim)
- Recovery      H           → X̃ (…,B,T,C)   GRU(z_dim→h_dim) + Linear(h_dim→x_dim)
- Generator     Z (…,B,T,z) → Ê             GRU(z_dim→h_dim) + Linear(h_dim→z_dim)
- Supervisor    Ê           → Ĥ             same shape as Generator
- Discriminator H           → p(real)       GRU(z_dim→h_dim), last step,
                                            spectral-norm Linear → sigmoid

Every recurrence but the discriminator's runs kernel K1 (forward and backward)
on the card; the D-step inputs of the stacked trainer run kernel K2 for
single-layer stacks with projections, else three K1 forward launches
(:func:`fused_disc_inputs`); the discriminator runs the plain recurrence,
which R1 differentiates twice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from eegsynth_torch.nn.gru import (
    GRULayer, GRUStack, gru_apply_time_major, gru_recurrence,
)
from eegsynth_torch.nn.layers import Dense, linear
from eegsynth_torch.nn.gru_sequence import MAX_HIDDEN
from eegsynth_torch.nn.multigru import multigru_disc_inputs
from eegsynth_torch.nn.spectral_norm import SNDense, sn_dense_apply

Carry = tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TimeGANConfig:
    x_dim: int = 14
    z_dim: int = 28
    h_dim: int = 56
    num_layers: int = 1
    dropout: float = 0.2


def adaptive_dims(x_dim: int, seq_len: int) -> tuple[int, int]:
    """z=clip(2C,16,64), h=clip(4C,32,128); +8/+16 if T>800 (C=14 → z=28, h=56)."""
    z = max(16, min(64, x_dim * 2))
    h = max(32, min(128, x_dim * 4))
    if seq_len > 800:
        z = min(64, z + 8)
        h = min(128, h + 16)
    return z, h


class Embedder(nn.Module):
    def __init__(self, cfg: TimeGANConfig, **kw):
        super().__init__()
        self.rnn = GRUStack(cfg.x_dim, cfg.z_dim, cfg.num_layers, **kw)


class Recovery(nn.Module):
    def __init__(self, cfg: TimeGANConfig, **kw):
        super().__init__()
        self.rnn = GRUStack(cfg.z_dim, cfg.h_dim, cfg.num_layers, **kw)
        self.out = Dense(cfg.h_dim, cfg.x_dim, **kw)


class RNNProj(nn.Module):
    """Generator / supervisor: GRU(z→h) then Linear(h→z), or Identity when
    h_dim == z_dim (as the reference)."""

    def __init__(self, cfg: TimeGANConfig, **kw):
        super().__init__()
        self.rnn = GRUStack(cfg.z_dim, cfg.h_dim, cfg.num_layers, **kw)
        self.proj = (nn.Identity() if cfg.h_dim == cfg.z_dim
                     else Dense(cfg.h_dim, cfg.z_dim, **kw))


class Discriminator(nn.Module):
    def __init__(self, cfg: TimeGANConfig, **kw):
        super().__init__()
        self.rnn = GRUStack(cfg.z_dim, cfg.h_dim, cfg.num_layers, **kw)
        self.fc = SNDense(cfg.h_dim, 1, **kw)


class TimeGAN(nn.Module):
    """The five networks. Weights are drawn on the host from ``generator`` and
    moved to ``device``."""

    def __init__(self, cfg: TimeGANConfig, *, generator: torch.Generator,
                 device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        kw = {"generator": generator, "device": device}
        self.embedder = Embedder(cfg, **kw)
        self.recovery = Recovery(cfg, **kw)
        self.generator = RNNProj(cfg, **kw)
        self.supervisor = RNNProj(cfg, **kw)
        self.discriminator = Discriminator(cfg, **kw)


def params_tree(model: TimeGAN) -> Params:
    """The module's live parameters (and ``u`` buffer) in the JAX package's
    tree layout; no copy."""
    def gru(net):
        g = net.rnn.rnn
        return [{"w_ih": getattr(g, f"weight_ih_l{k}"),
                 "w_hh": getattr(g, f"weight_hh_l{k}"),
                 "b_ih": getattr(g, f"bias_ih_l{k}"),
                 "b_hh": getattr(g, f"bias_hh_l{k}")}
                for k in range(g.num_layers)]

    def dense(d):
        return None if isinstance(d, nn.Identity) else {"w": d.weight, "b": d.bias}

    m = model
    fc = m.discriminator.fc
    return {"embedder": {"gru": gru(m.embedder)},
            "recovery": {"gru": gru(m.recovery), "out": dense(m.recovery.out)},
            "generator": {"gru": gru(m.generator), "proj": dense(m.generator.proj)},
            "supervisor": {"gru": gru(m.supervisor),
                           "proj": dense(m.supervisor.proj)},
            "discriminator": {"gru": gru(m.discriminator),
                              "fc": {"w": fc.weight_orig, "b": fc.bias,
                                     "u": fc.weight_u}}}


def timegan_init_stacked(cfg: TimeGANConfig, generators: list[torch.Generator],
                         *, device: torch.device | str) -> Params:
    """One model per generator, stacked over a leading bucket axis: bucket b
    holds exactly the weights of ``TimeGAN(cfg, generator=generators[b])``."""
    from eegsynth_torch.convert import stack_params, to_jax_params
    return stack_params([to_jax_params(TimeGAN(cfg, generator=g, device="cpu"))
                         for g in generators], device=device)


def _tree(model: TimeGAN | Params) -> Params:
    return params_tree(model) if isinstance(model, nn.Module) else model


def _layer(layer: dict) -> GRULayer:
    return GRULayer(layer["w_ih"], layer["w_hh"], layer["b_ih"], layer["b_hh"])


def _proj(p: dict | None, v: torch.Tensor) -> torch.Tensor:
    return v if p is None else linear(v, p["w"], p["b"])


def _run_gru(layers: list, x: torch.Tensor, impl: str = "kernel",
             dropout: float = 0.0, masks: list | None = None) -> torch.Tensor:
    """Batch-first stack x (…, B, T, in) → (…, B, T, H), zero initial states.

    Inter-layer dropout (torch ``nn.GRU`` semantics, the JAX
    ``gru_stack_apply``): ``masks`` holds one boolean keep-mask per layer
    boundary, batch-first (…, B, T, H) like that layer's output, and layer
    k's output becomes ``where(keep, y / (1 - dropout), 0)`` before layer
    k + 1. ``None`` is eval mode, or a stack without dropout. Each layer
    stays one recurrence launch; the mask is an elementwise step between
    launches."""
    if masks is not None and len(masks) != len(layers) - 1:
        raise ValueError(f"{len(layers)} layers take {len(layers) - 1} dropout "
                         f"masks, got {len(masks)}")
    y = x.transpose(-3, -2)
    for k, layer in enumerate(layers):
        h0 = y.new_zeros((*y.shape[:-3], y.shape[-2], layer["w_hh"].shape[-1]))
        y = gru_apply_time_major(_layer(layer), y, h0, impl)
        if masks is not None and k < len(layers) - 1:
            keep = masks[k].transpose(-3, -2)
            y = torch.where(keep, y / (1.0 - dropout), torch.zeros_like(y))
    return y.transpose(-3, -2)


def split_masks(masks: list | None, n: int):
    """The masks of two stacks run one after the other: the first ``n``,
    then the rest."""
    return (None, None) if masks is None else (masks[:n], masks[n:])


def encode(model: TimeGAN | Params, x: torch.Tensor, dropout: float = 0.0,
           masks: list | None = None) -> torch.Tensor:
    """X → H. ``dropout`` / ``masks`` as :func:`_run_gru` (train mode)."""
    return _run_gru(_tree(model)["embedder"]["gru"], x, dropout=dropout, masks=masks)


def recover(model: TimeGAN | Params, h: torch.Tensor, dropout: float = 0.0,
            masks: list | None = None) -> torch.Tensor:
    """H → X̃: GRU + output head."""
    r = _tree(model)["recovery"]
    return _proj(r["out"], _run_gru(r["gru"], h, dropout=dropout, masks=masks))


def reconstruct(model: TimeGAN | Params, x: torch.Tensor, dropout: float = 0.0,
                masks: list | None = None) -> torch.Tensor:
    """X → X̃ = recovery(embedder(x)), two K1 launches for single-layer stacks
    (the same recurrences as the JAX package's ``fused_reconstruct``).
    ``masks``: the embedder's layer boundaries, then the recovery's."""
    p = _tree(model)
    m_e, m_r = split_masks(masks, len(p["embedder"]["gru"]) - 1)
    return recover(p, encode(p, x, dropout, m_e), dropout, m_r)


def gen_latent(model: TimeGAN | Params, z: torch.Tensor, dropout: float = 0.0,
               masks: list | None = None) -> torch.Tensor:
    g = _tree(model)["generator"]
    return _proj(g["proj"], _run_gru(g["gru"], z, dropout=dropout, masks=masks))


def refine_latent(model: TimeGAN | Params, e: torch.Tensor, dropout: float = 0.0,
                  masks: list | None = None) -> torch.Tensor:
    s = _tree(model)["supervisor"]
    return _proj(s["proj"], _run_gru(s["gru"], e, dropout=dropout, masks=masks))


def decode(model: TimeGAN | Params, h: torch.Tensor, dropout: float = 0.0,
           masks: list | None = None) -> torch.Tensor:
    return recover(model, h, dropout, masks)


def discriminate(d: Params, h: torch.Tensor, u: torch.Tensor, train: bool,
                 dropout: float = 0.0, masks: list | None = None):
    """H (…, B, T, z) → (p(real) (…, B, 1), u_out), the JAX ``_disc_apply``:
    last-step GRU output, spectral-norm head, sigmoid. ``d`` is the
    discriminator's tree; its power-iteration vector is passed as ``u``
    explicitly. In train mode ``u`` advances once and dropout ``masks`` may
    apply; in eval mode (R1) ``u_out`` is ``u`` and no mask applies. The
    recurrence is the plain one, which autograd differentiates twice (R1)."""
    if masks is not None and not train:
        raise ValueError("dropout masks apply only in train mode")
    y = _run_gru(d["gru"], h, impl="plain", dropout=dropout, masks=masks)
    logits, u_out = sn_dense_apply({**d["fc"], "u": u}, y[..., -1, :], train=train)
    return torch.sigmoid(logits), u_out


def sample_noise(generator: torch.Generator, batch: int, seq_len: int,
                 z_dim: int, *, device: torch.device | str) -> torch.Tensor:
    """Uniform [0,1) noise — the reference's torch.rand source. ``generator``
    must live on ``device``."""
    return torch.rand((batch, seq_len, z_dim), generator=generator,
                      device=device)


def _fusable(model: TimeGAN | Params) -> bool:
    p = _tree(model)
    return all(len(p[k]["gru"]) == 1
               for k in ("generator", "supervisor", "recovery", "embedder"))


def cascade_init_carry(model: TimeGAN | Params, batch: int, *,
                       device: torch.device | str) -> Carry:
    """Zero hidden states (h_gen, h_sup, h_rec) for the G→S→R cascade. They
    are float32 whatever the compute dtype: they are K1's recurrence state."""
    p = _tree(model)
    out = []
    for net in ("generator", "supervisor", "recovery"):
        w_hh = p[net]["gru"][0]["w_hh"]
        out.append(torch.zeros((*w_hh.shape[:-2], batch, w_hh.shape[-1]),
                               dtype=torch.float32, device=device))
    return tuple(out)


def gen_refine_carry(model: TimeGAN | Params, z: torch.Tensor, carry: Carry,
                     with_decode: bool = False):
    """The G→S→R cascade over this chunk of ``z``, starting from the given
    (h_gen, h_sup, h_rec) hidden states.

    Returns ``(carry_out, h_hat)`` or ``(carry_out, (h_hat, x_hat))``, as
    ``fused_gen_refine_carry`` does. Computed as the composed cascade: one
    recurrence launch per network, time-major throughout, with each layer's
    ``h0`` taken from the carry and the new carry taken from each layer's last
    output row. A GRU is strictly causal, so chunks with threaded carries
    equal one full-length run. Needs the single-layer configuration.

    The compute dtype is z's, which must be the tree's: float32, or
    bfloat16 for a tree cast by ``nn.precision.cast_floating``. The
    projections run in it; each recurrence runs in float32
    (:func:`~eegsynth_torch.nn.gru.gru_recurrence`) and its output is cast
    back, while the carry keeps the float32 last rows, so a chunked
    half-precision run equals the one-shot run too."""
    if not _fusable(model):
        raise ValueError("gen_refine_carry needs single-layer GRU stacks")
    p = _tree(model)
    g, s, r = p["generator"], p["supervisor"], p["recovery"]
    h_g, h_s, h_r = carry
    dt = z.dtype
    ys_g = gru_recurrence(_layer(g["gru"][0]), z.transpose(-3, -2), h_g)
    ys_s = gru_recurrence(_layer(s["gru"][0]), _proj(g["proj"], ys_g.to(dt)), h_s)
    h_hat = _proj(s["proj"], ys_s.to(dt))                     # (…, T, B, z)
    last = lambda ys: ys[..., -1, :, :].clone()               # noqa: E731
    if not with_decode:
        return (last(ys_g), last(ys_s), h_r), h_hat.transpose(-3, -2)
    ys_r = gru_recurrence(_layer(r["gru"][0]), h_hat, h_r)
    x_hat = _proj(r["out"], ys_r.to(dt))                      # (…, T, B, C)
    carry_out = (last(ys_g), last(ys_s), last(ys_r))
    return carry_out, (h_hat.transpose(-3, -2), x_hat.transpose(-3, -2))


def fused_gen_refine(model: TimeGAN | Params, z: torch.Tensor,
                     with_decode: bool = False):
    """Ĥ = supervisor(generator(z)) (and optionally X̂ = recovery(Ĥ)).

    Returns ``h_hat`` or ``(h_hat, x_hat)`` in z's dtype (see
    :func:`gen_refine_carry`). Falls back to the composed functions for
    multi-layer stacks, whose layers each run their recurrence in float32
    and cast back."""
    p = _tree(model)
    if not _fusable(p):
        h_hat = refine_latent(p, gen_latent(p, z))
        return (h_hat, recover(p, h_hat)) if with_decode else h_hat
    init = cascade_init_carry(p, z.shape[-3], device=z.device)
    return gen_refine_carry(p, z, init, with_decode)[1]


def _takes_k2(params: Params) -> bool:
    """K2's route: single-layer stacks with generator and supervisor
    projections and every width at most 128 (every ``adaptive_dims`` width;
    K2 holds its weights in registers and stops there). Wider stacks take
    the composed route, whose K1 runs at any width to 1024. Decided from
    the shapes alone, before any launch, so the CPU takes the card's
    route."""
    g, s = params["generator"], params["supervisor"]
    if not _fusable(params) or g["proj"] is None or s["proj"] is None:
        return False
    widths = [params[net]["gru"][0]["w_hh"].shape[-1]
              for net in ("embedder", "generator", "supervisor")]
    return max(*widths, g["proj"]["w"].shape[-2]) <= MAX_HIDDEN


def fused_disc_inputs(params: Params, x: torch.Tensor, z: torch.Tensor):
    """D-step latents (h_real, h_fake) = (embedder(x), supervisor(generator(z)))
    of stacked buckets: x (nb, B, T, C), z (nb, B, T, z) → (nb, B, T, z) each.
    Forward only.

    Two routes, chosen by :func:`_takes_k2` from the widths before any
    launch, the same on the card and on the CPU:

    - :func:`_k2_disc_inputs`, kernel K2 on the card, its plain version on
      the CPU (the JAX vmapped ``fused_disc_inputs`` /
      ``multigru_disc_inputs_pallas``): single-layer stacks with both
      projections, every ``adaptive_dims`` width (z16/h32 to z64/h128);
    - otherwise the composed networks, ``encode`` and ``refine_latent ∘
      gen_latent`` (the JAX fallback, the same math as its fused scan): 3 K1
      forward launches on the card for single-layer stacks, the projections
      as products. Stacks without projections (h_dim == z_dim),
      multi-layer stacks and widths past 128 take it (there K1 runs its
      wide route)."""
    if _takes_k2(params):
        return _k2_disc_inputs(params, x, z)
    with torch.no_grad():
        return encode(params, x), refine_latent(params, gen_latent(params, z))


def k2_inputs(params: Params, x: torch.Tensor, z: torch.Tensor) -> tuple:
    """The arguments of :func:`multigru_disc_inputs` for x (nb, B, T, C) and
    z (nb, B, T, z): the input projections hoisted as two batched products
    (time-major), then the twelve weights and biases, transposed."""
    e, g, s = params["embedder"], params["generator"], params["supervisor"]
    el, gl, sl = e["gru"][0], g["gru"][0], s["gru"][0]
    t = lambda w: w.transpose(-1, -2).contiguous()            # noqa: E731
    with torch.no_grad():
        xp_e = linear(x.transpose(1, 2), el["w_ih"], el["b_ih"])   # (nb, T, B, 3He)
        xp_g = linear(z.transpose(1, 2), gl["w_ih"], gl["b_ih"])
        return (xp_e.contiguous(), xp_g.contiguous(),
                t(el["w_hh"]), el["b_hh"].contiguous(),
                t(gl["w_hh"]), gl["b_hh"].contiguous(),
                t(g["proj"]["w"]), g["proj"]["b"].contiguous(),
                t(sl["w_ih"]), sl["b_ih"].contiguous(),
                t(sl["w_hh"]), sl["b_hh"].contiguous(),
                t(s["proj"]["w"]), s["proj"]["b"].contiguous())


def _k2_disc_inputs(params: Params, x: torch.Tensor, z: torch.Tensor):
    """:func:`fused_disc_inputs` through K2 (its plain version on the CPU)."""
    with torch.no_grad():
        h_real, h_fake = multigru_disc_inputs(*k2_inputs(params, x, z))
    return h_real.transpose(1, 2), h_fake.transpose(1, 2)
