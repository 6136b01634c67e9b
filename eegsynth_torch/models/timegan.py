"""TimeGAN: embedder / recovery / generator / supervisor / discriminator.

Counterpart of ``eegsynth/models/timegan.py``, as ``nn.Module``s whose
parameter names are the reference torch state_dict's
(``generator.rnn.rnn.weight_ih_l0``, ``recovery.out.weight``,
``discriminator.fc.weight_orig`` / ``weight_u``, …):

- Embedder      X (B,T,C)  → H (B,T,z)   GRU(x_dim→z_dim)
- Recovery      H          → X̃ (B,T,C)   GRU(z_dim→h_dim) + Linear(h_dim→x_dim)
- Generator     Z (B,T,z)  → Ê           GRU(z_dim→h_dim) + Linear(h_dim→z_dim)
- Supervisor    Ê          → Ĥ           same shape as Generator
- Discriminator H          → p(real)     GRU(z_dim→h_dim) + spectral-norm Linear

Forward only: the synthesis path (generator → supervisor → recovery) and the
composed functions the JAX package exposes.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from eegsynth_torch.nn.gru import GRUStack, gru_apply_time_major
from eegsynth_torch.nn.layers import Dense
from eegsynth_torch.nn.spectral_norm import SNDense

Carry = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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


def encode(model: TimeGAN, x: torch.Tensor) -> torch.Tensor:
    """X → H."""
    return model.embedder.rnn(x)


def recover(model: TimeGAN, h: torch.Tensor) -> torch.Tensor:
    """H → X̃: GRU + output head."""
    return model.recovery.out(model.recovery.rnn(h))


def gen_latent(model: TimeGAN, z: torch.Tensor) -> torch.Tensor:
    return model.generator.proj(model.generator.rnn(z))


def refine_latent(model: TimeGAN, e: torch.Tensor) -> torch.Tensor:
    return model.supervisor.proj(model.supervisor.rnn(e))


def decode(model: TimeGAN, h: torch.Tensor) -> torch.Tensor:
    return recover(model, h)


def sample_noise(generator: torch.Generator, batch: int, seq_len: int,
                 z_dim: int, *, device: torch.device | str) -> torch.Tensor:
    """Uniform [0,1) noise — the reference's torch.rand source. ``generator``
    must live on ``device``."""
    return torch.rand((batch, seq_len, z_dim), generator=generator,
                      device=device)


def _fusable(model: TimeGAN) -> bool:
    return model.cfg.num_layers == 1


def cascade_init_carry(model: TimeGAN, batch: int, *,
                       device: torch.device | str) -> Carry:
    """Zero hidden states (h_gen, h_sup, h_rec) for the G→S→R cascade."""
    return tuple(torch.zeros((batch, net.rnn.rnn.weight_hh_l0.shape[1]),
                             device=device)
                 for net in (model.generator, model.supervisor, model.recovery))


def gen_refine_carry(model: TimeGAN, z: torch.Tensor, carry: Carry,
                     with_decode: bool = False):
    """The G→S→R cascade over this chunk of ``z``, starting from the given
    (h_gen, h_sup, h_rec) hidden states.

    Returns ``(carry_out, h_hat)`` or ``(carry_out, (h_hat, x_hat))``, as
    ``fused_gen_refine_carry`` does. Computed as the composed cascade: one
    recurrence launch per network, time-major throughout, with each layer's
    ``h0`` taken from the carry and the new carry taken from each layer's last
    output row. A GRU is strictly causal, so chunks with threaded carries
    equal one full-length run. Needs the single-layer configuration."""
    if not _fusable(model):
        raise ValueError("gen_refine_carry needs single-layer GRU stacks")
    g, s, r = model.generator, model.supervisor, model.recovery
    h_g, h_s, h_r = carry
    ys_g = gru_apply_time_major(g.rnn.rnn.layer(0), z.transpose(0, 1), h_g)
    ys_s = gru_apply_time_major(s.rnn.rnn.layer(0), g.proj(ys_g), h_s)
    h_hat = s.proj(ys_s)                                      # (T, B, z)
    if not with_decode:
        return (ys_g[-1].clone(), ys_s[-1].clone(), h_r), h_hat.transpose(0, 1)
    ys_r = gru_apply_time_major(r.rnn.rnn.layer(0), h_hat, h_r)
    x_hat = r.out(ys_r)                                       # (T, B, C)
    carry_out = (ys_g[-1].clone(), ys_s[-1].clone(), ys_r[-1].clone())
    return carry_out, (h_hat.transpose(0, 1), x_hat.transpose(0, 1))


def fused_gen_refine(model: TimeGAN, z: torch.Tensor, with_decode: bool = False):
    """Ĥ = supervisor(generator(z)) (and optionally X̂ = recovery(Ĥ)).

    Returns ``h_hat`` or ``(h_hat, x_hat)``. Falls back to the composed
    functions for multi-layer stacks."""
    if not _fusable(model):
        h_hat = refine_latent(model, gen_latent(model, z))
        return (h_hat, recover(model, h_hat)) if with_decode else h_hat
    init = cascade_init_carry(model, z.shape[0], device=z.device)
    return gen_refine_carry(model, z, init, with_decode)[1]
