"""The conditional GAN's configuration and its projection-ACGAN
discriminator head.

Counterpart of ``CGANConfig`` and ``disc_head`` in ``eegsynth/models/cgan.py``.
The head is shared by every discriminator trunk; the transformer trunk
(``models/cgan_transformer.py``) is the one ported so far. The conv generator
and discriminators (``generator_init`` / ``disc_init`` of the conv family)
come with the conv CGAN slice.
"""

from __future__ import annotations

import dataclasses

import torch

from eegsynth_torch.nn.spectral_norm import spectral_normalize


@dataclasses.dataclass(frozen=True)
class CGANConfig:
    noise_dim: int = 100
    num_classes: int = 9        # 9 postures (v1) or 2 conditions (v2/v3)
    channels: int = 14
    seq_len: int = 768
    init_len: int = 24
    proj_scale: float = 0.25    # v2 uses 0.10
    variant: str = "v1"         # "v1": learned std_weight; "v2": 0.1·std + dropout
    dropout: float = 0.1        # v2 feature dropout
    arch: str = "conv"          # "conv" (reference parity) | "transformer" extra


def disc_head(params: dict, f: torch.Tensor, labels: torch.Tensor, cfg,
              train: bool = True, dropout_keep: torch.Tensor | None = None):
    """Projection-ACGAN head on pooled features f (B, F): returns
    (score (B, 1), ACGAN logits (B, K), f_used, u_fc, u_cls).

    score = sn_fc(f) + proj_scale·⟨f, embed(y)⟩ + std term, where the std
    term is ``std_weight``·mean(minibatch std) in v1 and the fixed
    0.1·mean(minibatch std) in v2; the minibatch std is biased
    (var + 1e-8). v2 in train mode applies Dropout(``cfg.dropout``) with the
    passed-in boolean keep mask (B, F). ``u_fc`` / ``u_cls`` are the advanced
    power-iteration vectors in train mode and the stored ones in eval mode."""
    if cfg.variant == "v2" and train and cfg.dropout > 0:
        if dropout_keep is None:
            raise ValueError("the v2 discriminator needs a dropout keep mask in "
                             "train mode")
        f_used = torch.where(dropout_keep, f / (1.0 - cfg.dropout),
                             torch.zeros((), dtype=f.dtype, device=f.device))
    else:
        f_used = f

    std = torch.sqrt(f_used.var(dim=0, unbiased=False) + 1e-8)
    mb = std.mean()
    proj = (f_used * params["embed"][labels]).sum(dim=1, keepdim=True)

    w_fc, u_fc = spectral_normalize(params["fc"]["w"], params["fc"]["u"])
    score = f_used @ w_fc.T + params["fc"]["b"]
    if cfg.variant == "v2":
        score = score + cfg.proj_scale * proj + 0.1 * mb
    else:
        score = score + cfg.proj_scale * proj + params["std_weight"] * mb

    w_cls, u_cls = spectral_normalize(params["cls"]["w"], params["cls"]["u"])
    logits = f_used @ w_cls.T + params["cls"]["b"]
    if not train:
        u_fc, u_cls = params["fc"]["u"], params["cls"]["u"]
    return score, logits, f_used, u_fc, u_cls
