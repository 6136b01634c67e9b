"""Conditional GAN for EEG (14 × 768): an upsampling conv generator and
twin projection-ACGAN discriminators, the reference's own CGAN.

Counterpart of ``eegsynth/models/cgan.py``, on parameter trees of tensors
in the JAX package's layout (G: ``proj``, ``up1..up5.{conv,cbn}``,
``to_out``; D: ``c1..c5``, ``fc``, ``cls``, ``embed``, ``std_weight``; bn
state: ``up{i}.{mean,var}``), so checkpoints map leaf for leaf:

- generator: Linear(noise + one-hot → 512·init_len), then five blocks of
  nearest ×2, Conv1d k3, class-conditional BN and ReLU taking 512 → 16
  channels over lengths 24 → 768, then Conv1d(16 → 14, k3) and a sigmoid;
- discriminator: five spectral-norm Conv1d(k4, s2, p1) 14 → 32 → … → 512
  with LeakyReLU(0.2), time-mean features, then :func:`disc_head`, which
  the transformer trunk (``models/cgan_transformer.py``) shares. v1 has 9
  posture classes and a learned ``std_weight``, v2 2 condition classes, a
  fixed 0.1·std and Dropout(0.1) on the features.

Batch-norm running statistics and the spectral-norm ``u`` vectors are state
passed through every apply. ``compute_dtype=torch.bfloat16`` runs the
discriminator's conv trunk in bfloat16 (the trainer's ``precision_d``): the
power iteration, the pooled features and the head stay float32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from eegsynth_torch.nn.conv import (
    conv1d_apply, conv1d_init, sn_conv1d_apply, sn_conv1d_init, upsample_nearest_2x,
)
from eegsynth_torch.nn.layers import torch_dense_init
from eegsynth_torch.nn.norm import cbn1d_apply, cbn1d_init, cbn1d_state_init
from eegsynth_torch.nn.spectral_norm import _l2_normalize, spectral_normalize
from eegsynth_torch.tree import tree_map

GEN_CHANNELS = (512, 256, 128, 64, 32, 16)
DISC_CHANNELS = (32, 64, 128, 256, 512)


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


# ------------------------------ Generator ------------------------------

def generator_init(cfg: CGANConfig, generator: torch.Generator, *,
                   device: torch.device | str):
    """(params, bn state): weights drawn from ``generator`` (on its
    device), then moved to ``device``."""
    gen = generator
    params = {"proj": torch_dense_init(cfg.noise_dim + cfg.num_classes,
                                       GEN_CHANNELS[0] * cfg.init_len, gen)}
    state = {}
    for i in range(5):
        ci, co = GEN_CHANNELS[i], GEN_CHANNELS[i + 1]
        params[f"up{i + 1}"] = {"conv": conv1d_init(gen, ci, co, 3),
                                "cbn": cbn1d_init(co, cfg.num_classes, device=gen.device)}
        state[f"up{i + 1}"] = cbn1d_state_init(co, device=gen.device)
    params["to_out"] = conv1d_init(gen, GEN_CHANNELS[5], cfg.channels, 3)
    to = lambda tree: tree_map(lambda t: t.to(device), tree)  # noqa: E731
    return to(params), to(state)


def generator_apply(params: dict, state: dict, z: torch.Tensor,
                    labels: torch.Tensor, cfg: CGANConfig, train: bool = True):
    """(z (B, noise), labels (B,)) → (x (B, C, T) in (0, 1), new bn state)."""
    z = z.to(params["proj"]["w"].dtype)
    oh = F.one_hot(labels.long(), cfg.num_classes).to(z.dtype)
    h = torch.cat([z, oh], dim=1) @ params["proj"]["w"].T + params["proj"]["b"]
    h = h.reshape(-1, GEN_CHANNELS[0], cfg.init_len)
    new_state = {}
    for i in range(5):
        blk, name = params[f"up{i + 1}"], f"up{i + 1}"
        h = conv1d_apply(blk["conv"], upsample_nearest_2x(h), stride=1, padding=1)
        h, new_state[name] = cbn1d_apply(blk["cbn"], state[name], h, labels, train=train)
        h = torch.relu(h)
    x = conv1d_apply(params["to_out"], h, stride=1, padding=1)
    return torch.sigmoid(x), new_state


# ---------------------------- Discriminators ----------------------------

def disc_init(cfg: CGANConfig, generator: torch.Generator, *,
              device: torch.device | str) -> dict:
    gen = generator
    kw = {"generator": gen, "device": gen.device}
    chans = (cfg.channels,) + DISC_CHANNELS
    params = {f"c{i + 1}": sn_conv1d_init(gen, chans[i], chans[i + 1], 4)
              for i in range(5)}
    feat = DISC_CHANNELS[-1]
    fc = torch_dense_init(feat, 1, gen)
    fc["u"] = _l2_normalize(torch.randn((1,), **kw))
    cls = torch_dense_init(feat, cfg.num_classes, gen)
    cls["u"] = _l2_normalize(torch.randn((cfg.num_classes,), **kw))
    params["fc"], params["cls"] = fc, cls
    params["embed"] = torch.randn((cfg.num_classes, feat), **kw)
    params["std_weight"] = torch.zeros((1,), device=gen.device)
    return tree_map(lambda t: t.to(device), params)


def disc_features(params: dict, x: torch.Tensor, train: bool = True,
                  compute_dtype: torch.dtype | None = None, *, cfg: CGANConfig | None = None):
    """Five strided spectral-norm convs with LeakyReLU(0.2), time-mean
    pooled: (features (B, 512), params with the convs' ``u`` advanced in
    train mode). The mean is taken after a cast back to the parameter
    dtype, so a bfloat16 trunk still pools in float32. ``cfg`` is unused:
    it is there so that both architectures take the same arguments."""
    del cfg
    new = dict(params)
    pdtype = params["c1"]["w"].dtype
    h = x.to(compute_dtype if compute_dtype is not None else pdtype)
    for i in range(5):
        h, new[f"c{i + 1}"] = sn_conv1d_apply(params[f"c{i + 1}"], h, stride=2,
                                              padding=1, train=train,
                                              compute_dtype=compute_dtype)
        h = F.leaky_relu(h, 0.2)
    return h.to(pdtype).mean(dim=2), new


def disc_apply(params: dict, x: torch.Tensor, labels: torch.Tensor, cfg: CGANConfig,
               train: bool = True, dropout_keep: torch.Tensor | None = None,
               compute_dtype: torch.dtype | None = None):
    """→ (score (B, 1), ACGAN logits (B, K), features (B, 512), params with
    every advanced ``u``)."""
    f, new = disc_features(params, x, train=train, compute_dtype=compute_dtype)
    score, logits, f_used, u_fc, u_cls = disc_head(params, f, labels, cfg, train,
                                                   dropout_keep)
    new["fc"] = {**params["fc"], "u": u_fc}
    new["cls"] = {**params["cls"], "u": u_cls}
    return score, logits, f_used, new
