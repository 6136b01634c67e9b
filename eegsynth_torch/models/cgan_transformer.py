"""Transformer CGAN: posture-conditioned transformer generator and
discriminator.

Counterpart of ``eegsynth/models/cgan_transformer.py``, on parameter trees of
tensors in the JAX package's layout (``params["blk0"]["attn"]["wq"]["w"]``),
so checkpoints and parity tests map leaf for leaf:

- **Generator** (DiT-style): the class one-hot and the noise feed a
  conditioning MLP; ``seq_len / patch`` learned tokens pass through pre-LN
  blocks whose LayerNorm shift, scale and gate come per sample from
  zero-initialised adaLN heads (adaLN-zero: a fresh generator's blocks are
  the identity), then a patch head → (B, C, T) → sigmoid.
- **Discriminator**: patch embedding → pre-LN blocks → final LN with a
  learned affine → token-mean features, then ``models/cgan.py``'s
  projection-ACGAN head. Positional embeddings are sliced to the token
  count, so the same weights serve the global (768-sample) and local-crop
  (256-sample) discriminators.

The generator's attention runs through ``nn/attention.py``'s ``mha`` with
``cfg.attn_impl`` (None → the module default, ``"auto"``): flash attention
(K3a forward, K3b and K3c backward) on the card from 512 tokens or when
forced. The discriminator pins dense attention even when flash is forced:
R1 differentiates it twice, and the kernels are first-order only.

``jax.nn.gelu`` is the tanh approximation, so the MLP uses
``gelu(approximate="tanh")``; LayerNorm's variance is biased with eps 1e-6.
``remat=True`` wraps each discriminator block in
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, as the JAX
package wraps it in ``jax.checkpoint``: a block keeps only its input for the
backward pass and recomputes the rest there. R1's double backward passes
through it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from eegsynth_torch.models.cgan import CGANConfig, disc_head
from eegsynth_torch.nn.attention import mha
from eegsynth_torch.nn.layers import torch_dense_init
from eegsynth_torch.nn.spectral_norm import _l2_normalize
from eegsynth_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class TransformerCGANConfig(CGANConfig):
    arch: str = "transformer"
    dim: int = 256              # token width
    depth: int = 4
    heads: int = 4
    patch: int = 8              # samples per token → 768/8 = 96 tokens
    mlp_ratio: int = 4
    attn_impl: str | None = None  # None → the module default ("auto")
    remat: bool = False         # recompute each D block in the backward pass

    @property
    def tokens(self) -> int:
        return self.seq_len // self.patch


def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Parameter-free LayerNorm over the last axis, biased variance."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].T + p["b"]


def _zeros_dense(in_dim: int, out_dim: int, device) -> dict:
    return {"w": torch.zeros((out_dim, in_dim), device=device),
            "b": torch.zeros((out_dim,), device=device)}


def _attn_init(gen: torch.Generator, dim: int) -> dict:
    return {n: torch_dense_init(dim, dim, gen) for n in ("wq", "wk", "wv", "wo")}


def _attn_apply(p: dict, x: torch.Tensor, heads: int, impl) -> torch.Tensor:
    b, l, dim = x.shape
    dh = dim // heads

    def split(y):
        return y.reshape(b, l, heads, dh).transpose(1, 2)

    o = mha(split(_dense(p["wq"], x)), split(_dense(p["wk"], x)),
            split(_dense(p["wv"], x)), impl=impl)
    return _dense(p["wo"], o.transpose(1, 2).reshape(b, l, dim))


def _mlp_init(gen: torch.Generator, dim: int, hidden: int) -> dict:
    return {"fc1": torch_dense_init(dim, hidden, gen),
            "fc2": torch_dense_init(hidden, dim, gen)}


def _mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return _dense(p["fc2"], F.gelu(_dense(p["fc1"], x), approximate="tanh"))


# ------------------------------ Generator ------------------------------

def generator_init(cfg: TransformerCGANConfig, generator: torch.Generator, *,
                   device: torch.device | str):
    """(params, state): weights drawn from ``generator`` (on its device),
    then moved to ``device``; the state is empty (no batch statistics)."""
    dim, hidden = cfg.dim, cfg.dim * cfg.mlp_ratio
    gen = generator
    params = {
        "cond1": torch_dense_init(cfg.noise_dim + cfg.num_classes, dim, gen),
        "cond2": torch_dense_init(dim, dim, gen),
        "tok": 0.02 * torch.randn((cfg.tokens, dim), generator=gen, device=gen.device),
        "head_ada": _zeros_dense(dim, 2 * dim, gen.device),        # adaLN-zero
        # not zero: a constant initial output puts the coherence losses on
        # their zero-spectrum point, where the gradients are NaN
        "head_out": torch_dense_init(dim, cfg.patch * cfg.channels, gen),
    }
    for i in range(cfg.depth):
        params[f"blk{i}"] = {
            "attn": _attn_init(gen, dim),
            "mlp": _mlp_init(gen, dim, hidden),
            "ada": _zeros_dense(dim, 6 * dim, gen.device),         # adaLN-zero
        }
    return tree_map(lambda t: t.to(device), params), {}


def generator_apply(params: dict, state: dict, z: torch.Tensor,
                    labels: torch.Tensor, cfg: TransformerCGANConfig,
                    train: bool = True):
    """(z (B, noise), labels (B,)) → (x (B, C, T) in (0, 1), state)."""
    del train  # no batch statistics
    z = z.to(params["tok"].dtype)
    oh = F.one_hot(labels.long(), cfg.num_classes).to(z.dtype)
    c = _dense(params["cond2"], F.silu(_dense(params["cond1"], torch.cat([z, oh], 1))))
    c = F.silu(c)                                            # (B, dim)
    x = params["tok"][None].expand(z.shape[0], *params["tok"].shape)
    for i in range(cfg.depth):
        blk = params[f"blk{i}"]
        mod = _dense(blk["ada"], c)[:, None, :]             # (B, 1, 6·dim)
        sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
        h = _ln(x) * (1.0 + sc1) + sh1
        x = x + g1 * _attn_apply(blk["attn"], h, cfg.heads, cfg.attn_impl)
        h = _ln(x) * (1.0 + sc2) + sh2
        x = x + g2 * _mlp_apply(blk["mlp"], h)
    sh, sc = _dense(params["head_ada"], c)[:, None, :].chunk(2, dim=-1)
    y = _dense(params["head_out"], _ln(x) * (1.0 + sc) + sh)  # (B, L, patch·C)
    b, l, _ = y.shape
    y = y.reshape(b, l * cfg.patch, cfg.channels).transpose(1, 2)
    return torch.sigmoid(y), state


# ---------------------------- Discriminator ----------------------------

def disc_init(cfg: TransformerCGANConfig, generator: torch.Generator, *,
              device: torch.device | str) -> dict:
    dim, hidden = cfg.dim, cfg.dim * cfg.mlp_ratio
    gen = generator
    kw = {"generator": gen, "device": gen.device}
    params = {
        "embed_in": torch_dense_init(cfg.patch * cfg.channels, dim, gen),
        "pos": 0.02 * torch.randn((cfg.tokens, dim), **kw),
        "ln_g": torch.ones((dim,), device=gen.device),
        "ln_b": torch.zeros((dim,), device=gen.device),
    }
    for i in range(cfg.depth):
        params[f"blk{i}"] = {"attn": _attn_init(gen, dim),
                             "mlp": _mlp_init(gen, dim, hidden)}
    fc = torch_dense_init(dim, 1, gen)
    fc["u"] = _l2_normalize(torch.randn((1,), **kw))
    cls = torch_dense_init(dim, cfg.num_classes, gen)
    cls["u"] = _l2_normalize(torch.randn((cfg.num_classes,), **kw))
    params["fc"], params["cls"] = fc, cls
    params["embed"] = torch.randn((cfg.num_classes, dim), **kw)
    params["std_weight"] = torch.zeros((1,), device=gen.device)
    return tree_map(lambda t: t.to(device), params)


def disc_features(params: dict, x: torch.Tensor, train: bool = True, *,
                  cfg: TransformerCGANConfig):
    """(B, C, T) → (token-mean features (B, dim), params unchanged)."""
    del train
    b, c, t = x.shape
    if t % cfg.patch:
        raise ValueError(f"T={t} is not a multiple of patch={cfg.patch}")
    l = t // cfg.patch
    h = x.to(params["pos"].dtype).transpose(1, 2).reshape(b, l, cfg.patch * c)
    h = _dense(params["embed_in"], h) + params["pos"][None, :l]

    def block(blk, h):
        # dense attention always: R1 differentiates the discriminator twice
        h = h + _attn_apply(blk["attn"], _ln(h), cfg.heads, "dense")
        return h + _mlp_apply(blk["mlp"], _ln(h))

    for i in range(cfg.depth):
        if cfg.remat:
            h = checkpoint(block, params[f"blk{i}"], h, use_reentrant=False)
        else:
            h = block(params[f"blk{i}"], h)
    h = _ln(h) * params["ln_g"] + params["ln_b"]
    return h.mean(dim=1), params


def disc_apply(params: dict, x: torch.Tensor, labels: torch.Tensor,
               cfg: TransformerCGANConfig, train: bool = True,
               dropout_keep: torch.Tensor | None = None,
               compute_dtype: torch.dtype | None = None):
    """→ (score (B, 1), ACGAN logits (B, K), features (B, dim), params with
    the head's advanced ``u``). ``compute_dtype`` takes the conv model's
    place in the call: this discriminator has no reduced-precision trunk
    and refuses any."""
    if compute_dtype is not None:
        raise ValueError("the transformer discriminator runs in its parameters' dtype")
    f, _ = disc_features(params, x, train=train, cfg=cfg)
    score, logits, f_used, u_fc, u_cls = disc_head(params, f, labels, cfg, train,
                                                   dropout_keep)
    new = dict(params)
    new["fc"] = {**params["fc"], "u": u_fc}
    new["cls"] = {**params["cls"], "u": u_cls}
    return score, logits, f_used, new
