"""Carry weights between the JAX package's params trees and the port.

TimeGAN:

The JAX package keeps TimeGAN parameters as a nested dict
(``params["generator"]["gru"][0]["w_hh"]``, …; ``proj`` is ``None`` when
h_dim == z_dim), with torch layouts. The port's ``TimeGAN`` module names the
same arrays as the reference torch state_dict
(``generator.rnn.rnn.weight_hh_l0``, …), so converting is a key remap, the
one ``scripts/convert_torch_ckpt.py`` does for reference checkpoints.

The multi-bucket trainer keeps the JAX tree itself, stacked over a leading
bucket axis (:func:`stack_params`); :func:`unstack_params` slices one bucket
out for a checkpoint or for ``from_jax_params``.

Transformer CGAN: the port keeps the JAX tree itself (``{"blk0": {"attn":
{"wq": {"w", "b"}}}}``) for parameters and optimizer states alike, so
converting is a change of leaf type: :func:`tree_to_device` takes a tree of
numpy arrays (as ``train.checkpoint.load_checkpoint`` returns it, from a
checkpoint written by either package) onto a device, and
:func:`tree_to_numpy` brings a tree of tensors back for a checkpoint.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from eegsynth_torch.models.timegan import TimeGAN, TimeGANConfig, params_tree
from eegsynth_torch.tree import take, tree_map

NETS = ("embedder", "recovery", "generator", "supervisor", "discriminator")
_GRU_KEYS = (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
             ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))


def _config_from_jax_params(tree: dict[str, Any]) -> TimeGANConfig:
    """Model dimensions read off the arrays' shapes."""
    emb = tree["embedder"]["gru"]
    return TimeGANConfig(x_dim=int(np.shape(emb[0]["w_ih"])[1]),
                         z_dim=int(np.shape(emb[0]["w_hh"])[1]),
                         h_dim=int(np.shape(tree["generator"]["gru"][0]["w_hh"])[1]),
                         num_layers=len(emb))


def from_jax_params(tree: dict[str, Any], *, device: torch.device | str) -> TimeGAN:
    """JAX params tree (nested dicts / lists of arrays) → ``TimeGAN`` on
    ``device``. Strict: a missing, extra or misshapen array raises."""
    sd: dict[str, Any] = {}
    for net in NETS:
        for k, layer in enumerate(tree[net]["gru"]):
            for jk, tk in _GRU_KEYS:
                sd[f"{net}.rnn.rnn.{tk}_l{k}"] = layer[jk]
    sd["recovery.out.weight"] = tree["recovery"]["out"]["w"]
    sd["recovery.out.bias"] = tree["recovery"]["out"]["b"]
    for net in ("generator", "supervisor"):
        proj = tree[net].get("proj")
        if proj is not None:
            sd[f"{net}.proj.weight"] = proj["w"]
            sd[f"{net}.proj.bias"] = proj["b"]
    fc = tree["discriminator"]["fc"]
    sd["discriminator.fc.weight_orig"] = fc["w"]
    sd["discriminator.fc.bias"] = fc["b"]
    sd["discriminator.fc.weight_u"] = fc["u"]

    # the init is overwritten below; a fixed seed keeps construction cheap and
    # deterministic
    model = TimeGAN(_config_from_jax_params(tree),
                    generator=torch.Generator().manual_seed(0), device=device)
    model.load_state_dict({k: torch.from_numpy(np.array(v, dtype=np.float32))
                           for k, v in sd.items()}, strict=True)
    return model


def to_jax_params(model: TimeGAN) -> dict[str, Any]:
    """``TimeGAN`` → JAX params tree of float32 numpy arrays (inverse of
    :func:`from_jax_params`)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), params_tree(model))


def stack_params(trees: list[dict[str, Any]], *,
                 device: torch.device | str) -> dict[str, Any]:
    """Per-bucket trees of arrays → one tree of tensors on ``device`` with a
    leading bucket axis (what ``jax.vmap(timegan_init)`` returns)."""
    return tree_map(lambda *leaves: torch.from_numpy(
        np.stack([np.asarray(a) for a in leaves])).to(device), *trees)


def unstack_params(params: dict[str, Any], b: int) -> dict[str, Any]:
    """Bucket ``b`` of a stacked tree as numpy arrays, ready for
    :func:`from_jax_params` or a checkpoint."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), take(params, b))


def tree_to_device(tree: Any, *, device: torch.device | str) -> Any:
    """A tree of numpy arrays → the same tree of tensors on ``device``
    (dtypes kept; ``Attrs`` nodes and ``None`` subtrees kept)."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def tree_to_numpy(tree: Any) -> Any:
    """A tree of tensors → the same tree of numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def restore_like(template: Any, tree: Any, path: str = "") -> Any:
    """A tree of numpy arrays as ``train.checkpoint.load_checkpoint`` returns
    it (dicts, ``Attrs`` and lists; an empty subtree absent or ``None``) →
    ``template``'s structure, as tensors of the template's dtype on its
    device. A stored leaf with one axis fewer than its template leaf (one
    model's, as a checkpoint of one bucket holds it) gains a leading bucket
    axis of 1. A missing leaf raises ``KeyError``, any other shape mismatch
    ``ValueError``."""
    if template is None:
        return None
    if isinstance(template, dict):
        get = tree.get if isinstance(tree, dict) else (lambda k: None)
        return type(template)((k, restore_like(template[k], get(k), f"{path}[{k!r}]"))
                              for k in template)
    if isinstance(template, (list, tuple)):
        items = tree if isinstance(tree, (list, tuple)) else []
        return type(template)(
            restore_like(t, items[i] if i < len(items) else None, f"{path}[{i}]")
            for i, t in enumerate(template))
    if tree is None:
        raise KeyError(f"no stored leaf at {path or 'the root'}")
    a = torch.from_numpy(np.array(tree)).to(device=template.device, dtype=template.dtype)
    if a.dim() == template.dim() - 1:
        a = a.unsqueeze(0)
    if a.shape != template.shape:
        raise ValueError(f"stored shape {tuple(a.shape)} at {path} does not fit "
                         f"{tuple(template.shape)}")
    return a
