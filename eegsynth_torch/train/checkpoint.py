"""Flat-tree NPZ checkpoints with JSON meta, shared with the JAX package.

Counterpart of ``eegsynth/train/checkpoint.py``, NPZ backend only. A
checkpoint holds named trees (nested dicts and lists of arrays, e.g.
``{"model": params, "optG": ..., "optD": ...}``); each leaf is stored under
``<name><path>``, where the path is written as ``jax.tree_util.keystr`` writes
it, plus a ``__meta__`` JSON blob. Three kinds of path segment:

- ``['name']``, a dict key: ``model['generator']['gru'][0]['w_hh']``;
- ``[i]``, a list or tuple index;
- ``.name``, a NamedTuple field, as in the optax states the trainers save:
  ``optD[1][0].count``, ``optD[1][0].mu['fc']['w']``. Such a node is an
  :class:`Attrs` here.

A ``None`` subtree stores nothing, as in JAX (an optax ``EmptyState`` stores
nothing either), and a list index with nothing stored under it reads back as
``None``. The key strings are parsed here without jax, so a checkpoint saved
by either package loads in the other.

Orbax checkpoint directories (``*.orbax``) are not read: NPZ is the format
both packages share.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any

import numpy as np

_ORBAX_SUFFIX = ".orbax"
_SEGMENT = re.compile(r"\[(?:'([^']*)'|(\d+))\]|\.([A-Za-z_]\w*)")


class Attrs(dict):
    """A tree node whose children are attributes: the counterpart of a JAX
    NamedTuple (an optax state). Written back as ``.name`` segments."""


def _require_npz(path: Path | str) -> None:
    if str(path).endswith(_ORBAX_SUFFIX):
        raise ValueError(f"{path}: Orbax checkpoints are not supported by "
                         "eegsynth_torch; save the run as NPZ")


def find_checkpoint(run_dir: Path | str, stem: str) -> Path | None:
    """Existing checkpoint named ``stem`` (``.npz`` or ``.orbax``), the most
    recently written winning, as in the JAX package — an Orbax one is found
    here so that loading it fails loudly instead of serving stale weights."""
    cands = [p for suffix in (".npz", _ORBAX_SUFFIX)
             if (p := Path(run_dir) / (stem + suffix)).exists()]
    if not cands:
        return None
    return max(cands, key=lambda p: p.stat().st_mtime)


def _to_numpy(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any, prefix: str, out: dict[str, np.ndarray]) -> None:
    if tree is None:
        return
    if isinstance(tree, Attrs):
        for k in tree:
            _flatten(tree[k], f"{prefix}.{k}", out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}[{k!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}[{i}]", out)
    else:
        out[prefix] = _to_numpy(tree)


def _parse_key(key: str) -> tuple[str, list[tuple[str, str | int]]]:
    """``"optD[1][0].mu['w']"`` → ``("optD", [("[]", 1), ("[]", 0),
    (".", "mu"), ("[]", "w")])``: each segment with its kind."""
    cut = min((i for i in (key.find("["), key.find(".")) if i >= 0),
              default=len(key))
    name, rest = key[:cut], key[cut:]
    path, pos = [], 0
    for m in _SEGMENT.finditer(rest):
        if m.start() != pos:
            break
        if m.group(3) is not None:
            path.append((".", m.group(3)))
        else:
            path.append(("[]", m.group(1) if m.group(2) is None else int(m.group(2))))
        pos = m.end()
    if pos != len(rest) or not name:
        raise ValueError(f"unparseable checkpoint key {key!r}")
    return name, path


def _listify(node):
    """Turn the int-keyed dicts built while unflattening into lists; an index
    with nothing stored under it (an empty subtree) becomes ``None``."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_listify(node.get(i)) for i in range(max(node) + 1)]
    return type(node)((k, _listify(v)) for k, v in node.items())


def _unflatten(payload: dict[str, np.ndarray]) -> dict[str, Any]:
    root: dict = {}
    for key, arr in payload.items():
        name, path = _parse_key(key)
        if not path:
            root[name] = arr
            continue
        # a node's type follows the kind of segment that indexes into it
        kinds = [kind for kind, _ in path]
        node = root.setdefault(name, Attrs() if kinds[0] == "." else {})
        for (_, seg), next_kind in zip(path[:-1], kinds[1:]):
            node = node.setdefault(seg, Attrs() if next_kind == "." else {})
        node[path[-1][1]] = arr
    return {k: _listify(v) for k, v in root.items()}


def save_checkpoint(path: Path | str, trees: dict[str, Any], meta: dict) -> None:
    """``trees``: named trees of numpy arrays or tensors (e.g. ``{"model":
    convert.to_jax_params(model)}``). Written as one compressed NPZ."""
    _require_npz(path)
    payload: dict[str, np.ndarray] = {}
    for name, tree in trees.items():
        _flatten(tree, name, payload)
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8).copy()
    np.savez_compressed(path, **payload)


def load_meta(path: Path | str) -> dict:
    """Read only the JSON meta of a checkpoint."""
    _require_npz(path)
    with np.load(path) as data:
        return json.loads(bytes(data["__meta__"]).decode("utf-8"))


def load_checkpoint(path: Path | str) -> tuple[dict[str, Any], dict]:
    """Return (trees, meta): every named tree in the file (``model``, and
    ``optG`` / ``optD`` where the trainer saved them) rebuilt as nested dicts,
    :class:`Attrs` and lists of numpy arrays from the stored key paths."""
    _require_npz(path)
    with np.load(path) as data:   # close the zip handle: a server loads many
        meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
        payload = {k: data[k] for k in data.files if k != "__meta__"}
    return _unflatten(payload), meta
