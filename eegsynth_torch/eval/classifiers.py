"""Post-hoc GRU discriminative and predictive scores (TSTR / TRTS).

Counterpart of ``eegsynth/eval/classifiers.py``: a one-layer GRU(24) with a
linear head on its last step, trained by full-batch Adam, scores real against
fake (20 epochs, accuracy and AUC) or regresses a window's last step from the
steps before it (50 epochs, RMSE and R²). The GRU is
``eegsynth_torch.nn.gru.gru_apply``, so on the card every epoch runs kernel
K1's forward and backward once.

The scorers of a batch call train together: tasks whose training rows,
targets and test rows have the same shapes form one group, stacked on K1's
bucket axis (nb = tasks, B = rows), so a group costs one K1 forward and one
backward launch an epoch, and one forward for its test rows. The host
protocol (permutations, stratified split, initial weights, metrics) is the
JAX package's per task, with the split and metrics from
``eegsynth_torch.eval.protocol``.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from eegsynth_torch.eval.protocol import (
    accuracy_score, mean_squared_error, r2_score, roc_auc_score, train_test_split,
)
from eegsynth_torch.nn.gru import GRULayer, gru_apply
from eegsynth_torch.nn.layers import linear
from eegsynth_torch.train.optim import Adam
from eegsynth_torch.tree import tree_map


def _rnn_head_init(seed: int, input_dim: int, hidden: int, out_dim: int) -> dict:
    """torch's default init, every parameter ~ U(±1/√hidden), drawn on the
    host from a ``torch.Generator`` seeded with ``seed``; the JAX package's
    tree ``{"gru": [{w_ih, w_hh, b_ih, b_hh}], "out": {w, b}}``."""
    g = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(hidden)

    def u(*shape):
        return torch.empty(shape).uniform_(-bound, bound, generator=g)

    return {"gru": [{"w_ih": u(3 * hidden, input_dim), "w_hh": u(3 * hidden, hidden),
                     "b_ih": u(3 * hidden), "b_hh": u(3 * hidden)}],
            "out": {"w": u(out_dim, hidden), "b": u(out_dim)}}


def scorer_params_from_jax(tree: Any, *, device: torch.device | str = "cpu") -> Any:
    """A scorer's parameter tree from the JAX package (numpy or JAX arrays,
    as its ``_rnn_head_init`` makes them) → float32 tensors on ``device``."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                                           device=device), tree)


def _forward_last(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The GRU over x (…, B, T, in), then the head on its last step:
    (…, B, out). Leading axes of ``x`` are the parameters' stacked axes."""
    layer = params["gru"][0]
    y = gru_apply(GRULayer(layer["w_ih"], layer["w_hh"], layer["b_ih"],
                           layer["b_hh"]), x)
    return linear(y[..., -1, :], params["out"]["w"], params["out"]["b"])


def _loss(out: torch.Tensor, y: torch.Tensor, classify: bool) -> torch.Tensor:
    """Per scorer (the leading axes): the binary cross-entropy of
    sigmoid(out) with log terms clipped at -100, or the mean squared error
    over rows and outputs."""
    if classify:
        prob = torch.sigmoid(out)
        logp = torch.clamp(torch.log(prob), min=-100.0)
        log1mp = torch.clamp(torch.log1p(-prob), min=-100.0)
        return -(y * logp + (1 - y) * log1mp).sum(dim=(-2, -1)) / y.shape[-2]
    return ((out - y) ** 2).sum(dim=(-2, -1)) / (y.shape[-2] * y.shape[-1])


def _train_core(params: dict, X: torch.Tensor, y: torch.Tensor, epochs: int,
                lr: float, classify: bool) -> tuple[dict, torch.Tensor]:
    """``epochs`` full-batch Adam steps (optax's b1 0.9, b2 0.999, eps 1e-8)
    on X (…, B, T, in), y (…, B, out). Returns the trained parameters and the
    losses (epochs, …) before each step."""
    opt = Adam(lr, 0.9, 0.999)
    state = opt.init(params)
    losses = []
    for _ in range(epochs):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = _loss(_forward_last(p, X), y, classify)
        loss.sum().backward()
        params, state = opt.update(tree_map(lambda t: t.grad, p), state, params)
        losses.append(loss.detach())
    return params, torch.stack(losses)


def _run_grouped(tasks: list[dict], epochs: int, lr: float, classify: bool,
                 device: torch.device | str) -> list[np.ndarray]:
    """Each task: {params, Xtr, ytr, Xte}. Tasks with the same shapes of
    (Xtr, ytr, Xte) train as one stack on ``device``. Returns each task's
    outputs on its test rows, as host arrays, in input order."""
    out: list = [None] * len(tasks)
    groups: dict = {}
    for i, t in enumerate(tasks):
        key = (t["Xtr"].shape, t["ytr"].shape, t["Xte"].shape)
        groups.setdefault(key, []).append(i)
    for idxs in groups.values():
        params = tree_map(lambda *ls: torch.stack(ls).to(device),
                          *[tasks[i]["params"] for i in idxs])

        def stack(name):
            return torch.from_numpy(np.stack(
                [np.asarray(tasks[i][name], np.float32) for i in idxs])).to(device)

        params, _ = _train_core(params, stack("Xtr"), stack("ytr"), epochs, lr,
                                classify)
        with torch.no_grad():
            res = _forward_last(params, stack("Xte")).cpu().numpy()
        for j, i in enumerate(idxs):
            out[i] = res[j]
    return out


def discriminative_task(real: np.ndarray, fake: np.ndarray, hidden: int = 24,
                        seed: int = 0) -> tuple[dict, np.ndarray]:
    """One real-vs-fake classifier's task for :func:`_run_grouped` and its
    test labels: n = min counts, the first n of a seeded permutation of each
    corpus, labels 1 (real) and 0 (fake), a 70/30 stratified split."""
    n = min(len(real), len(fake))
    idx_r = np.random.RandomState(seed).permutation(len(real))[:n]
    idx_f = np.random.RandomState(seed + 1).permutation(len(fake))[:n]
    X = np.concatenate([real[idx_r], fake[idx_f]], axis=0).astype(np.float32)
    y = np.concatenate([np.ones(n), np.zeros(n)]).astype(np.float32)
    Xtr, Xte, ytr, yte = train_test_split(X, y, test_size=0.3, random_state=seed)
    return ({"params": _rnn_head_init(seed, X.shape[-1], hidden, 1),
             "Xtr": Xtr, "ytr": ytr[:, None], "Xte": Xte}, yte)


def discriminative_scores_batch(pairs: list[tuple[np.ndarray, np.ndarray]],
                                epochs: int = 20, lr: float = 1e-3,
                                hidden: int = 24, seed: int = 0,
                                device: torch.device | str = "cuda") -> list[tuple]:
    """(accuracy, AUC) of a balanced real-vs-fake GRU classifier for each
    (real, fake) pair (:func:`discriminative_task`), trained by full-batch
    Adam."""
    tasks, truths = zip(*(discriminative_task(real, fake, hidden, seed)
                          for real, fake in pairs))
    results = []
    for yte, logits in zip(truths, _run_grouped(list(tasks), epochs, lr, True,
                                                device)):
        p = (1.0 / (1.0 + np.exp(-logits))).ravel()
        results.append((accuracy_score(yte, (p >= 0.5).astype(int)),
                        roc_auc_score(yte, p)))
    return results


def predictive_scores_batch(tasks_in: list[tuple], epochs: int = 50,
                            lr: float = 1e-3, hidden: int = 24, seed: int = 0,
                            device: torch.device | str = "cuda") -> list[tuple]:
    """(RMSE, R²) of a GRU regressor for each (X_train, y_train, X_test,
    y_test) task; the TSTR / TRTS wiring stays with the callers."""
    tasks, truths = [], []
    for X_train, y_train, X_test, y_test in tasks_in:
        tasks.append({"params": _rnn_head_init(seed, X_train.shape[-1], hidden,
                                               y_train.shape[-1]),
                      "Xtr": X_train, "ytr": y_train, "Xte": X_test})
        truths.append(np.asarray(y_test))
    results = []
    for y_test, yhat in zip(truths, _run_grouped(tasks, epochs, lr, False, device)):
        results.append((float(np.sqrt(mean_squared_error(y_test, yhat))),
                        r2_score(y_test, yhat)))
    return results


def discriminative_score(real: np.ndarray, fake: np.ndarray, epochs: int = 20,
                         lr: float = 1e-3, hidden: int = 24, seed: int = 0,
                         device: torch.device | str = "cuda"):
    """Single-pair wrapper over :func:`discriminative_scores_batch`."""
    return discriminative_scores_batch([(real, fake)], epochs=epochs, lr=lr,
                                       hidden=hidden, seed=seed, device=device)[0]


def predictive_score(X_train: np.ndarray, y_train: np.ndarray,
                     X_test: np.ndarray, y_test: np.ndarray, epochs: int = 50,
                     lr: float = 1e-3, hidden: int = 24, seed: int = 0,
                     device: torch.device | str = "cuda"):
    """Single-task wrapper over :func:`predictive_scores_batch`."""
    return predictive_scores_batch([(X_train, y_train, X_test, y_test)],
                                   epochs=epochs, lr=lr, hidden=hidden, seed=seed,
                                   device=device)[0]
