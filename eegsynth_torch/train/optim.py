"""The trainers' optimizers, with optax semantics.

:class:`Adam` is ``optax.adam(lr, b1, b2)`` on one (unstacked) tree, for the
CGAN trainer: no clip, eps 1e-8 outside the square root, bias correction on
the update count, and a constant rate or a schedule of the update count.
:meth:`Adam.state_tree` gives optax's layout, ``(ScaleByAdamState(count,
mu, nu), EmptyState())``, or ``ScaleByScheduleState(count)`` second when the
rate is scheduled.

The rest of this module serves the TimeGAN trainers, on stacked buckets.

Counterpart of ``_make_opt``, ``_multistep_lr`` and ``make_gan_opts``
(``eegsynth/train/timegan.py:114-132,293-305``):
``optax.chain(clip_by_global_norm(clip), adam(lr, b1, b2))`` per bucket.

- ``clip_by_global_norm``: each bucket's gradients are scaled by
  ``clip / norm`` (computed as ``g / norm * clip``) only when its global norm
  is at least ``clip``. No ``+1e-6`` as in ``torch.nn.utils.clip_grad_norm_``.
- Adam with eps outside the square root and bias correction on the update
  count.
- The learning rate ``init · 0.5^(#milestones ≤ count)`` (``_multistep_lr``),
  where count is the number of updates so far, starting at 0.

Every leaf of the parameter, gradient and moment trees carries a leading
bucket axis; the global norm, the clip and the moments are per bucket. All
buckets take every step together, so the update count is one Python int.
:meth:`Optimizer.state_tree` gives the state in optax's tree layout
(``[1][0].count / .mu / .nu``, and ``[1][1].count`` for a scheduled rate), so
a checkpoint written by the port loads into the JAX package's optimizer
templates; :meth:`Optimizer.restore` reads it back, from either package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from eegsynth_torch.convert import restore_like
from eegsynth_torch.train.checkpoint import Attrs
from eegsynth_torch.tree import tree_leaves, tree_map


def _multistep_lr(init: float, milestones: tuple[int, ...],
                  gamma: float = 0.5) -> Callable[[int], float]:
    """torch MultiStepLR semantics on the update count."""
    def sched(count: int) -> float:
        return init * gamma ** sum(count >= m for m in milestones)
    return sched


@dataclasses.dataclass
class OptState:
    count: int          # updates taken (optax's ScaleByAdamState.count)
    mu: Any             # first moments, the parameters' tree
    nu: Any             # second moments


class Optimizer:
    """Global-norm clip, then Adam, then a (scheduled) learning rate: the
    JAX package's ``_make_opt(lr, clip, beta1, beta2)``."""

    def __init__(self, lr: float | Callable[[int], float], clip: float,
                 b1: float, b2: float, eps: float = 1e-8):
        self.scheduled = callable(lr)
        self.lr = lr if callable(lr) else (lambda count, lr=lr: lr)
        self.clip, self.b1, self.b2, self.eps = clip, b1, b2, eps

    def init(self, params: Any) -> OptState:
        return OptState(0, tree_map(torch.zeros_like, params),
                        tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads: Any, state: OptState, params: Any):
        """One step for every bucket: returns (new params, new state)."""
        leaves = tree_leaves(grads)
        nb = leaves[0].shape[0]
        sq = sum(g.reshape(nb, -1).pow(2).sum(-1) for g in leaves)
        norm = torch.sqrt(sq)                                   # (nb,)
        keep = norm < self.clip

        def clipped(g):
            shape = (nb,) + (1,) * (g.dim() - 1)
            return torch.where(keep.view(shape), g,
                               g / norm.view(shape) * self.clip)

        g = tree_map(clipped, grads)
        b1, b2, count = self.b1, self.b2, state.count + 1
        mu = tree_map(lambda g_, m: (1 - b1) * g_ + b1 * m, g, state.mu)
        nu = tree_map(lambda g_, v: (1 - b2) * g_ ** 2 + b2 * v, g, state.nu)
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        step = -self.lr(state.count)

        def apply(p, m, v):
            return p + step * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps))

        return tree_map(apply, params, mu, nu), OptState(count, mu, nu)

    def state_tree(self, state: OptState) -> list:
        """The state in optax's layout, stacked over buckets:
        ``(EmptyState, (ScaleByAdamState, ScaleByScheduleState | EmptyState))``
        with ``None`` for each empty state."""
        nb = tree_leaves(state.mu)[0].shape[0]
        count = torch.full((nb,), state.count, dtype=torch.int32)
        adam = Attrs(count=count, mu=state.mu, nu=state.nu)
        return [None, [adam, Attrs(count=count.clone()) if self.scheduled else None]]

    def restore(self, tree: list, like: OptState) -> OptState:
        """The inverse of :meth:`state_tree`: optax's layout, as
        ``train.checkpoint.load_checkpoint`` returns it from a checkpoint of
        either package, → an :class:`OptState` shaped like ``like`` (the
        bucket axis added where the checkpoint holds one model, whose count
        is a scalar). ``count`` carries over, so the schedule goes on where
        it stopped."""
        adam = tree[1][0]
        counts = np.unique(np.asarray(adam["count"]))
        if len(counts) != 1:
            raise ValueError(f"buckets at different update counts {counts}")
        return OptState(int(counts[0]), restore_like(like.mu, adam["mu"]),
                        restore_like(like.nu, adam["nu"]))


def make_gan_opts(hp) -> tuple[Optimizer, Optimizer]:
    """(optD, optG): Adam + global-norm clip with the learning rate halved at
    50 % and 75 % of ``gan_steps``."""
    milestones = (hp.gan_steps // 2, int(hp.gan_steps * 0.75))
    optD = Optimizer(_multistep_lr(hp.lr_d, milestones), hp.grad_clip,
                     hp.beta1, hp.beta2)
    optG = Optimizer(_multistep_lr(hp.lr_g, milestones), hp.grad_clip,
                     hp.beta1, hp.beta2)
    return optD, optG


class Adam:
    """``optax.adam(lr, b1, b2)`` on an unstacked tree; ``lr`` is a float or
    a schedule of the update count (``train.cgan.make_lr``).

    Every leaf of the tree has moments, including leaves that receive a zero
    gradient (the spectral-norm ``u`` vectors, which JAX's
    ``stop_gradient`` keeps out of the loss): optax keeps moments for every
    leaf, and the checkpoint layout follows it."""

    def __init__(self, lr: float | Callable[[int], float], b1: float, b2: float,
                 eps: float = 1e-8):
        self.scheduled = callable(lr)
        self.lr = lr if callable(lr) else (lambda count, lr=lr: lr)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Any) -> OptState:
        return OptState(0, tree_map(torch.zeros_like, params),
                        tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads: Any, state: OptState, params: Any):
        """One step: returns (new params, new state)."""
        b1, b2, count = self.b1, self.b2, state.count + 1
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * g ** 2 + b2 * v, grads, state.nu)
        # optax raises the float32 decay to the int32 count in float32
        f32 = np.float32
        bc1, bc2 = float(1 - f32(b1) ** count), float(1 - f32(b2) ** count)
        step = -self.lr(state.count)

        def apply(p, m, v):
            return p + step * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps))

        return tree_map(apply, params, mu, nu), OptState(count, mu, nu)

    def state_tree(self, state: OptState) -> list:
        """The state in optax's layout: ``[ScaleByAdamState,
        ScaleByScheduleState | None]`` (``None`` for the empty state)."""
        count = torch.tensor(state.count, dtype=torch.int32)
        adam = Attrs(count=count, mu=state.mu, nu=state.nu)
        return [adam, Attrs(count=count.clone()) if self.scheduled else None]
