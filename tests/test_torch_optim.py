"""eegsynth_torch's optimizer against optax, as the JAX trainers build it
(``_make_opt`` / ``make_gan_opts``): global-norm clip, Adam and the
multi-step learning rate over 6 updates, per bucket, with the clip firing
and idle; and the state's tree layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegsynth.train import timegan as jtrain
from eegsynth_torch.train import optim as topt
from eegsynth_torch.train.checkpoint import Attrs
from eegsynth_torch.train.timegan import TimeGANHParams
from eegsynth_torch.tree import tree_leaves, tree_map

NB = 3
PARAMS = {"gru": [{"w": (4, 5), "b": (4,)}], "fc": {"w": (1, 4), "u": (1,)}}


def _shaped(rng, scale):
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return (scale * rng.standard_normal((NB, *node))).astype(np.float32)
    return walk(PARAMS)


def topt_hp(hp):
    """The port's hparams with the JAX ones' schedule and clip."""
    return TimeGANHParams(gan_steps=hp.gan_steps, grad_clip=hp.grad_clip)


@pytest.mark.parametrize("clip,grad_scale", [(0.5, 1.0), (100.0, 1.0),
                                             (0.5, 0.06)])
def test_matches_optax_over_six_updates(clip, grad_scale):
    """gan_steps 8 puts the milestones at 4 and 6, inside the 6 updates;
    (0.5, 1.0) clips every update, (100, 1.0) none, (0.5, 0.06) some."""
    hp = jtrain.TimeGANHParams(gan_steps=8, grad_clip=clip)
    params = _shaped(np.random.default_rng(0), 1.0)
    grads = [_shaped(np.random.default_rng(10 + i), grad_scale * (1 + i % 3))
             for i in range(6)]
    with jax.enable_x64(False):
        optD, _ = jtrain.make_gan_opts(hp)
        state = jax.vmap(optD.init)(params)
        p = jax.tree.map(jnp.asarray, params)
        upd = jax.jit(jax.vmap(lambda g, s, p: optD.update(g, s, p)))
        for g in grads:
            u, state = upd(g, state, p)
            p = jax.vmap(lambda a, b: jax.tree.map(lambda x, y: x + y, a, b))(p, u)

    tD, _ = topt.make_gan_opts(topt_hp(hp))
    tp = tree_map(torch.from_numpy, params)
    ts = tD.init(tp)
    norms = []
    for g in grads:
        gt = tree_map(torch.from_numpy, g)
        norms.append(torch.sqrt(sum(x.pow(2).reshape(NB, -1).sum(1)
                                    for x in tree_leaves(gt))))
        tp, ts = tD.update(gt, ts, tp)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for a, b in zip(tree_leaves(ts.mu) + tree_leaves(ts.nu),
                    jax.tree.leaves(state[1][0].mu) + jax.tree.leaves(state[1][0].nu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-9)
    assert ts.count == 6 and np.all(np.asarray(state[1][0].count) == 6)
    assert np.all(np.asarray(state[1][1].count) == 6)
    fired = torch.stack(norms) >= clip
    if (clip, grad_scale) == (0.5, 1.0):
        assert fired.all()
    elif clip == 100.0:
        assert not fired.any()
    else:
        assert fired.any() and not fired.all()


def test_multistep_lr():
    sched = topt._multistep_lr(1e-3, (4, 6))
    jsched = jtrain._multistep_lr(1e-3, (4, 6))
    for c in range(9):
        assert sched(c) == pytest.approx(float(jsched(c)))
    assert [sched(c) for c in (0, 3, 4, 5, 6, 100)] == \
        [1e-3, 1e-3, 5e-4, 5e-4, 2.5e-4, 2.5e-4]


def test_state_tree_layout():
    """The state tree flattens to optax's key paths; a constant rate (the AE
    and SUP phases) has no schedule count, as optax's EmptyState."""
    from eegsynth_torch.train.checkpoint import _flatten
    params = tree_map(torch.from_numpy, _shaped(np.random.default_rng(1), 1.0))
    hp = jtrain.TimeGANHParams(gan_steps=8)
    with jax.enable_x64(False):
        optD, _ = jtrain.make_gan_opts(hp)
        jstate = optD.init(jax.tree.map(lambda a: np.asarray(a[0]), params))
        want = sorted("optD" + jax.tree_util.keystr(k) for k, _ in
                      jax.tree_util.tree_flatten_with_path(jstate)[0])
    tD, _ = topt.make_gan_opts(topt_hp(hp))
    tree = tD.state_tree(tD.init(params))
    assert tree[0] is None and isinstance(tree[1][0], Attrs)
    out = {}
    _flatten(tree_map(lambda t: t[0].numpy(), tree), "optD", out)
    assert sorted(out) == want
    assert out["optD[1][0].count"].dtype == np.int32
    const = topt.Optimizer(1e-3, 0.5, 0.5, 0.9)
    assert const.state_tree(const.init(params))[1][1] is None
