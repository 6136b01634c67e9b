"""The v2 conv-CGAN step of eegsynth_torch against eegsynth's, on the CPU
(condition-conditional, Dropout(0.1) on the 512 head features with JAX's
own keep masks, prewarm): with and without prewarm, from
``test_torch_cgan_conv_train.py``'s helpers and tolerances; one step at
the full length, T 768, with v2's coherence loss on; and that loss's
gradient into the generator on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cgan_conv_train import J, check_conv_state, run_conv_step_pair
from test_torch_cgan_train import check_step

from eegsynth.data.datasets import build_label_table
from eegsynth.losses import spectral as JS
from eegsynth.models import cgan as JM
from eegsynth_torch.convert import tree_to_numpy
from eegsynth_torch.losses import spectral as PS
from eegsynth_torch.train import cgan as P
from eegsynth_torch.tree import tree_leaves, tree_map

# The conv biases ahead of the five class-conditional BNs: their gradient is
# zero in exact arithmetic (train-mode BN removes any per-channel shift)
BN_BIASES = tuple(f"up{i}.conv.b" for i in range(1, 6))


@pytest.mark.parametrize("prewarm", [True, False])
def test_v2_conv_step_matches_jax(prewarm):
    """v2 with JAX's keep masks at the conv features' width (512); a
    prewarm step updates no D and advances bn once."""
    got, want, hp, _ = run_conv_step_pair("v2", prewarm=prewarm)
    check_step(got, want, hp)
    check_conv_state(got, want)
    if prewarm:
        assert torch.count_nonzero(got[-1][:8]) == 0 and got[-1][9] == 0


def test_v2_conv_step_with_coherence_matches_jax():
    """v2 at T 768 (init_len 24) with the coherence loss at v2's weight,
    on the 24 channel pairs JAX drew for the step: its gradient reaches the
    generator through every block. At this length the float32 coherence
    gradient is well conditioned. Over 4·768 samples the BN biases' zero
    gradient rounds to about 1e-6, so they are held through their moments
    (``g_zero_grad``)."""
    got, want, hp, _ = run_conv_step_pair("v2", size=dict(init_len=24, seq_len=768),
                                          coh_weight=J.V2_OVERRIDES["coh_weight"])
    assert hp.coh_weight > 0
    check_step(got, want, hp, g_zero_grad=BN_BIASES)
    check_conv_state(got, want)



def test_v2_coherence_gradient_into_the_generator_matches_jax():
    """The coherence term of v2's G loss alone, differentiated in every
    generator leaf (train mode, T 768, B 4), on one step's own draws: JAX's
    key splits replayed for z, labels, rows and the 24 channel pairs, which
    are the pairs JAX's ``coh_loss_random`` draws from the same key. In the
    whole step this gradient is too small to show on random data, and in
    float32 it is ill-conditioned at this length too (num / den of two
    nearly equal magnitudes: each package's float32 gradient is off its
    float64 value by about 1 % of its scale). So it is held in float64:
    the two packages within 1e-9 of the largest gradient."""
    from test_torch_cgan_train import replay_draws

    kw = {**J.V2_OVERRIDES, "batch_size": 4}
    hp, thp = J.CGANHParams(**kw), P.CGANHParams(**kw)
    X = np.random.default_rng(3).uniform(0, 1, (8, 14, 768))
    tab, cnt = build_label_table(np.repeat(np.arange(2), 4), 2, 0)
    tcfg = P.build_cfg(thp, 2)
    tG, tbn = P.generator_init(tcfg, torch.Generator().manual_seed(2), device="cpu")
    key = jax.random.key(6)
    with jax.enable_x64(False):
        cfg = J.build_cfg(hp, 2)
        draws = replay_draws(key, hp, cfg, tab, cnt, False).g
        coh_key = jax.random.split(key, 21)[20]          # ks[19] of the step
        perm = np.asarray(jax.random.permutation(coh_key, len(JS.ALL_PAIRS)))
        assert np.array_equal(draws.pairs.numpy(), JS.ALL_PAIRS[perm[:hp.coh_pairs]])
    real, z = X[draws.rows.numpy()], draws.z.double().numpy()

    with jax.enable_x64(True):
        G, bn = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree_to_numpy(t))
                 for t in (tG, tbn))

        def jloss(G):
            fake = JM.generator_apply(G, bn, jnp.asarray(z), jnp.asarray(
                draws.labels.numpy()), cfg, train=True)[0]
            return hp.coh_weight * JS.coh_loss_random(coh_key, jnp.asarray(real), fake,
                                                      hp.coh_pairs)

        want = [np.asarray(g) for g in jax.tree.leaves(jax.jit(jax.grad(jloss))(G))]
    Gr = tree_map(lambda t: t.double().requires_grad_(), tG)
    fake = P.generator_apply(Gr, tree_map(torch.Tensor.double, tbn), torch.from_numpy(z),
                             draws.labels, tcfg)[0]
    loss = thp.coh_weight * PS.coh_loss_random(draws.pairs, torch.from_numpy(real), fake)
    got = [g.numpy() for g in torch.autograd.grad(loss, tree_leaves(Gr))]
    scale = max(np.abs(w).max() for w in want)
    err = max(np.abs(g - w).max() for g, w in zip(got, want))
    assert err <= 1e-9 * scale, (err, scale)
