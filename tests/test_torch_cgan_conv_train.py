"""One conv-CGAN step of eegsynth_torch against eegsynth's, on the CPU:
``cgan_step`` against ``make_cgan_epoch(..., 1, ...)`` on the same
parameters, data and JAX's replayed draws (``replay_draws`` of
``test_torch_cgan_train.py``) at CGANConfig(init_len=3, seq_len=96),
local_crop 32, B 4: v1 hinge with R1 firing and with R1 off. The v2 steps
(one at T 768 with the coherence loss on) are in
``test_torch_cgan_conv_step.py``, two D updates in
``test_torch_cgan_conv_d_steps.py``, the bfloat16 D update in
``test_torch_cgan_conv_bf16.py`` (one JAX compile of about a minute a
case on one core, so a file holds at most two), files, resume, the CLI
and serving in ``test_torch_cgan_conv_io.py``; the step helpers here serve
them all. The tolerances are ``test_torch_cgan_train.py``'s (``check_step``),
and the bn statistics are held within 1e-6.

The coherence loss is off in the steps at T 96 (``coh_weight=0``). There
its float32 gradient is ill-conditioned (``num / den`` of two nearly equal
magnitudes): JAX's own float32 gradient differs from its float64 value by
more than the first moments' 1e-5 of their scale (1.6e-4 on random
inputs), while the two packages agree in float64 within 1e-9 (both pinned
in ``test_torch_cgan_conv.py``). One v2 step at T 768 holds it on.

JAX runs with x64 off: float32 on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_cgan_train import check_step, replay_draws

from eegsynth.data.datasets import build_label_table
from eegsynth.train import cgan as J
from eegsynth_torch.convert import tree_to_numpy
from eegsynth_torch.train import cgan as P
from eegsynth_torch.tree import tree_leaves

B, C = 4, 14
SMALL = dict(init_len=3, seq_len=96)
SIGMA = 0.15
# JAX's step compiled without LLVM's optimisation passes: the same XLA
# program and float semantics (no fast-math either way), a third of the
# compile time on one core
JAX_COMPILE = {"xla_backend_optimization_level": 0,
               "xla_llvm_disable_expensive_passes": True}
# The bn running statistics after a step: within BN_ATOL of their largest
# magnitude (at least 1); the conv ``u`` vectors, parameter leaves of the
# JAX tree, within the parameters' 2e-6 (PARAM_ATOL).
BN_ATOL, U_ATOL = 1e-6, 2e-6


def _cfg(mod, hp, K, size=SMALL):
    return dataclasses.replace(mod.build_cfg(hp, K), **size)


def run_conv_step_pair(variant="v1", prewarm=False, size=SMALL, **over):
    """The same conv step in both packages from the port's seeded init at
    ``size`` (``init_len``, ``seq_len``), the coherence loss off unless
    ``over`` sets it (module docstring). Returns (port outputs, JAX
    outputs, port hp, ``step``); ``step(hp, n_d)`` reruns the port's step
    on the same inputs with another hp, or with only the first ``n_d`` D
    updates' draws."""
    K, base = (9, 1) if variant == "v1" else (2, 0)
    kw = {**(J.V2_OVERRIDES if variant == "v2" else {}), "batch_size": B,
          "local_crop": 32, "variant": variant, "coh_weight": 0.0, **over}
    hp, thp = J.CGANHParams(**kw), P.CGANHParams(**kw)
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (4 * K, C, size["seq_len"])).astype(np.float32)
    tab, cnt = build_label_table(np.repeat(np.arange(base, base + K), 4), K, base)
    tcfg = _cfg(P, thp, K, size)
    gen = torch.Generator().manual_seed(1)
    tG, tbn = P.generator_init(tcfg, gen, device="cpu")
    tD = {k: P.disc_init(tcfg, gen, device="cpu") for k in ("dg", "dl")}
    with jax.enable_x64(False):
        cfg = _cfg(J, hp, K, size)
        G, bn, D = (jax.tree.map(jnp.asarray, tree_to_numpy(t)) for t in (tG, tbn, tD))
        optG = optax.adam(hp.lr_g, b1=hp.beta1, b2=hp.beta2)
        optD = optax.adam(hp.lr_d, b1=hp.beta1, b2=hp.beta2)
        key = jax.random.key(5)
        args = (G, bn, D, G, jax.jit(optG.init)(G), jax.jit(optD.init)(D), jnp.asarray(X),
                jnp.asarray(tab), jnp.asarray(cnt, jnp.float32), jnp.float32(SIGMA), key)
        want = J.make_cgan_epoch(cfg, hp, optG, optD, 1, prewarm=prewarm).lower(
            *args).compile(compiler_options=JAX_COMPILE)(*args)
        draws = replay_draws(key, hp, cfg, tab, cnt, prewarm)

    def step(h=thp, n_d=None):
        oG, oD = P.Adam(h.lr_g, h.beta1, h.beta2), P.Adam(h.lr_d, h.beta1, h.beta2)
        dr = draws if n_d is None else dataclasses.replace(draws, d=draws.d[:n_d])
        return P.cgan_step(tG, tbn, tD, tG, oG.init(tG), oD.init(tD), torch.from_numpy(X),
                           dr, 0, float(np.float32(SIGMA)), cfg=tcfg, hp=h, optG=oG,
                           optD=oD, prewarm=prewarm)

    return step(), want, thp, step


def check_conv_state(got, want):
    """The bn statistics and the five conv ``u`` of both discriminators."""
    for a, b in zip(tree_leaves(got[1]), jax.tree.leaves(want[1])):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=BN_ATOL * max(1.0, np.abs(b).max()))
    for net in ("dg", "dl"):
        for i in range(1, 6):
            np.testing.assert_allclose(got[2][net][f"c{i}"]["u"].numpy(),
                                       np.asarray(want[2][net][f"c{i}"]["u"]),
                                       atol=U_ATOL)


@pytest.mark.parametrize("r1_gamma", [0.5, 0.0])
def test_v1_conv_step_matches_jax(r1_gamma):
    """R1 fires at step index 0 (r1_gamma 0.5) or is off (0.0)."""
    got, want, hp, _ = run_conv_step_pair("v1", r1_gamma=r1_gamma)
    check_step(got, want, hp)
    check_conv_state(got, want)
