"""The conv CGAN's bfloat16 D update (``precision_d="bf16"``) in
eegsynth_torch against eegsynth's, on the CPU, from
``test_torch_cgan_conv_train.py``'s helpers.

bfloat16 keeps 8 bits (a rounding is up to 2**-8 = 3.9e-3 relative), and
the two packages' CPU backends round the trunk's convolutions and their
backward passes differently. So the bfloat16 step is held by what does not
depend on that rounding, and by its size:

- the logs within BF16_LOG_RTOL relative (one bfloat16 rounding);
- the G step's first moments within BF16_G_MU_ATOL of each leaf's largest
  magnitude (at least 1): the G step is float32, and differs only through
  D's updated parameters;
- each D leaf's first moments: the port's distance from its own float32
  step at most BF16_D_RATIO times JAX's bfloat16 distance from that step
  (both are the bfloat16 trunk's error), and the port's and JAX's
  bfloat16 moments at a cosine of at least BF16_D_COS;
- every parameter, bn statistic and optimizer moment float32 and finite.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_cgan_conv_train import P, run_conv_step_pair

from eegsynth_torch.tree import tree_leaves

BF16_LOG_RTOL = 2.0 ** -8
BF16_G_MU_ATOL = 2e-3
BF16_D_RATIO, BF16_D_COS = 4.0, 0.98


def test_bf16_d_step_matches_jax():
    """precision_d="bf16" in both packages, and the port's float32 step on
    the same inputs as the yardstick of the bfloat16 error."""
    got, want, hp, step = run_conv_step_pair("v1", precision_d="bf16")
    f32 = step(dataclasses.replace(hp, precision_d="f32"))
    G2, bn2, D2, ema2, gs, ds, logs = got
    jlogs = np.asarray(want[-1])[0]
    np.testing.assert_allclose(logs.numpy(), jlogs, rtol=BF16_LOG_RTOL, atol=1e-6)
    for m, mj in zip(tree_leaves(gs.mu), jax.tree.leaves(want[4][0].mu)):
        mj = np.asarray(mj)
        np.testing.assert_allclose(m.numpy(), mj, rtol=0,
                                   atol=BF16_G_MU_ATOL * max(1.0, np.abs(mj).max()))
    for m, mj, m32 in zip(tree_leaves(ds.mu), jax.tree.leaves(want[5][0].mu),
                          tree_leaves(f32[5].mu)):
        m, mj, m32 = m.numpy(), np.asarray(mj), m32.numpy()
        if not np.abs(mj).max() > 0:           # the u vectors: no gradient
            np.testing.assert_array_equal(m, 0)
            continue
        port_err, jax_err = np.abs(m - m32).max(), np.abs(mj - m32).max()
        assert port_err <= BF16_D_RATIO * jax_err + 1e-7, (m.shape, port_err, jax_err)
        cos = float((m * mj).sum() / (np.linalg.norm(m) * np.linalg.norm(mj)))
        assert cos >= BF16_D_COS, (m.shape, cos)
    assert not np.array_equal(ds.mu["dg"]["c1"]["w"].numpy(),
                              f32[5].mu["dg"]["c1"]["w"].numpy())   # bf16 did run
    for t in tree_leaves((G2, bn2, D2, ema2, gs.mu, gs.nu, ds.mu, ds.nu)):
        assert t.dtype == torch.float32 and torch.isfinite(t).all()
    with pytest.raises(ValueError, match="conv"):
        P.CGANHParams(arch="transformer", precision_d="bf16")
