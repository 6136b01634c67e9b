"""eegsynth_torch GRU: the plain recurrence and gru_apply against the JAX
package (Pallas kernel K1 in interpret mode, and the XLA scan), the CPU
wrapper path. The kernel itself is checked on the card by
tests/test_torch_card.py and chip_smoke.py."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_threads import one_thread_each  # noqa: F401

from eegsynth.nn.gru import gru_apply as jax_gru_apply
from eegsynth.nn.gru import gru_init
from eegsynth.nn.pallas_gru import gru_apply_pallas
from eegsynth.nn.pallas_gru import gru_sequence as jax_gru_sequence
from eegsynth_torch.nn.gru import GRU, GRULayer, gru_apply
from eegsynth_torch.nn.gru_sequence import gru_sequence, gru_sequence_reference

ROOT = Path(__file__).resolve().parent.parent


def _seq_inputs(rng, T, B, H):
    xp = rng.standard_normal((T, B, 3 * H)).astype(np.float32)
    w = (rng.standard_normal((H, 3 * H)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((1, 3 * H)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((B, H)).astype(np.float32)
    return xp, w, b, h0


def _layer(params) -> GRULayer:
    return GRULayer(*(torch.from_numpy(np.array(params[k], np.float32))
                      for k in ("w_ih", "w_hh", "b_ih", "b_hh")))


@pytest.mark.parametrize("T,B,H", [(9, 2, 4), (37, 4, 28), (16, 3, 56), (20, 5, 24)])
def test_reference_matches_pallas_interpret(T, B, H):
    """K1's plain version against the Pallas kernel, nonzero h0."""
    inputs = _seq_inputs(np.random.default_rng(T), T, B, H)
    ref = jax_gru_sequence(*(jnp.asarray(a) for a in inputs), True)
    got = gru_sequence_reference(*(torch.from_numpy(a) for a in inputs))
    assert got.shape == (T, B, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def _sigmoid_fwd(x):
    return (np.float32(0.5) * np.tanh(np.float32(0.5) * x) + np.float32(0.5)).astype(
        np.float32)


def _kernel_sum_order(xp, w, b, h0):
    """K1 forward's arithmetic in the Hopper kernel's order
    (eegsynth_torch/csrc/gru_seq.cu), in numpy float32: each of S lanes sums
    a KL-long k-slice of h W_hhᵀ as a chain of multiply-adds from zero (h and
    W padded with zeros past H), the S partial sums are added pairwise at
    distance S/2, then S/4, ... (the shuffle butterfly), then b_hh, then the
    gates, with the kernel's sigmoid 1/2 + tanh(x/2)/2. A multiply-add is
    rounded once from float64, as fmaf is (within double rounding)."""
    T, B, G = xp.shape
    H = G // 3
    kl = 16 if H <= 64 else 32 if H <= 96 else 64
    s = 1
    while s * kl < H:
        s *= 2
    w_pad = np.zeros((s * kl, G), np.float32)
    w_pad[:H] = w
    w_sl = w_pad.reshape(s, kl, G).astype(np.float64)
    h = h0.astype(np.float32)
    ys = np.empty((T, B, H), np.float32)
    for t in range(T):
        h_pad = np.zeros((B, s * kl), np.float32)
        h_pad[:, :H] = h
        h_sl = h_pad.reshape(B, s, kl).transpose(1, 0, 2).astype(np.float64)
        part = np.zeros((s, B, G), np.float32)
        for k in range(kl):
            part = (h_sl[:, :, k, None] * w_sl[:, None, k, :] + part).astype(np.float32)
        while len(part) > 1:
            half = len(part) // 2
            part = part[:half] + part[half:]
        acc = part[0]
        x = xp[t]
        r = _sigmoid_fwd(x[:, :H] + (acc[:, :H] + b[0, :H]))
        z = _sigmoid_fwd(x[:, H:2 * H] + (acc[:, H:2 * H] + b[0, H:2 * H]))
        n = np.tanh(x[:, 2 * H:] + r * (acc[:, 2 * H:] + b[0, 2 * H:]))
        h = ((1 - z) * n + z * h).astype(np.float32)
        ys[t] = h
    return ys


# the H cap (KL 64, S 2) over 1024 steps; the serving width (KL 16, S 4);
# the wide model's h80 (KL 32, S 4)
@pytest.mark.parametrize("T,B,H", [(1024, 5, 128), (768, 4, 56), (768, 3, 80)])
def test_kernel_sum_order_matches_reference(T, B, H):
    """The kernel's summation order (sliced k, zero padding, butterfly) stays
    within the card tests' 1e-4 of the plain recurrence: f32 sums in another
    order over up to 1024 dependent steps."""
    inputs = list(_seq_inputs(np.random.default_rng(T + H), T, B, H))
    inputs[1] /= np.float32(0.3 * np.sqrt(H))    # W ~ 1/sqrt(H), as at init
    got = _kernel_sum_order(*inputs)
    ref = gru_sequence_reference(*(torch.from_numpy(a) for a in inputs))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-4)


def test_kernel_sum_order_matches_pallas_interpret():
    """The same order against the Pallas kernel in interpret mode at H 20
    (KL 16, S 2: 12 zero-padded k)."""
    T, B, H = 16, 3, 20
    inputs = _seq_inputs(np.random.default_rng(T), T, B, H)
    ref = jax_gru_sequence(*(jnp.asarray(a) for a in inputs), True)
    np.testing.assert_allclose(_kernel_sum_order(*inputs), np.asarray(ref),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("B,T,I,H", [(4, 37, 14, 28), (2, 16, 28, 56)])
def test_gru_apply_matches_jax(impl, B, T, I, H):
    rng = np.random.default_rng(1)
    params = gru_init(jax.random.key(0), I, H)
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    h0 = rng.standard_normal((B, H)).astype(np.float32)
    if impl == "pallas":
        ref = gru_apply_pallas(params, jnp.asarray(x), jnp.asarray(h0),
                               interpret=True)
    else:
        ref = jax_gru_apply(params, jnp.asarray(x), jnp.asarray(h0), impl="xla")
    got = gru_apply(_layer(params), torch.from_numpy(x), torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_gru_module_matches_torch_gru():
    """Parameter names and gate math follow torch.nn.GRU (2 layers)."""
    g = torch.Generator().manual_seed(0)
    ours = GRU(5, 8, num_layers=2, generator=g, device="cpu")
    ref = torch.nn.GRU(5, 8, num_layers=2, batch_first=True)
    ref.load_state_dict(ours.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 11, 5))
                         .astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(ours(x).numpy(), ref(x)[0].numpy(), atol=2e-6)


def test_cpu_wrapper_never_launches():
    """On CPU tensors the wrapper is the plain version and never touches the
    kernel: the launch counter stays where it was."""
    inputs = [torch.from_numpy(a) for a in
              _seq_inputs(np.random.default_rng(3), 12, 3, 8)]
    before = gru_sequence.launches
    got = gru_sequence(*inputs)
    assert gru_sequence.launches == before
    assert torch.equal(got, gru_sequence_reference(*inputs))


def test_wrapper_rejects_bad_shapes():
    xp, w, b, h0 = (torch.from_numpy(a) for a in
                    _seq_inputs(np.random.default_rng(4), 5, 2, 4))
    with pytest.raises(ValueError, match="b_hh"):
        gru_sequence(xp, w, b[0], h0)
    with pytest.raises(ValueError, match="h0"):
        gru_sequence(xp, w, b, h0[:1])


def test_port_imports_without_jax():
    code = ("import eegsynth_torch, eegsynth_torch.serve, "
            "eegsynth_torch.train.timegan; import sys; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_no_module_imports_jax():
    for src in (ROOT / "eegsynth_torch").rglob("*.py"):
        text = src.read_text()
        assert "import jax" not in text and "from jax" not in text, src
        assert "from eegsynth." not in text and "import eegsynth\n" not in text, src
