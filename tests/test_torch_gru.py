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


@pytest.mark.parametrize("T,B,H", [(9, 2, 4), (37, 4, 28), (16, 3, 56)])
def test_reference_matches_pallas_interpret(T, B, H):
    """K1's plain version against the Pallas kernel, nonzero h0."""
    inputs = _seq_inputs(np.random.default_rng(T), T, B, H)
    ref = jax_gru_sequence(*(jnp.asarray(a) for a in inputs), True)
    got = gru_sequence_reference(*(torch.from_numpy(a) for a in inputs))
    assert got.shape == (T, B, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


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
