"""eegsynth_torch on a CUDA card: the Hopper GRU kernel against its plain
version, its wrapper's checks, and the serving cascade chunked against
one-shot.

Every test skips without a card: the kernel has no CPU mode. This file
imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_card.py -q
"""

import numpy as np
import pytest
import torch

from eegsynth_torch.models.timegan import TimeGAN, TimeGANConfig
from eegsynth_torch.nn.gru_sequence import gru_sequence, gru_sequence_reference
from eegsynth_torch.train.timegan import synthesize_from_noise

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(T, B, H, device, seed=0):
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((T, B, 3 * H)).astype(np.float32)
    w = (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    b = (rng.standard_normal((1, 3 * H)) * 0.1).astype(np.float32)
    h0 = rng.uniform(-0.5, 0.5, (B, H)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (xp, w, b, h0)]


# serving width, embedder width, H cap with a ragged batch, a batch just
# over one tile per SM, an H that is not a multiple of 32, one step
@pytest.mark.parametrize("T,B,H", [(768, 256, 56), (768, 256, 28),
                                   (1024, 37, 128), (64, 133, 56), (50, 7, 20),
                                   (1, 3, 8)])
def test_kernel_matches_plain(cuda_device, T, B, H):
    inputs = _inputs(T, B, H, cuda_device)
    before = gru_sequence.launches
    got = gru_sequence(*inputs)
    ref = gru_sequence_reference(*inputs)
    torch.cuda.synchronize()
    assert gru_sequence.launches == before + 1
    assert got.shape == (T, B, H) and torch.isfinite(got).all()
    # f32 with another summation order over up to 1024 dependent steps
    assert (got - ref).abs().max().item() <= 1e-4


def test_wrapper_raises_instead_of_falling_back(cuda_device):
    xp, w, b, h0 = _inputs(8, 4, 16, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        gru_sequence(xp.double(), w, b, h0)
    with pytest.raises(ValueError, match="contiguous"):
        gru_sequence(xp, w.t().contiguous().t(), b, h0)
    with pytest.raises(ValueError, match="several devices"):
        gru_sequence(xp, w.cpu(), b, h0)
    with pytest.raises(RuntimeError, match="forward only"):
        gru_sequence(xp.requires_grad_(), w, b, h0)


def test_cascade_chunked_equals_one_shot(cuda_device):
    model = TimeGAN(TimeGANConfig(), generator=torch.Generator().manual_seed(0),
                    device=cuda_device).eval()
    z = torch.rand((16, 3 * 64, 28), generator=torch.Generator().manual_seed(1))
    z = z.to(cuda_device)
    one_shot, _ = synthesize_from_noise(model, z)
    carry, pieces = None, []
    for t0 in range(0, z.shape[1], 64):
        x, carry = synthesize_from_noise(model, z[:, t0:t0 + 64], carry)
        pieces.append(x)
    assert (torch.cat(pieces, 1) - one_shot).abs().max().item() <= 1e-5
