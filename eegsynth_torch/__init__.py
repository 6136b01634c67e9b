"""eegsynth_torch — PyTorch / CUDA port of the ``eegsynth`` package.

The JAX package ``eegsynth`` is the reference: every module here mirrors its
counterpart by path and name (``eegsynth_torch/nn/gru.py`` ←
``eegsynth/nn/gru.py`` …) and is tested against it on the same parameters
and inputs. This package imports ``torch`` and never ``jax``, and nothing
from ``eegsynth`` (whose ``__init__`` pulls in jax).

Plain tensor code is PyTorch; each Pallas TPU kernel of the reference becomes
a kernel written by hand for Hopper (``csrc/``), built at first use by
``eegsynth_torch._build``. Every kernel wrapper runs its plain PyTorch version
for CPU tensors and launches the kernel (or raises) for CUDA tensors.

Library code takes an explicit ``device`` and explicit ``torch.Generator``s;
nothing defaults to CUDA or to the CPU on its own.
"""

import torch

# The reference computes in float32. TF32 keeps about 3 decimal digits, which
# is far outside the tolerances the port is held to, so float32 matrix
# products and convolutions run in full float32 on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EPOC_CHANNELS = [
    "AF3", "F7", "F3", "FC5", "T7", "P7", "O1",
    "O2", "P8", "T8", "FC6", "F4", "F8", "AF4",
]
"""Canonical Emotiv EPOC+ channel order, a copy of ``eegsynth.EPOC_CHANNELS``
(the JAX package's ``__init__`` imports jax)."""
