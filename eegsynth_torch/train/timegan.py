"""TimeGAN synthesis: Z → decode(refine(gen(Z))).

Counterpart of ``synthesize`` in ``eegsynth/train/timegan.py`` (training is
not ported yet). Only ``precision="f32"`` is supported; the JAX ``mesh``
option has no counterpart on one card.
"""

from __future__ import annotations

import numpy as np
import torch

from eegsynth_torch.models.timegan import (
    Carry, TimeGAN, _fusable, cascade_init_carry, fused_gen_refine,
    gen_refine_carry, sample_noise,
)


@torch.inference_mode()
def synthesize_from_noise(model: TimeGAN, z: torch.Tensor,
                          carry: Carry | None = None):
    """One dispatch of the synthesis cascade on given noise z (B, T, z_dim).

    Returns ``(x_hat (B, T, C), carry_out)``; ``carry=None`` starts from zero
    hidden states (the JAX ``_synth_run``), a carry continues a chunked run
    (``_synth_step``). Multi-layer stacks take the composed path, one-shot
    only, and return ``carry_out=None``."""
    if not _fusable(model):
        if carry is not None:
            raise ValueError("a carried state needs single-layer GRU stacks")
        return fused_gen_refine(model, z, with_decode=True)[1], None
    if carry is None:
        carry = cascade_init_carry(model, z.shape[0], device=z.device)
    carry, (_, x_hat) = gen_refine_carry(model, z, carry, with_decode=True)
    return x_hat, carry


@torch.inference_mode()
def synthesize(model: TimeGAN, n: int, seq_len: int, *,
               generator: torch.Generator, batch: int | None = None,
               time_chunk: int | None = None,
               precision: str = "f32") -> np.ndarray:
    """``n`` windows of ``seq_len`` steps as a float32 numpy array (n, seq_len, C).

    Noise is U[0,1) drawn from ``generator``, which must live on the model's
    device. ``batch`` micro-batches n at one fixed shape: every micro-batch
    draws a full ``batch`` of noise and the last is sliced. ``time_chunk``
    streams the sequence axis with the GRU hidden states carried across
    fixed-(batch, time_chunk) dispatches; the last chunk draws a full
    ``time_chunk`` of noise, then slices. Chunk outputs land on the host, so
    device memory stays bounded at one chunk. The same generator state
    reproduces outputs only for identical (n, seq_len, batch, time_chunk).
    Multi-layer stacks run one-shot."""
    if precision != "f32":
        raise NotImplementedError(f"precision={precision!r}: only 'f32' "
                                  "synthesis is ported")
    device = next(model.parameters()).device
    z_dim = model.cfg.z_dim
    chunked = (time_chunk is not None and time_chunk < seq_len
               and _fusable(model))

    def run_batch(b: int) -> np.ndarray:
        if not chunked:
            z = sample_noise(generator, b, seq_len, z_dim, device=device)
            return synthesize_from_noise(model, z)[0].cpu().numpy()
        carry, pieces = None, []
        for t0 in range(0, seq_len, time_chunk):
            z = sample_noise(generator, b, time_chunk, z_dim, device=device)
            x, carry = synthesize_from_noise(model, z, carry)
            pieces.append(x[:, :min(time_chunk, seq_len - t0)].cpu().numpy())
        return np.concatenate(pieces, axis=1)

    if batch is None or batch >= n:
        return run_batch(n)
    return np.concatenate([run_batch(batch)[:min(batch, n - i)]
                           for i in range(0, n, batch)], axis=0)
