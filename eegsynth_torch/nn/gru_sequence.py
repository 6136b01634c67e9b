"""GRU sequence kernel K1: the whole recurrence of one GRU layer in one launch.

Counterpart of ``eegsynth/nn/pallas_gru.py`` (``_gru_seq_pallas`` /
``gru_sequence``). On a CUDA tensor :func:`gru_sequence` launches the Hopper
kernel ``eegsynth_torch/csrc/gru_seq.cu`` (built at first use by
``eegsynth_torch._build``) or raises; on a CPU tensor it runs
:func:`gru_sequence_reference`, the plain PyTorch version, which is also the
oracle the kernel is checked against on the card. Forward only: serving needs
no gradient, and a CUDA call that would need one raises.

Layouts (f32), as the Pallas kernel's: xp (T, B, 3H) with gate order
[r, z, n], w_hh_t (H, 3H) = W_hhᵀ, b_hh (1, 3H), h0 (B, H) → ys (T, B, H).
"""

from __future__ import annotations

import torch

from eegsynth_torch import _build

MAX_HIDDEN = 128
"""Largest H the kernel takes: ``adaptive_dims`` caps h_dim at 128."""


def gru_sequence_reference(xp: torch.Tensor, w_hh_t: torch.Tensor,
                           b_hh: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch recurrence: a Python loop over T running the cell of
    ``eegsynth/nn/pallas_gru.py:_gru_seq_kernel``."""
    H = h0.shape[-1]
    h = h0
    ys = []
    for t in range(xp.shape[0]):
        hp = torch.matmul(h, w_hh_t) + b_hh
        x = xp[t]
        r = torch.sigmoid(x[:, 0:H] + hp[:, 0:H])
        z = torch.sigmoid(x[:, H:2 * H] + hp[:, H:2 * H])
        n = torch.tanh(x[:, 2 * H:3 * H] + r * hp[:, 2 * H:3 * H])
        h = (1.0 - z) * n + z * h
        ys.append(h)
    if not ys:
        return xp.new_empty((0, h0.shape[0], H))
    return torch.stack(ys)


def _check_shapes(xp, w_hh_t, b_hh, h0) -> tuple[int, int, int]:
    if xp.dim() != 3 or xp.shape[2] % 3:
        raise ValueError(f"xp must be (T, B, 3H), got {tuple(xp.shape)}")
    T, B, G = xp.shape
    H = G // 3
    for name, t, shape in (("w_hh_t", w_hh_t, (H, G)), ("b_hh", b_hh, (1, G)),
                           ("h0", h0, (B, H))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return T, B, H


def gru_sequence(xp: torch.Tensor, w_hh_t: torch.Tensor, b_hh: torch.Tensor,
                 h0: torch.Tensor) -> torch.Tensor:
    """Run the recurrence: (T,B,3H), (H,3H), (1,3H), (B,H) → (T,B,H).

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    ``gru_sequence.launches`` counts those launches."""
    T, B, H = _check_shapes(xp, w_hh_t, b_hh, h0)
    devices = {t.device for t in (xp, w_hh_t, b_hh, h0)}
    if len(devices) != 1:
        raise ValueError(f"gru_sequence: inputs on several devices {devices}")
    device = xp.device
    if device.type == "cpu":
        return gru_sequence_reference(xp, w_hh_t, b_hh, h0)
    if device.type != "cuda":
        raise ValueError(f"gru_sequence: no kernel for device {device}")

    for name, t in (("xp", xp), ("w_hh_t", w_hh_t), ("b_hh", b_hh), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"gru_sequence: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gru_sequence: {name} must be contiguous")
    if H > MAX_HIDDEN:
        raise ValueError(f"gru_sequence: H={H} > {MAX_HIDDEN}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp, w_hh_t, b_hh, h0)):
        raise RuntimeError("gru_sequence: the CUDA kernel is forward only; "
                           "run under torch.no_grad() / inference_mode()")

    ys = torch.empty((T, B, H), dtype=torch.float32, device=device)
    if T == 0 or B == 0:
        return ys
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.gru_seq_fwd(xp.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(),
                               h0.data_ptr(), ys.data_ptr(), T, B, H, stream)
    _build.check(lib, "gru_seq_fwd", code)
    gru_sequence.launches += 1
    return ys


gru_sequence.launches = 0
