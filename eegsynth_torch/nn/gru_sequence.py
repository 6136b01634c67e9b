"""GRU sequence kernel K1: the whole recurrence of one GRU layer in one launch,
forward and backward, for one model or for nb stacked models (buckets).

Counterpart of ``eegsynth/nn/pallas_gru.py`` (``_gru_seq_pallas``, and the
custom VJP ``_gru_seq_bwd``). :func:`gru_sequence` is differentiable through
:class:`GRUSequence`, whose forward and backward are both kernels on the card
(``eegsynth_torch/csrc/gru_seq.cu``, built at first use by
``eegsynth_torch._build``). On a CPU tensor each half runs its plain PyTorch
version (:func:`gru_sequence_reference`, :func:`gru_sequence_bwd_reference`),
which is also the oracle the kernels are checked against on the card; on a
CUDA tensor it launches the kernel or raises. The backward is first-order
only: a second derivative (R1) takes the plain recurrence of
``eegsynth_torch.nn.gru`` instead.

Layouts (f32), as the Pallas kernel's with an optional leading bucket axis:
xp (nb, T, B, 3H) with gate order [r, z, n], w_hh_t (nb, H, 3H) = W_hhᵀ,
b_hh (nb, 1, 3H), h0 (nb, B, H) → ys (nb, T, B, H). Without the leading axis
the shapes are the Pallas kernel's own.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from eegsynth_torch import _build

MAX_HIDDEN = 128
"""Largest H the kernels take: ``adaptive_dims`` caps h_dim at 128."""


def _gates(x: torch.Tensor, hp: torch.Tensor, H: int):
    r = torch.sigmoid(x[..., 0:H] + hp[..., 0:H])
    z = torch.sigmoid(x[..., H:2 * H] + hp[..., H:2 * H])
    n = torch.tanh(x[..., 2 * H:3 * H] + r * hp[..., 2 * H:3 * H])
    return r, z, n


def gru_sequence_reference(xp: torch.Tensor, w_hh_t: torch.Tensor,
                           b_hh: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch recurrence: a Python loop over T running the cell of
    ``eegsynth/nn/pallas_gru.py:_gru_seq_kernel``. Differentiable (twice) by
    autograd; any leading axes are batch axes."""
    H = h0.shape[-1]
    h = h0
    ys = []
    for t in range(xp.shape[-3]):
        hp = torch.matmul(h, w_hh_t) + b_hh
        _, z, n = _gates(xp[..., t, :, :], hp, H)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    if not ys:
        return xp.new_empty((*xp.shape[:-3], 0, h0.shape[-2], H))
    return torch.stack(ys, dim=-3)


def gru_sequence_bwd_reference(xp, w_hh_t, b_hh, h0, ys, d_ys):
    """Plain PyTorch backward: the exact reverse-time BPTT of
    ``eegsynth/nn/pallas_gru.py:_gru_seq_bwd``, gates recomputed from the
    saved ``ys`` and ``h0``. Returns (dxp, dw_hh_t, db_hh, dh0)."""
    H = h0.shape[-1]
    T = xp.shape[-3]
    dh = torch.zeros_like(h0)
    dw = torch.zeros_like(w_hh_t)
    db = torch.zeros_like(b_hh)
    dxp = torch.empty_like(xp)
    w_hh = w_hh_t.transpose(-1, -2)
    for t in range(T - 1, -1, -1):
        h_prev = h0 if t == 0 else ys[..., t - 1, :, :]
        dh = dh + d_ys[..., t, :, :]
        hp = torch.matmul(h_prev, w_hh_t) + b_hh
        r, z, n = _gates(xp[..., t, :, :], hp, H)
        hn = hp[..., 2 * H:3 * H]
        dz = dh * (h_prev - n)
        dn = dh * (1.0 - z)
        dn_pre = dn * (1.0 - n * n)
        dr_pre = dn_pre * hn * r * (1.0 - r)
        dz_pre = dz * z * (1.0 - z)
        dxp[..., t, :, :] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        dhp = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)
        dw = dw + torch.matmul(h_prev.transpose(-1, -2), dhp)
        db = db + dhp.sum(dim=-2, keepdim=True)
        dh = dh * z + torch.matmul(dhp, w_hh)
    return dxp, dw, db, dh


def _check_shapes(xp, w_hh_t, b_hh, h0) -> tuple[int, int, int, int]:
    """(nb, T, B, H) of stacked inputs; raises on anything else."""
    if xp.dim() != 4 or xp.shape[3] % 3:
        raise ValueError(f"xp must be (nb, T, B, 3H), got {tuple(xp.shape)}")
    nb, T, B, G = xp.shape
    H = G // 3
    for name, t, shape in (("w_hh_t", w_hh_t, (nb, H, G)),
                           ("b_hh", b_hh, (nb, 1, G)), ("h0", h0, (nb, B, H))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return nb, T, B, H


def _device_of(name: str, *tensors: torch.Tensor) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {device}")
    return device


def _check_cuda(name: str, H: int, **tensors: torch.Tensor) -> None:
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if H > MAX_HIDDEN:
        raise ValueError(f"{name}: H={H} > {MAX_HIDDEN}")


def _launch(fn: str, *args) -> None:
    lib = _build.load_library()
    device = next(a for a in args if isinstance(a, torch.Tensor)).device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, fn)(*ptrs, stream)
    _build.check(lib, fn, code)


def forward_tile(nb: int, B: int, H: int) -> dict[str, int]:
    """The forward kernel's tile for (nb, B, H) on the current card: batch
    rows a block, tiles a bucket (the grid is tiles × nb), threads a block,
    the k-slice length KL, the lanes S that split one dot product, and the
    block's shared bytes."""
    lib = _build.load_library()
    out = (ctypes.c_int * 6)()
    _build.check(lib, "gru_seq_fwd_tile", lib.gru_seq_fwd_tile(nb, B, H, out))
    return dict(zip(("rows", "blocks", "threads", "kl", "s", "smem"), out))


def _forward(xp, w_hh_t, b_hh, h0) -> torch.Tensor:
    nb, T, B, H = _check_shapes(xp, w_hh_t, b_hh, h0)
    if _device_of("gru_sequence", xp, w_hh_t, b_hh, h0).type == "cpu":
        return gru_sequence_reference(xp, w_hh_t, b_hh, h0)
    _check_cuda("gru_sequence", H, xp=xp, w_hh_t=w_hh_t, b_hh=b_hh, h0=h0)
    ys = torch.empty((nb, T, B, H), dtype=torch.float32, device=xp.device)
    if nb and T and B:
        _launch("gru_seq_fwd", xp, w_hh_t, b_hh, h0, ys, nb, T, B, H)
        gru_sequence.launches += 1
    return ys


DW_CHUNKS = 16
"""dW_hhᵀ's T·B-deep sum is split into this many chunks, one batched product
each, added in a fixed order: cuBLAS runs the single deep product on few
blocks (PERF.md §6)."""


def weight_grads(h_prev: torch.Tensor, dhp: torch.Tensor):
    """dW_hhᵀ = h_prevᵀ dhp and db_hh = Σ dhp over the T·B rows of
    h_prev (nb, T·B, H) and dhp (nb, T·B, 3H): (nb, H, 3H), (nb, 1, 3H)."""
    nb, rows, H = h_prev.shape
    c = math.gcd(rows, DW_CHUNKS)
    dw = torch.matmul(h_prev.view(nb, c, rows // c, H).transpose(2, 3),
                      dhp.view(nb, c, rows // c, dhp.shape[-1])).sum(dim=1)
    return dw, dhp.sum(dim=1, keepdim=True)


def gru_sequence_bwd_recurrence(xp, hp, h_prev, d_ys, w_hh_t, b_hh, dhp):
    """Launch K1's backward kernel on CUDA tensors: the reverse recurrence
    fed with hp = h_prev W_hhᵀ (nb, T·B, 3H; the kernel adds b_hh), h_prev
    (nb, T·B, H) and d_ys; writes dhp (which may be ``hp`` itself: the kernel
    overwrites it in place) and returns (dxp, dh0).
    ``gru_sequence_bwd.launches`` counts its launches."""
    nb, T, B, H = d_ys.shape
    dxp = torch.empty_like(xp)
    dh0 = torch.empty((nb, B, H), dtype=torch.float32, device=xp.device)
    if nb and B:
        _launch("gru_seq_bwd", xp, hp, h_prev, d_ys, w_hh_t, b_hh, dxp, dhp, dh0,
                nb, T, B, H)
        gru_sequence_bwd.launches += 1
    return dxp, dh0


def gru_sequence_bwd(xp, w_hh_t, b_hh, h0, ys, d_ys):
    """K1's backward on stacked inputs: (dxp, dw_hh_t, db_hh, dh0).

    CPU tensors take the plain version. CUDA tensors run three parts: one
    batched matrix product hp = h_prev W_hhᵀ over all T·B rows (h_prev =
    [h0, ys[:-1]]); the kernel (:func:`gru_sequence_bwd_recurrence`: the
    reverse recurrence, which adds b_hh to hp, writes dxp and dh0, and
    writes dhp over hp); then :func:`weight_grads`, dW_hhᵀ = h_prevᵀ dhp as
    batched products and db_hh = Σ dhp as one sum.
    ``gru_sequence_bwd.launches`` counts the kernel's launches."""
    nb, T, B, H = _check_shapes(xp, w_hh_t, b_hh, h0)
    for name, t in (("ys", ys), ("d_ys", d_ys)):
        if tuple(t.shape) != (nb, T, B, H):
            raise ValueError(f"{name} must be {(nb, T, B, H)}, got {tuple(t.shape)}")
    device = _device_of("gru_sequence_bwd", xp, w_hh_t, b_hh, h0, ys, d_ys)
    if device.type == "cpu":
        return gru_sequence_bwd_reference(xp, w_hh_t, b_hh, h0, ys, d_ys)
    _check_cuda("gru_sequence_bwd", H, xp=xp, w_hh_t=w_hh_t, b_hh=b_hh, h0=h0,
                ys=ys, d_ys=d_ys)
    h_prev = torch.cat([h0.unsqueeze(1), ys[:, :T - 1]], dim=1) if T else ys
    h_prev = h_prev.reshape(nb, T * B, H)
    dhp = torch.matmul(h_prev, w_hh_t)      # hp; the kernel writes dhp over it
    dxp, dh0 = gru_sequence_bwd_recurrence(xp, dhp, h_prev, d_ys, w_hh_t, b_hh, dhp)
    return (dxp, *weight_grads(h_prev, dhp), dh0)


class GRUSequence(torch.autograd.Function):
    """K1 with its backward kernel: the forward runs the forward kernel and
    saves ``ys``; the backward runs :func:`gru_sequence_bwd`, on the card the
    hp product, the backward kernel and the dW product. First-order only."""

    @staticmethod
    def forward(ctx, xp, w_hh_t, b_hh, h0):
        ys = _forward(xp, w_hh_t, b_hh, h0)
        ctx.save_for_backward(xp, w_hh_t, b_hh, h0, ys)
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, d_ys):
        return gru_sequence_bwd(*ctx.saved_tensors, d_ys.contiguous())


def gru_sequence(xp: torch.Tensor, w_hh_t: torch.Tensor, b_hh: torch.Tensor,
                 h0: torch.Tensor) -> torch.Tensor:
    """Run the recurrence: (nb,T,B,3H), (nb,H,3H), (nb,1,3H), (nb,B,H) →
    (nb,T,B,H), or the same without the leading bucket axis.

    CPU tensors take the plain versions; CUDA tensors launch the kernels, and
    ``gru_sequence.launches`` counts the forward launches."""
    if xp.dim() == 3:
        return gru_sequence(xp[None], w_hh_t[None], b_hh[None], h0[None])[0]
    return GRUSequence.apply(xp, w_hh_t, b_hh, h0)


gru_sequence.launches = 0
gru_sequence_bwd.launches = 0
