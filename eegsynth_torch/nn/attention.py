"""Multi-head attention with the flash-attention kernels K3a, K3b and K3c.

Counterpart of ``eegsynth/nn/attention.py``:

- :func:`attention_dense`, dense softmax attention (``attention_xla``),
  plain PyTorch and twice differentiable;
- :func:`flash_attention`, blocked online-softmax attention through
  :class:`FlashAttention`, whose forward is K3a and whose backward is
  delta = rowsum(dO∘O) as a torch op, then K3b (dq) and K3c (dk, dv). For
  head dims up to 128 all three run on the tensor cores with split-TF32
  ``wgmma`` (``eegsynth_torch/csrc/flash_attn_tc.cu``); past 128 they run
  on the tensor cores too, with D streamed in chunks and the output
  columns held in groups (K3a in ``csrc/flash_attn_wide.cu``, K3b and K3c
  in ``csrc/flash_attn_wide_bwd.cu``). All are built at first use by
  ``eegsynth_torch._build``. First-order only, as the JAX custom
  VJP: a second derivative raises, so paths that differentiate twice (R1
  through the transformer discriminator) take the dense path;
- :func:`mha` and :func:`set_attention_impl`, the dispatch: ``"dense"``,
  ``"flash"`` and ``"auto"`` mirror JAX's ``"xla"``, ``"pallas"`` and
  ``"auto"``. ``"auto"`` takes the kernels for CUDA tensors with T ≥ 512
  (the TPU's threshold, kept as the dispatch rule; :func:`auto_takes_flash`)
  at any D and any B·H, and dense attention otherwise.

Each kernel has a plain PyTorch version with its signature
(:func:`flash_forward_plain`, :func:`flash_dq_plain`,
:func:`flash_dkv_plain`) using the kernels' formulas: the scale ``D**-0.5``
applied after the dot, ``p = exp(s − lse)``, ``ds = p∘(dP − delta)·scale``.
The wrappers (:func:`flash_forward`, :func:`flash_dq`, :func:`flash_dkv`)
run the plain version for CPU tensors and launch a kernel, or raise, for
CUDA tensors, chosen from D before the launch: the kernel for
D ≤ ``MAX_TC_HEAD_DIM``, counted by ``<wrapper>.launches``, and the wide
kernel past it, counted by ``<wrapper>.wide_launches``.

Layout: q, k, v are (B, H, T, D), full (non-causal) attention, computed in
float32 (inputs are cast, the output cast back); lse and delta are
(B, H, T). The kernels mask the ragged edge of T themselves, so nothing is
padded.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from eegsynth_torch import _build
from eegsynth_torch.nn.gru_sequence import _device_of, _launch

MAX_TC_HEAD_DIM = 128
"""Largest D of the kernels that hold whole rows of D columns
(``flash_attn_tc.cu``; the model uses 64). Wider heads take the wide
kernels, also on the tensor cores, with D split into chunks and column
groups."""

_ATTN_IMPL = "auto"


def takes_wide_kernels(D: int) -> bool:
    """Whether a head dim of ``D`` takes the wide kernels on the card."""
    return D > MAX_TC_HEAD_DIM


def set_attention_impl(impl: str) -> None:
    """Select the attention path for subsequent calls ("dense"/"flash"/"auto")."""
    global _ATTN_IMPL
    if impl not in ("dense", "flash", "auto"):
        raise ValueError(f"attention impl must be 'dense', 'flash' or 'auto', "
                         f"got {impl!r}")
    _ATTN_IMPL = impl


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5


def attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense softmax attention, (B, H, T, D) each."""
    return torch.matmul(torch.softmax(_scores(q, k), dim=-1), v)


def flash_forward_plain(q, k, v):
    """K3a's plain version: (o, lse) with s = (q kᵀ)·scale,
    lse = logsumexp(s), o = exp(s − lse) v."""
    s = _scores(q, k)
    lse = torch.logsumexp(s, dim=-1)
    return torch.matmul(torch.exp(s - lse[..., None]), v), lse


def _probs_and_ds(q, k, v, do, lse, delta):
    s = _scores(q, k)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do, v.transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * q.shape[-1] ** -0.5


def flash_dq_plain(q, k, v, do, lse, delta):
    """K3b's plain version: dq = ds k."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta)
    return torch.matmul(ds, k)


def flash_dkv_plain(q, k, v, do, lse, delta):
    """K3c's plain version: (dk, dv) = (dsᵀ q, pᵀ dO)."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta)
    return torch.matmul(ds.transpose(-1, -2), q), torch.matmul(p.transpose(-1, -2), do)


def flash_backward_plain(q, k, v, o, lse, do):
    """The whole backward in plain PyTorch: (dq, dk, dv)."""
    delta = (do * o).sum(dim=-1)
    return (flash_dq_plain(q, k, v, do, lse, delta),
            *flash_dkv_plain(q, k, v, do, lse, delta))


def _check(name: str, shape, **tensors: torch.Tensor) -> torch.device:
    """The device of ``tensors``; for CUDA tensors, raise on anything the
    kernels do not take."""
    for key, t in tensors.items():
        want = shape if t.dim() == 4 else shape[:3]
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: {key} must be {tuple(want)}, got {tuple(t.shape)}")
    device = _device_of(name, *tensors.values())
    if device.type == "cuda":
        for key, t in tensors.items():
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {key} must be contiguous")
    return device


def flash_forward(q, k, v):
    """K3a: (o, lse) for (B, H, T, D) float32 q, k, v."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, D), got {tuple(q.shape)}")
    if _check("flash_forward", q.shape, q=q, k=k, v=v).type == "cpu":
        return flash_forward_plain(q, k, v)
    B, H, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if B * H and T and takes_wide_kernels(D):
        _launch("flash_fwd_wide", q, k, v, o, lse, B * H, T, D)
        flash_forward.wide_launches += 1
    elif B * H and T:
        _launch("flash_fwd", q, k, v, o, lse, B * H, T, D)
        flash_forward.launches += 1
    return o, lse


def flash_dq(q, k, v, do, lse, delta):
    """K3b: dq from the saved lse and delta = rowsum(dO∘O)."""
    if _check("flash_dq", q.shape, q=q, k=k, v=v, do=do, lse=lse,
              delta=delta).type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta)
    B, H, T, D = q.shape
    dq = torch.empty_like(q)
    if B * H and T and takes_wide_kernels(D):
        _launch("flash_bwd_dq_wide", q, k, v, do, lse, delta, dq, B * H, T, D)
        flash_dq.wide_launches += 1
    elif B * H and T:
        _launch("flash_bwd_dq", q, k, v, do, lse, delta, dq, B * H, T, D)
        flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta):
    """K3c: (dk, dv) from the saved lse and delta."""
    if _check("flash_dkv", q.shape, q=q, k=k, v=v, do=do, lse=lse,
              delta=delta).type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta)
    B, H, T, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if B * H and T and takes_wide_kernels(D):
        _launch("flash_bwd_dkv_wide", q, k, v, do, lse, delta, dk, dv, B * H, T, D)
        flash_dkv.wide_launches += 1
    elif B * H and T:
        # q and do split into the kernel's query tiles by its pre-pass
        n = _build.load_library().flash_bwd_dkv_scratch(B * H, T, D)
        scratch = torch.empty(n, dtype=torch.float32, device=q.device)
        _launch("flash_bwd_dkv", q, k, v, do, lse, delta, dk, dv, scratch, B * H, T, D)
        flash_dkv.launches += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """K3a forward, saving q, k, v, o and lse; backward: delta as a torch
    op, then K3b and K3c. First-order only."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_forward(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do * o).sum(dim=-1)
        return (flash_dq(q, k, v, do, lse, delta),
                *flash_dkv(q, k, v, do, lse, delta))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Blocked online-softmax attention: (B, H, T, D)³ → (B, H, T, D),
    computed in float32 and returned in q's dtype."""
    f32 = [t.to(torch.float32).contiguous() for t in (q, k, v)]
    return FlashAttention.apply(*f32).to(q.dtype)


def auto_takes_flash(shape, device_type: str) -> bool:
    """``"auto"``'s rule for q of ``shape`` (B, H, T, D) on a device of
    ``device_type``: the kernels for CUDA tensors with T ≥ 512 (the TPU's
    threshold, as JAX's ``mha``), dense attention for everything else."""
    return device_type == "cuda" and shape[2] >= 512


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        impl: str | None = None) -> torch.Tensor:
    """Dispatching multi-head attention. ``impl`` overrides the module
    default."""
    impl = impl or _ATTN_IMPL
    if impl == "auto":
        impl = "flash" if auto_takes_flash(q.shape, q.device.type) else "dense"
    if impl == "flash":
        return flash_attention(q, k, v)
    if impl != "dense":
        raise ValueError(f"unknown attention impl {impl!r}")
    return attention_dense(q, k, v)


flash_forward.launches = flash_forward.wide_launches = 0
flash_dq.launches = flash_dq.wide_launches = 0
flash_dkv.launches = flash_dkv.wide_launches = 0
