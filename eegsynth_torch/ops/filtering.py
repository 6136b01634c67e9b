"""Zero-phase IIR filtering: the direct-form-II-transposed recurrence and
scipy's ``filtfilt`` around it.

Counterpart of ``eegsynth/ops/filtering.py`` (``lfilter_zi``, ``lfilter``,
``_odd_ext``, ``filtfilt``). The JAX package runs the recurrence as a
``lax.scan`` that XLA compiles into one loop; here the recurrence is a kernel
written by hand for Hopper (``eegsynth_torch/csrc/iir_filter.cu``, built at
first use by ``eegsynth_torch._build``). It replaces no Pallas kernel: written
as PyTorch operations a time step is about seven launches, so a 60 s trial
would cost some 200,000 launches. On a CPU tensor :func:`lfilter` runs its
plain PyTorch version (:func:`lfilter_reference`, a loop over time), which is
also the oracle the kernel is checked against on the card; on a CUDA tensor
it launches the kernel or raises.

The kernel and the plain version round alike: each step is ``y = b0·x + z0``,
then ``z_i ← (b_{i+1}·x + z_{i+1}) − a_{i+1}·y``, every product and sum
rounded on its own (no fused multiply-add), in the input's dtype (float32 or
float64).
"""

from __future__ import annotations

import numpy as np
import torch

from eegsynth_torch import _build

MAX_TAPS = 9
"""Longest b or a the kernel takes: order 8, a 4th-order Butterworth band-pass."""


def lfilter_zi(b, a) -> np.ndarray:
    """Steady-state initial conditions for a step input (numpy, float64):
    the linear system scipy.signal.lfilter_zi solves."""
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    n = max(len(a), len(b))
    a = np.concatenate([a, np.zeros(n - len(a))])
    b = np.concatenate([b, np.zeros(n - len(b))])
    # Companion-matrix formulation: zi = (I - A^T)^-1 B
    comp = np.zeros((n - 1, n - 1))
    comp[0, :] = -a[1:n]
    comp[1:, :-1] = np.eye(n - 2)
    B = b[1:n] - a[1:n] * b[0]
    return np.linalg.solve(np.eye(n - 1) - comp.T, B)


def _taps(b, a, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """b and a as host tensors of ``dtype``, padded to one length and
    normalised by a[0] in that dtype, as the JAX package does."""
    b = torch.as_tensor(np.asarray(b, dtype=np.float64)).to(dtype)
    a = torch.as_tensor(np.asarray(a, dtype=np.float64)).to(dtype)
    n = max(b.shape[0], a.shape[0])
    b = torch.nn.functional.pad(b, (0, n - b.shape[0]))
    a = torch.nn.functional.pad(a, (0, n - a.shape[0]))
    return b / a[0], a / a[0]


def lfilter_reference(b: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
                      zi: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch recurrence, one loop iteration a time step: x (T, M),
    normalised taps b, a (n,) and zi (n - 1, M), all on x's device and in its
    dtype → y (T, M)."""
    T, M = x.shape
    order = b.shape[0] - 1
    b, a = b.to(x.device), a.to(x.device)
    # u[t] = b·x_t + z (n, M): u[t, 0] is y_t and u[t, 1:] the new state
    # before a·y_t is taken off; three operations a step, on views made once
    u = b[None, :, None] * x[:, None, :]
    z = torch.zeros((order + 1, M), dtype=x.dtype, device=x.device)
    z[:order] = zi                                    # z[order] stays 0
    head = z[:order]
    a_taps = a[1:, None]
    ay = torch.empty((order, M), dtype=x.dtype, device=x.device)
    rows, ys, rests = u.unbind(0), u[:, 0].unbind(0), u[:, 1:].unbind(0)
    for t in range(T):
        torch.add(rows[t], z, out=rows[t])
        torch.mul(a_taps, ys[t], out=ay)
        torch.sub(rests[t], ay, out=head)
    return u[:, 0].contiguous()


def _check_cuda(x: torch.Tensor, zi: torch.Tensor, n: int) -> None:
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"lfilter: x must be float32 or float64, got {x.dtype}")
    if zi.device != x.device or zi.dtype != x.dtype:
        raise ValueError("lfilter: zi must lie on x's device, in x's dtype")
    if n > MAX_TAPS:
        raise ValueError(f"lfilter: {n} taps > {MAX_TAPS}")


def _launch(b: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
            zi: torch.Tensor) -> torch.Tensor:
    T, M = x.shape
    y = torch.empty_like(x)
    if T and M:
        lib = _build.load_library()
        fn = "iir_filter_f64" if x.dtype == torch.float64 else "iir_filter_f32"
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            # b and a stay on the host: the C entry point copies them into
            # the kernel's parameters
            code = getattr(lib, fn)(x.data_ptr(), zi.data_ptr(), b.data_ptr(),
                                    a.data_ptr(), y.data_ptr(), T, M, b.shape[0],
                                    stream)
        _build.check(lib, fn, code)
        lfilter.launches += 1
    return y


def lfilter(b, a, x: torch.Tensor, zi: torch.Tensor | None = None,
            axis: int = 0) -> torch.Tensor:
    """IIR filter of ``x`` along ``axis`` (direct form II transposed).

    ``b``, ``a``: host coefficients (numpy or sequences), normalised here by
    a[0] in x's dtype. Every axis but ``axis`` is a batch of independent
    columns; ``zi`` has shape ``(order,) + batch_shape`` (None: zeros).
    CPU tensors take :func:`lfilter_reference`; CUDA tensors launch the
    kernel (``lfilter.launches`` counts the launches) or raise."""
    x = x.movedim(axis, 0)
    batch_shape = x.shape[1:]
    b, a = _taps(b, a, x.dtype)
    order = b.shape[0] - 1
    x2 = x.reshape(x.shape[0], -1).contiguous()
    M = x2.shape[1]
    if zi is None:
        zi2 = torch.zeros((order, M), dtype=x.dtype, device=x.device)
    else:
        zi2 = torch.as_tensor(zi).to(x.dtype).reshape(order, M).contiguous()
    if x.device.type == "cpu":
        y = lfilter_reference(b, a, x2, zi2)
    elif x.device.type == "cuda":
        _check_cuda(x2, zi2, b.shape[0])
        y = _launch(b, a, x2, zi2)
    else:
        raise ValueError(f"lfilter: no kernel for device {x.device}")
    return y.reshape(x.shape).movedim(0, axis)


lfilter.launches = 0


def _odd_ext(x: torch.Tensor, padlen: int) -> torch.Tensor:
    """Odd extension at both ends along axis 0 (scipy padtype='odd')."""
    left = 2 * x[0] - x[1:padlen + 1].flip(0)
    right = 2 * x[-1] - x[-padlen - 1:-1].flip(0)
    return torch.cat([left, x, right], dim=0)


def filtfilt(b, a, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Zero-phase forward-backward IIR filter, scipy.filtfilt-compatible:
    odd extension of ``3·max(len(a), len(b))`` samples, each pass seeded
    with ``lfilter_zi`` times its first sample. Two :func:`lfilter` calls
    (two kernel launches on the card). Raises ``ValueError`` when the input
    is not longer than the extension."""
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    padlen = 3 * max(len(a), len(b))
    zi_host = lfilter_zi(b, a)                        # (order,)

    x = x.movedim(axis, 0)
    T = x.shape[0]
    if T <= padlen:
        raise ValueError(f"Input length {T} must exceed padlen {padlen}.")
    batch_shape = x.shape[1:]
    zi = torch.as_tensor(zi_host).to(dtype=x.dtype, device=x.device)
    zi = zi.reshape((-1,) + (1,) * len(batch_shape))

    ext = _odd_ext(x, padlen)
    y = lfilter(b, a, ext, zi=zi * ext[0][None], axis=0)
    y = y.flip(0)
    y = lfilter(b, a, y, zi=zi * y[0][None], axis=0)
    y = y.flip(0)
    return y[padlen:padlen + T].movedim(0, axis)
