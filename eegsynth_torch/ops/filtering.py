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
rounded on its own (no fused multiply-add), in the input's dtype: float64,
float32, or bfloat16 and float16, where each operation is taken in float32
and rounded to the dtype, as PyTorch does. Any number of taps n ≥ 1, as
the JAX ``lfilter``. In float64 the kernel spreads a column's state over a
group of lanes (lane 0 forms y and the first :data:`IIR_LOCAL` elements,
lane g ≥ 1 one element each) up to :data:`IIR_MAX_LANE_TAPS` taps; in
float32 one thread holds it in registers up to :data:`IIR_MAX_COLUMN_TAPS`;
past those, and in bfloat16 and float16, one thread a column holds it in
memory, the order an argument (the runtime route); :func:`iir_plan` picks.
"""

from __future__ import annotations

import numpy as np
import torch

from eegsynth_torch import _build

IIR_MAX_LANE_TAPS = 17
"""Most taps of the lanes route (float64, ``iir_filter.cu``
``kMaxLaneTaps``): 16 lanes a column. A warp would hold a column to 34
taps; each n is a kernel instance of its own, and the build stops here."""

IIR_MAX_COLUMN_TAPS = 17
"""Most taps of the column route in float32 (``kMaxColumnTaps``): 16 state
elements, 34 taps and three chunks of x and y in one thread's registers.
bfloat16 and float16 take the runtime route at every n."""

IIR_SHARED_STATE_BYTES = 49152
"""The runtime route keeps a block's columns' states in shared memory up to
this many bytes (``kSharedStateBytes``: what every card gives a block
without opting in), else in a global buffer."""

IIR_DTYPES = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16"}
"""The dtypes the kernel takes, and its entry points' suffixes."""

IIR_THREADS = 128
"""Threads a block of the IIR kernel (``iir_filter.cu`` ``kThreads``): one
warp on each of an SM's four schedulers."""

IIR_CHUNK = 16
"""Rows of x a lane holds in registers, loaded a chunk ahead, and of y lane 0
of a group stores after each chunk (``kChunk``)."""

IIR_LOCAL = 2
"""State elements lane 0 of a lane group holds and forms itself, with its own
y (``kLocal``): the loop through the first element held by another lane then
spans IIR_LOCAL + 1 steps and two shuffles."""


def iir_lanes(n: int, local: int = IIR_LOCAL) -> int:
    """Lanes a column on the lanes route for ``n`` taps (``iir_filter.cu``
    ``lanes_for``): the fewest, a power of two, whose lanes 1.. hold the
    ``n − 1 − local`` state elements lane 0 does not (1: lane 0 holds them
    all, the column route's kernel)."""
    order = n - 1
    need = order - min(local, order) + 1
    return 1 << (need - 1).bit_length()


def iir_plan(M: int, n: int, dtype: torch.dtype) -> dict:
    """The IIR kernel's launch for ``M`` columns of ``n`` taps in ``dtype``:
    the route (``"lanes"``: float64 up to :data:`IIR_MAX_LANE_TAPS` taps,
    :func:`iir_lanes` lanes a column, lane 0 holding ``local`` state
    elements; ``"column"``: one thread a column holding them all in
    registers, in float32 up to :data:`IIR_MAX_COLUMN_TAPS` taps, whose
    four-cycle operations leave the shuffles' latency on the lanes' step,
    or in float64 where one lane holds the whole state; ``"runtime"``: past
    those, and in bfloat16 and float16, one thread a column holding its
    ``n − 1`` state elements in memory, ``state`` ``"shared"`` where a
    block's fit :data:`IIR_SHARED_STATE_BYTES`, else ``"global"``), ``lanes``,
    ``columns_per_block`` (IIR_THREADS / lanes), ``blocks`` and the
    ``chunk`` of rows. Column c goes to block c // columns_per_block, lanes
    (c % columns_per_block)·lanes onwards. Raises for fewer than one tap."""
    if n < 1:
        raise ValueError(f"lfilter: {n} taps, not 1 or more")
    lanes = iir_lanes(n) if dtype == torch.float64 and n <= IIR_MAX_LANE_TAPS else 1
    per_block = IIR_THREADS // lanes
    plan = {"route": "lanes" if lanes > 1 else "column", "lanes": lanes,
            "local": IIR_LOCAL if lanes > 1 else n - 1, "columns_per_block": per_block,
            "threads": IIR_THREADS, "blocks": -(-M // per_block), "chunk": IIR_CHUNK}
    column = dtype in (torch.float64, torch.float32) and n <= IIR_MAX_COLUMN_TAPS
    if lanes == 1 and not column:
        smem = IIR_THREADS * (n - 1) * torch.empty((), dtype=dtype).element_size()
        plan.update(route="runtime", local=0,
                    state="shared" if smem <= IIR_SHARED_STATE_BYTES else "global")
    return plan


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
    if n < 1:
        raise ValueError(f"lfilter: {n} taps, not 1 or more")
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


def _check_cuda(x: torch.Tensor, zi: torch.Tensor) -> None:
    if x.dtype not in IIR_DTYPES:
        raise TypeError(f"lfilter: x must be float64, float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    if zi.device != x.device or zi.dtype != x.dtype:
        raise ValueError("lfilter: zi must lie on x's device, in x's dtype")


def _launch(b: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
            zi: torch.Tensor) -> torch.Tensor:
    T, M = x.shape
    n = b.shape[0]
    plan = iir_plan(M, n, x.dtype)
    y = torch.empty_like(x)
    if T and M:
        lib = _build.load_library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if plan["route"] == "runtime":
                # the taps in a device buffer; the state in a copy of zi,
                # which the kernel may overwrite
                fn = f"iir_filter_runtime_{IIR_DTYPES[x.dtype]}"
                taps = torch.cat([b, a]).to(x.device)
                state = zi.clone()
                code = getattr(lib, fn)(x.data_ptr(), state.data_ptr(), taps.data_ptr(),
                                        y.data_ptr(), T, M, n, stream)
            else:
                # b and a stay on the host: the C entry point copies them
                # into the kernel's parameters
                fn = f"iir_filter_{IIR_DTYPES[x.dtype]}"
                code = getattr(lib, fn)(x.data_ptr(), zi.data_ptr(), b.data_ptr(),
                                        a.data_ptr(), y.data_ptr(), T, M, n,
                                        plan["lanes"], stream)
        _build.check(lib, fn, code)
        lfilter.launches += 1
    return y


CHAIN_TAPS = ((0.5, 0.25, 1.0), (1.0, -0.5, 0.125))
"""The step-chain probe's b and a: b0, b1, a1 of a stable step, and its
fixed x (b[2]) and z1 (a[2]): from every lane's own start the chain
converges to the same finite y, 1.75."""


def iir_chain_probe(T: int, dtype: torch.dtype, shuffle: bool = False,
                    device: torch.device | str = "cuda") -> torch.Tensor:
    """Launch the IIR kernel's step-chain probe (``iir_filter_chain_f64`` /
    ``_f32``) on one warp: ``T`` steps of lane 0's chain (y = b0·x + z0,
    a1·y, z0' = (b1·x + z1) − a1·y, each rounded on its own) with no loads
    and one store, and with ``shuffle`` a ``__shfl_sync`` round trip of y a
    step. Returns the warp's last y (32,), finite. Timed as the kernel's
    step-chain floor; counted by no launch counter."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"iir_chain_probe: no kernel for device {device}")
    b, a = (torch.tensor(c, dtype=dtype) for c in CHAIN_TAPS)
    out = torch.empty(32, dtype=dtype, device=device)
    lib = _build.load_library()
    fn = "iir_filter_chain_f64" if dtype == torch.float64 else "iir_filter_chain_f32"
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, fn)(b.data_ptr(), a.data_ptr(), out.data_ptr(), T, 32,
                                int(shuffle), stream)
    _build.check(lib, fn, code)
    return out


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
        _check_cuda(x2, zi2)
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
