"""GRU sequence kernel K1: the whole recurrence of one GRU layer in one launch,
forward and backward, for one model or for nb stacked models (buckets).

Counterpart of ``eegsynth/nn/pallas_gru.py`` (``_gru_seq_pallas``, and the
custom VJP ``_gru_seq_bwd``). :func:`gru_sequence` is differentiable through
:class:`GRUSequence`, whose forward and backward are both kernels on the card
(``eegsynth_torch/csrc/gru_seq.cu``, built at first use by
``eegsynth_torch._build``); past H 128 both halves take the wide route
(the forward on a thread-block cluster that holds W_hhᵀ in its blocks'
shared memory, ``eegsynth_torch/csrc/gru_seq_cluster.cu``, up to the H a
cluster holds; above that, and the backward at every wide H,
``eegsynth_torch/csrc/gru_seq_wide.cu``: W_hhᵀ streamed from L2 each step,
up to H 1024). On a CPU tensor each half runs its plain PyTorch
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
"""Largest H of K1's register-resident kernels (``gru_seq.cu``) and of K2,
which holds W_hhᵀ slices in registers the same way; ``adaptive_dims`` caps
h_dim here. K1 takes wider H through the wide route."""

MAX_WIDE_HIDDEN = 1024
"""Largest H of K1's wide route (``gru_seq_wide.cu``: one thread a column,
1024 threads a block); the wrappers raise above it."""


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


def _check_cuda(name: str, H: int, cap: int = MAX_HIDDEN,
                **tensors: torch.Tensor) -> None:
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if H > cap:
        raise ValueError(f"{name}: H={H} > {cap}")


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
    _check_cuda("gru_sequence", H, MAX_WIDE_HIDDEN, xp=xp, w_hh_t=w_hh_t,
                b_hh=b_hh, h0=h0)
    if H > MAX_HIDDEN:
        return gru_sequence_wide(xp, w_hh_t, b_hh, h0)
    ys = torch.empty((nb, T, B, H), dtype=torch.float32, device=xp.device)
    if nb and T and B:
        _launch("gru_seq_fwd", xp, w_hh_t, b_hh, h0, ys, nb, T, B, H)
        gru_sequence.launches += 1
    return ys


CLUSTER_SIZES = (2, 4, 8, 16)
"""Blocks a cluster of K1's cluster forward (``gru_seq_cluster.cu``); 16 is
a non-portable size, taken where the card reports such clusters resident."""

CLUSTER_ROWS = (1, 2, 4, 8)
"""Batch rows a cluster (its kernel instances)."""

CLUSTER_MAX_THREADS = 512
"""Threads a block of the cluster forward (its launch bound)."""

CLUSTER_BAR_BYTES = 16
"""Shared bytes of the block's two mbarriers, ahead of W_hhᵀ's slice."""

CLUSTER_MAX_REGS = 128
"""Registers a thread of the cluster forward may take: 65,536 over its
launch bound of 512 threads (the widest instance takes 118)."""

EXCHANGE_CLOCKS = 1500
"""The plan's estimate of one step's exchange of h' inside a cluster and the
wait for it, in SM clocks, beside the sums' clocks (:func:`cluster_plan`):
the step-chain probe took 0.55–1.10 µs a step (1,100–2,200 clocks at 1.98
GHz) at the cluster shapes of ``chip_smoke.py``'s ``[bound]`` lines on the
H100 (PERF.md §6)."""


def cluster_geometry(H: int, C: int) -> dict[str, int]:
    """A cluster of C blocks at width H: units a block U = ceil(H / C), the
    lanes S that split a dot product (4 for C up to 4, else 8), the slice
    KL = ceil(H / S) rounded up to 4, and threads a block, U·S rounded up to
    a warp."""
    S = 4 if C <= 4 else 8
    U = -(-H // C)
    KL = (-(-H // S) + 3) // 4 * 4
    return {"S": S, "KL": KL, "U": U, "threads": -(-U * S // 32) * 32}


def cluster_smem(R: int, S: int, KL: int, U: int) -> int:
    """Shared bytes of a block of the cluster forward (as
    ``gru_seq_cluster.cu``'s ``cluster_smem``): the mbarriers, W_hhᵀ's
    slice of 3·U units over the padded depth S·KL, and two buffers of R rows
    of h at S slices of KL + 4 or KL + 8."""
    sp = KL + 4 if KL % 8 == 0 else KL + 8
    return CLUSTER_BAR_BYTES + 4 * (3 * KL * U * S + 2 * R * S * sp)


def _step_clocks(g: dict[str, int], R: int) -> float:
    """The plan's model of one step of a block, in SM clocks: the larger of
    its multiply-adds at 128 a clock and its shared-memory wavefronts (W_hhᵀ
    as 512-byte warp reads, h as broadcasts), plus the exchange."""
    work = 3 * g["U"] * g["S"] * g["KL"]
    fma = work * R / 128
    lds = work / 32 + g["threads"] // 32 * g["KL"] // 4 * R
    return max(fma, lds) + EXCHANGE_CLOCKS


def resident_clusters(card: dict, C: int, threads: int, smem: int) -> int:
    """Clusters of C blocks of ``threads`` threads and ``smem`` shared bytes
    resident at once: the card's count at one block an SM, times the blocks
    an SM holds by its shared memory and by its registers at
    :data:`CLUSTER_MAX_REGS` a thread (a cluster's blocks may share an SM)."""
    by_smem = card["smem_sm"] // (smem + card["smem_reserved"])
    by_regs = 65536 // (CLUSTER_MAX_REGS * threads)
    return card["resident"].get(C, 0) * max(1, min(by_smem, by_regs))


def cluster_fits(H: int, card: dict):
    """Every cluster the card can run at width H, as (C, R,
    :func:`cluster_geometry`, shared bytes): C of :data:`CLUSTER_SIZES`
    with clusters resident, at most :data:`CLUSTER_MAX_THREADS` threads a
    block and a unit for every block, and each R of :data:`CLUSTER_ROWS`
    whose shared bytes fit a block."""
    for C in CLUSTER_SIZES:
        g = cluster_geometry(H, C)
        if (card["resident"].get(C, 0) < 1 or g["threads"] > CLUSTER_MAX_THREADS
                or (C - 1) * g["U"] >= H):
            continue
        for R in CLUSTER_ROWS:
            smem = cluster_smem(R, g["S"], g["KL"], g["U"])
            if smem <= card["smem"]:
                yield C, R, g, smem


def cluster_plan(nb: int, B: int, H: int, card: dict) -> dict:
    """K1's wide forward route for (nb, B, H) on a card with ``card["smem"]``
    shared bytes a block, ``card["smem_sm"]`` an SM (``card["smem_reserved"]``
    of them reserved a block) and ``card["resident"][C]`` clusters of C
    blocks resident at once at one block an SM (:func:`cluster_card`).

    Each C of :func:`cluster_fits` takes the fewest rows R that put the
    launch's nb·ceil(B / R) clusters in one wave (:func:`resident_clusters`),
    else the most rows that fit. The plan is the C of the fewest modelled
    clocks (waves × :func:`_step_clocks`) among those in one wave, or among
    all where none is; the smaller C on a tie. Where no C fits (past the
    cap: H 544 on the H100 with clusters of 16, else 384), the route is
    ``"stream"``: ``gru_seq_wide.cu``'s forward."""
    by_size: dict[int, list] = {}
    for C, R, g, smem in cluster_fits(H, card):
        by_size.setdefault(C, []).append(
            (R, g, smem, resident_clusters(card, C, g["threads"], smem)))
    best = None
    for C, fits in by_size.items():
        R, g, smem, resident = next((f for f in fits if nb * -(-B // f[0]) <= f[3]), fits[-1])
        clusters = nb * -(-B // R)
        waves = -(-clusters // resident)
        clocks = waves * _step_clocks(g, R)
        if best is None or (waves > 1, clocks) < (best["waves"] > 1, best["clocks"]):
            best = {"route": "cluster", "C": C, "R": R, **g, "smem": smem,
                    "clusters": clusters, "resident": resident, "waves": waves,
                    "clocks": clocks}
    return best or {"route": "stream"}


_CARDS: dict[int, dict] = {}


def cluster_card(device: torch.device | None = None) -> dict:
    """The numbers :func:`cluster_plan` takes, from the card itself
    (``gru_seq_cluster_card``; kept per device): SMs, shared bytes a block
    and an SM and those reserved a block, and clusters of each C resident
    at once, one block an SM."""
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _CARDS:
        lib = _build.load_library()
        out = (ctypes.c_int * 8)()
        with torch.cuda.device(index):
            _build.check(lib, "gru_seq_cluster_card", lib.gru_seq_cluster_card(out))
        _CARDS[index] = {"sms": out[0], "smem": out[1], "smem_sm": out[2],
                         "smem_reserved": out[3],
                         "resident": dict(zip(CLUSTER_SIZES, out[4:8]))}
    return _CARDS[index]


def gru_sequence_wide(xp, w_hh_t, b_hh, h0, plan: dict | None = None) -> torch.Tensor:
    """Launch K1's wide forward on stacked, checked CUDA tensors (any H up
    to :data:`MAX_WIDE_HIDDEN`; :func:`gru_sequence` takes it past
    :data:`MAX_HIDDEN`): the cluster kernel where :func:`cluster_plan` (or
    the ``plan`` given) finds a cluster that holds W_hhᵀ, counted by
    ``gru_sequence_wide.cluster_launches``; else the streaming kernel,
    counted by ``gru_sequence_wide.launches``. A plan the kernel cannot
    launch raises."""
    nb, T, B, H = _check_shapes(xp, w_hh_t, b_hh, h0)
    ys = torch.empty((nb, T, B, H), dtype=torch.float32, device=xp.device)
    if nb and T and B:
        if plan is None:
            plan = cluster_plan(nb, B, H, cluster_card(xp.device))
        if plan["route"] == "cluster":
            _launch("gru_seq_cluster_fwd", xp, w_hh_t, b_hh, h0, ys, nb, T, B, H,
                    *(plan[k] for k in ("C", "R", "S", "KL", "U")))
            gru_sequence_wide.cluster_launches += 1
        else:
            _launch("gru_seq_wide_fwd", xp, w_hh_t, b_hh, h0, ys, nb, T, B, H)
            gru_sequence_wide.launches += 1
    return ys


def cluster_chain_probe(xp, w_hh_t, b_hh, h0, plan: dict) -> None:
    """Launch the cluster forward's step-chain probe (``gru_seq_cluster_chain``)
    on the inputs of a :func:`gru_sequence_wide` call and its cluster plan:
    the same launch with each step's sums and gates left out, T steps of the
    exchange of h and the wait for it alone. It writes nothing, is counted
    by no launch counter, and is timed as the route's step-chain floor."""
    nb, T, B, H = _check_shapes(xp, w_hh_t, b_hh, h0)
    _launch("gru_seq_cluster_chain", xp, w_hh_t, b_hh, h0, xp, nb, T, B, H,
            *(plan[k] for k in ("C", "R", "S", "KL", "U")))


def wide_tile(nb: int, B: int, H: int) -> dict:
    """The wide route for (nb, B, H) on the current card: the forward's
    ``route`` (``"cluster"`` or ``"stream"``) with its cluster ``C`` and rows
    ``R`` (None on the streaming kernel) and ``plan`` (:func:`cluster_plan`);
    and the streaming kernels' tile (the backward's at every wide H): batch
    rows a block, tiles a bucket, threads a block, and the forward's and the
    backward's shared bytes."""
    lib = _build.load_library()
    out = (ctypes.c_int * 5)()
    _build.check(lib, "gru_seq_wide_tile", lib.gru_seq_wide_tile(nb, B, H, out))
    plan = cluster_plan(nb, B, H, cluster_card())
    return {"route": plan["route"], "C": plan.get("C"), "R": plan.get("R"), "plan": plan,
            **dict(zip(("rows", "blocks", "threads", "fwd_smem", "bwd_smem"), out))}


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
    writes dhp over hp; past H 128 :func:`gru_sequence_bwd_wide`); then
    :func:`weight_grads`, dW_hhᵀ = h_prevᵀ dhp as batched products and
    db_hh = Σ dhp as one sum. ``gru_sequence_bwd.launches`` and
    ``gru_sequence_bwd_wide.launches`` count the kernels' launches."""
    nb, T, B, H = _check_shapes(xp, w_hh_t, b_hh, h0)
    for name, t in (("ys", ys), ("d_ys", d_ys)):
        if tuple(t.shape) != (nb, T, B, H):
            raise ValueError(f"{name} must be {(nb, T, B, H)}, got {tuple(t.shape)}")
    device = _device_of("gru_sequence_bwd", xp, w_hh_t, b_hh, h0, ys, d_ys)
    if device.type == "cpu":
        return gru_sequence_bwd_reference(xp, w_hh_t, b_hh, h0, ys, d_ys)
    _check_cuda("gru_sequence_bwd", H, MAX_WIDE_HIDDEN, xp=xp, w_hh_t=w_hh_t,
                b_hh=b_hh, h0=h0, ys=ys, d_ys=d_ys)
    h_prev = torch.cat([h0.unsqueeze(1), ys[:, :T - 1]], dim=1) if T else ys
    h_prev = h_prev.reshape(nb, T * B, H)
    dhp = torch.matmul(h_prev, w_hh_t)      # hp; the kernel writes dhp over it
    recurrence = (gru_sequence_bwd_recurrence if H <= MAX_HIDDEN
                  else gru_sequence_bwd_wide)
    dxp, dh0 = recurrence(xp, dhp, h_prev, d_ys, w_hh_t, b_hh, dhp)
    return (dxp, *weight_grads(h_prev, dhp), dh0)


def gru_sequence_bwd_wide(xp, hp, h_prev, d_ys, w_hh_t, b_hh, dhp):
    """Launch K1's wide backward kernel on CUDA tensors: the arguments and
    results of :func:`gru_sequence_bwd_recurrence`, for any H up to
    :data:`MAX_WIDE_HIDDEN`. The kernel streams W_hh, so it is passed
    W_hhᵀ transposed back, contiguous. ``gru_sequence_bwd_wide.launches``
    counts its launches."""
    nb, T, B, H = d_ys.shape
    dxp = torch.empty_like(xp)
    dh0 = torch.empty((nb, B, H), dtype=torch.float32, device=xp.device)
    if nb and B:
        w_hh = w_hh_t.transpose(-1, -2).contiguous()
        _launch("gru_seq_wide_bwd", xp, hp, h_prev, d_ys, w_hh, b_hh, dxp, dhp, dh0,
                nb, T, B, H)
        gru_sequence_bwd_wide.launches += 1
    return dxp, dh0


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

    CPU tensors take the plain versions; CUDA tensors launch the kernels:
    ``gru_sequence.launches`` counts the forward launches at H up to
    :data:`MAX_HIDDEN`, ``gru_sequence_wide.cluster_launches`` and
    ``gru_sequence_wide.launches`` the wide route's past it (the cluster and
    the streaming kernel; and ``gru_sequence_bwd`` / ``gru_sequence_bwd_wide``
    the backward's).
    H past :data:`MAX_WIDE_HIDDEN` raises."""
    if xp.dim() == 3:
        return gru_sequence(xp[None], w_hh_t[None], b_hh[None], h0[None])[0]
    return GRUSequence.apply(xp, w_hh_t, b_hh, h0)


gru_sequence.launches = 0
gru_sequence_bwd.launches = 0
gru_sequence_wide.launches = 0
gru_sequence_wide.cluster_launches = 0
gru_sequence_bwd_wide.launches = 0
