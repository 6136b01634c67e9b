"""GRU sequence kernel K1: the whole recurrence of one GRU layer in one launch,
forward and backward, for one model or for nb stacked models (buckets).

Counterpart of ``eegsynth/nn/pallas_gru.py`` (``_gru_seq_pallas``, and the
custom VJP ``_gru_seq_bwd``). :func:`gru_sequence` is differentiable through
:class:`GRUSequence`, whose forward and backward are both kernels on the card
(``eegsynth_torch/csrc/gru_seq.cu``, built at first use by
``eegsynth_torch._build``). Which kernel takes which H (the numbers are the
H100's):

- up to H 128 (:data:`MAX_HIDDEN`), both halves hold W_hhᵀ in registers
  (``gru_seq.cu``);
- from H 129 to the clusters' cap (544 with clusters of 16, 384 without),
  each half runs on a thread-block cluster whose blocks hold W_hhᵀ's slice
  of their units in shared memory: the forward in
  ``eegsynth_torch/csrc/gru_seq_cluster.cu`` (h' all-gathered each step,
  :func:`cluster_plan`), the backward in
  ``eegsynth_torch/csrc/gru_seq_cluster_bwd.cu`` (dh reduce-scattered each
  step, :func:`cluster_bwd_plan`);
- above the cap up to H 1024, each half runs on one cooperative grid
  whose blocks hold the slice of their units in shared memory and exchange
  one operand through L2 once a step: the forward holds W_hhᵀ's columns and
  all-gathers h (``eegsynth_torch/csrc/gru_seq_grid.cu``, :func:`grid_plan`),
  the backward W_hh's columns and all-gathers dhp
  (``eegsynth_torch/csrc/gru_seq_grid_bwd.cu``, :func:`grid_bwd_plan`);
- past that, where a grid's blocks cannot hold all of W_hh (in split TF32
  it outgrows the card's shared memory near H 1100), up to
  :func:`wide_cap` (H 9685: the streaming backward's one-row tile of dhp
  fills a block's shared memory): the forward runs on one cooperative grid
  whose blocks own 8·J units each, keep what fits of their slice of W_hhᵀ
  in shared memory and stream the rest of it once a step beside h
  (``eegsynth_torch/csrc/gru_seq_grid_stream.cu``,
  :func:`grid_stream_plan`); the backward on
  ``eegsynth_torch/csrc/gru_seq_wide.cu``'s streaming kernel, which reads
  all of W_hh from L2 each step in every block (:func:`stream_plan`; the
  streaming forward beside it runs only on the plan ``{"route":
  "stream"}``).

On a CPU tensor each half runs its plain PyTorch
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


def _check_cuda(name: str, H: int, cap: int | None = MAX_HIDDEN,
                **tensors: torch.Tensor) -> None:
    """dtype and layout of the kernel's inputs, and H up to ``cap``; None
    is K1's: past :data:`MAX_HIDDEN`, :func:`wide_cap` of the tensors'
    card."""
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if cap is None:
        if H > MAX_HIDDEN:
            _check_wide(name, H, cluster_card(next(iter(tensors.values())).device))
    elif H > cap:
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
    _check_cuda("gru_sequence", H, None, xp=xp, w_hh_t=w_hh_t, b_hh=b_hh, h0=h0)
    if H > MAX_HIDDEN:
        return gru_sequence_wide(xp, w_hh_t, b_hh, h0)
    ys = torch.empty((nb, T, B, H), dtype=torch.float32, device=xp.device)
    if nb and T and B:
        _launch("gru_seq_fwd", xp, w_hh_t, b_hh, h0, ys, nb, T, B, H)
        gru_sequence.launches += 1
    return ys


CLUSTER_SIZES = (2, 4, 8, 16)
"""Blocks a cluster of K1's cluster forward and backward
(``gru_seq_cluster.cu``, ``gru_seq_cluster_bwd.cu``); 16 is a non-portable
size, taken where the card reports such clusters resident."""

CLUSTER_ROWS = (1, 2, 4, 8)
"""Batch rows a cluster (its kernel instances)."""

CLUSTER_MAX_THREADS = 512
"""Threads a block of the cluster forward and backward (their launch
bound)."""

CLUSTER_BAR_BYTES = 16
"""Shared bytes of the block's two mbarriers, ahead of W_hhᵀ's slice."""

CLUSTER_MAX_REGS = 128
"""Registers a thread of the cluster forward or backward may take: 65,536
over their launch bound of 512 threads (the forward's widest instance takes
118)."""

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


def _step_clocks(g: dict[str, int], R: int, share: int) -> float:
    """The plan's model of one step of a block, in SM clocks: the larger of
    its multiply-adds at 128 a clock and its shared-memory wavefronts (W_hhᵀ
    as 512-byte warp reads, h as broadcasts), plus the exchange. (The
    blocks that share an SM, ``share``, do not enter it.)"""
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


def _best_plan(nb: int, B: int, card: dict, fits, step_clocks, group) -> dict:
    """The plan of the fewest modelled clocks among ``fits`` ((C, R,
    geometry, shared bytes) of one route), taken in groups
    (``group(C, R, geometry)``): each group takes the fewest rows R that put
    the launch's nb·ceil(B / R) clusters in one wave
    (:func:`resident_clusters`), else the most rows that fit; the plan is
    the one of the fewest waves × ``step_clocks(geometry, R, share)`` among
    those in one wave, or among all where none is; the first on a tie.
    ``share`` is the blocks of one wave on an SM, at least 1.
    ``{"route": "stream"}`` where nothing fits."""
    groups: dict[tuple, list] = {}
    for C, R, g, smem in fits:
        groups.setdefault(group(C, R, g), []).append(
            (C, R, g, smem, resident_clusters(card, C, g["threads"], smem)))
    best = None
    for options in groups.values():
        C, R, g, smem, resident = next(
            (f for f in options if nb * -(-B // f[1]) <= f[4]), options[-1])
        clusters = nb * -(-B // R)
        waves = -(-clusters // resident)
        share = -(-min(clusters, resident) * C // card["sms"])
        clocks = waves * step_clocks(g, R, share)
        if best is None or (waves > 1, clocks) < (best["waves"] > 1, best["clocks"]):
            best = {"route": "cluster", "C": C, "R": R, **g, "smem": smem,
                    "clusters": clusters, "resident": resident, "waves": waves,
                    "clocks": clocks}
    return best or {"route": "stream"}


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
    ``"stream"``, and :func:`wide_plan` takes the grid or the streaming plan
    instead."""
    return _best_plan(nb, B, card, cluster_fits(H, card), _step_clocks,
                      lambda C, R, g: C)


CLUSTER_BWD_SLICES = (1, 2, 4, 8)
"""Lanes S that split one output quad's sum in K1's cluster backward
(``gru_seq_cluster_bwd.cu``)."""


def cluster_bwd_geometry(H: int, C: int, S: int) -> dict[str, int]:
    """K1's cluster backward on C blocks at width H with S lanes a quad:
    units a block U = ceil(H / C), output quads NO = ceil(H / 4), entries a
    lane KE = ceil(3U / S) rounded up to 4 (the kernel reads them as
    float4s), and threads a block, NO·S rounded up to a warp."""
    U = -(-H // C)
    NO = -(-H // 4)
    return {"S": S, "KE": (-(-3 * U // S) + 3) // 4 * 4, "U": U, "NO": NO,
            "threads": -(-NO * S // 32) * 32}


def cluster_bwd_smem(H: int, C: int, R: int, S: int, KE: int, U: int) -> int:
    """Shared bytes of a block of the cluster backward (as
    ``gru_seq_cluster_bwd.cu``'s ``cluster_bwd_smem``): the mbarriers, W_hh's
    slice of S·KE entries by ceil(H / 4) float4 quads, two receive buffers of
    C source blocks × R rows × (ceil(U / 4) + 1) quads, and two buffers of R
    rows of dhp at S slices of KE or KE + 4, whichever is 4 past a multiple
    of 8."""
    recv_pitch = (-(-U // 4) + 1) * 4
    pitch = KE + 4 if KE % 8 == 0 else KE
    return CLUSTER_BAR_BYTES + 4 * (4 * KE * -(-H // 4) * S + 2 * C * R * recv_pitch
                                    + 2 * R * S * pitch)


BWD_ISSUE_CLOCKS = 1.5
"""The plan's estimate of the SM clocks an instruction of a warp of the
cluster backward's sums takes on its scheduler, stalls included
(:func:`_bwd_step_clocks`)."""

BWD_ENTRY_CLOCKS = 30
"""The plan's estimate of one entry of a lane's chain of sums in the cluster
backward, in SM clocks: its dependent shared-memory loads and
multiply-adds."""

BWD_ROUND_CLOCKS = 200
"""The plan's estimate of one round of the cluster backward's butterfly
over the S lanes of a quad (4R values a lane), in SM clocks."""

BWD_EXCHANGE_CLOCKS = 1500
"""The plan's estimate of one step's reduce-scatter of dh in the cluster
backward and the wait for it, in SM clocks: the step-chain probe took
0.77–1.12 µs a step (1,500–2,200 clocks at 1.98 GHz) at the one-wave
shapes of ``chip_smoke.py``'s ``[bound]`` lines on the H100 (PERF.md §6). With
the three constants above, the model ranks the plans that
``chip_smoke.py`` times at every shape of its backward plan sweep (the
``[kernel] gru_sequence_bwd_wide_cluster ... plans`` lines) so that the
pick was the fastest at (1, 768, 64, 256) and 512 and within 10 % of the
fastest at the sweep's other shapes on the H100; a ranking, not a
time."""


def _bwd_step_clocks(g: dict[str, int], R: int, share: int) -> float:
    """The plan's model of one step of a block of the cluster backward, in SM
    clocks: the larger of its issue (a warp's KE·(1 + R/4 + 4R)
    instructions, a quarter of the warps on each scheduler, half again for
    each other block on the SM) and a lane's chain of KE entries, plus the
    butterfly's log2(S) rounds and the exchange."""
    per_scheduler = -(-g["threads"] // 128) * (1 + (share - 1) / 2)
    issue = BWD_ISSUE_CLOCKS * per_scheduler * g["KE"] * (1 + R / 4 + 4 * R)
    chain = g["KE"] * BWD_ENTRY_CLOCKS
    rounds = g["S"].bit_length() - 1
    return max(issue, chain) + rounds * BWD_ROUND_CLOCKS + BWD_EXCHANGE_CLOCKS


def cluster_bwd_fits(H: int, card: dict):
    """Every cluster backward the card can run at width H, as (C, R,
    :func:`cluster_bwd_geometry`, shared bytes): C of :data:`CLUSTER_SIZES`
    with clusters resident and a unit for every block (at least 4 units a
    block), S of :data:`CLUSTER_BWD_SLICES` with at most
    :data:`CLUSTER_MAX_THREADS` threads a block, and each R of
    :data:`CLUSTER_ROWS` with a thread for each of its R·U (row, unit)
    pairs whose shared bytes fit a block."""
    for C in CLUSTER_SIZES:
        U = -(-H // C)
        if card["resident"].get(C, 0) < 1 or (C - 1) * U >= H or U < 4:
            continue
        for S in CLUSTER_BWD_SLICES:
            g = cluster_bwd_geometry(H, C, S)
            if g["threads"] > CLUSTER_MAX_THREADS:
                continue
            for R in CLUSTER_ROWS:
                smem = cluster_bwd_smem(H, C, R, S, g["KE"], U)
                if R * U <= g["threads"] and smem <= card["smem"]:
                    yield C, R, g, smem


def cluster_bwd_plan(nb: int, B: int, H: int, card: dict) -> dict:
    """K1's wide backward route for (nb, B, H) on the card's numbers (as
    :func:`cluster_plan`): among every (C, S, R) of :func:`cluster_bwd_fits`
    (rows are not taken fewest first: two clusters sharing an SM ran slower
    than one cluster of twice the rows), the plan of the fewest modelled
    clocks (waves × :func:`_bwd_step_clocks`), one wave first. Where
    nothing fits (past the cap: H 544 on the H100 with clusters of 16, else
    384), the route is ``"stream"``, and :func:`wide_bwd_plan` takes the
    grid or the streaming plan instead."""
    return _best_plan(nb, B, card, cluster_bwd_fits(H, card), _bwd_step_clocks,
                      lambda C, R, g: (C, g["S"], R))


GRID_UNITS = 8
"""Units a block of K1's grid forward (``gru_seq_grid.cu``) and backward
(``gru_seq_grid_bwd.cu``) owns: the forward's wgmma is N = 3U = 24 gate
columns wide, the backward's N = U = 8 columns of dh (multiples of 8).
Sixteen units' slice of W_hh fits a block's shared memory only up to H
544, below the grid's widths."""

GRID_MAX_HIDDEN = 1024
"""The widest H of the grid forward and backward (``grid.cuh``
``kMaxHidden``): their W_hh in split TF32, 24·H² bytes, fills the H100's
132 blocks of shared memory near it (25.2 MB at H 1024). Past it
:func:`wide_plan` takes the grid that streams W's remainder
(:func:`grid_stream_plan`) and :func:`wide_bwd_plan` the streaming
kernel."""

GRID_STAGES = 2
"""Stages of the grid forward's ring of h chunks: one landing while the
tensor cores multiply the other (three or four ran no faster on the H100,
PERF.md §6)."""

GRID_CHUNK = 64
"""Depth of h a stage of the grid forward holds at 64 rows (16 KB; at fewer
rows a stage holds proportionally more depth)."""

GRID_PAD = 32
"""The grid kernels pad H (h's depth in the forward, each gate of dhp in the
backward, and W's rows with them) to a multiple of this: two 16-deep parts,
one for each set of fragments a forward warpgroup keeps in flight."""

GRID_TILE_ROWS = 64
"""Batch rows of the grid kernels' tile (the forward's wgmma M, four of the
backward's 16-row `mma.sync` tiles); a block loops over ceil(B / 64) tiles a
step."""

GRID_THREADS = 256
"""Threads a block of the grid kernels: the forward's two warpgroups, one for
each k-slice of a 16-deep part of h; the backward's eight warps."""


def grid_smem(H: int) -> int:
    """Shared bytes of a block of the grid forward (as ``gru_seq_grid.cu``'s
    ``grid_smem``): W_hhᵀ's slice of 3·:data:`GRID_UNITS` columns over the
    depth padded to :data:`GRID_PAD`, TF32 hi and lo, and the ring of
    :data:`GRID_STAGES` stages of 64 rows × :data:`GRID_CHUNK`."""
    depth = -(-H // GRID_PAD) * GRID_PAD
    return 4 * (2 * depth * 3 * GRID_UNITS + GRID_STAGES * GRID_TILE_ROWS * GRID_CHUNK)


GRID_BWD_AHEAD = (2, 8)
"""Parts of 16 of dhp whose rows a lane of the grid backward
(``gru_seq_grid_bwd.cu``) has in flight from L2 while it multiplies the part
before: in its instance for two blocks an SM (at most 128 registers a
thread), taken where two blocks fit an SM's shared memory, and in the one
for a block alone on its SM."""


def grid_bwd_smem(H: int) -> int:
    """Shared bytes of a block of the grid backward (as
    ``gru_seq_grid_bwd.cu``'s ``grid_bwd_smem``): W_hh's columns of
    :data:`GRID_UNITS` units over the three gates, each padded to
    :data:`GRID_PAD`, TF32 hi and lo, and each warp's sums of a 16-row
    tile."""
    depth = 3 * (-(-H // GRID_PAD) * GRID_PAD)
    return 4 * (2 * depth * GRID_UNITS + GRID_THREADS // 32 * 16 * GRID_UNITS)


def grid_resident(card: dict, smem: int, blocks_sm: str = "grid_blocks_sm") -> int:
    """Blocks of a grid kernel at ``smem`` shared bytes resident at once: the
    card's SMs times the blocks an SM holds, the fewer of the kernel's count
    at no dynamic shared memory (``card[blocks_sm]``: ``"grid_blocks_sm"``
    for the forward, ``"grid_bwd_blocks_sm"`` for the backward; 0 without
    cooperative launches) and its shared memory's."""
    by_smem = card["smem_sm"] // (smem + card["smem_reserved"])
    return card["sms"] * min(card[blocks_sm], by_smem)


def _grid_plan(what: str, nb: int, H: int, smem: int, card: dict, blocks_sm: str,
               must: bool = True, **shape) -> dict | None:
    """The plan of a grid kernel (``what``) of ``smem`` shared bytes a block:
    ceil(H / 8) blocks a bucket, waves of the buckets resident at once, and
    the kernel's ``shape`` keys. Where one bucket's blocks are not resident
    at once (none are past :data:`GRID_MAX_HIDDEN`) it raises, or with
    ``must`` False returns None."""
    blocks = -(-H // GRID_UNITS)
    resident = (grid_resident(card, smem, blocks_sm)
                if smem <= card["smem"] and H <= GRID_MAX_HIDDEN else 0)
    if resident < blocks:
        if not must:
            return None
        raise RuntimeError(
            f"K1's {what} at H {H}: {blocks} blocks of {smem} shared bytes, "
            f"{resident} resident at once on this card (cooperative launches "
            f"{'yes' if card[blocks_sm] else 'no'})")
    per_wave = max(1, min(max(nb, 1), resident // blocks))
    return {"route": "grid", "U": GRID_UNITS, "blocks": blocks, **shape,
            "threads": GRID_THREADS, "buckets_per_wave": per_wave,
            "waves": -(-nb // per_wave), "smem": smem, "resident": resident}


def grid_plan(nb: int, B: int, H: int, card: dict, must: bool = True) -> dict | None:
    """K1's grid forward for (nb, B, H) on the card's numbers
    (:func:`cluster_card`): ceil(H / 8) blocks a bucket (each owning a unit,
    the last one's slice masked) of :func:`grid_smem` shared bytes; a
    launch (a wave) holds the buckets whose blocks are resident at once,
    the rest go in further launches. B does not enter: a block loops over
    the batch in tiles of 64 rows. Raises where one bucket's blocks do not
    fit resident at once (a card without cooperative launches, or too
    little shared memory), or with ``must`` False returns None there
    (:func:`wide_plan` then plans the streaming kernel)."""
    return _grid_plan("grid forward", nb, H, grid_smem(H), card, "grid_blocks_sm", must,
                      chunk=GRID_CHUNK, stages=GRID_STAGES)


def grid_bwd_plan(nb: int, B: int, H: int, card: dict, must: bool = True) -> dict | None:
    """K1's grid backward for (nb, B, H) on the card's numbers, in the form
    of :func:`grid_plan`: ceil(H / 8) blocks a bucket of
    :func:`grid_bwd_smem` shared bytes, the buckets resident at once a wave
    (the backward's own count of blocks an SM, ``card["grid_bwd_blocks_sm"]``,
    that of its instance for two blocks an SM: at H up to 576 two blocks
    share an SM), and its parts in flight (:data:`GRID_BWD_AHEAD`).
    Raises where one bucket's blocks do not fit resident at once, or with
    ``must`` False returns None there (:func:`wide_bwd_plan` then plans the
    streaming kernel)."""
    smem = grid_bwd_smem(H)
    two = 2 * (smem + card["smem_reserved"]) <= card["smem_sm"]
    return _grid_plan("grid backward", nb, H, smem, card, "grid_bwd_blocks_sm", must,
                      ahead=GRID_BWD_AHEAD[0 if two else 1])


GRID_STREAM_MAX_GROUPS = 10
"""Groups of :data:`GRID_UNITS` units a block of K1's grid forward past
H 1024 (``gru_seq_grid_stream.cu`` ``kMaxGroups``) owns at most: J groups
make N = 24·J gate columns, one wgmma m64nNk8 a k-slice (N ≤ 256). Ten (80
units) put H 9685 on 122 blocks of the H100's 132."""

GRID_STREAM_CHUNK = 32
"""Depth of a chunk of the grid forward past H 1024: two 16-deep parts of h
(one for each warpgroup's k-slice of a part) and, past the resident rows,
W's 32 rows of the chunk, hi and lo, in one stage of its ring."""


def grid_stream_stages(J: int) -> int:
    """Stages of the ring of the grid forward past H 1024 at J groups (as
    ``gru_seq_grid_stream.cu``'s ``stream_stages``): four up to J 8, else
    three (four stages of J 9 outgrow a block); stages - 2 chunks are in
    flight."""
    return 4 if J <= 8 else 3


def grid_stream_smem(J: int, resident_depth: int) -> int:
    """Shared bytes of a block of the grid forward past H 1024 (as
    ``gru_seq_grid_stream.cu``'s ``stream_smem``): W's resident rows of
    24·J columns, TF32 hi and lo, and the ring, each stage 64 rows × 32 of
    h and 32 rows of W hi and lo."""
    stage = GRID_TILE_ROWS * GRID_STREAM_CHUNK + 2 * GRID_STREAM_CHUNK * 3 * GRID_UNITS * J
    return 4 * (2 * resident_depth * 3 * GRID_UNITS * J + grid_stream_stages(J) * stage)


def grid_stream_plan(nb: int, B: int, H: int, card: dict) -> dict:
    """K1's forward past the grid's H 1024 for (nb, B, H) on the card's
    numbers (:func:`cluster_card`): one cooperative grid of one block an SM
    (the block takes the most shared bytes an SM gives one block), so
    ``card["sms"]`` blocks resident where the kernel's registers allow one
    (``card["grid_stream_blocks_sm"]``; 0 without cooperative launches).
    The fewest groups J of :data:`GRID_UNITS` units a block (to
    :data:`GRID_STREAM_MAX_GROUPS`) that put a bucket's ceil(H / 8J) blocks
    resident at once; each block keeps the most rows of its slice's depth
    (H padded to :data:`GRID_PAD`), a multiple of
    :data:`GRID_STREAM_CHUNK`, that fit its shared memory beside the ring
    (:func:`grid_stream_smem`) and streams the rest each step. A wave holds
    the buckets resident at once. B does not enter: a block loops over the
    batch in tiles of 64 rows. Raises where no J puts a bucket resident,
    naming what did not fit."""
    depth = -(-H // GRID_PAD) * GRID_PAD
    per_sm = min(card["grid_stream_blocks_sm"], 1)
    resident = card["sms"] * per_sm
    room = min(card["smem"], card["smem_sm"] - card["smem_reserved"])
    for J in range(1, GRID_STREAM_MAX_GROUPS + 1):
        blocks = -(-H // (GRID_UNITS * J))
        ring = grid_stream_smem(J, 0)
        if blocks <= resident and ring <= room:
            break
    else:
        raise RuntimeError(
            f"K1's grid forward past H {GRID_MAX_HIDDEN} at H {H}: {blocks} blocks of "
            f"{GRID_UNITS * J} units at the most ({J} groups), {resident} resident at once "
            f"on this card, one block an SM (cooperative launches "
            f"{'yes' if card['grid_stream_blocks_sm'] else 'no'}), its ring {ring} of "
            f"{room} shared bytes")
    row = 2 * 4 * 3 * GRID_UNITS * J
    kept = min(depth, (room - ring) // row // GRID_STREAM_CHUNK * GRID_STREAM_CHUNK)
    per_wave = max(1, min(max(nb, 1), resident // blocks))
    return {"route": "grid_stream", "U": GRID_UNITS * J, "groups": J, "blocks": blocks,
            "threads": GRID_THREADS, "blocks_sm": per_sm, "resident_depth": kept,
            "streamed_depth": depth - kept, "chunk": GRID_STREAM_CHUNK,
            "stages": grid_stream_stages(J), "smem": grid_stream_smem(J, kept),
            "buckets_per_wave": per_wave, "waves": -(-nb // per_wave), "resident": resident}


STREAM_MAX_THREADS = 1024
"""Threads a block of the streaming kernels (``gru_seq_wide.cu``
``kMaxThreads``, their launch bound): a thread owns every column j + k·1024
past that."""

STREAM_ROWS = (1, 2, 4)
"""Batch rows a block of the streaming kernels (``kMaxRows`` 4)."""


def stream_smem(R: int, H: int) -> tuple[int, int]:
    """Shared bytes of a block of the streaming forward and backward at R
    rows (as ``gru_seq_wide.cu``'s ``fwd_smem_bytes`` / ``bwd_smem_bytes``):
    two buffers of R rows of h at a pitch of H rounded up to 4, and two of
    dhp at 3H rounded up to 4."""
    return 4 * 2 * R * ((H + 3) & ~3), 4 * 2 * R * ((3 * H + 3) & ~3)


def wide_cap(card: dict) -> int:
    """The widest H of K1's wide route on the card's numbers: the streaming
    backward's one-row tile holds two rows of dhp, 2·3H floats (3H rounded
    up to 4), in one block's shared memory (``card["smem"]``, the opt-in
    bytes a block; the card reserves its 1 KB a block on top). H 9685 on
    the H100's 232,448 bytes. Past it no route holds a step's dhp, and the
    wrappers raise."""
    return card["smem"] // 8 // 4 * 4 // 3


def _check_wide(name: str, H: int, card: dict) -> None:
    cap = wide_cap(card)
    if H > cap:
        raise ValueError(
            f"{name}: H={H} past the wide route's cap H {cap} on this card: the streaming "
            f"backward's one-row tile, 2 x 3H floats of dhp, must fit a block's "
            f"{card['smem']} shared bytes")


def stream_plan(nb: int, B: int, H: int, card: dict) -> dict:
    """The streaming kernels' tile for (nb, B, H) on the card's numbers (as
    ``gru_seq_wide.cu``'s ``make_wide_tile``): R rows a block, the fewest of
    :data:`STREAM_ROWS` that give one tile per SM for the launch's nb·B
    rows (else 4), halved while the backward's shared bytes
    (:func:`stream_smem`) do not fit a block; ceil(B / R) blocks a bucket;
    min(1024, H rounded up to a warp) threads a block, each owning ``cols``
    = ceil(H / threads) columns; both halves' shared bytes. Raises past
    :func:`wide_cap`."""
    _check_wide("K1's streaming kernels", H, card)
    want = -(-max(nb, 1) * max(B, 1) // card["sms"])
    R = 1 if want <= 1 else 2 if want <= 2 else STREAM_ROWS[-1]
    while R > 1 and stream_smem(R, H)[1] > card["smem"]:
        R //= 2
    threads = min(STREAM_MAX_THREADS, -(-H // 32) * 32)
    fwd_smem, bwd_smem = stream_smem(R, H)
    return {"route": "stream", "R": R, "blocks": -(-B // R), "threads": threads,
            "cols": -(-H // threads), "fwd_smem": fwd_smem, "bwd_smem": bwd_smem}


def wide_plan(nb: int, B: int, H: int, card: dict) -> dict:
    """K1's wide forward route for (nb, B, H) on the card's numbers: the
    cluster plan (:func:`cluster_plan`) up to the clusters' cap, the grid
    plan (:func:`grid_plan`) where a bucket's grid blocks are resident at
    once (to H 1024 on the H100; the streaming kernel's,
    :func:`stream_plan`, on a card without cooperative launches), and past
    :data:`GRID_MAX_HIDDEN` the grid that streams W's remainder
    (:func:`grid_stream_plan`, which raises where it cannot launch) up to
    :func:`wide_cap` (raises past it)."""
    plan = cluster_plan(nb, B, H, card)
    if plan["route"] == "cluster":
        return plan
    if H > GRID_MAX_HIDDEN:
        _check_wide("K1's wide forward", H, card)
        return grid_stream_plan(nb, B, H, card)
    return grid_plan(nb, B, H, card, must=False) or stream_plan(nb, B, H, card)


def wide_bwd_plan(nb: int, B: int, H: int, card: dict) -> dict:
    """K1's wide backward route for (nb, B, H) on the card's numbers: the
    cluster backward's plan (:func:`cluster_bwd_plan`) up to its cap, the
    grid backward's (:func:`grid_bwd_plan`) where a bucket's blocks are
    resident at once, else the streaming kernel's (:func:`stream_plan`)."""
    plan = cluster_bwd_plan(nb, B, H, card)
    if plan["route"] == "cluster":
        return plan
    return grid_bwd_plan(nb, B, H, card, must=False) or stream_plan(nb, B, H, card)


_CARDS: dict[int, dict] = {}


def cluster_card(device: torch.device | None = None) -> dict:
    """The numbers :func:`cluster_plan`, :func:`grid_plan`,
    :func:`grid_bwd_plan`, :func:`grid_stream_plan` and :func:`stream_plan`
    take, from the card itself (``gru_seq_cluster_card``,
    ``gru_seq_grid_card``, ``gru_seq_grid_bwd_card``,
    ``gru_seq_grid_stream_card``; kept per device): SMs, shared bytes a
    block and an SM and those reserved a block, clusters of each C resident
    at once, one block an SM, and the grid forward's, the grid backward's
    and the grid forward past H 1024's blocks resident on an SM at no
    dynamic shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    the last the fewest of its instances; 0 where the card has no
    cooperative launches)."""
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _CARDS:
        lib = _build.load_library()
        out = (ctypes.c_int * 8)()
        grid, grid_bwd, stream = ((ctypes.c_int * 2)() for _ in range(3))
        with torch.cuda.device(index):
            _build.check(lib, "gru_seq_cluster_card", lib.gru_seq_cluster_card(out))
            _build.check(lib, "gru_seq_grid_card", lib.gru_seq_grid_card(grid))
            _build.check(lib, "gru_seq_grid_bwd_card", lib.gru_seq_grid_bwd_card(grid_bwd))
            _build.check(lib, "gru_seq_grid_stream_card", lib.gru_seq_grid_stream_card(stream))
        _CARDS[index] = {"sms": out[0], "smem": out[1], "smem_sm": out[2],
                         "smem_reserved": out[3],
                         "resident": dict(zip(CLUSTER_SIZES, out[4:8])),
                         "grid_blocks_sm": grid[1] * grid[0],
                         "grid_bwd_blocks_sm": grid_bwd[1] * grid_bwd[0],
                         "grid_stream_blocks_sm": stream[1] * stream[0]}
    return _CARDS[index]


def gru_sequence_wide(xp, w_hh_t, b_hh, h0, plan: dict | None = None) -> torch.Tensor:
    """Launch K1's wide forward on stacked, checked CUDA tensors (any H up
    to :func:`wide_cap`; :func:`gru_sequence` takes it past
    :data:`MAX_HIDDEN`) on :func:`wide_plan`'s route, or the ``plan`` given:
    the cluster kernel (counted by ``gru_sequence_wide.cluster_launches``)
    where a cluster holds W_hhᵀ, the grid kernel (one launch a wave of
    buckets, each counted by ``gru_sequence_wide.grid_launches``) where a
    bucket's grid blocks are resident at once, and the streaming kernel
    (``gru_sequence_wide.launches``; ``{"route": "stream"}``, whose tile
    the kernel takes from the card, as :func:`stream_plan`), which the
    planned route no longer takes; past H 1024 the grid that streams W's
    remainder (one launch a wave of buckets, each counted by
    ``gru_sequence_wide.grid_stream_launches``). A plan the card cannot
    launch raises."""
    nb, T, B, H = _check_shapes(xp, w_hh_t, b_hh, h0)
    ys = torch.empty((nb, T, B, H), dtype=torch.float32, device=xp.device)
    if nb and T and B:
        if plan is None:
            plan = wide_plan(nb, B, H, cluster_card(xp.device))
        if plan["route"] == "cluster":
            _launch("gru_seq_cluster_fwd", xp, w_hh_t, b_hh, h0, ys, nb, T, B, H,
                    *(plan[k] for k in ("C", "R", "S", "KL", "U")))
            gru_sequence_wide.cluster_launches += 1
        elif plan["route"] == "grid":
            gru_sequence_wide.grid_launches += _grid_waves(
                "gru_seq_grid_fwd", "gru_seq_grid_workspace", (xp, w_hh_t, b_hh, h0, ys),
                (nb, T, B, H), plan)
        elif plan["route"] == "grid_stream":
            gru_sequence_wide.grid_stream_launches += _grid_waves(
                "gru_seq_grid_stream_fwd", "gru_seq_grid_stream_workspace",
                (xp, w_hh_t, b_hh, h0, ys), (nb, T, B, H), plan, *_stream_args(plan))
        elif plan["route"] == "stream":
            _launch("gru_seq_wide_fwd", xp, w_hh_t, b_hh, h0, ys, nb, T, B, H)
            gru_sequence_wide.launches += 1
        else:
            raise ValueError(f"gru_sequence_wide: no route {plan['route']!r}")
    return ys


def _grid_waves(fn: str, workspace: str, tensors: tuple, dims: tuple, plan: dict,
                *extra: int) -> int:
    """Launch ``fn`` (a grid kernel or its probe) on ``tensors`` once for each
    wave of the plan's ``buckets_per_wave`` buckets, on one zeroed workspace
    of ``workspace``'s words (the flags and the exchange buffers of every
    bucket, and past H 1024 W's slices), ``extra`` (the plan's own ints;
    the first also the workspace's) after the wave's buckets; returns the
    launches."""
    nb, T, B, H = dims
    lib = _build.load_library()
    words = getattr(lib, workspace)(nb, B, H, *extra[:1])
    if words < 0:
        raise ValueError(f"{fn}: no workspace for nb={nb} B={B} H={H}")
    ws = torch.zeros(words, dtype=torch.int32, device=tensors[0].device)
    per_wave = plan["buckets_per_wave"]
    for first in range(0, nb, per_wave):
        _launch(fn, *tensors, ws, nb, T, B, H, first, min(per_wave, nb - first), *extra)
    return -(-nb // per_wave)


def _stream_args(plan: dict) -> tuple[int, int]:
    """The ints a grid_stream plan hands its kernel: J and the resident
    depth."""
    return plan["groups"], plan["resident_depth"]


def cluster_chain_probe(xp, w_hh_t, b_hh, h0, plan: dict) -> None:
    """Launch the cluster forward's step-chain probe (``gru_seq_cluster_chain``)
    on the inputs of a :func:`gru_sequence_wide` call and its cluster plan:
    the same launch with each step's sums and gates left out, T steps of the
    exchange of h and the wait for it alone. It writes nothing, is counted
    by no launch counter, and is timed as the route's step-chain floor."""
    nb, T, B, H = _check_shapes(xp, w_hh_t, b_hh, h0)
    _launch("gru_seq_cluster_chain", xp, w_hh_t, b_hh, h0, xp, nb, T, B, H,
            *(plan[k] for k in ("C", "R", "S", "KL", "U")))


def grid_chain_probe(xp, w_hh_t, b_hh, h0, plan: dict) -> None:
    """Launch the grid forward's step-chain probe (``gru_seq_grid_chain``) on
    the inputs of a :func:`gru_sequence_wide` call and its grid plan: the
    same launches with each step's product and gates left out, T steps of
    the wait, the read of h from L2 and the publication alone. It writes
    only its workspace, is counted by no launch counter, and is timed as the
    route's step-chain floor."""
    _grid_waves("gru_seq_grid_chain", "gru_seq_grid_workspace", (xp, w_hh_t, b_hh, h0, xp),
                _check_shapes(xp, w_hh_t, b_hh, h0), plan)


def grid_stream_chain_probe(xp, w_hh_t, b_hh, h0, plan: dict) -> None:
    """Launch the step-chain probe of the grid forward past H 1024
    (``gru_seq_grid_stream_chain``) on the inputs of a
    :func:`gru_sequence_wide` call and its grid_stream plan: the same
    launches with W's prep, each step's product and gates left out, T steps
    of the wait, the copies of h and of W's streamed rows from L2 and the
    publication alone. It writes only its workspace, is counted by no launch
    counter, and is timed as the route's step-chain floor."""
    _grid_waves("gru_seq_grid_stream_chain", "gru_seq_grid_stream_workspace",
                (xp, w_hh_t, b_hh, h0, xp), _check_shapes(xp, w_hh_t, b_hh, h0), plan,
                *_stream_args(plan))


def wide_tile(nb: int, B: int, H: int) -> dict:
    """The wide route for (nb, B, H) on the current card: the forward's
    ``route`` (``"cluster"``, ``"grid"``, ``"grid_stream"`` or ``"stream"``)
    with its cluster ``C`` and rows ``R`` (None off the cluster kernel) and
    ``plan`` (:func:`wide_plan`: the cluster, grid, grid_stream or streaming
    plan); the backward's
    the same under ``bwd_route``, ``bwd_C``, ``bwd_R`` and ``bwd_plan``
    (:func:`wide_bwd_plan`); and the streaming kernels' tile as the kernel
    makes it on the card (:func:`stream_plan` mirrors it): batch rows a
    block, tiles a bucket, threads a block, and the forward's and the
    backward's shared bytes."""
    lib = _build.load_library()
    out = (ctypes.c_int * 5)()
    _build.check(lib, "gru_seq_wide_tile", lib.gru_seq_wide_tile(nb, B, H, out))
    card = cluster_card()
    plan = wide_plan(nb, B, H, card)
    bwd = wide_bwd_plan(nb, B, H, card)
    return {"route": plan["route"], "C": plan.get("C"), "R": plan.get("R"), "plan": plan,
            "bwd_route": bwd["route"], "bwd_C": bwd.get("C"), "bwd_R": bwd.get("R"),
            "bwd_plan": bwd,
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


def gru_sequence_bwd(xp, w_hh_t, b_hh, h0, ys, d_ys, plan: dict | None = None):
    """K1's backward on stacked inputs: (dxp, dw_hh_t, db_hh, dh0).

    CPU tensors take the plain version. CUDA tensors run three parts: one
    batched matrix product hp = h_prev W_hhᵀ over all T·B rows (h_prev =
    [h0, ys[:-1]]); the kernel (:func:`gru_sequence_bwd_recurrence`: the
    reverse recurrence, which adds b_hh to hp, writes dxp and dh0, and
    writes dhp over hp; past H 128 :func:`gru_sequence_bwd_wide`); then
    :func:`weight_grads`, dW_hhᵀ = h_prevᵀ dhp as batched products and
    db_hh = Σ dhp as one sum. ``gru_sequence_bwd.launches``,
    ``gru_sequence_bwd_wide.cluster_launches``,
    ``gru_sequence_bwd_wide.grid_launches`` and
    ``gru_sequence_bwd_wide.launches`` count the kernels' launches. A
    ``plan`` (past H 128 only) is the wide backward's, as
    :func:`gru_sequence_bwd_wide` takes it."""
    nb, T, B, H = _check_shapes(xp, w_hh_t, b_hh, h0)
    for name, t in (("ys", ys), ("d_ys", d_ys)):
        if tuple(t.shape) != (nb, T, B, H):
            raise ValueError(f"{name} must be {(nb, T, B, H)}, got {tuple(t.shape)}")
    device = _device_of("gru_sequence_bwd", xp, w_hh_t, b_hh, h0, ys, d_ys)
    if device.type == "cpu":
        return gru_sequence_bwd_reference(xp, w_hh_t, b_hh, h0, ys, d_ys)
    _check_cuda("gru_sequence_bwd", H, None, xp=xp, w_hh_t=w_hh_t,
                b_hh=b_hh, h0=h0, ys=ys, d_ys=d_ys)
    h_prev = torch.cat([h0.unsqueeze(1), ys[:, :T - 1]], dim=1) if T else ys
    h_prev = h_prev.reshape(nb, T * B, H)
    dhp = torch.matmul(h_prev, w_hh_t)      # hp; the kernel writes dhp over it
    if H <= MAX_HIDDEN:
        if plan is not None:
            raise ValueError(f"gru_sequence_bwd: a plan is the wide route's, H={H}")
        dxp, dh0 = gru_sequence_bwd_recurrence(xp, dhp, h_prev, d_ys, w_hh_t, b_hh, dhp)
    else:
        dxp, dh0 = gru_sequence_bwd_wide(xp, dhp, h_prev, d_ys, w_hh_t, b_hh, dhp, plan)
    return (dxp, *weight_grads(h_prev, dhp), dh0)


_BWD_PLAN_KEYS = ("C", "R", "S", "KE", "U")


def gru_sequence_bwd_wide(xp, hp, h_prev, d_ys, w_hh_t, b_hh, dhp, plan: dict | None = None):
    """Launch K1's wide backward on CUDA tensors: the arguments and results
    of :func:`gru_sequence_bwd_recurrence`, for any H up to
    :func:`wide_cap`, on :func:`wide_bwd_plan`'s route, or the ``plan``
    given: the cluster kernel (counted by
    ``gru_sequence_bwd_wide.cluster_launches``) where a cluster holds
    W_hhᵀ, the grid kernel (one launch a wave of buckets, each counted by
    ``gru_sequence_bwd_wide.grid_launches``; none at T = 0, where dh0 is
    zero) where a bucket's grid blocks are resident at once, and the
    streaming kernel past that (``{"route": "stream"}``), which streams
    W_hh and is passed W_hhᵀ transposed back, contiguous
    (``gru_sequence_bwd_wide.launches``). A plan the card cannot launch
    raises."""
    nb, T, B, H = d_ys.shape
    dxp = torch.empty_like(xp)
    dh0 = torch.empty((nb, B, H), dtype=torch.float32, device=xp.device)
    if nb and B:
        if plan is None:
            plan = wide_bwd_plan(nb, B, H, cluster_card(xp.device))
        if plan["route"] == "cluster":
            _launch("gru_seq_cluster_bwd", xp, hp, h_prev, d_ys, w_hh_t, b_hh, dxp, dhp, dh0,
                    nb, T, B, H, *(plan[k] for k in _BWD_PLAN_KEYS))
            gru_sequence_bwd_wide.cluster_launches += 1
        elif plan["route"] == "grid":
            if T:
                gru_sequence_bwd_wide.grid_launches += _grid_waves(
                    "gru_seq_grid_bwd", "gru_seq_grid_bwd_workspace",
                    (xp, hp, h_prev, d_ys, w_hh_t, b_hh, dxp, dhp, dh0), (nb, T, B, H), plan)
            else:
                dh0.zero_()
        elif plan["route"] == "stream":
            w_hh = w_hh_t.transpose(-1, -2).contiguous()
            _launch("gru_seq_wide_bwd", xp, hp, h_prev, d_ys, w_hh, b_hh, dxp, dhp, dh0,
                    nb, T, B, H)
            gru_sequence_bwd_wide.launches += 1
        else:
            raise ValueError(f"gru_sequence_bwd_wide: no route {plan['route']!r}")
    return dxp, dh0


def grid_bwd_chain_probe(xp, hp, h_prev, d_ys, w_hh_t, b_hh, plan: dict) -> None:
    """Launch the grid backward's step-chain probe (``gru_seq_grid_bwd_chain``)
    on the inputs of a :func:`gru_sequence_bwd_wide` call and its grid plan:
    the same launches with each step's coefficients, product and dhp left
    out, T steps of the wait, the read of dhp from L2 and the publication
    alone. It writes only its workspace, is counted by no launch counter,
    and is timed as the route's step-chain floor."""
    _grid_waves("gru_seq_grid_bwd_chain", "gru_seq_grid_bwd_workspace",
                (xp, hp, h_prev, d_ys, w_hh_t, b_hh, xp, xp, xp), d_ys.shape, plan)


def cluster_bwd_chain_probe(xp, hp, h_prev, d_ys, w_hh_t, b_hh, plan: dict) -> None:
    """Launch the cluster backward's step-chain probe
    (``gru_seq_cluster_bwd_chain``) on the inputs of a
    :func:`gru_sequence_bwd_wide` call and its cluster plan: the same launch
    with each step's coefficients, dhp and sums left out, T steps of the
    exchange of the partials and the wait for them alone. It writes nothing,
    is counted by no launch counter, and is timed as the route's step-chain
    floor."""
    nb, T, B, H = d_ys.shape
    _launch("gru_seq_cluster_bwd_chain", xp, hp, h_prev, d_ys, w_hh_t, b_hh, xp, xp, xp,
            nb, T, B, H, *(plan[k] for k in _BWD_PLAN_KEYS))


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
    :data:`MAX_HIDDEN`, ``gru_sequence_wide.cluster_launches``,
    ``gru_sequence_wide.grid_launches``,
    ``gru_sequence_wide.grid_stream_launches`` and
    ``gru_sequence_wide.launches`` the wide route's past it (the cluster,
    the grid, the grid past H 1024 and the streaming kernel; and
    ``gru_sequence_bwd``,
    ``gru_sequence_bwd_wide.cluster_launches``,
    ``gru_sequence_bwd_wide.grid_launches`` and
    ``gru_sequence_bwd_wide.launches`` the backward's).
    H past :func:`wide_cap` (H 9685 on the H100) raises."""
    if xp.dim() == 3:
        return gru_sequence(xp[None], w_hh_t[None], b_hh[None], h0[None])[0]
    return GRUSequence.apply(xp, w_hh_t, b_hh, h0)


gru_sequence.launches = 0
gru_sequence_bwd.launches = 0
gru_sequence_wide.launches = 0
gru_sequence_wide.cluster_launches = 0
gru_sequence_wide.grid_launches = 0
gru_sequence_wide.grid_stream_launches = 0
gru_sequence_bwd_wide.launches = 0
gru_sequence_bwd_wide.cluster_launches = 0
gru_sequence_bwd_wide.grid_launches = 0
