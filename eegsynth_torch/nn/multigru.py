"""Fused multi-network GRU kernel K2: the D-step inputs of every stacked
bucket in one launch.

Counterpart of ``eegsynth/nn/pallas_multigru.py``
(``multigru_disc_inputs_pallas``). Per time step and per bucket it runs the
embedder cell, the generator cell, the generator projection, the supervisor
input projection, the supervisor cell and the supervisor projection. Forward
only: the D step differentiates only through the discriminator.

On a CUDA tensor :func:`multigru_disc_inputs` launches the Hopper kernel
``eegsynth_torch/csrc/multigru.cu`` or raises; on a CPU tensor it runs
:func:`multigru_disc_inputs_reference`, the plain PyTorch version (the
stacked ``fused_disc_inputs`` of ``eegsynth/models/timegan.py``: a loop over T
with batched products), which is also the kernel's oracle on the card.

Layouts (f32), time-major with a leading bucket axis: xp_e (nb, T, B, 3He),
xp_g (nb, T, B, 3Hg); weights transposed so that a product is ``v @ W``:
w_e (nb, He, 3He), w_g (nb, Hg, 3Hg), w_pg (nb, Hg, Z), w_is (nb, Z, 3Hs),
w_s (nb, Hs, 3Hs), w_ps (nb, Hs, Z); biases (nb, n) → h_real (nb, T, B, He),
h_fake (nb, T, B, Z).

Accepted widths on the card: every width at most 128 (``MAX_HIDDEN``), the
widest ``adaptive_dims`` gives (z64/h128) included, and any nb, T and B.
The kernel runs the three cells on the three blocks of a thread-block
cluster (generator, supervisor, embedder), each with its recurrent weights
in registers as K1's forward, the projections beside the cells' sums, and
G's and S's outputs passed on through rings in the next block's shared
memory (``multigru.cu``'s header). Called with anything else, the wrapper
raises; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from eegsynth_torch import _build
from eegsynth_torch.nn.gru_sequence import _check_cuda, _device_of, _gates, _launch

WEIGHTS = ("w_e", "b_e", "w_g", "b_g", "w_pg", "b_pg", "w_is", "b_is",
           "w_s", "b_s", "w_ps", "b_ps")


def _cell(xp_t, h, w, b):
    _, z, n = _gates(xp_t, torch.matmul(h, w) + b, h.shape[-1])
    return (1.0 - z) * n + z * h


def multigru_disc_inputs_reference(xp_e, xp_g, w_e, b_e, w_g, b_g, w_pg, b_pg,
                                   w_is, b_is, w_s, b_s, w_ps, b_ps):
    """Plain PyTorch version: ``_make_kernel``'s body as a loop over T, every
    bucket at once through batched products."""
    nb, T, B, _ = xp_e.shape
    b_e, b_g, b_pg, b_is, b_s, b_ps = (b.unsqueeze(1) for b in
                                       (b_e, b_g, b_pg, b_is, b_s, b_ps))
    h_e = xp_e.new_zeros((nb, B, w_e.shape[1]))
    h_g = xp_e.new_zeros((nb, B, w_g.shape[1]))
    h_s = xp_e.new_zeros((nb, B, w_s.shape[1]))
    real, fake = [], []
    for t in range(T):
        h_e = _cell(xp_e[:, t], h_e, w_e, b_e)
        h_g = _cell(xp_g[:, t], h_g, w_g, b_g)
        e_t = torch.matmul(h_g, w_pg) + b_pg
        s_in = torch.matmul(e_t, w_is) + b_is
        h_s = _cell(s_in, h_s, w_s, b_s)
        real.append(h_e)
        fake.append(torch.matmul(h_s, w_ps) + b_ps)
    if not real:
        return (xp_e.new_empty((nb, 0, B, w_e.shape[1])),
                xp_e.new_empty((nb, 0, B, w_ps.shape[2])))
    return torch.stack(real, dim=1), torch.stack(fake, dim=1)


def k2_tile(nb: int, B: int, He: int, Hg: int, Hs: int, Z: int) -> dict[str, int]:
    """The kernel's tile for (nb, B, widths) on the current card: batch rows a
    cluster, tiles a bucket, threads and shared bytes a block, the clusters of
    the launch and how many can be resident at once, and the instance's KL, S
    and KLZ (the slice of e W_is's depth Z)."""
    lib = _build.load_library()
    out = (ctypes.c_int * 9)()
    _build.check(lib, "multigru_fwd_tile", lib.multigru_fwd_tile(nb, B, He, Hg, Hs, Z, out))
    return dict(zip(("rows", "tiles", "threads", "smem", "clusters", "resident", "kl",
                     "s", "klz"), out))


def _dims(xp_e, xp_g, w):
    if xp_e.dim() != 4 or xp_g.dim() != 4:
        raise ValueError("xp_e, xp_g must be (nb, T, B, 3H)")
    nb, T, B, _ = xp_e.shape
    He, Hg, Hs, Z = (w["w_e"].shape[1], w["w_g"].shape[1], w["w_s"].shape[1],
                     w["w_pg"].shape[2])
    shapes = {"w_e": (nb, He, 3 * He), "b_e": (nb, 3 * He),
              "w_g": (nb, Hg, 3 * Hg), "b_g": (nb, 3 * Hg),
              "w_pg": (nb, Hg, Z), "b_pg": (nb, Z),
              "w_is": (nb, Z, 3 * Hs), "b_is": (nb, 3 * Hs),
              "w_s": (nb, Hs, 3 * Hs), "b_s": (nb, 3 * Hs),
              "w_ps": (nb, Hs, Z), "b_ps": (nb, Z)}
    for name, shape in shapes.items():
        if tuple(w[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(w[name].shape)}")
    for name, t, shape in (("xp_e", xp_e, (nb, T, B, 3 * He)),
                           ("xp_g", xp_g, (nb, T, B, 3 * Hg))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return nb, T, B, He, Hg, Hs, Z


def multigru_disc_inputs(xp_e, xp_g, w_e, b_e, w_g, b_g, w_pg, b_pg, w_is,
                         b_is, w_s, b_s, w_ps, b_ps):
    """(h_real (nb,T,B,He), h_fake (nb,T,B,Z)) for all stacked buckets.

    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    ``multigru_disc_inputs.launches`` counts those launches."""
    weights = dict(zip(WEIGHTS, (w_e, b_e, w_g, b_g, w_pg, b_pg, w_is, b_is,
                                 w_s, b_s, w_ps, b_ps)))
    nb, T, B, He, Hg, Hs, Z = _dims(xp_e, xp_g, weights)
    device = _device_of("multigru_disc_inputs", xp_e, xp_g, *weights.values())
    if device.type == "cpu":
        return multigru_disc_inputs_reference(xp_e, xp_g, *weights.values())
    _check_cuda("multigru_disc_inputs", max(He, Hg, Hs, Z), xp_e=xp_e, xp_g=xp_g,
                **weights)
    h_real = torch.empty((nb, T, B, He), dtype=torch.float32, device=device)
    h_fake = torch.empty((nb, T, B, Z), dtype=torch.float32, device=device)
    if nb and T and B:
        _launch("multigru_fwd", xp_e, xp_g, *weights.values(), h_real, h_fake,
                nb, T, B, He, Hg, Hs, Z)
        multigru_disc_inputs.launches += 1
    return h_real, h_fake


multigru_disc_inputs.launches = 0
