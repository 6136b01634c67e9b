"""How far a scan over time drifts from the serial IIR recurrence, on the
host: the reason the IIR kernel (``csrc/iir_filter.cu``) stays serial in
time.

The scan filters x in chunks of L rows: each chunk from a zero state (the
chunks independent of each other), then the states at the chunks' starts
carried across the chunks in float64 with the companion matrix's L-th power,
then each chunk filtered again from its carried state. It equals the serial
recurrence in exact arithmetic; in floating point it differs, most where the
poles lie near the unit circle (the order-8 band-pass's reach |p| 0.98 at
fs 128). Filters and input as preprocessing's: the 1–45 Hz band-pass and the
60 Hz notch at fs 128, a random walk of 14 columns over one 60 s trial with
the band-pass's odd extension (7734 rows).

    python3 -m eegsynth_torch.tools.iir_scan_error

Prints, for each filter, dtype and L, the largest difference from scipy's
serial ``lfilter`` in the same dtype relative to its largest output, and the
filter's largest pole magnitude.
"""

from __future__ import annotations

import numpy as np
import scipy.signal

from eegsynth_torch.data.filters import design_filters

T, M = 7734, 14
CHUNKS = (32, 64, 128, 256)


def companion(b: np.ndarray, a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The direct-form-II-transposed state update z' = A z + B x (float64),
    with a[0] = 1: A[i, 0] = −a[i+1], A[i, i+1] = 1; B[i] = b[i+1] − a[i+1]·b[0]."""
    order = len(a) - 1
    A = np.zeros((order, order))
    A[:, 0] = -a[1:]
    A[:-1, 1:] = np.eye(order - 1)
    return A, b[1:] - a[1:] * b[0]


def chunked_scan(b: np.ndarray, a: np.ndarray, x: np.ndarray, zi: np.ndarray,
                 L: int) -> np.ndarray:
    """x (T, M) filtered by the chunked scan above, each pass in x's dtype,
    the carry in float64."""
    A, _ = companion(b, a)
    AL = np.linalg.matrix_power(A, L)
    bd, ad = b.astype(x.dtype), a.astype(x.dtype)
    starts = range(0, x.shape[0], L)
    z = zi.astype(np.float64)
    y = np.empty_like(x)
    for s in starts:
        chunk = x[s:s + L]
        _, zf0 = scipy.signal.lfilter(bd, ad, chunk, axis=0,
                                      zi=np.zeros_like(zi, dtype=x.dtype))
        y[s:s + L], _ = scipy.signal.lfilter(bd, ad, chunk, axis=0, zi=z.astype(x.dtype))
        step = np.linalg.matrix_power(A, len(chunk)) if len(chunk) < L else AL
        z = step @ z + zf0.astype(np.float64)
    return y


def scan_errors(T: int = T, M: int = M, chunks=CHUNKS, seed: int = 0) -> list[dict]:
    """The relative error of the chunked scan for both filters, float64 and
    float32, at each chunk length."""
    (b_bp, a_bp), (b_n, a_n) = design_filters(128.0)
    walk = np.random.default_rng(seed).standard_normal((T, M)).cumsum(axis=0)
    rows = []
    for name, (b, a) in (("band-pass", (b_bp, a_bp)), ("notch", (b_n, a_n))):
        pole = float(np.abs(np.roots(a)).max())
        for dtype in (np.float64, np.float32):
            x = walk.astype(dtype)
            zi = (scipy.signal.lfilter_zi(b, a)[:, None] * x[0]).astype(dtype)
            ref, _ = scipy.signal.lfilter(b.astype(dtype), a.astype(dtype), x, axis=0, zi=zi)
            for L in chunks:
                y = chunked_scan(b, a, x, zi, L)
                rel = float(np.abs(y - ref).max() / np.abs(ref).max())
                rows.append({"filter": name, "dtype": np.dtype(dtype).name, "L": L,
                             "rel": rel, "pole": pole})
    return rows


def main() -> None:
    for r in scan_errors():
        print(f"[scan] {r['filter']} (largest pole |p| {r['pole']:.4f}) {r['dtype']} L={r['L']}: "
              f"max|scan - serial| / max|serial| = {r['rel']:.3e}", flush=True)


if __name__ == "__main__":
    main()
