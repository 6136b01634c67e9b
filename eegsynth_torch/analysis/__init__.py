"""Mental-fatigue analysis: band powers, fatigue indices, t-test reports.

Counterpart of ``eegsynth/analysis`` without its figures (``plots.py`` and
the bar figures of ``ttests.four_group_report``): the spectra are batched
float64 Welch PSDs and rFFT powers on a device; the t-tests stay on the host
with scipy.stats, on the unscaled values.
"""

from eegsynth_torch.analysis.bandpower import (  # noqa: F401
    BANDS, band_powers, compute_psd_per_channel,
)
from eegsynth_torch.analysis.fatigue import fatigue_indices, workload_ratio  # noqa: F401
