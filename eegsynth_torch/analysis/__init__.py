"""Mental-fatigue analysis: band powers, fatigue indices, t-test reports.

Counterpart of ``eegsynth/analysis``: the spectra are batched float64 Welch
PSDs and rFFT powers on a device; the t-tests stay on the host with
scipy.stats, on the unscaled values; the figures (``plots.py``, the bars of
``ttests.four_group_report``) are drawn on the host by the port's raster
layer.
"""

from eegsynth_torch.analysis.bandpower import (  # noqa: F401
    BANDS, band_powers, compute_psd_per_channel,
)
from eegsynth_torch.analysis.fatigue import fatigue_indices, workload_ratio  # noqa: F401
