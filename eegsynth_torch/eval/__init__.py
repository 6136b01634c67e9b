"""TimeGAN evaluation: the GRU(24) discriminative and predictive scorers, the
statistical similarity of a real and a synthetic corpus, and the driver that
writes the metric CSVs. Counterpart of ``eegsynth/eval`` (its TimeGAN part,
without the PCA / t-SNE figures)."""

from eegsynth_torch.eval.classifiers import discriminative_score, predictive_score  # noqa: F401
from eegsynth_torch.eval.stats import statistical_similarity  # noqa: F401
