"""Figures without matplotlib: the raster layer (``raster``), the colormaps
(``colors``), the embeddings on the card (``embed``) and the figure families
of the JAX package's ``eegsynth/viz`` (``cluster``, ``traces``,
``prep_stages``)."""
