"""Synthetic data for the port (counterpart: ``src/repro/data/``)."""
from repro_torch.data.synthetic import (  # noqa: F401
    synth_classification,
    synth_imagenet_features,
    synth_labeled_text,
    synth_netflix_tiled,
    synth_text_corpus,
)
