"""Synthetic data and the seekable stream of the port (counterpart:
``src/repro/data/``)."""
from repro_torch.data.pipeline import BatchIterator, shard_batch  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    synth_classification,
    synth_imagenet_features,
    synth_labeled_text,
    synth_netflix_tiled,
    synth_text_corpus,
)
