"""Synthetic data for the port (counterpart: ``src/repro/data/``)."""
from repro_torch.data.synthetic import (  # noqa: F401
    synth_classification,
    synth_imagenet_features,
)
