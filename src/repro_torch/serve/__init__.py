"""Serving of fitted models (counterpart: ``src/repro/serve/``)."""
from repro_torch.serve.predictor import ModelPredictor, PredictRequest  # noqa: F401
