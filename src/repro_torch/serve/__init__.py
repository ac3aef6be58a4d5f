"""Serving (counterpart: ``src/repro/serve/``): the prediction service for
fitted models and the continuous-batching LM engine with its scheduler."""
from repro_torch.serve.engine import ServeEngine  # noqa: F401
from repro_torch.serve.predictor import ModelPredictor, PredictRequest  # noqa: F401
from repro_torch.serve.scheduler import (FairQueue, Request, SlotScheduler,  # noqa: F401
                                         tenant_report)
