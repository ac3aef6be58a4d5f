"""Serving (counterpart: ``src/repro/serve/``): the prediction service for
fitted models, the continuous-batching LM engine with its scheduler, the
radix prefix KV cache, and the replica router with its autoscaler."""
from repro_torch.serve.autoscaler import QueueAutoscaler  # noqa: F401
from repro_torch.serve.engine import ServeEngine  # noqa: F401
from repro_torch.serve.predictor import ModelPredictor, PredictRequest  # noqa: F401
from repro_torch.serve.prefix_cache import PrefixMatch, RadixPrefixCache  # noqa: F401
from repro_torch.serve.router import PredictorFleet, ReplicaRouter  # noqa: F401
from repro_torch.serve.scheduler import (FairQueue, Request, SlotScheduler,  # noqa: F401
                                         tenant_report)
