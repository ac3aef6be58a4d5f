"""Shard-aware model evaluation (counterpart: ``src/repro/eval/``)."""
from repro_torch.eval.metrics import (  # noqa: F401
    MetricHistory,
    accuracy,
    log_loss,
    predictions,
    rmse,
    silhouette_lite,
)

__all__ = ["accuracy", "log_loss", "rmse", "silhouette_lite", "predictions",
           "MetricHistory"]
