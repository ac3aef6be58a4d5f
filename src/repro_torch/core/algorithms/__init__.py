"""Algorithms of the port (counterpart: ``src/repro/core/algorithms/``)."""
from repro_torch.core.algorithms.kmeans import (  # noqa: F401
    KMeans,
    KMeansModel,
    KMeansParameters,
)
from repro_torch.core.algorithms.logistic_regression import (  # noqa: F401
    LogisticRegression,
    LogisticRegressionAlgorithm,
    LogisticRegressionModel,
    LogisticRegressionParameters,
)
