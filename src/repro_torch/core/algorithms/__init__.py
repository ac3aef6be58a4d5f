"""Algorithms of the port (counterpart: ``src/repro/core/algorithms/``).

``__all__`` is the reference's list; ``PCA`` and ``GaussianNaiveBayes``
(and their models and parameters) are importable from here too, as there.
"""
from repro_torch.core.algorithms.logistic_regression import (  # noqa: F401
    LogisticRegression,
    LogisticRegressionAlgorithm,
    LogisticRegressionModel,
    LogisticRegressionParameters,
)
from repro_torch.core.algorithms.linear_models import (  # noqa: F401
    GeneralizedLinearModel,
    LinearRegressionAlgorithm,
    LinearRegressionParameters,
    LinearSVMAlgorithm,
    LinearSVMParameters,
    Regularization,
)
from repro_torch.core.algorithms.als import (  # noqa: F401
    ALSParameters,
    BroadcastALS,
    MatrixFactorizationModel,
)
from repro_torch.core.algorithms.kmeans import (  # noqa: F401
    KMeans,
    KMeansModel,
    KMeansParameters,
)

__all__ = [
    "LogisticRegressionAlgorithm", "LogisticRegressionModel", "LogisticRegressionParameters",
    "LinearRegressionAlgorithm", "LinearRegressionParameters",
    "LinearSVMAlgorithm", "LinearSVMParameters",
    "GeneralizedLinearModel", "Regularization",
    "BroadcastALS", "ALSParameters", "MatrixFactorizationModel",
    "KMeans", "KMeansParameters", "KMeansModel",
]
from repro_torch.core.algorithms.pca import PCA, PCAModel, PCAParameters  # noqa: F401,E402
from repro_torch.core.algorithms.naive_bayes import (  # noqa: F401,E402
    GaussianNaiveBayes,
    NaiveBayesModel,
    NaiveBayesParameters,
)
