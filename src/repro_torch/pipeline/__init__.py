"""One fitted-model contract from raw table to serving (paper Fig. A2).

Counterpart: ``src/repro/pipeline/``.  ``Pipeline`` composes fitted
transformers (:class:`repro_torch.features.NGrams`, ``TfIdf``,
``HashingVectorizer``, ``Standardizer``, ``BiasAdder``) and one terminal
estimator into a single object that fits through the emulated
:class:`repro_torch.core.runner.DistributedRunner` and serves raw rows
through :class:`repro_torch.serve.ModelPredictor`.
"""
from repro_torch.pipeline.pipeline import FittedPipeline, Pipeline

__all__ = ["Pipeline", "FittedPipeline"]
