"""One fitted-model contract from raw table to serving (paper Fig. A2).

Counterpart: ``src/repro/pipeline/``.  ``Pipeline`` composes fitted
transformers (:class:`repro_torch.features.NGrams`, ``TfIdf``,
``HashingVectorizer``, ``Standardizer``, ``BiasAdder``) and one terminal
estimator into a single object that fits through the emulated
:class:`repro_torch.core.runner.DistributedRunner` (resident, or from a
stream of epochs with one atomic snapshot of the whole pipeline), saves and
loads as one artifact, and serves raw rows through
:class:`repro_torch.serve.ModelPredictor`.
"""
from repro_torch.pipeline.pipeline import FittedPipeline, Pipeline

__all__ = ["Pipeline", "FittedPipeline"]
