"""PyTorch / CUDA port of the MLI reproduction (counterpart: ``src/repro/``).

The JAX package ``repro`` is the reference; this package ports it one slice
at a time and imports neither ``jax`` nor ``repro``.  The slice here is the
paper's main path: a row-partitioned :class:`~repro_torch.core.numeric_table.
MLNumericTable` → emulated :class:`~repro_torch.core.runner.DistributedRunner`
rounds → :class:`~repro_torch.core.algorithms.logistic_regression.
LogisticRegression` and :class:`~repro_torch.core.algorithms.kmeans.KMeans`
→ :class:`~repro_torch.serve.predictor.ModelPredictor`.  The three Pallas
kernels of that path are hand-written CUDA under ``kernels/csrc/``.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``
(see :func:`repro_torch.device.resolve_device`).
"""
