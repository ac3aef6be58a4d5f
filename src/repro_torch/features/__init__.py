"""Feature extraction (paper Fig. A2: nGrams → tfIdf → train pipeline).

Counterpart: ``src/repro/features/``.  Fitted transformers
(:class:`NGrams`, :class:`TfIdf`, :class:`HashingVectorizer`,
:class:`Standardizer`, :class:`BiasAdder`) compute corpus statistics once
at ``fit`` and replay them at ``transform`` on any table or raw serving
row — the building blocks of :class:`repro_torch.pipeline.Pipeline`.  The
seed-era one-shot functions remain as fit+transform shims.
"""
from repro_torch.features.scaling import (
    BiasAdder,
    FittedBiasAdder,
    FittedStandardizer,
    Standardizer,
    add_bias,
    standardize,
)
from repro_torch.features.text import (
    FittedHashingVectorizer,
    FittedNGrams,
    FittedTfIdf,
    HashingVectorizer,
    NGrams,
    TfIdf,
    hashing_vectorizer,
    n_grams,
    tf_idf,
)

__all__ = [
    "NGrams", "FittedNGrams", "TfIdf", "FittedTfIdf",
    "HashingVectorizer", "FittedHashingVectorizer",
    "Standardizer", "FittedStandardizer", "BiasAdder", "FittedBiasAdder",
    "n_grams", "tf_idf", "hashing_vectorizer", "standardize", "add_bias",
]
