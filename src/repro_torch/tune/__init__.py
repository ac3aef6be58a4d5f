"""Model search over MLI algorithms (the MLbase end goal), in the port.

Counterpart: ``src/repro/tune/__init__.py``, with the same ``__all__``:

  * :mod:`repro_torch.tune.search` — grid / random enumeration, the median
    stopping rule, asynchronous successive halving (ASHA) and the
    :class:`ModelSearch` driver;
  * :mod:`repro_torch.tune.trials` — trial specs, stacked groups (K
    same-shape trials advanced together, each lane running the launches of
    its trial alone) and mid-search checkpoint and resume;
  * :mod:`repro_torch.tune.callback` — LightGBM-style hooks fired between
    epochs;
  * :mod:`repro_torch.tune.cv` — k-fold and holdout splitters as row-index
    views.
"""
from repro_torch.tune.callback import (  # noqa: F401
    CallbackEnv,
    EarlyStopException,
    EvalEntry,
    early_stopping,
    hyper_schedule,
    record_evaluation,
)
from repro_torch.tune.cv import KFold, fold_view, holdout_split  # noqa: F401
from repro_torch.tune.search import (  # noqa: F401
    AshaScheduler,
    AsyncSuccessiveHalving,
    MedianStoppingRule,
    ModelSearch,
    SearchResult,
    TrialResult,
    grid,
    sample,
)
from repro_torch.tune.trials import TrialSpec, tree_stack, tree_unstack  # noqa: F401

__all__ = [
    "KFold",
    "fold_view",
    "holdout_split",
    "grid",
    "sample",
    "AshaScheduler",
    "AsyncSuccessiveHalving",
    "MedianStoppingRule",
    "ModelSearch",
    "SearchResult",
    "TrialResult",
    "TrialSpec",
    "tree_stack",
    "tree_unstack",
    "CallbackEnv",
    "EarlyStopException",
    "EvalEntry",
    "early_stopping",
    "hyper_schedule",
    "record_evaluation",
]
