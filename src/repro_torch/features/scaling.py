"""Numeric feature transforms on the device tier — fitted transformers.

Counterpart: ``src/repro/features/scaling.py`` (``resolve_skip``,
``resolve_labels``, ``Standardizer``, ``BiasAdder`` and the ``standardize``
/ ``add_bias`` shims).  Column statistics are computed once at ``fit`` with
the table's explicit global reduces (the table statistics' one order, so a
mesh table's statistics are bitwise its emulated twin's) and *replayed* at
``transform`` on any table (a mesh table stays on its mesh) — or, via ``apply``, on label-free feature rows of a serving
microbatch.  Both run in torch on the table's device; ``apply`` is
elementwise, so a served row gets the bits its table row got.

Label safety: supervised tables carry the label in column 0 (library
convention).  Both transformers skip label/bias columns by default:
``skip="auto"`` passes through any column named ``label``/``bias`` plus
(for the Standardizer) near-constant columns, and pipelines additionally
pass the supervised label index explicitly.
"""
from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.interfaces import FittedTransformer, Transformer
from repro_torch.core.numeric_table import MLNumericTable, column_sums
from repro_torch.device import DeviceLike, resolve_device, to_tensor

__all__ = [
    "Standardizer",
    "FittedStandardizer",
    "BiasAdder",
    "FittedBiasAdder",
    "standardize",
    "add_bias",
    "resolve_skip",
    "resolve_labels",
    "AUTO_SKIP_NAMES",
]

#: column names passed through untouched under ``skip="auto"``
AUTO_SKIP_NAMES = ("label", "bias")

SkipSpec = Union[str, None, Iterable[Any]]


def _table_names(table: Any) -> Tuple[Any, ...]:
    return tuple(getattr(table, "names", None) or
                 getattr(getattr(table, "schema", None), "names", None) or ())


def resolve_skip(table: Any, skip: SkipSpec, default_skip: Sequence[int] = ()
                 ) -> Tuple[int, ...]:
    """Resolve a skip spec to sorted column indices of ``table``.

    ``"auto"`` matches :data:`AUTO_SKIP_NAMES` by column name (when the
    table carries names) and unions ``default_skip`` (the pipeline's
    supervised-label indices); an explicit iterable mixes names and
    indices; ``None``/``()`` skips nothing.
    """
    ncols = int(table.num_cols)
    names = _table_names(table)
    idx = set()
    if isinstance(skip, str):
        if skip != "auto":
            raise ValueError(
                f"skip={skip!r}: the only string spec is 'auto' — pass an "
                f"iterable of names/indices (e.g. skip=[{skip!r}])")
        for i, n in enumerate(names):
            if n and str(n).lower() in AUTO_SKIP_NAMES:
                idx.add(i)
        idx.update(int(i) for i in default_skip)
    elif skip is not None:
        for s in skip:
            if isinstance(s, str):
                if s in names:
                    idx.add(names.index(s))
                else:
                    raise KeyError(f"no column named {s!r} to skip")
            else:
                idx.add(int(s))
    return tuple(sorted(i for i in idx if 0 <= i < ncols))


def resolve_labels(table: Any, default_skip: Sequence[int] = ()
                   ) -> Tuple[int, ...]:
    """The *label* columns of a table — the columns a raw serving row does
    not carry (columns named ``label`` plus the pipeline's supervised
    indices).  Other skipped columns (a ``bias`` column, near-constant
    features) exist in serving rows and pass through ``apply`` as
    identities instead of being dropped."""
    names = _table_names(table)
    labels = set(int(i) for i in default_skip)
    for i, n in enumerate(names):
        if n and str(n).lower() == "label":
            labels.add(i)
    return tuple(sorted(i for i in labels if 0 <= i < int(table.num_cols)))


def _feature_cols(ncols: int, skip_idx: Tuple[int, ...]) -> np.ndarray:
    skip = set(skip_idx)
    return np.asarray([i for i in range(ncols) if i not in skip], np.int64)


def _state_tensor(value: Any, device: DeviceLike) -> torch.Tensor:
    """A fitted statistic as a tensor: kept where it lies, or a host array
    copied to ``device`` (the CUDA card unless ``device="cpu"``)."""
    if isinstance(value, torch.Tensor):
        return value if device is None else value.to(resolve_device(device))
    return to_tensor(value, resolve_device(device))


class FittedStandardizer(FittedTransformer):
    """Column-wise ``(x - shift) / scale`` with fitted statistics.

    ``shift``/``scale`` span the fitted table's full column width; skipped
    columns (labels, bias, near-constant) carry the identity ``(0, 1)``,
    so :meth:`transform` is one elementwise map.  :meth:`apply` replays on
    label-free serving rows: only the *label* columns are absent there —
    other skipped columns (a bias column) are present and pass through as
    identities.
    """

    tier = "device"

    def __init__(self, shift: Any, scale: Any, skip_idx: Tuple[int, ...],
                 label_idx: Tuple[int, ...] = (),
                 device: DeviceLike = None) -> None:
        self.shift = _state_tensor(shift, device)
        self.scale = _state_tensor(scale, device)
        self.skip_idx = tuple(int(i) for i in skip_idx)
        self.label_idx = tuple(int(i) for i in label_idx)
        feat = torch.as_tensor(_feature_cols(self.shift.shape[0], self.label_idx),
                               device=self.shift.device)
        self._shift_feat = self.shift[feat]
        self._scale_feat = self.scale[feat]

    def transform(self, table: MLNumericTable) -> MLNumericTable:
        if table.num_cols != self.shift.shape[0]:
            raise ValueError(
                f"fitted on {self.shift.shape[0]} columns, table has "
                f"{table.num_cols}")
        return table._like((table.data - self.shift) / self.scale, table.names)

    def apply(self, feats: torch.Tensor) -> torch.Tensor:
        """Replay on (n, f) serving rows — f excludes only the label
        columns; skipped non-label columns pass through as identities."""
        return (feats - self._shift_feat) / self._scale_feat

    @property
    def partial(self):
        return {"shift": self.shift, "scale": self.scale}

    def host_state(self) -> dict:
        return {"kind": "standardizer", "skip": list(self.skip_idx),
                "label": list(self.label_idx),
                "num_cols": int(self.shift.shape[0])}

    @staticmethod
    def partial_template(host_state: dict) -> dict:
        """Structure of ``partial`` for a checkpoint restore (values unread)."""
        n = int(host_state["num_cols"])
        return {"shift": torch.zeros((n,), dtype=torch.float32),
                "scale": torch.zeros((n,), dtype=torch.float32)}

    @classmethod
    def from_state(cls, host_state: dict, partial: dict,
                   device: DeviceLike = None) -> "FittedStandardizer":
        return cls(partial["shift"], partial["scale"],
                   tuple(host_state["skip"]),
                   tuple(host_state.get("label", host_state["skip"])),
                   device=device)


class Standardizer(Transformer):
    """Fit column means/stds with explicit global reduces; replay anywhere.

    ``skip="auto"`` (default) protects label/bias-named columns and
    near-constant columns (variance ≤ ``min_variance`` — a bias column is
    constant by construction) from being standardized: they pass through
    unchanged.
    """

    tier = "device"

    def __init__(self, eps: float = 1e-8, skip: SkipSpec = "auto",
                 min_variance: float = 1e-12) -> None:
        self.eps = float(eps)
        self.skip = skip
        self.min_variance = float(min_variance)
        self._config = {"eps": eps, "skip": skip, "min_variance": min_variance}

    def fit(self, table: MLNumericTable, default_skip: Sequence[int] = ()
            ) -> FittedStandardizer:
        skip_idx = resolve_skip(table, self.skip, default_skip)
        label_idx = resolve_labels(table, default_skip)
        n = table.num_rows
        # the reference's formula, ss/n − mean², in the table's dtype; both
        # sums in the table statistics' order (the same on a mesh)
        s = table.sum_rows()
        ss = column_sums(table.data, table.num_shards, table.mesh,
                        fn=lambda v: v * v)
        mean = s / n
        var = torch.clamp(ss / n - mean * mean, min=0.0)
        std = torch.sqrt(var) + self.eps
        passthrough = torch.zeros(table.num_cols, dtype=torch.bool,
                                  device=table.device)
        passthrough[list(skip_idx)] = True
        passthrough = passthrough | (var <= self.min_variance)
        shift = torch.where(passthrough, torch.zeros_like(mean), mean)
        scale = torch.where(passthrough, torch.ones_like(std), std)
        return FittedStandardizer(shift, scale, skip_idx, label_idx)


class FittedBiasAdder(FittedTransformer):
    """Insert a constant-1 column at a fitted table index (named ``bias``
    so downstream auto-skip recognizes it)."""

    tier = "device"

    def __init__(self, at: int, num_cols: int, skip_idx: Tuple[int, ...],
                 label_idx: Tuple[int, ...] = ()) -> None:
        self.at = int(at)
        self.num_cols = int(num_cols)
        self.skip_idx = tuple(int(i) for i in skip_idx)
        self.label_idx = tuple(int(i) for i in label_idx)
        # serving-row insert position: table index minus the preceding
        # label columns (raw rows carry everything except the labels)
        self._feat_at = self.at - sum(1 for i in self.label_idx
                                      if i < self.at)

    def _names_out(self, names):
        if names is None:
            return None
        names = list(names)
        return tuple(names[: self.at] + ["bias"] + names[self.at:])

    def transform(self, table: MLNumericTable) -> MLNumericTable:
        if table.num_cols != self.num_cols:
            raise ValueError(
                f"fitted on {self.num_cols} columns, table has "
                f"{table.num_cols}")
        # this process's rows (a host's, on a mesh)
        ones = torch.ones((table.data.shape[0], 1), dtype=table.data.dtype,
                          device=table.device)
        data = torch.cat(
            [table.data[:, : self.at], ones, table.data[:, self.at:]], dim=1)
        return table._like(data, self._names_out(table.names))

    def apply(self, feats: torch.Tensor) -> torch.Tensor:
        ones = torch.ones(tuple(feats.shape[:-1]) + (1,), dtype=feats.dtype,
                          device=feats.device)
        return torch.cat(
            [feats[..., : self._feat_at], ones, feats[..., self._feat_at:]],
            dim=-1)

    def host_state(self) -> dict:
        return {"kind": "bias", "at": self.at, "num_cols": self.num_cols,
                "skip": list(self.skip_idx), "label": list(self.label_idx)}

    @staticmethod
    def partial_template(host_state: dict) -> dict:
        return {}

    @classmethod
    def from_state(cls, host_state: dict, partial: dict,
                   device: DeviceLike = None) -> "FittedBiasAdder":
        return cls(host_state["at"], host_state["num_cols"],
                   tuple(host_state["skip"]),
                   tuple(host_state.get("label", host_state["skip"])))


class BiasAdder(Transformer):
    """Insert a constant-1 bias column after the label columns (``at=None``
    → immediately after the skipped columns; an explicit ``at`` is a table
    column index)."""

    tier = "device"

    def __init__(self, at: Optional[int] = None, skip: SkipSpec = "auto"
                 ) -> None:
        self.at = at
        self.skip = skip
        self._config = {"at": at, "skip": skip}

    def fit(self, table: MLNumericTable, default_skip: Sequence[int] = ()
            ) -> FittedBiasAdder:
        skip_idx = resolve_skip(table, self.skip, default_skip)
        label_idx = resolve_labels(table, default_skip)
        at = self.at if self.at is not None else len(skip_idx)
        return FittedBiasAdder(at, table.num_cols, skip_idx, label_idx)


# --------------------------------------------------------------------------- #
# seed-era function shims
# --------------------------------------------------------------------------- #
def standardize(table: MLNumericTable, eps: float = 1e-8,
                skip: SkipSpec = "auto") -> MLNumericTable:
    """Column-wise ``(x - mean) / std`` (shim over :class:`Standardizer`).

    Label/bias-named columns and constant columns pass through unchanged by
    default (``skip="auto"``) — pass ``skip=None`` to standardize every
    column regardless.
    """
    f, out = Standardizer(eps=eps, skip=skip).fit_transform(table)
    return out


def add_bias(table: MLNumericTable, at: int = 1) -> MLNumericTable:
    """Insert a constant-1 bias column at index ``at`` (after the label
    col) — shim over :class:`BiasAdder`."""
    f, out = BiasAdder(at=at, skip=None).fit_transform(table)
    return out
