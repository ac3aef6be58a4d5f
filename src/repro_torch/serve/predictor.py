"""Microbatching prediction service for the paper's Model contract.

Counterpart: ``src/repro/serve/predictor.py`` (``PredictRequest`` and
``ModelPredictor``: numeric and raw-text requests, the featurize memo; the
shard-aware predict waits for mesh mode).

    submit (n_i, d) feature blocks — or raw rows  →  featurize raw rows
    through a bounded memo  →  pack into fixed-size microbatches  →  one
    predict per microbatch on the device  →  split outputs per request

Microbatches have a static row count (``max_batch``; the short final batch
is right-padded with zeros and the pad rows sliced off), so every batch has
the same shape — for a fitted k-means model with ``use_kernel``, one
``kmeans_assign`` launch per microbatch.  Any fitted model's ``predict``
is served: a ``MatrixFactorizationModel`` takes integer (user, item) pair
rows, whose zero pad rows are the valid pair (0, 0); the GLM, naive Bayes
and MF models sum in an order fixed by the width, so a served row is
bitwise its offline prediction.  A raw-text request served to a
:class:`repro_torch.pipeline.FittedPipeline` runs its vocab lookup on the
host (``featurize_rows``), then the pipeline's device chain and model.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, to_tensor

__all__ = ["PredictRequest", "ModelPredictor"]


@dataclasses.dataclass
class PredictRequest:
    """One prediction request: a block of feature rows — or *raw* rows
    (a str / sequence of str) when the service carries a featurizer (a
    fitted pipeline's host-tier vocab lookup).

    ``result`` is filled by the service (shape ``(n,)`` or ``(n, …)``
    matching the model's per-row output); ``done`` flips on completion.
    """

    features: np.ndarray               # (n, d) — or (d,), treated as (1, d)
    result: Optional[np.ndarray] = None
    done: bool = False
    finished_at: Optional[float] = None
    #: True when ``features`` holds raw (string) rows awaiting host-tier
    #: featurization at flush time
    raw: bool = dataclasses.field(default=False, init=False)

    def __post_init__(self):
        if isinstance(self.features, str):
            self.features = np.asarray([self.features], object)
        else:
            self.features = np.asarray(self.features)
        if self.features.dtype.kind in "OUS":
            self.raw = True
            self.features = self.features.reshape(-1)
            return
        if self.features.ndim == 1:
            self.features = self.features[None, :]
        if self.features.ndim != 2:
            raise ValueError("features must be (n, d) rows")


class ModelPredictor:
    """Queue + microbatcher around ``model.predict`` on ``device`` (the
    CUDA card unless ``device="cpu"``).

    Rows from queued requests are packed greedily into ``max_batch``-row
    microbatches: a request larger than one microbatch spans several, and
    one microbatch can serve many small requests (rows are independent
    under the Model contract).  The final short batch is zero-padded to the
    same shape and the pad rows sliced off before results are scattered
    back.

    Raw (string) rows pass a host-side **featurize memo** first — a
    bounded LRU keyed by row content: repeated raw-text rows skip
    re-featurization (fitted featurizers replay frozen statistics, so a
    row's features are a pure function of its content).  ``featurize``
    defaults to the model's ``featurize_rows``; ``featurize_cache=0``
    disables the memo.
    """

    def __init__(self, model: Any, *, max_batch: int = 256,
                 predict_fn: Optional[Callable] = None,
                 featurize: Optional[Callable] = None,
                 featurize_cache: int = 512,
                 device: DeviceLike = None):
        if max_batch < 1:
            raise ValueError("max_batch must be positive")
        self.model = model
        self.max_batch = int(max_batch)
        self.device = resolve_device(device)
        self._predict = predict_fn if predict_fn is not None else model.predict
        # raw (string) requests run this host-tier map before packing
        self._featurize = (featurize if featurize is not None
                           else getattr(model, "featurize_rows", None))
        self._queue: Deque[PredictRequest] = deque()
        # bounded LRU over featurized raw rows, keyed by row content
        self._feat_cap = int(featurize_cache)
        self._feat_memo: Optional[OrderedDict] = (
            OrderedDict() if self._feat_cap > 0 else None)
        # stats
        self.batches = 0
        self.rows_served = 0
        self.rows_padded = 0
        self.featurize_hits = 0
        self.featurize_misses = 0

    def submit(self, req: PredictRequest) -> PredictRequest:
        if req.raw and self._featurize is None:
            # fail fast, per request — a bad request must never poison the
            # queued valid ones at flush time
            raise ValueError(
                "raw (string) request but the service has no featurizer — "
                "serve a FittedPipeline or pass featurize=")
        self._queue.append(req)
        return req

    @property
    def queued(self) -> int:
        return len(self._queue)

    def flush(self, now: float = 0.0) -> List[PredictRequest]:
        """Serve everything queued; returns the completed requests.

        The queue is popped only after every microbatch has succeeded: a
        predict error leaves all queued requests intact for a retry, and
        the per-microbatch stats roll back, so a failed flush is invisible
        in ``report()``.  Raw requests are featurized first, each in place
        (its ``raw`` flips off as it succeeds), so a featurizer error also
        leaves every queued request intact."""
        reqs = list(self._queue)
        if not reqs:
            return []
        for r in reqs:
            if r.raw:
                r.features = self._featurize_rows(list(r.features))
                r.raw = False               # (n, d): featurized once
        rows = np.concatenate([r.features for r in reqs], axis=0)
        outs: List[np.ndarray] = []
        batches0, padded0 = self.batches, self.rows_padded
        try:
            for start in range(0, rows.shape[0], self.max_batch):
                chunk = rows[start : start + self.max_batch]
                pad = self.max_batch - chunk.shape[0]
                if pad:
                    chunk = np.concatenate(
                        [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
                    self.rows_padded += pad
                outs.append(self._predict_batch(chunk)[: self.max_batch - pad])
                self.batches += 1
        except Exception:
            self.batches, self.rows_padded = batches0, padded0
            raise
        for _ in reqs:                      # all microbatches succeeded
            self._queue.popleft()
        flat = np.concatenate(outs, axis=0)
        self.rows_served += rows.shape[0]
        ofs = 0
        for r in reqs:
            n = r.features.shape[0]
            r.result = flat[ofs : ofs + n]
            r.done = True
            r.finished_at = now
            ofs += n
        return reqs

    @staticmethod
    def _row_key(row):
        """Content key for one raw row (str/bytes hash directly; anything
        array-like keys on dtype+shape+bytes)."""
        if isinstance(row, (str, bytes)):
            return row
        arr = np.asarray(row)
        if arr.dtype.kind in "OUS":
            return str(row)
        return (arr.dtype.str, arr.shape, arr.tobytes())

    def _featurize_rows(self, rows: List[Any]) -> np.ndarray:
        """Featurize ``rows`` through the LRU memo: only content-new rows
        reach the featurizer; repeats are served from the memo."""
        if self._feat_memo is None:
            return np.asarray(self._featurize(rows), np.float32)
        memo = self._feat_memo
        keys = [self._row_key(r) for r in rows]
        local: dict = {}
        miss_keys: List[Any] = []
        miss_rows: List[Any] = []
        for k, r in zip(keys, rows):
            if k in local:
                continue
            if k in memo:
                memo.move_to_end(k)
                local[k] = memo[k]
            else:
                local[k] = None
                miss_keys.append(k)
                miss_rows.append(r)
        if miss_rows:
            feats = np.asarray(self._featurize(miss_rows), np.float32)
            for k, f in zip(miss_keys, feats):
                local[k] = f
                memo[k] = f
                if len(memo) > self._feat_cap:
                    memo.popitem(last=False)
        self.featurize_misses += len(miss_rows)
        self.featurize_hits += len(rows) - len(miss_rows)
        return np.stack([local[k] for k in keys])

    def predict_many(self, blocks: List[np.ndarray],
                     now: float = 0.0) -> List[np.ndarray]:
        """Convenience: submit + flush a list of feature blocks, returning
        results in submission order."""
        reqs = [self.submit(PredictRequest(features=b)) for b in blocks]
        self.flush(now)
        return [r.result for r in reqs]

    def _predict_batch(self, chunk: np.ndarray) -> np.ndarray:
        """One microbatch: host rows to the device, predict, result back
        to the host (which waits for the device)."""
        out = self._predict(to_tensor(chunk, self.device))
        return out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)

    def report(self) -> dict:
        served = max(self.rows_served, 1)
        return {
            "batches": self.batches,
            "rows_served": self.rows_served,
            "rows_padded": self.rows_padded,
            "pad_fraction": self.rows_padded / (served + self.rows_padded),
            "max_batch": self.max_batch,
            "featurize_hits": self.featurize_hits,
            "featurize_misses": self.featurize_misses,
            "featurize_cache": self._feat_cap,
        }
