"""Microbatching prediction service for the paper's Model contract.

Counterpart: ``src/repro/serve/predictor.py`` (``PredictRequest`` and
``ModelPredictor`` for numeric requests; raw-text featurization and the
shard-aware predict wait for later slices).

    submit (n_i, d) feature blocks  →  pack into fixed-size microbatches
    →  one predict per microbatch on the device  →  split outputs per request

Microbatches have a static row count (``max_batch``; the short final batch
is right-padded with zeros and the pad rows sliced off), so every batch has
the same shape — for a fitted k-means model with ``use_kernel``, one
``kmeans_assign`` launch per microbatch.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Deque, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, to_tensor

__all__ = ["PredictRequest", "ModelPredictor"]


@dataclasses.dataclass
class PredictRequest:
    """One prediction request: a block of feature rows.

    ``result`` is filled by the service (shape ``(n,)`` or ``(n, …)``
    matching the model's per-row output); ``done`` flips on completion.
    """

    features: np.ndarray               # (n, d) — or (d,), treated as (1, d)
    result: Optional[np.ndarray] = None
    done: bool = False
    finished_at: Optional[float] = None

    def __post_init__(self):
        self.features = np.asarray(self.features)
        if self.features.dtype.kind in "OUS":
            raise ValueError("raw (string) rows need a featurizer, which the "
                             "port's predictor does not have yet")
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
    """

    def __init__(self, model: Any, *, max_batch: int = 256,
                 predict_fn: Optional[Callable] = None,
                 device: DeviceLike = None):
        if max_batch < 1:
            raise ValueError("max_batch must be positive")
        self.model = model
        self.max_batch = int(max_batch)
        self.device = resolve_device(device)
        self._predict = predict_fn if predict_fn is not None else model.predict
        self._queue: Deque[PredictRequest] = deque()
        # stats
        self.batches = 0
        self.rows_served = 0
        self.rows_padded = 0

    def submit(self, req: PredictRequest) -> PredictRequest:
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
        in ``report()``."""
        reqs = list(self._queue)
        if not reqs:
            return []
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
        }
