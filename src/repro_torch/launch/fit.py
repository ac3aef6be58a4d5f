"""MLI-algorithm launcher: streaming epochs with checkpoint and resume.

Counterpart: ``src/repro/launch/fit.py`` (its single-host lanes).  Data
arrives as per-epoch minibatch windows from a
:class:`repro_torch.data.pipeline.BatchIterator` (never resident as a
whole), the :class:`repro_torch.core.runner.DistributedRunner` iterates
them on the device, and a :class:`repro_torch.core.runner.CheckpointPolicy`
makes the run survive being killed: relaunching with ``--resume`` continues
from the newest snapshot bit for bit.  The lanes are ``logreg``, ``linreg``
(``MinibatchSGD``), ``kmeans`` and ``pipeline`` (raw labeled text → NGrams
→ TfIdf → Standardizer → logistic regression, every snapshot one atomic
file with the featurizers, the model and the stream position).  It runs on
the CUDA card unless ``--device cpu``.  Not ported yet (ROADMAP.md, Queue
1 item 3): ``--hosts``, ``--devices-per-host``, ``--staleness``,
``--elastic`` and ``--exchange-dir``.

Examples (CPU):

    PYTHONPATH=src python -m repro_torch.launch.fit --algorithm kmeans \\
        --device cpu --ckpt-dir /tmp/mli-kmeans --epochs 4

    # kill it mid-run, or let it end, then continue to 8 epochs:
    PYTHONPATH=src python -m repro_torch.launch.fit --algorithm kmeans \\
        --device cpu --ckpt-dir /tmp/mli-kmeans --epochs 8 --resume
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.core.algorithms.kmeans import KMeans, KMeansParameters
from repro_torch.core.algorithms.logistic_regression import (
    LogisticRegressionAlgorithm,
    LogisticRegressionParameters,
)
from repro_torch.core.optimizer import MinibatchSGD, MinibatchSGDParameters
from repro_torch.core.runner import CheckpointPolicy
from repro_torch.data import BatchIterator
from repro_torch.device import resolve_device, to_tensor

__all__ = ["ALGORITHMS", "make_source", "linreg_grad", "run_pipeline", "main"]

ALGORITHMS = ("logreg", "linreg", "kmeans", "pipeline")


def make_source(algorithm: str, rows: int, features: int, seed: int):
    """Deterministic per-step window generator — a pure function of the
    step, which is what makes ``--resume`` exact."""
    if algorithm == "logreg":
        def source(step: int):
            rng = np.random.default_rng(seed * 100_003 + step)
            w = np.linspace(-1, 1, features).astype(np.float32)
            X = rng.normal(size=(rows, features)).astype(np.float32)
            y = (X @ w > 0).astype(np.float32)
            return {"data": np.concatenate([y[:, None], X], 1)}
    elif algorithm == "linreg":
        def source(step: int):
            rng = np.random.default_rng(seed * 100_003 + step)
            w = np.arange(1, features + 1, dtype=np.float32) / features
            X = rng.normal(size=(rows, features)).astype(np.float32)
            y = X @ w + 0.01 * rng.normal(size=rows).astype(np.float32)
            return {"data": np.concatenate([y[:, None], X], 1)}
    else:
        def source(step: int):
            rng = np.random.default_rng(seed * 100_003 + step)
            k = 4
            centers = np.stack([np.full(features, 2.0 * (i - (k - 1) / 2))
                                for i in range(k)]).astype(np.float32)
            idx = rng.integers(0, k, size=rows)
            X = centers[idx] + 0.3 * rng.normal(size=(rows, features))
            return {"data": X.astype(np.float32)}
    return source


def linreg_grad(chunks: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Squared-loss chunk gradient (label in column 0): for each partition
    of a ``(P, m, 1 + d)`` stack, Σ_rows x·(x·w − y) → ``(P, d)``."""
    X, y = chunks[..., 1:], chunks[..., 0]
    r = (X * w.unsqueeze(-2)).sum(-1) - y
    return (X * r.unsqueeze(-1)).sum(-2)


def run_pipeline(args, device, ckpt, resume):
    """The Fig. A2 scenario as ONE object: raw labeled text → NGrams →
    TfIdf → Standardizer → logistic regression, trained from streamed
    windows with the whole artifact in every atomic checkpoint."""
    from repro_torch.core.mltable import MLTable
    from repro_torch.data import synth_labeled_text
    from repro_torch.features import NGrams, Standardizer, TfIdf
    from repro_torch.pipeline import Pipeline
    from repro_torch.serve.predictor import ModelPredictor, PredictRequest

    rows = synth_labeled_text(n_docs=args.rows_per_epoch, seed=args.seed)
    raw = MLTable.from_rows(rows, names=["label", "text"], num_partitions=4)
    pipe = Pipeline([
        NGrams(n=1, top=args.features, column="text"),
        TfIdf(),
        Standardizer(),
        LogisticRegressionAlgorithm(
            learning_rate=args.lr, local_batch_size=args.local_batch_size,
            schedule=args.schedule),
    ], num_shards=args.num_shards, device=device)
    fitted = pipe.fit_stream(raw, num_epochs=args.epochs,
                             chunks_per_epoch=args.chunks_per_epoch,
                             checkpoint=ckpt, resume=resume)
    table = fitted.transform(raw)
    X = table.data
    acc = (fitted.model.predict(X[:, 1:]) == X[:, 0]).float().mean().item()
    print(f"done: pipeline train acc {acc:.3f} "
          f"({table.num_rows} rows x {table.num_cols - 1} features)")
    served = ModelPredictor(fitted, max_batch=8, device=device)
    req = served.submit(PredictRequest(features=rows[0][1]))
    served.flush()
    print(f"served raw text -> class {float(req.result[0]):.0f} "
          f"(label {rows[0][0]:.0f})")
    return fitted


def main(argv=None):
    """Run the launcher; returns the fitted model (``pipeline``,
    ``logreg``, ``kmeans``) or the weights (``linreg``)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--algorithm", required=True, choices=ALGORITHMS)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--rows-per-epoch", type=int, default=256)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--chunks-per-epoch", type=int, default=4)
    ap.add_argument("--schedule", default="allreduce",
                    choices=("allreduce", "gather_broadcast", "reduce_scatter"))
    ap.add_argument("--num-shards", type=int, default=4,
                    help="emulated partitions on the device")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=1)
    ap.add_argument("--keep", type=int, default=None,
                    help="retain only the newest N checkpoints")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in --ckpt-dir")
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--local-batch-size", type=int, default=8)
    ap.add_argument("--k", type=int, default=4, help="k-means cluster count")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    print(f"fit: {args.algorithm} | {args.num_shards} emulated partitions on "
          f"{device} | schedule={args.schedule} | {args.epochs} epochs x "
          f"{args.rows_per_epoch} rows x {args.chunks_per_epoch} chunks")

    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointPolicy(args.ckpt_dir, every_epochs=args.ckpt_every,
                                keep=args.keep)
    resume = bool(args.resume and args.ckpt_dir
                  and latest_step(args.ckpt_dir) is not None)
    if args.resume and not resume:
        print("no checkpoint found; starting fresh")
    if resume:
        print(f"resuming from step {latest_step(args.ckpt_dir)} "
              f"in {args.ckpt_dir}")

    if args.algorithm == "pipeline":
        return run_pipeline(args, device, ckpt, resume)

    source = make_source(args.algorithm, args.rows_per_epoch, args.features,
                         args.seed)
    stream = BatchIterator(source, device=device)
    common = dict(num_shards=args.num_shards,
                  chunks_per_epoch=args.chunks_per_epoch, checkpoint=ckpt,
                  resume=resume)
    holdout = to_tensor(source(10**9)["data"], device)  # never a training step
    X, y = holdout[:, 1:], holdout[:, 0]

    if args.algorithm == "logreg":
        p = LogisticRegressionParameters(
            learning_rate=args.lr, local_batch_size=args.local_batch_size,
            schedule=args.schedule)
        out = LogisticRegressionAlgorithm(p).fit_stream(
            stream, num_epochs=args.epochs, **common)
        acc = (out.predict(X) == y).float().mean().item()
        print(f"done: holdout loss {out.loss(X, y).item():.4f} acc {acc:.3f}")
    elif args.algorithm == "linreg":
        p = MinibatchSGDParameters(
            w_init=torch.zeros(args.features, dtype=torch.float32, device=device),
            grad=linreg_grad, learning_rate=args.lr * 0.1,
            schedule=args.schedule)
        out = MinibatchSGD(p).apply_stream(stream, args.epochs, **common)
        print(f"done: holdout mse {((X @ out - y) ** 2).mean().item():.5f}")
    else:
        p = KMeansParameters(k=args.k, seed=args.seed, schedule=args.schedule)
        out = KMeans(p).fit_stream(stream, num_epochs=args.epochs, **common)
        print(f"done: holdout inertia {out.inertia(holdout).item():.2f}")
    print(f"stream position: step {stream.step}")
    return out


if __name__ == "__main__":
    main()
