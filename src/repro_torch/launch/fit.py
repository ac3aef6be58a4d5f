"""MLI-algorithm launcher: streaming epochs with checkpoint and resume, on
one device or across host processes.

Counterpart: ``src/repro/launch/fit.py``.  Data arrives as per-epoch
minibatch windows from a :class:`repro_torch.data.pipeline.BatchIterator`
(never resident as a whole), the :class:`repro_torch.core.runner.
DistributedRunner` iterates them, and a :class:`repro_torch.core.runner.
CheckpointPolicy` makes the run survive being killed: relaunching with
``--resume`` continues from the newest snapshot bit for bit.  The lanes are
``logreg``, ``linreg`` (``MinibatchSGD``), ``kmeans`` and ``pipeline`` (raw
labeled text → NGrams → TfIdf → Standardizer → logistic regression, every
snapshot one atomic file with the featurizers, the model and the stream
position).  It runs on the CUDA card unless ``--device cpu``.

Multi-host (``--hosts N``): the launcher becomes a driver that re-executes
this module once per host under :class:`repro_torch.launch.elastic.
ElasticController` (a ``file://`` rendezvous per generation), and prints
each host's lines.  Without ``--staleness`` the hosts join one process
group (BSP: every round's combine runs the schedule over the group, each
host holding ``--devices-per-host`` partitions of every window, gloo on the
CPU and where hosts share a card, NCCL where each has its own).  With
``--staleness S`` they are independent programs (each on its own windows,
seed ``seed + 7919·host``) exchanging post-epoch states through a
:class:`repro_torch.core.exchange.ParamStore` under the bound ``S``.
``--elastic`` restarts the world, resized, when a host dies; the survivors
resume from ``--ckpt-dir`` with ``allow_resize``.  Faults set in
``REPRO_CHAOS`` (:mod:`repro_torch.testing.chaos`) fire in generation 0.

The windows are the reference launcher's (:func:`make_source`, drawn with
numpy).  A program that embeds the launcher passes its own window maker as
``main(argv, source=...)``, and in driver mode its own host entry point as
``child=``, so that every host process draws the same windows.
``--json`` ends with a ``RESULT::{json}`` line (the state's sha256, the
stream position, the partitions, the SSP trace).

Examples (CPU):

    PYTHONPATH=src python -m repro_torch.launch.fit --algorithm kmeans \\
        --device cpu --ckpt-dir /tmp/mli-kmeans --epochs 4

    # kill it mid-run, or let it end, then continue to 8 epochs:
    PYTHONPATH=src python -m repro_torch.launch.fit --algorithm kmeans \\
        --device cpu --ckpt-dir /tmp/mli-kmeans --epochs 8 --resume

    # BSP over 2 host processes x 2 partitions (gloo)
    PYTHONPATH=src python -m repro_torch.launch.fit --algorithm logreg \\
        --hosts 2 --device cpu

    # SSP with bound 0 (lock-step), and an elastic BSP run
    PYTHONPATH=src python -m repro_torch.launch.fit --algorithm logreg \\
        --hosts 2 --staleness 0 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.fit --algorithm logreg \\
        --hosts 2 --elastic --ckpt-dir /tmp/mli-elastic --device cpu
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.core import hostmesh
from repro_torch.core.algorithms.kmeans import KMeans, KMeansParameters
from repro_torch.core.algorithms.logistic_regression import (
    LogisticRegressionAlgorithm,
    LogisticRegressionParameters,
)
from repro_torch.core.optimizer import MinibatchSGD, MinibatchSGDParameters
from repro_torch.core.runner import CheckpointPolicy
from repro_torch.data import BatchIterator
from repro_torch.device import to_tensor
from repro_torch.launch.elastic import mesh_from_env, run_host, run_hosts

__all__ = ["ALGORITHMS", "SSP_SEED_STRIDE", "GENERATION_TIMEOUT", "make_source",
           "linreg_grad", "state_sha", "run_pipeline", "main"]

ALGORITHMS = ("logreg", "linreg", "kmeans", "pipeline")

#: an SSP host streams its own windows, from seed + SSP_SEED_STRIDE · host
SSP_SEED_STRIDE = 7919

#: seconds a generation of host processes may run before the driver kills it
GENERATION_TIMEOUT = 600.0


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


def state_sha(x: torch.Tensor) -> str:
    """sha256 of a state tensor's bytes (its bits, not its value)."""
    return hashlib.sha256(x.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


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


def _drive_hosts(args, argv, child=None) -> None:
    """Driver mode: re-execute this module (or the command ``child``) once
    per host under the elastic controller; the children carry
    ``REPRO_HOST_ID`` and skip this branch.  Faults in ``REPRO_CHAOS`` go
    to generation 0."""
    from repro_torch.testing.chaos import ChaosInjector

    child = list(child or [sys.executable, "-m", "repro_torch.launch.fit"]) + \
        list(argv if argv is not None else sys.argv[1:])
    ssp = args.staleness is not None and not args.exchange_dir
    report = run_hosts(
        child, args.hosts, timeout=GENERATION_TIMEOUT, work=args.ckpt_dir,
        exchange_flag="--exchange-dir" if ssp else None,
        faults=ChaosInjector.faults_from_env(),
        max_restarts=2 if args.elastic else 0, min_hosts=1,
        global_mesh=args.staleness is None)
    for gen in report.generations:
        tag = f"generation {gen.index} ({gen.num_hosts} hosts)"
        for e in sorted(gen.exits, key=lambda x: x.host_id):
            for line in e.stdout.strip().splitlines():
                print(f"[{tag} h{e.host_id}] {line}")
    if report.resized:
        print(f"elastic: {len(report.generations)} generations, restart "
              f"latency {[f'{s:.2f}s' for s in report.restart_seconds]}, "
              f"generation seconds {[f'{g.duration:.2f}' for g in report.generations]}")
    return report


def _parser() -> argparse.ArgumentParser:
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
                    help="emulated partitions on the device (one process)")
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
    ap.add_argument("--use-kernel", action="store_true",
                    help="logreg / kmeans through the CUDA kernels")
    ap.add_argument("--json", action="store_true",
                    help="print a RESULT::{json} line at the end")
    ap.add_argument("--hosts", type=int, default=1,
                    help="spawn N host processes (BSP over one process group "
                         "unless --staleness is given)")
    ap.add_argument("--devices-per-host", type=int, default=2,
                    help="partitions each host process holds (L)")
    ap.add_argument("--staleness", type=int, default=None,
                    help="stale-synchronous lane with this bound (0 = "
                         "lock-step BSP over the exchange store)")
    ap.add_argument("--elastic", action="store_true",
                    help="restart the world (resized) when a host dies; "
                         "survivors resume from --ckpt-dir")
    ap.add_argument("--exchange-dir", default=None,
                    help="shared SSP exchange directory (the driver puts one "
                         "under --ckpt-dir or a fresh temp dir)")
    return ap


def main(argv=None, *, source=None, child=None):
    """Run the launcher; returns the fitted model (``pipeline``,
    ``logreg``, ``kmeans``), the weights (``linreg``), or in driver mode
    the :class:`repro_torch.launch.elastic.ElasticReport`.

    ``source(algorithm, rows, features, seed, device)``, when given, makes
    the window source instead of :func:`make_source`; ``child`` is the
    command that driver mode runs per host before the arguments (it must
    end in a ``main`` call with the same ``source``)."""
    ap = _parser()
    args = ap.parse_args(argv)
    host_mode = "REPRO_HOST_ID" in os.environ
    if args.hosts > 1 and not host_mode:
        return _drive_hosts(args, argv, child)
    return run_host(lambda: _run(ap, args, host_mode, source))


def _run(ap, args, host_mode: bool, make=None):
    n_hosts = int(os.environ.get("REPRO_NUM_HOSTS", "1")) if host_mode else 1
    host = int(os.environ.get("REPRO_HOST_ID", "0"))
    ssp = args.staleness is not None and n_hosts > 1
    device = hostmesh.host_device(args.device, host)
    mesh = None
    if host_mode and not ssp:
        mesh = mesh_from_env(device, args.devices_per_host)
    partitions = args.devices_per_host if host_mode else args.num_shards
    where = (f"{mesh.num_hosts} hosts x {mesh.local_partitions} partitions "
             f"({mesh.backend})" if mesh is not None
             else f"{partitions} emulated partitions")
    print(f"fit: {args.algorithm} | {where} on {device} | "
          f"schedule={args.schedule} | {args.epochs} epochs x "
          f"{args.rows_per_epoch} rows x {args.chunks_per_epoch} chunks")

    elastic_resume = args.elastic and os.environ.get("REPRO_RESUME") == "1"
    store = None
    ckpt_dir = args.ckpt_dir
    seed = args.seed
    if ssp:
        from repro_torch.core.exchange import ParamStore

        if not args.exchange_dir:
            ap.error("--staleness with --hosts needs --exchange-dir "
                     "(the driver injects one)")
        store = ParamStore(args.exchange_dir, host, n_hosts,
                           keep=args.staleness + 2)
        if ckpt_dir:
            ckpt_dir = os.path.join(ckpt_dir, f"h{host}")
        seed = args.seed + SSP_SEED_STRIDE * host

    ckpt = None
    if ckpt_dir:
        ckpt = CheckpointPolicy(ckpt_dir, every_epochs=args.ckpt_every,
                                keep=args.keep)
    resume = bool((args.resume or elastic_resume) and ckpt_dir
                  and latest_step(ckpt_dir) is not None)
    resumed_from = latest_step(ckpt_dir) if resume else None
    if args.resume and not resume:
        print("no checkpoint found; starting fresh")
    if resume:
        print(f"resuming from step {resumed_from} in {ckpt_dir}")

    if args.algorithm == "pipeline":
        if host_mode:
            ap.error("--hosts supports logreg | linreg | kmeans")
        return run_pipeline(args, device, ckpt, resume)

    if make is not None:
        source = make(args.algorithm, args.rows_per_epoch, args.features, seed, device)
    else:
        source = make_source(args.algorithm, args.rows_per_epoch, args.features, seed)
    stream = BatchIterator(source, device=device, mesh=mesh)
    if host_mode:
        from repro_torch.testing.chaos import ChaosInjector

        stream = ChaosInjector.from_env(host_id=host, store=store).wrap_stream(stream)
    common = dict(num_shards=partitions,
                  chunks_per_epoch=args.chunks_per_epoch, checkpoint=ckpt,
                  resume=resume)
    trace = []
    if ssp:
        common.update(store=store, staleness=args.staleness, trace=trace)
        if args.algorithm == "kmeans":
            common["chunks_per_epoch"] = 1
    elif args.elastic:
        common["allow_resize"] = True
    holdout = source(10**9)["data"]  # never a training step
    holdout = holdout.to(device) if isinstance(holdout, torch.Tensor) \
        else to_tensor(holdout, device)
    X, y = holdout[:, 1:], holdout[:, 0]

    if args.algorithm == "logreg":
        p = LogisticRegressionParameters(
            learning_rate=args.lr, local_batch_size=args.local_batch_size,
            schedule=args.schedule, use_kernel=args.use_kernel)
        out = LogisticRegressionAlgorithm(p).fit_stream(
            stream, num_epochs=args.epochs, **common)
        state = out.weights
        acc = (out.predict(X) == y).float().mean().item()
        print(f"done: holdout loss {out.loss(X, y).item():.4f} acc {acc:.3f}")
    elif args.algorithm == "linreg":
        p = MinibatchSGDParameters(
            w_init=torch.zeros(args.features, dtype=torch.float32, device=device),
            grad=linreg_grad, learning_rate=args.lr * 0.1,
            schedule=args.schedule)
        out = state = MinibatchSGD(p).apply_stream(stream, args.epochs, **common)
        print(f"done: holdout mse {((X @ out - y) ** 2).mean().item():.5f}")
    else:
        p = KMeansParameters(k=args.k, seed=args.seed, schedule=args.schedule,
                             use_kernel=args.use_kernel)
        out = KMeans(p).fit_stream(stream, num_epochs=args.epochs, **common)
        state = out.centroids
        print(f"done: holdout inertia {out.inertia(holdout).item():.2f}")
    print(f"stream position: step {stream.step}")
    if args.json:
        print("RESULT::" + json.dumps({
            "host": host, "num_hosts": n_hosts,
            "generation": int(os.environ.get("REPRO_GENERATION", "0")),
            "partitions": mesh.num_partitions if mesh is not None else partitions,
            "backend": mesh.backend if mesh is not None else None,
            "sha": state_sha(state), "stream_step": stream.step,
            "resumed_from": resumed_from,
            "trace": [{"epoch": t["epoch"], "wait_seconds": t["wait_seconds"],
                       "reads": {str(k): v for k, v in t["reads"].items()}}
                      for t in trace]}))
    return out


if __name__ == "__main__":
    main()
