"""Model-search launcher: grid / random search with CV and checkpoint/resume.

Counterpart: ``src/repro/launch/tune.py`` (the same flags and output
lines; ``--device`` is the port's, for the reference's mesh).  It
enumerates candidate configurations (``--grid`` or ``--samples`` over
``--space``), trains them as stacked trials through
:class:`repro_torch.tune.ModelSearch` (streaming epochs, k-fold or holdout
validation, optional median early stopping or ASHA) and reports every
trial plus the winner.  With ``--ckpt-dir`` the search snapshots after
every completed unit; ``--resume`` continues a killed search trial for
trial.  It runs on the CUDA card unless ``--device cpu``; the table is
drawn with numpy from ``--seed`` as the reference draws it, then put on
the device, in 4 emulated partitions.

With ``--hosts N`` the search runs on a host mesh, as the reference runs it
on a device mesh over ``jax.devices()``: the launcher re-executes itself
once a host under :class:`repro_torch.launch.elastic.ElasticController`
(no restarts), each host joins the process group (gloo when the hosts
share a card or run on the CPU), draws the same table and keeps its
``--devices-per-host`` partitions of it
(``MLNumericTable.from_numpy(..., mesh=)``, or ``Pipeline(mesh=)`` for
``pipeline``), and every host runs the same search; the launcher prints
host 0's lines and fails when a host fails or the hosts' results differ.

Examples (CPU):

    PYTHONPATH=src python -m repro_torch.launch.tune --algorithm logreg \\
        --grid "learning_rate=0.05,0.1,0.3;l2=0.0,0.01" --device cpu \\
        --rows 128 --features 8 --epochs 4 --chunks-per-epoch 2 --folds 3

    PYTHONPATH=src python -m repro_torch.launch.tune --algorithm logreg \\
        --samples 6 --space "learning_rate=loguniform:0.01:1.0;l2=0.0,0.01" \\
        --device cpu --ckpt-dir /tmp/mli-search
    # kill it mid-search, then add --resume to the same command line

    PYTHONPATH=src python -m repro_torch.launch.tune --algorithm logreg \\
        --grid "learning_rate=0.05,0.3" --device cpu --hosts 2 \\
        --schedule gather_broadcast --json
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import signal
import sys
from typing import Any, Dict, List

import numpy as np

from repro_torch.core import hostmesh
from repro_torch.core.collectives import CollectiveSchedule
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.device import resolve_device
from repro_torch.launch.elastic import mesh_from_env, run_host, run_hosts
from repro_torch.tune import (AsyncSuccessiveHalving, MedianStoppingRule,
                              ModelSearch, grid, record_evaluation, sample)

__all__ = ["ALGORITHMS", "parse_space", "make_pipeline", "make_table", "main"]

ALGORITHMS = ("logreg", "kmeans", "pipeline")

#: emulated partitions of the launcher's tables (the reference's
#: single-device layout)
NUM_SHARDS = 4

#: seconds the host processes of ``--hosts`` may run before the launcher
#: kills them
GENERATION_TIMEOUT = 600.0


def _literal(text: str) -> Any:
    """One grid/space value: a python literal when it is one, else the raw
    string."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def parse_space(spec: str) -> Dict[str, Any]:
    """Parse ``"lr=0.1,0.3;l2=0.0,0.01"`` into a search space dict: each
    ``;``-separated entry is ``name=v1,v2,…`` or ``name=uniform:lo:hi`` /
    ``name=loguniform:lo:hi`` (a continuous range for ``--samples``)."""
    space: Dict[str, Any] = {}
    for entry in filter(None, (e.strip() for e in spec.split(";"))):
        name, _, values = entry.partition("=")
        if not _ or not values:
            raise ValueError(f"malformed space entry {entry!r} (want name=…)")
        if values.startswith(("uniform:", "loguniform:")):
            kind, lo, hi = values.split(":")
            space[name.strip()] = (kind, float(lo), float(hi))
        else:
            space[name.strip()] = [_literal(v) for v in values.split(",")]
    return space


def make_pipeline(features: int, device, mesh=None):
    """The Fig. A2 text pipeline with nested-stage search keys
    (``ngrams.top``, ``tfidf.*``, ``logreg.*``), committing to ``mesh``
    when one is given."""
    from repro_torch.core.algorithms.logistic_regression import \
        LogisticRegressionAlgorithm
    from repro_torch.features import NGrams, Standardizer, TfIdf
    from repro_torch.pipeline import Pipeline

    return Pipeline([
        NGrams(n=1, top=features, column="text"),
        TfIdf(),
        Standardizer(),
        LogisticRegressionAlgorithm(),
    ], mesh=mesh, num_shards=None if mesh is not None else NUM_SHARDS,
        device=device)


def make_table(algorithm: str, rows: int, features: int, seed: int, device,
               mesh=None):
    """The reference's synthetic dataset (a pure function of the
    arguments, so a ``--resume`` relaunch sees the same table), on
    ``device``, or this host's rows of it on ``mesh``.  ``pipeline`` gets a
    raw labeled-text MLTable (every host holds all of it)."""
    rng = np.random.default_rng(seed * 100_003 + 17)
    if algorithm == "pipeline":
        from repro_torch.core.mltable import MLTable
        from repro_torch.data import synth_labeled_text

        return MLTable.from_rows(synth_labeled_text(n_docs=rows, seed=seed),
                                 names=["label", "text"], num_partitions=4)
    if algorithm == "logreg":
        w = np.linspace(-1, 1, features).astype(np.float32)
        X = rng.normal(size=(rows, features)).astype(np.float32)
        y = (X @ w > 0).astype(np.float32)
        data = np.concatenate([y[:, None], X], 1)
    else:
        k = 4
        centers = np.stack([np.full(features, 2.5 * (i - (k - 1) / 2))
                            for i in range(k)]).astype(np.float32)
        idx = rng.integers(0, k, size=rows)
        data = (centers[idx]
                + 0.3 * rng.normal(size=(rows, features))).astype(np.float32)
    if mesh is not None:
        return MLNumericTable.from_numpy(data, mesh=mesh)
    return MLNumericTable.from_numpy(data, num_shards=NUM_SHARDS, device=device)


def _drive_hosts(args, argv):
    """Launcher mode: re-execute this module once a host (no restarts; the
    children carry ``REPRO_HOST_ID`` and skip this branch); print host 0's
    lines; raise ``SystemExit(1)`` when a host failed or the hosts'
    ``RESULT::`` lines differ.  Returns the
    :class:`repro_torch.launch.elastic.ElasticReport`."""
    child = [sys.executable, "-m", "repro_torch.launch.tune"] + \
        list(argv if argv is not None else sys.argv[1:])
    report = run_hosts(child, args.hosts, timeout=GENERATION_TIMEOUT,
                       max_restarts=0)
    exits = sorted(report.final.exits, key=lambda e: e.host_id)
    print(exits[0].stdout, end="")
    results = {e.host_id: [ln for ln in e.stdout.splitlines()
                           if ln.startswith("RESULT::")] for e in exits}
    bad = [e for e in exits if e.returncode != 0]
    for e in bad:
        print(f"host {e.host_id} exited {e.returncode}: {e.stderr[-3000:]}",
              file=sys.stderr)
    if bad or any(r != results[0] for r in results.values()):
        if not bad:
            print("the hosts' results differ", file=sys.stderr)
        raise SystemExit(1)
    return report


def main(argv=None):
    """Run the launcher; returns the :class:`repro_torch.tune.SearchResult`
    (with ``--hosts`` > 1, the
    :class:`repro_torch.launch.elastic.ElasticReport`)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--algorithm", required=True, choices=ALGORITHMS)
    ap.add_argument("--grid", default=None,
                    help="grid space, e.g. 'learning_rate=0.1,0.3;l2=0,0.01'")
    ap.add_argument("--samples", type=int, default=None,
                    help="random-search draw count (over --space)")
    ap.add_argument("--space", default=None,
                    help="random-search space; supports uniform:lo:hi and "
                         "loguniform:lo:hi ranges")
    ap.add_argument("--rows", type=int, default=128)
    ap.add_argument("--features", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--chunks-per-epoch", type=int, default=2)
    ap.add_argument("--folds", type=int, default=None,
                    help="k-fold CV; omit for a single holdout split")
    ap.add_argument("--holdout", type=float, default=0.25,
                    help="holdout validation fraction (when --folds is unset)")
    ap.add_argument("--metric", default=None,
                    help="accuracy | log_loss (logreg), silhouette (kmeans)")
    ap.add_argument("--schedule", default="allreduce",
                    choices=[s.value for s in CollectiveSchedule])
    ap.add_argument("--exec", dest="execution", default="auto",
                    choices=("auto", "stacked", "sequential"))
    ap.add_argument("--early-stop", action="store_true",
                    help="median-rule early stopping, one rung per "
                         "--rung-epochs")
    ap.add_argument("--rung-epochs", type=int, default=None)
    ap.add_argument("--asha", action="store_true",
                    help="asynchronous successive halving (overrides "
                         "--early-stop)")
    ap.add_argument("--reduction-factor", type=int, default=3,
                    help="ASHA: promote the top 1/rf of each rung")
    ap.add_argument("--min-rounds", type=int, default=1,
                    help="ASHA: trial-local epochs before the first rung")
    ap.add_argument("--slots", type=int, default=None,
                    help="ASHA: concurrent trial slots (default min(8, "
                         "trials))")
    ap.add_argument("--epoch-budget", type=int, default=None,
                    help="ASHA: total slot-epochs; admission stops once "
                         "spent")
    ap.add_argument("--record-eval", action="store_true",
                    help="record per-rung metric snapshots (printed, and "
                         "in the --json payload as 'history')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest snapshot in --ckpt-dir")
    ap.add_argument("--json", action="store_true",
                    help="print a RESULT::{json} line with every trial")
    ap.add_argument("--kill-after-trial", type=int, default=None,
                    help="fault injection: SIGKILL this process after N "
                         "trials are completed and checkpointed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run "
                         "on the CPU)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="run the search on a mesh of N host processes")
    ap.add_argument("--devices-per-host", type=int, default=2,
                    help="partitions each host process holds (L)")
    args = ap.parse_args(argv)
    if args.hosts > 1 and "REPRO_HOST_ID" not in os.environ:
        return _drive_hosts(args, argv)
    return run_host(lambda: _run(ap, args))


def _run(ap, args):

    if args.grid:
        configs = grid(parse_space(args.grid))
    elif args.samples:
        if not args.space:
            ap.error("--samples requires --space")
        configs = sample(parse_space(args.space), args.samples, args.seed)
    else:
        ap.error("pass --grid or --samples/--space")

    mesh = None
    if "REPRO_HOST_ID" in os.environ:
        device = hostmesh.host_device(args.device, int(os.environ["REPRO_HOST_ID"]))
        mesh = mesh_from_env(device, args.devices_per_host)
    else:
        device = resolve_device(args.device)
    table = make_table(args.algorithm, args.rows, args.features, args.seed,
                       device, mesh)
    algorithm = args.algorithm
    if algorithm == "pipeline":
        algorithm = make_pipeline(args.features, device, mesh)
    layout = (f"{mesh.num_hosts} hosts x {mesh.local_partitions} partitions "
              f"({mesh.backend})" if mesh is not None
              else f"{NUM_SHARDS} emulated partitions")
    where = (f"host table (featurized per fold, {layout}) on {device}"
             if args.algorithm == "pipeline" else f"{layout} on {device}")
    print(f"tune: {args.algorithm} | {len(configs)} trials | "
          f"{'%d-fold CV' % args.folds if args.folds else 'holdout'} | "
          f"exec={args.execution} | schedule={args.schedule} | {where}")

    killer = None
    if args.kill_after_trial is not None:
        completed = {"trials": 0}

        def killer(units_done: int, trial_indices: List[int]) -> None:
            completed["trials"] += len(trial_indices)
            if completed["trials"] >= args.kill_after_trial:
                os.kill(os.getpid(), signal.SIGKILL)

    if args.asha:
        early = AsyncSuccessiveHalving(
            reduction_factor=args.reduction_factor,
            min_rounds=args.min_rounds, slots=args.slots,
            epoch_budget=args.epoch_budget)
    else:
        early = MedianStoppingRule() if args.early_stop else None

    history = None
    callbacks = ()
    if args.record_eval:
        from repro_torch.eval.metrics import MetricHistory

        history = MetricHistory()
        callbacks = (record_evaluation(history),)

    search = ModelSearch(
        algorithm=algorithm, configs=configs, num_epochs=args.epochs,
        chunks_per_epoch=args.chunks_per_epoch, folds=args.folds,
        val_fraction=args.holdout, metric=args.metric,
        schedule=args.schedule, execution=args.execution, seed=args.seed,
        early_stop=early, rung_epochs=args.rung_epochs,
        callbacks=callbacks, ckpt_dir=args.ckpt_dir,
        unit_callback=killer)

    resume = bool(args.resume and args.ckpt_dir)
    if resume:
        from repro_torch.checkpoint import latest_step
        step = latest_step(args.ckpt_dir)
        if step is None:
            print("no checkpoint found; starting fresh")
            resume = False
        else:
            print(f"resuming from unit {step} in {args.ckpt_dir}")

    result = search.run(table, resume=resume)

    for t in result.trials:
        flag = " (stopped early)" if t.stopped else ""
        print(f"TRIAL {t.index} score={t.score:.6f} "
              f"config={json.dumps(t.config, sort_keys=True)}{flag}")
    best = result.best
    print(f"BEST trial={best.index} score={best.score:.6f} "
          f"config={json.dumps(best.config, sort_keys=True)}")
    if history is not None:
        for t in history.trials():
            for m in history.metrics(t):
                points = " ".join(f"{e}:{v:.4f}"
                                  for e, v in history.series(t, m))
                print(f"EVAL trial={t} metric={m} {points}")

    if args.json:
        payload = {
            "trials": [
                {"index": t.index, "config": t.config,
                 "score": t.score, "rung_scores": t.rung_scores,
                 "stopped": t.stopped,
                 "state": t.state.detach().cpu().numpy().tolist()}
                for t in result.trials
            ],
            "best": {"index": best.index, "config": best.config,
                     "score": best.score},
        }
        if history is not None:
            payload["history"] = history.to_dict()
        print("RESULT::" + json.dumps(payload))
    return result


if __name__ == "__main__":
    main()
