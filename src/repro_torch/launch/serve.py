"""Serving launcher: ``python -m repro_torch.launch.serve --engine lm|model``
(counterpart: ``src/repro/launch/serve.py``).

  * ``--engine lm`` — the continuous-batching LM engine
    (``serve/engine.py`` + ``serve/scheduler.py``): synthetic mixed-length
    prompts arrive on an all-at-once / Poisson / uniform / burst trace, are
    queued, admitted into decode slots (backfilled mid-decode), and
    greedy-decoded through one fused per-slot-position step.  Weights are
    made from ``--seed``, quantized a block at a time as they are drawn;
    ``--quantize int8`` sends every attention and dense MLP projection
    through the ``quant_matmul`` kernel (an MoE block's experts stay in the
    config's dtype, as the reference's int8 mode leaves them).
  * ``--engine model`` — the prediction service for fitted models
    (``serve/predictor.py``): fit a small logistic regression or k-means on
    synthetic data, then serve feature-block requests through the
    microbatcher.

Both run on the CUDA card unless ``--device cpu``.  The engine is warmed
up on the trace's shapes before the timed run.  ``--json`` prints the
report as a ``RESULT::{json}`` line.  ``--replicas N`` serves through a
``ReplicaRouter`` fleet of N lane-group replicas (``--autoscale-min`` adds
the queue-driven autoscaler, ``--admission`` the SLO gate, with
``--slo-ms`` and ``--tenants``), and ``--prefix-cache on`` adds the radix
prefix KV cache (``--prefix-block``, ``--prefix-capacity``; with
``--prefix-share p`` a fraction p of the requests open with one shared
``--prefix-len``-token prefix), as the reference's flags do.  Not ported
yet (ROADMAP.md, Queue 1): ``--mesh``, which raises.

A configuration with a stubbed frontend prints the reference's note:
``llava-next-34b`` then serves its text-only path, and ``whisper-small``
exits with the engine's error (the engine takes no encoder frames).

Examples (CPU; ``--arch`` also ``granite-3-8b``, ``qwen1.5-32b``,
``recurrentgemma-9b``, ``gemma3-1b``, ``mamba2-2.7b``, ``llava-next-34b``,
and the MoE models ``mixtral-8x22b`` and ``llama4-scout-17b-16e``, which
prefill each request alone):
    PYTHONPATH=src python -m repro_torch.launch.serve --engine lm \
        --arch qwen2-1.5b --smoke --quantize int8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --engine lm \
        --arch qwen2-1.5b --smoke --requests 16 --prefix-cache on \
        --prefix-share 0.8 --prefix-len 32 --prefix-block 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --engine lm \
        --arch qwen2-1.5b --smoke --requests 16 --replicas 4 --slots 2 \
        --autoscale-min 1 --prefix-cache on --prefix-share 0.5 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --engine model \
        --algorithm kmeans --rows 512 --features 16 --batch 64 --device cpu --json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, PENDING_IDS, get_config, get_smoke
from repro_torch.device import resolve_device

__all__ = ["arrival_trace", "run_lm", "run_model", "main"]


def arrival_trace(kind: str, n: int, rate: float, seed: int) -> np.ndarray:
    """Request release times (seconds from serve start).

    ``all-at-once`` (rate<=0 or kind 'none') releases everything at t=0;
    ``poisson`` draws exponential inter-arrivals at ``rate`` req/s;
    ``uniform`` spaces arrivals evenly at the same mean rate; ``burst``
    releases half at t=0 and half at a fixed ``1/rate`` seconds."""
    if kind == "none" or rate <= 0:
        return np.zeros(n)
    rng = np.random.default_rng(seed + 1)
    if kind == "poisson":
        return np.cumsum(rng.exponential(1.0 / rate, size=n))
    if kind == "uniform":
        return np.arange(n) / rate
    if kind == "burst":
        half = (n + 1) // 2
        return np.concatenate([np.zeros(half), np.full(n - half, 1.0 / rate)])
    raise ValueError(f"unknown arrival kind {kind!r}")


def run_lm(args) -> dict:
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import (QueueAutoscaler, RadixPrefixCache, ReplicaRouter,
                                   Request, ServeEngine, SlotScheduler)

    if args.mesh:
        raise NotImplementedError("--mesh is not ported yet (ROADMAP.md, Queue 1)")
    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encoder_layers or cfg.vision_tokens:
        print(f"note: {cfg.name} frontend is stubbed; serving text-only path")
    if args.quantize != "none":
        cfg = dataclasses.replace(cfg, quantize=args.quantize)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    # quantized a block at a time as drawn: Qwen1.5-32B's bf16 tree would
    # not fit the card
    params = init_model(gen, cfg)
    fleet = args.replicas > 0

    lens = [int(x) for x in args.prompt_lens.split(",") if x]
    rng = np.random.default_rng(args.seed)
    arrivals = arrival_trace(args.arrival, args.requests, args.rate, args.seed)
    tenants = [f"t{i}" for i in range(max(1, args.tenants))]
    # with --prefix-share p, fraction p of the requests open with ONE shared
    # --prefix-len token prefix (a synthetic system prompt); the rest are
    # random at the same total length, so cache-on and cache-off runs
    # prefill the same token counts (the reference's draw, in its order)
    shared_prefix = rng.integers(0, cfg.vocab_size, size=args.prefix_len).astype(np.int32)

    def prompt(i: int) -> np.ndarray:
        if args.prefix_share <= 0:
            return rng.integers(0, cfg.vocab_size, size=lens[i % len(lens)]).astype(np.int32)
        n = args.prefix_len + lens[i % len(lens)]
        if rng.random() < args.prefix_share:
            tail = rng.integers(0, cfg.vocab_size, size=n - args.prefix_len).astype(np.int32)
            return np.concatenate([shared_prefix, tail])
        return rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)

    reqs = [Request(prompt=prompt(i), max_new_tokens=args.max_new,
                    arrival=float(arrivals[i]), tenant=tenants[i % len(tenants)],
                    slo_ms=args.slo_ms if args.slo_ms > 0 else None)
            for i in range(args.requests)]
    prefix_cache = (RadixPrefixCache(block_size=args.prefix_block,
                                     capacity_blocks=args.prefix_capacity)
                    if args.prefix_cache == "on" else None)

    def prefix_fields(rep: dict) -> None:
        s = prefix_cache.stats() if prefix_cache is not None else None
        rep["prefix_cache"] = s
        rep["prefill_tokens"] = (s["prompt_tokens"] if s
                                 else sum(len(r.prompt) for r in reqs))
        rep["cached_prefill_tokens"] = s["cached_tokens"] if s else 0
        rep["prefix_hit_rate"] = s["hit_rate"] if s else 0.0
        if s:
            print(f"  prefix cache: {s['cached_tokens']}/{s['prompt_tokens']} "
                  f"prefill tokens served cached (hit rate {s['hit_rate']:.2f}), "
                  f"{s['evictions']} evictions")

    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    try:
        if fleet:
            autoscaler = (QueueAutoscaler(slots_per_replica=args.slots,
                                          min_replicas=args.autoscale_min,
                                          max_replicas=args.replicas)
                          if args.autoscale_min > 0 else None)
            server = ReplicaRouter(
                cfg, params, slots_per_replica=args.slots, max_replicas=args.replicas,
                max_seq=args.max_seq, admission=args.admission, autoscaler=autoscaler,
                min_replicas=args.autoscale_min or args.replicas,
                prefix_cache=prefix_cache, device=device)
        else:
            server = ServeEngine(cfg, params, batch_size=args.slots,
                                 max_seq=args.max_seq, prefix_cache=prefix_cache,
                                 device=device)
    except ValueError as e:          # a configuration the engine cannot serve
        raise SystemExit(f"error: {e}") from None
    if not args.no_warmup:
        t0 = time.perf_counter()
        if fleet:
            server.warmup(prompt_lens=lens,
                          spans=(range(args.autoscale_min, args.replicas + 1)
                                 if args.autoscale_min > 0 else [args.replicas]))
        else:
            server.warmup(prompt_lens=lens)
        print(f"warmup {time.perf_counter() - t0:.2f}s — excluded from the "
              f"perf report")

    start = time.perf_counter()
    now_fn = (lambda: time.perf_counter() - start)
    if fleet:
        done = server.run(reqs, now_fn=now_fn)
        dt = time.perf_counter() - start
        served = [r for r in done if r.done]
        total_new = sum(len(r.out_tokens) for r in served)
        rep = server.report()
        rep.pop("per_replica")
        rep.update({
            "engine": "lm", "arch": args.arch, "slots": args.slots,
            "requests": len(served), "new_tokens": total_new,
            "seconds": round(dt, 4),
            "requests_per_sec": round(len(served) / dt, 2),
            "tokens_per_sec": round(total_new / dt, 1),
            "arrival": args.arrival, "rate": args.rate,
            "quantize": args.quantize, "admission": args.admission,
            "tenants_n": len(tenants), "mesh": "none",
            "device": str(device), "device_name": device_name,
        })
        print(f"fleet served {len(served)}/{len(done)} requests / {total_new} tokens in "
              f"{dt:.2f}s ({rep['requests_per_sec']} req/s, {rep['tokens_per_sec']} tok/s) "
              f"| {args.replicas}x{args.slots} lanes, quantize={args.quantize} on "
              f"{device_name}")
        print(f"latency p50={rep['latency_p50']*1e3:.1f}ms "
              f"p95={rep['latency_p95']*1e3:.1f}ms p99={rep['latency_p99']*1e3:.1f}ms | "
              f"rejected={rep['rejected']} degraded={rep['degraded']} | "
              f"backfills={rep['backfills']}")
        for t, tr in sorted(rep["tenants"].items()):
            print(f"  {t}: finished={tr['finished']} rejected={tr['rejected']} "
                  f"slo_attainment={tr['slo_attainment']:.2f}")
        if rep["autoscaler_events"]:
            print(f"  autoscaler: {rep['autoscaler_events']}")
        prefix_fields(rep)
        assert all(r.done or r.rejected for r in done)
        return rep

    sched = SlotScheduler(args.slots)
    done = server.run(reqs, scheduler=sched, now_fn=now_fn)
    dt = time.perf_counter() - start

    total_new = sum(len(r.out_tokens) for r in done)
    rep = sched.report()
    rep.update({
        "engine": "lm", "arch": args.arch, "slots": args.slots,
        "requests": len(done), "new_tokens": total_new,
        "seconds": round(dt, 4),
        "requests_per_sec": round(len(done) / dt, 2),
        "tokens_per_sec": round(total_new / dt, 1),
        "arrival": args.arrival, "rate": args.rate,
        "quantize": args.quantize, "mesh": "none",
        "ragged_prefill": server.ragged_ok,
        "device": str(device), "device_name": device_name,
    })
    prefix_fields(rep)
    print(f"served {len(done)} requests / {total_new} tokens in {dt:.2f}s "
          f"({rep['requests_per_sec']} req/s, {rep['tokens_per_sec']} tok/s) "
          f"on {rep['device_name']}")
    print(f"queue depth max={rep['queue_depth_max']} "
          f"mean={rep['queue_depth_mean']:.2f} | backfills={rep['backfills']} "
          f"| wait p50={rep['wait_p50']*1e3:.1f}ms p95={rep['wait_p95']*1e3:.1f}ms "
          f"| latency p50={rep['latency_p50']*1e3:.1f}ms "
          f"p95={rep['latency_p95']*1e3:.1f}ms "
          f"p99={rep['latency_p99']*1e3:.1f}ms")
    for i, r in enumerate(done[:4]):
        print(f"  req{i}: {r.out_tokens[:8]}...")
    assert all(r.done for r in done)
    return rep


def run_model(args) -> dict:
    from repro_torch.core.numeric_table import MLNumericTable
    from repro_torch.serve import ModelPredictor, PredictRequest

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    if args.algorithm == "logreg":
        from repro_torch.core.algorithms import LogisticRegression
        w = np.linspace(-1, 1, args.features).astype(np.float32)
        X = rng.normal(size=(args.rows, args.features)).astype(np.float32)
        y = (X @ w > 0).astype(np.float32)
        table = MLNumericTable.from_numpy(
            np.concatenate([y[:, None], X], 1), num_shards=args.shards,
            device=device)
        model = LogisticRegression(max_iter=5, use_kernel=args.kernel).fit(table)
    else:
        from repro_torch.core.algorithms import KMeans
        k = 4
        centers = np.stack([np.full(args.features, 2.5 * (i - (k - 1) / 2))
                            for i in range(k)]).astype(np.float32)
        X = (centers[rng.integers(0, k, size=args.rows)]
             + 0.3 * rng.normal(size=(args.rows, args.features))
             ).astype(np.float32)
        table = MLNumericTable.from_numpy(X, num_shards=args.shards, device=device)
        model = KMeans(k=k, max_iter=5, use_kernel=args.kernel).fit(table)

    service = ModelPredictor(model, max_batch=args.batch, device=device)
    sizes = rng.integers(1, max(2, args.batch // 2), size=args.requests)
    blocks = [rng.normal(size=(int(s), args.features)).astype(np.float32)
              for s in sizes]
    if not args.no_warmup:
        service.predict_many([blocks[0]])
        service.batches = service.rows_served = service.rows_padded = 0

    arrivals = arrival_trace(args.arrival, args.requests, args.rate, args.seed)
    start = time.perf_counter()
    for b, a in zip(blocks, arrivals):
        wait = a - (time.perf_counter() - start)
        if wait > 0:
            time.sleep(wait)
        service.submit(PredictRequest(features=b))
    done = service.flush(now=time.perf_counter() - start)
    dt = time.perf_counter() - start

    rows = sum(b.shape[0] for b in blocks)
    rep = service.report()
    rep.update({
        "engine": "model", "algorithm": args.algorithm,
        "requests": len(done), "rows": rows, "seconds": round(dt, 4),
        "rows_per_sec": round(rows / dt, 1),
        "requests_per_sec": round(len(done) / dt, 2),
        "device": str(device),
    })
    print(f"served {len(done)} predict requests / {rows} rows in {dt:.3f}s "
          f"({rep['rows_per_sec']} rows/s, {rep['batches']} microbatches, "
          f"pad fraction {rep['pad_fraction']:.2f})")
    assert all(r.done and r.result is not None for r in done)
    return rep


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--engine", default="lm", choices=("lm", "model"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run "
                         "on the CPU)")
    # shared
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival", default="none",
                    choices=("none", "poisson", "uniform", "burst"))
    ap.add_argument("--rate", type=float, default=0.0,
                    help="mean arrival rate (requests/sec; 0 = all at once)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warmup (the report then includes first-call "
                         "costs)")
    ap.add_argument("--json", action="store_true",
                    help="print a RESULT::{json} line with the perf report")
    # lm engine
    ap.add_argument("--arch", default="qwen2-1.5b", choices=ARCH_IDS + PENDING_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (continuous-batching batch size; "
                         "slots PER REPLICA with --replicas)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve through a ReplicaRouter fleet of this many "
                         "replicas (0 = single engine)")
    ap.add_argument("--tenants", type=int, default=1,
                    help="synthetic tenants (requests round-robin t0..tN-1)")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="per-request arrival→finish SLO in ms (0 = none)")
    ap.add_argument("--admission", default="none",
                    choices=("none", "reject", "degrade"),
                    help="fleet admission control when the predicted "
                         "completion misses the SLO")
    ap.add_argument("--quantize", default="none",
                    choices=("none", "bf16", "int8"),
                    help="weight quantization for the decode/prefill path")
    ap.add_argument("--prompt-lens", default="8,12,16,20",
                    help="comma list; request i uses length i mod list")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--mesh", action="store_true",
                    help="slot sharding over a mesh (not ported yet)")
    ap.add_argument("--prefix-cache", default="off", choices=("on", "off"),
                    help="radix prefix KV cache: reuse repeated prompt "
                         "prefixes across requests (and replicas)")
    ap.add_argument("--prefix-block", type=int, default=16,
                    help="prefix cache block size in tokens")
    ap.add_argument("--prefix-capacity", type=int, default=256,
                    help="prefix cache capacity in blocks (LRU beyond)")
    ap.add_argument("--prefix-share", type=float, default=0.0,
                    help="fraction of requests opening with one shared "
                         "--prefix-len token prefix (synthetic system "
                         "prompt); the rest are random at the same length")
    ap.add_argument("--prefix-len", type=int, default=32,
                    help="shared prefix length for --prefix-share traffic")
    ap.add_argument("--autoscale-min", type=int, default=0,
                    help="enable queue-driven autoscale with this minimum "
                         "replica count (0 = fixed fleet)")
    # model engine
    ap.add_argument("--algorithm", default="logreg", choices=("logreg", "kmeans"))
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--batch", type=int, default=64,
                    help="microbatch rows")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--kernel", action="store_true",
                    help="route the model through its CUDA kernel")
    args = ap.parse_args(argv)

    rep = run_lm(args) if args.engine == "lm" else run_model(args)
    if args.json:
        print("RESULT::" + json.dumps(rep))
    return rep


if __name__ == "__main__":
    main()
