#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's two main paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each one that fails makes the script exit non-zero):

  1. device   — the card's name and power limit, torch and CUDA versions;
                TF32 is switched off, so fp32 means IEEE fp32 throughout.
  2. build    — the four kernels from ``src/repro_torch/kernels/csrc`` with
                nvcc (one process per source, in parallel), into ``build/``.
  3. kernels  — each kernel of the first path against its plain PyTorch
                version on the card, in fp32 and bf16, with ragged n, d and k,
                k = 65 and 257, planted ties, and a small fit on the card
                against the same fit on the CPU.
  4. logistic regression at the paper's width: a 65,536 x (1 + 160,000) fp32
                table made on the card from a seed (the paper's 200K rows do
                not fit 80 GB at fp32, so rows are cut), 8 partitions, 3 rounds
                of each solver through the kernels, against the plain path.
  5. k-means   — 1,048,576 x 4,096 (synth_imagenet_features' width), k = 50
                (Fig. A2), 8 partitions, 3 Lloyd rounds through the kernel,
                against the plain expanded form.
  6. serving   — 16 requests of mixed sizes to each fitted model through the
                port's ModelPredictor.
  7. timing    — each kernel of the first path at its shapes with CUDA events,
                beside its plain version, a one-call library yardstick where
                there is one, and its bound.  The two tables are freed after.
  8. LM serving — Qwen2-1.5B at full width and depth (28 layers, d_model 1536,
                vocab 151,936), bf16 weights made from a seed, int8
                projections (quantize="int8"), 8 slots, max_seq 2,048: 16
                requests of 128..1,024 prompt tokens and 64 new tokens each,
                all at once, through ServeEngine.run.  Checked: 196
                quant_matmul launches per forward (7 a layer), every stream
                equal to the slot-at-a-time _run_one's, and the int8 prefill
                logits within 20 % of the same weights unquantized at the
                2-layer depth that bound was pinned on, and within 100 % at
                28 layers (on random weights the error grows with depth, in
                the reference as much as here), where a model whose int8
                weights are shifted by one layer must read beyond it.
  9. quant_matmul against its plain version, bitwise, at every (M, K, N) the
                serving phase launched, at ragged shapes and at ±127.
 10. timing    — quant_matmul at the four decode shapes and the largest
                prefill shape: device time per launch (CUDA events around a
                CUDA graph of launches, each reading its own copy of the
                weight so that the weights miss L2), the plain version,
                torch._int_mm where cuBLAS takes the shape, and the bound.

Kernel launch counts are set to 0 just before each main path (phases 4-6,
then phase 8) and read just after it: they count those paths only.  The
second-to-last line of the output is one JSON object with a record per
kernel; the last line is the device summary.  The script needs the
repository's ``src/`` beside it and one CUDA card.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM, NVIDIA's data sheet: device memory rate, the fp32 rate outside
# the tensor cores (kernels 1-3 do IEEE fp32 arithmetic) and the dense int8
# tensor-core rate (quant_matmul)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12

DEVICE = "cuda"
SEED = 0
LOGREG_ROWS, LOGREG_FEATURES = 65_536, 160_000
KMEANS_ROWS, KMEANS_FEATURES, KMEANS_K = 1_048_576, 4_096, 50
SHARDS, ROUNDS, SGD_BATCH = 8, 3, 256
FP32_TOL = 2e-4      # tests/test_kernels.py's fp32 tolerance
BF16_TOL = 5e-2      # and its bf16 one
# the LM serving phase
LM_ARCH, LM_SLOTS, LM_MAX_SEQ = "qwen2-1.5b", 8, 2048
LM_REQUESTS, LM_PROMPT_MIN, LM_PROMPT_MAX, LM_NEW = 16, 128, 1024, 64
INT8_LOGIT_TOL = 0.20   # tests/test_serve_router.py's int8 bound on its 2-layer
                        # model, relative to max |logit|
# ... and at all 28 layers, where random weights make the int8 error grow.
# The limit passes the sound int8 model and fails one whose int8 weights
# are shifted by one layer, at width 256 on the CPU
# (tests/test_torch_lm.py::test_int8_deep_bound_sees_a_shifted_layer) and
# at full width in phase 8, which reads both.
INT8_LOGIT_TOL_DEEP = 1.0
# device time of the decode launches is taken with weights that miss the
# H100's 50 MB L2, as the serving path's 1.31 GB of weights do: each timed
# launch reads its own copy of wq, cycling through at least this many bytes
COLD_BYTES = 200e6


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


CARD = ""


def say(msg: str) -> None:
    print(f"   {msg}  [{CARD}]", flush=True)


def phase(name: str):
    print(f"== {name}", flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a − b| over max|b|: the error relative to the largest entry."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp(min=1e-30)).item()


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_ms(fn, launches: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``launches`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events.  A graph keeps
    the host's per-call cost out of the reading, which eager back-to-back
    calls of a few-microsecond kernel would measure instead.  ``fn`` may
    also be a list of calls, captured once each in that order."""
    fns = fn if isinstance(fn, list) else [fn] * launches
    fns[0]()
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    graph.replay()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    sync()
    return start.elapsed_time(end) / (reps * len(fns))


def score_gap(X: torch.Tensor, C: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor):
    """For rows where two assignments differ: |score(a) − score(b)| in fp64
    and the fp32 rounding scale of those scores, so a difference can be
    shown to be a tie within rounding."""
    rows = (a != b).nonzero(as_tuple=True)
    if rows[0].numel() == 0:
        return 0, 0.0, 0.0
    x = X[rows].double()
    Cd = C.double()
    cn = (Cd * Cd).sum(1)
    ca, cb = Cd[a[rows].long()], Cd[b[rows].long()]
    gap = ((cn[a[rows].long()] - 2 * (x * ca).sum(-1))
           - (cn[b[rows].long()] - 2 * (x * cb).sum(-1))).abs()
    # an fp32 sum of d products errs by at most d·2⁻²⁴ times the sum of the
    # magnitudes; two scores of ||c||² − 2·x·c each carry that error
    mag = (cn.max() + 2 * torch.maximum((x.abs() * ca.abs()).sum(-1),
                                        (x.abs() * cb.abs()).sum(-1)))
    scale = 2 * X.shape[-1] * 2.0 ** -24 * mag
    return rows[0].numel(), gap.max().item(), (gap / scale).max().item()


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #
def phase_device() -> None:
    phase("1. device")
    print(CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")


def phase_build() -> None:
    from repro_torch.kernels import _build

    phase("2. build")
    t0 = time.perf_counter()
    logs = _build.build()
    say(f"built {sorted(logs)} in {time.perf_counter() - t0:.2f} s "
        f"into {os.path.relpath(_build.BUILD_DIR, ROOT)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"      {name}: {line.strip()}")


def phase_kernels(gen: torch.Generator) -> None:
    from repro_torch.core.algorithms.kmeans import KMeans
    from repro_torch.core.algorithms.logistic_regression import LogisticRegression
    from repro_torch.core.numeric_table import MLNumericTable
    from repro_torch.kernels import kmeans_assign as kka
    from repro_torch.kernels import logreg_grad as klg

    phase("3. kernels against their plain versions")
    say(f"tolerance: fp32 {FP32_TOL}, bf16 {BF16_TOL} (z: max abs error; "
        f"g: max abs error over max |g|); k-means assignments exact except "
        f"ties within fp32 rounding")
    for P, n, d in [(3, 77, 1031), (1, 1, 7), (2, 2500, 33), (8, 257, 4099)]:
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            table = torch.randn(P, n, d + 1, generator=gen, device=DEVICE).to(dtype)
            X, y = table[..., 1:], (table[..., 0] > 0).float()
            for w in (torch.randn(d, generator=gen, device=DEVICE) * 0.05,
                      torch.randn(P, d, generator=gen, device=DEVICE) * 0.05):
                z = klg.logreg_margin(X, y, w)
                zp = klg.logreg_margin_plain(X, y, w)
                g = klg.logreg_xt_z(X, zp)
                gp = klg.logreg_xt_z_plain(X, zp)
                sync()
                ez, eg = (z - zp).abs().max().item(), rel_err(g, gp)
                check(ez <= tol and eg <= tol,
                      f"logreg X{(P, n, d)} {dtype} w{tuple(w.shape)}: "
                      f"z err {ez}, g rel err {eg}")
            say(f"logreg {str(dtype)[6:]} X{(P, n, d)} (strided view), shared "
                f"and per-partition w: z err {ez:.3g}, g rel err {eg:.3g}")
    for P, n, d, k in [(3, 333, 1031, 50), (2, 129, 33, 7), (1, 5, 3, 1),
                       (2, 300, 70, 65), (1, 513, 100, 257), (2, 1000, 64, 64)]:
        for dtype in (torch.float32, torch.bfloat16):
            X = torch.randn(P, n, d, generator=gen, device=DEVICE).to(dtype)
            C = torch.randn(k, d, generator=gen, device=DEVICE)
            a, ap = kka.kmeans_assign(X, C), kka.kmeans_assign_plain(X, C)
            sync()
            differ, gap, ratio = score_gap(X.float(), C, a, ap)
            check(ratio <= 1.0, f"kmeans X{(P, n, d)} k={k} {dtype}: "
                  f"{differ} picks differ beyond rounding (gap {gap})")
        say(f"kmeans_assign X{(P, n, d)} k={k}: fp32 and bf16 equal to the "
            f"plain version ({differ} tie picks)")
    X = torch.randn(2, 256, 512, generator=gen, device=DEVICE)
    C0 = torch.randn(4, 512, generator=gen, device=DEVICE)
    a = kka.kmeans_assign(X, torch.cat([C0, C0, C0]))
    sync()
    check(torch.equal(a, kka.kmeans_assign(X, C0)) and int(a.max()) < 4,
          "planted ties did not go to the lowest index")
    say("kmeans_assign: planted 3-way ties go to the lowest index")

    # a small fit on the card (kernels) against the same fit on the CPU (plain)
    rng = np.random.default_rng(SEED)
    data = rng.normal(size=(512, 65)).astype(np.float32)
    data[:, 0] = (data[:, 1:] @ rng.normal(size=64) > 0)
    for solver, lr in (("sgd", 0.1), ("gd", 0.002)):
        kw = dict(solver=solver, learning_rate=lr, max_iter=3, local_batch_size=8)
        card = LogisticRegression(use_kernel=True, **kw).fit(
            MLNumericTable.from_numpy(data, num_shards=4, device=DEVICE))
        cpu = LogisticRegression(use_kernel=True, **kw).fit(
            MLNumericTable.from_numpy(data, num_shards=4, device="cpu"))
        e = rel_err(card.weights.cpu(), cpu.weights)
        check(e <= FP32_TOL, f"small {solver} fit: card vs CPU {e}")
        say(f"small logreg fit {solver}: card (kernels) vs CPU (plain) rel err {e:.3g}")
    Xk = data[:, 1:]
    init = Xk[:5]
    card = KMeans(k=5, max_iter=4, use_kernel=True).fit(
        MLNumericTable.from_numpy(Xk, num_shards=4, device=DEVICE),
        init_centroids=init)
    cpu = KMeans(k=5, max_iter=4).fit(
        MLNumericTable.from_numpy(Xk, num_shards=4, device="cpu"),
        init_centroids=init)
    e = (card.centroids.cpu() - cpu.centroids).abs().max().item()
    check(e <= FP32_TOL, f"small k-means fit: card vs CPU {e}")
    say(f"small k-means fit: card (kernel) vs CPU (direct form) centroids max abs err {e:.3g}")


def logreg_table(gen: torch.Generator) -> torch.Tensor:
    """(rows, 1 + d) fp32 on the card: ReLU'd gaussian features (as
    synth_imagenet_features) and labels from a planted linear model split
    at its median; made in row slabs, never on the host."""
    n, d = LOGREG_ROWS, LOGREG_FEATURES
    table = torch.empty((n, d + 1), dtype=torch.float32, device=DEVICE)
    w_true = torch.randn(d, generator=gen, device=DEVICE) / math.sqrt(d)
    for i in range(0, n, 4096):
        slab = table[i:i + 4096, 1:]
        slab.normal_(generator=gen).clamp_(min=0.0)
        table[i:i + 4096, 0] = slab @ w_true
    table[:, 0] = (table[:, 0] > table[:, 0].median()).float()
    return table


def phase_logreg(gen, counts, report) -> None:
    from repro_torch.core.algorithms.logistic_regression import LogisticRegression
    from repro_torch.core.numeric_table import MLNumericTable
    from repro_torch.kernels import launch_counts

    phase(f"4. logistic regression, {LOGREG_ROWS:,} x {LOGREG_FEATURES:,}, "
          f"{SHARDS} partitions")
    t0 = time.perf_counter()
    data = logreg_table(gen)
    sync()
    say(f"table {LOGREG_ROWS} x {LOGREG_FEATURES + 1} fp32 "
        f"({data.numel() * 4 / 1e9:.1f} GB) made on the card in "
        f"{time.perf_counter() - t0:.2f} s; rows cut from the paper's 200,000 "
        f"(128 GB at fp32) to fit 80 GB")
    table = MLNumericTable(data, num_shards=SHARDS)
    rows_per_shard = table.rows_per_shard
    X, y = data[:, 1:], data[:, 0]
    report["logreg"] = {"table": table}
    # the features are non-negative, so a step moves every margin the same way
    # by about lr·Σ_j x_j·g_j; on 256-row chunks at this width that common
    # move swamps the signal (one class predicted) unless lr is ~1e-7.  gd
    # steps on the gradient summed over all rows, where it cancels.
    for solver, lr in (("sgd", 1e-7), ("gd", 1e-4 / LOGREG_ROWS)):
        kw = dict(solver=solver, learning_rate=lr, max_iter=ROUNDS,
                  local_batch_size=SGD_BATCH)
        before = launch_counts()
        sync()
        t0 = time.perf_counter()
        fused = LogisticRegression(use_kernel=True, **kw).fit(table)
        sync()
        t_fused = (time.perf_counter() - t0) / ROUNDS
        after = launch_counts()
        t0 = time.perf_counter()
        plain = LogisticRegression(use_kernel=False, **kw).fit(table)
        sync()
        t_plain = (time.perf_counter() - t0) / ROUNDS
        per_round = rows_per_shard // SGD_BATCH if solver == "sgd" else 1
        got = {k: after[k] - before[k] for k in ("logreg_margin", "logreg_xt_z")}
        counts[solver] = got
        say(f"launches in the {solver} fit: {got} over {ROUNDS} rounds "
            f"(expected {per_round} of each kernel per round)")
        check(all(v == per_round * ROUNDS for v in got.values()),
              f"{solver} launches {got}")
        w = fused.weights
        check(w.shape == (LOGREG_FEATURES,) and bool(torch.isfinite(w).all()),
              f"{solver} weights not finite or misshapen")
        e = rel_err(w, plain.weights)
        # accuracy through the plain product: it is not part of the main path
        acc = ((torch.sigmoid(X @ w) > 0.5).float() == y).float().mean().item()
        say(f"fit {solver}: {t_fused:.4f} s/round through the kernels, "
            f"{t_plain:.4f} s/round plain; weights rel err vs plain {e:.3g}; "
            f"training accuracy {acc:.4f}")
        check(e <= 1e-3, f"{solver} weights kernel vs plain rel err {e}")
        report["logreg"][solver] = fused


def kmeans_table(gen: torch.Generator) -> torch.Tensor:
    n, d = KMEANS_ROWS, KMEANS_FEATURES
    data = torch.empty((n, d), dtype=torch.float32, device=DEVICE)
    data.normal_(generator=gen).clamp_(min=0.0)
    return data


def plain_lloyd(blocks: torch.Tensor, C: torch.Tensor, rounds: int):
    """Lloyd rounds with the plain expanded-form assignment, written out
    independently of the port's KMeans."""
    from repro_torch.kernels.kmeans_assign import kmeans_assign_plain

    k = C.shape[0]
    for _ in range(rounds):
        a = kmeans_assign_plain(blocks, C).long()
        onehot = torch.nn.functional.one_hot(a, k).float()
        sums = (onehot.transpose(1, 2) @ blocks).sum(0)
        counts = onehot.sum((0, 1)).unsqueeze(-1)
        C = torch.where(counts > 0, sums / counts.clamp(min=1.0), C)
    return C


def phase_kmeans(gen, counts, report) -> None:
    from repro_torch.core.algorithms.kmeans import KMeans
    from repro_torch.core.numeric_table import MLNumericTable
    from repro_torch.kernels import launch_counts

    phase(f"5. k-means {KMEANS_ROWS:,} x {KMEANS_FEATURES:,}, k={KMEANS_K}, "
          f"{SHARDS} partitions")
    t0 = time.perf_counter()
    data = kmeans_table(gen)
    sync()
    say(f"table {KMEANS_ROWS} x {KMEANS_FEATURES} fp32 "
        f"({data.numel() * 4 / 1e9:.1f} GB) made on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    table = MLNumericTable(data, num_shards=SHARDS)
    est = KMeans(k=KMEANS_K, max_iter=ROUNDS, seed=SEED, use_kernel=True)
    init = KMeans(k=KMEANS_K, max_iter=0, seed=SEED).fit(table).centroids
    before = launch_counts()["kmeans_assign"]
    sync()
    t0 = time.perf_counter()
    model = est.fit(table)
    sync()
    t_fit = (time.perf_counter() - t0) / ROUNDS
    got = launch_counts()["kmeans_assign"] - before
    counts["kmeans_fit"] = got
    say(f"launches of kmeans_assign in the fit: {got} over {ROUNDS} rounds "
        f"(expected 1 a round)")
    check(got == ROUNDS, f"k-means fit launches {got}")
    t0 = time.perf_counter()
    C_plain = plain_lloyd(data.view(SHARDS, -1, KMEANS_FEATURES), init, ROUNDS)
    sync()
    t_plain = (time.perf_counter() - t0) / ROUNDS
    C = model.centroids
    e = (C - C_plain).abs().max().item()
    check(C.shape == (KMEANS_K, KMEANS_FEATURES) and bool(torch.isfinite(C).all()),
          "centroids not finite or misshapen")
    # a centroid is a mean over ~2·10^4 rows: one tie row moving between
    # clusters shifts a coordinate by well under 1e-3
    check(e <= 1e-3, f"centroids kernel vs plain max abs err {e}")
    say(f"fit: {t_fit:.4f} s/round through the kernel (1 launch a round), "
        f"{t_plain:.4f} s/round plain expanded form; centroids max abs err "
        f"vs plain {e:.3g}")
    report["kmeans"] = {"table": table, "model": model}


def phase_serving(gen, counts, report) -> None:
    from repro_torch.kernels import launch_counts
    from repro_torch.serve.predictor import ModelPredictor, PredictRequest

    phase("6. serving 16 requests to each fitted model")
    rng = np.random.default_rng(SEED)
    for name, model, rows, max_batch, kernel in (
            ("k-means", report["kmeans"]["model"],
             report["kmeans"]["table"].data, 2048, "kmeans_assign"),
            ("logreg", report["logreg"]["sgd"],
             report["logreg"]["table"].data[:, 1:], 32, "logreg_margin")):
        svc = ModelPredictor(model, max_batch=max_batch, device=DEVICE)
        sizes = rng.integers(1, 2 * max_batch, size=16)
        starts = rng.integers(0, rows.shape[0] - 2 * max_batch, size=16)
        blocks = [rows[s:s + m].cpu().numpy() for s, m in zip(starts, sizes)]
        before = launch_counts()[kernel]
        latencies, results = [], []
        for b in blocks:
            t0 = time.perf_counter()
            req = svc.submit(PredictRequest(features=b))
            svc.flush()
            latencies.append((time.perf_counter() - t0) * 1e3)
            results.append(req.result)
        got = launch_counts()[kernel] - before
        counts[f"serve_{name}"] = got
        check(got == svc.batches, f"{name} serving: {got} launches for "
              f"{svc.batches} microbatches")
        # each result against the plain path on the same rows
        mismatched = 0
        for b, r in zip(blocks, results):
            x = torch.from_numpy(b).to(DEVICE)
            if name == "k-means":
                from repro_torch.kernels.kmeans_assign import kmeans_assign_plain
                want = kmeans_assign_plain(x, model.centroids)
                n, _, ratio = score_gap(x, model.centroids,
                                        torch.from_numpy(r).to(DEVICE), want)
                check(ratio <= 1.0, "served assignment differs beyond a tie")
                mismatched += n
            else:
                p = torch.sigmoid(x @ model.weights)
                want = (p > 0.5).float()
                bad = (torch.from_numpy(r).to(DEVICE) != want) & ((p - 0.5).abs() > 1e-4)
                check(not bool(bad.any()), "served label differs from the plain path")
                mismatched += int((torch.from_numpy(r).to(DEVICE) != want).sum())
        say(f"{name}: served {len(blocks)} requests of {min(sizes)}..{max(sizes)} "
            f"rows ({sum(sizes)} in all) in {svc.batches} microbatches of "
            f"{max_batch}, {got} {kernel} launches; latency median "
            f"{float(np.median(latencies)):.3f} ms, max {max(latencies):.3f} ms; "
            f"{mismatched} results differ from the plain path, each a tie "
            f"within rounding")


def phase_timing(gen, counts, report) -> list:
    from repro_torch.kernels import kmeans_assign as kka
    from repro_torch.kernels import logreg_grad as klg

    phase("7. timing at the main path's shapes")
    records = []
    data = report["logreg"]["table"].data
    n, d = LOGREG_ROWS // SHARDS, LOGREG_FEATURES
    X = data.view(SHARDS, n, d + 1)[..., 1:]
    y = data.view(SHARDS, n, d + 1)[..., 0].contiguous()
    w = report["logreg"]["gd"].weights
    Xs = X[:, :SGD_BATCH]
    ys = y[:, :SGD_BATCH].contiguous()
    Ws = report["logreg"]["sgd"].weights.expand(SHARDS, -1).contiguous()
    P = SHARDS

    # margin: X read once, w and y read, z written
    z = klg.logreg_margin(X, y, w)
    zp = klg.logreg_margin_plain(X, y, w)
    sync()
    err_z = (z - zp).abs().max().item()
    check(err_z <= FP32_TOL, f"logreg_margin at the gd shape: err {err_z}")
    zs, zsp = klg.logreg_margin(Xs, ys, Ws), klg.logreg_margin_plain(Xs, ys, Ws)
    sync()
    check((zs - zsp).abs().max().item() <= FP32_TOL, "logreg_margin at the sgd shape")
    g = klg.logreg_xt_z(X, zp)
    gp = klg.logreg_xt_z_plain(X, zp)
    sync()
    err_g = (g - gp).abs().max().item()
    check(rel_err(g, gp) <= FP32_TOL, f"logreg_xt_z at the gd shape: rel err {rel_err(g, gp)}")
    gs, gsp = klg.logreg_xt_z(Xs, zsp), klg.logreg_xt_z_plain(Xs, zsp)
    sync()
    check(rel_err(gs, gsp) <= FP32_TOL, "logreg_xt_z at the sgd shape")
    say(f"at X{(P, n, d)}: logreg_margin max abs err {err_z:.3g}; logreg_xt_z "
        f"max abs err {err_g:.3g} (rel {rel_err(g, gp):.3g}), fp32 tol {FP32_TOL}")

    def bytes_margin(rows):
        return 4 * (P * rows * d + d * (P if rows == SGD_BATCH else 1) + 2 * P * rows)

    for name, shape_rows, fn, plain, lib in (
            ("logreg_margin", n, lambda: klg.logreg_margin(X, y, w),
             lambda: klg.logreg_margin_plain(X, y, w), None),
            ("logreg_xt_z", n, lambda: klg.logreg_xt_z(X, zp),
             lambda: klg.logreg_xt_z_plain(X, zp),
             lambda: torch.matmul(X.transpose(1, 2), zp.unsqueeze(-1)))):
        ms = cuda_ms(fn, 5)
        plain_ms = cuda_ms(plain, 5)
        lib_ms = cuda_ms(lib, 5) if lib is not None else None
        if name == "logreg_margin":
            t_b, by = bound(bytes_margin(n), 2.0 * P * n * d)
            sgd = (cuda_ms(lambda: klg.logreg_margin(Xs, ys, Ws), 20),
                   cuda_ms(lambda: klg.logreg_margin_plain(Xs, ys, Ws), 20),
                   bound(bytes_margin(SGD_BATCH), 2.0 * P * SGD_BATCH * d)[0])
            err = err_z
        else:
            t_b, by = bound(4 * (P * n * d + P * n + P * d), 2.0 * P * n * d)
            sgd = (cuda_ms(lambda: klg.logreg_xt_z(Xs, zsp), 20),
                   cuda_ms(lambda: klg.logreg_xt_z_plain(Xs, zsp), 20),
                   bound(4 * (P * SGD_BATCH * d + P * SGD_BATCH + P * d),
                         2.0 * P * SGD_BATCH * d)[0])
            err = err_g
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        say(f"{name} X{(P, n, d)} (gd): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_txt}, bound {t_b:.4f} ms ({by})")
        say(f"{name} X{(P, SGD_BATCH, d)} (sgd chunk): kernel {sgd[0]:.4f} ms, "
            f"plain {sgd[1]:.4f} ms, bound {sgd[2]:.4f} ms (bytes)")
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/logreg_grad.cu",
            "replaces": "src/repro/kernels/logreg_grad.py:"
                        + ("85" if name == "logreg_margin" else "111"),
            "launches": counts["sgd"][name] + counts["gd"][name]
            + (counts["serve_logreg"] if name == "logreg_margin" else 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": t_b, "bound_by": by, "library_ms": lib_ms,
            "shape": [P, n, d], "sgd_shape": [P, SGD_BATCH, d],
            "sgd_ms": sgd[0], "sgd_plain_ms": sgd[1], "sgd_bound_ms": sgd[2],
            "launches_by_path": {
                "fit_sgd": counts["sgd"][name], "fit_gd": counts["gd"][name],
                "serve": counts["serve_logreg"] if name == "logreg_margin" else 0},
        })
    data = report["kmeans"]["table"].data
    Xk = data.view(SHARDS, -1, KMEANS_FEATURES)
    C = report["kmeans"]["model"].centroids
    a, ap = kka.kmeans_assign(Xk, C), kka.kmeans_assign_plain(Xk, C)
    sync()
    differ, gap, ratio = score_gap(Xk, C, a, ap)
    check(ratio <= 1.0, f"kmeans_assign at the main shape: {differ} picks "
          f"differ beyond rounding")
    ms = cuda_ms(lambda: kka.kmeans_assign(Xk, C), 5)
    plain_ms = cuda_ms(lambda: kka.kmeans_assign_plain(Xk, C), 5)
    nk = Xk.shape[0] * Xk.shape[1]
    t_b, by = bound(4 * (nk * KMEANS_FEATURES + KMEANS_K * KMEANS_FEATURES + nk),
                    2.0 * nk * KMEANS_FEATURES * KMEANS_K)
    say(f"kmeans_assign X{tuple(Xk.shape)} k={KMEANS_K}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library none, bound {t_b:.4f} ms ({by}); {differ} "
        f"assignments differ from the plain version, each a tie within fp32 "
        f"rounding (largest gap {gap:.3g}, {ratio:.3g}x the rounding scale)")
    records.append({
        "name": "kmeans_assign", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans_assign.py:75",
        "launches": counts["kmeans_fit"] + counts["serve_k-means"],
        "max_abs_err": gap, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": t_b, "bound_by": by, "library_ms": None,
        "shape": list(Xk.shape) + [KMEANS_K], "tie_picks": differ,
        "launches_by_path": {"fit": counts["kmeans_fit"],
                             "serve": counts["serve_k-means"]},
    })
    return records


def free_tables(report) -> None:
    """Drop the first path's tables (41.9 GB and 17.2 GB) before the LM."""
    report.pop("logreg", None)
    report.pop("kmeans", None)
    torch.cuda.empty_cache()
    say(f"tables freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
        f"allocated")


def lm_requests(cfg):
    from repro_torch.serve import Request

    rng = np.random.default_rng(SEED)
    lens = rng.integers(LM_PROMPT_MIN, LM_PROMPT_MAX + 1, size=LM_REQUESTS)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32),
                    max_new_tokens=LM_NEW) for n in lens]


def phase_lm(counts, report) -> None:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models.transformer import TransformerLM, init_model
    from repro_torch.serve import ServeEngine, SlotScheduler

    cfg = dataclasses.replace(get_config(LM_ARCH), quantize="int8")
    phase(f"8. LM serving: {cfg.name}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size:,}, {cfg.dtype}, int8 "
          f"projections, {LM_SLOTS} slots, max_seq {LM_MAX_SEQ}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    engine = ServeEngine(cfg, params, batch_size=LM_SLOTS, max_seq=LM_MAX_SEQ,
                         device=DEVICE)
    sync()
    n_params = sum(t.numel() for t in _leaves(params))
    q_bytes = sum(t.qt.numel() for t in _leaves(engine.params, qtensors=True))
    say(f"weights made on the card from seed {SEED} and quantized in "
        f"{time.perf_counter() - t0:.2f} s: {n_params / 1e9:.3f} B params "
        f"({cfg.dtype}), {q_bytes / 1e9:.3f} GB of int8 projections")
    engine.warmup(prompt_lens=[LM_PROMPT_MIN])
    sync()
    reqs = lm_requests(cfg)
    lens = [len(r.prompt) for r in reqs]

    # time the prefill waves; each ends in a device-to-host copy of its
    # first tokens, so the host clock covers the device work
    waves = []
    prefill_into = engine._prefill_into

    def timed_prefill_into(*a, **kw):
        t = time.perf_counter()
        out = prefill_into(*a, **kw)
        waves.append(time.perf_counter() - t)
        return out

    engine._prefill_into = timed_prefill_into
    for k in engine.calls:
        engine.calls[k] = 0
    quant_matmul.shapes.clear()
    sched = SlotScheduler(LM_SLOTS)
    reset_launch_counts()            # the LM path's run starts here
    sync()
    t0 = time.perf_counter()
    served = engine.run(reqs, scheduler=sched)
    sync()
    t_run = time.perf_counter() - t0
    got = launch_counts()            # ... and ends here
    engine._prefill_into = prefill_into
    shapes = sorted(quant_matmul.shapes)
    by_shape = dict(quant_matmul.shapes)
    forwards = engine.calls["prefill_waves"] + engine.calls["decode_steps"]
    per_forward = 7 * cfg.num_layers
    counts["lm"] = got
    counts["lm_shapes"] = shapes
    counts["lm_by_shape"] = by_shape
    counts["lm_layers"] = cfg.num_layers
    counts["lm_widths"] = (cfg.d_model, cfg.num_kv_heads * cfg.resolved_head_dim,
                           cfg.d_ff)
    say(f"launches in the serving run: {got}; {engine.calls['prefill_waves']} "
        f"prefill waves + {engine.calls['decode_steps']} decode steps = "
        f"{forwards} forwards x {per_forward}")
    check(got["quant_matmul"] == per_forward * forwards > 0,
          f"quant_matmul launches {got['quant_matmul']} != {per_forward} x {forwards}")
    check(all(v == 0 for k, v in got.items() if k != "quant_matmul"),
          f"the LM path launched another kernel: {got}")
    new = sum(len(r.out_tokens) for r in served)
    check(all(r.done and len(r.out_tokens) == LM_NEW for r in served),
          "a request did not finish with its tokens")
    t_prefill = sum(waves)
    steps = engine.calls["decode_steps"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"served {len(served)} requests ({min(lens)}..{max(lens)} prompt tokens, "
        f"{sum(lens)} in all) / {new} new tokens in {t_run:.3f} s: "
        f"{new / t_run:.1f} tokens/s; prefill {t_prefill:.3f} s in {len(waves)} "
        f"waves; decode {(t_run - t_prefill) / max(steps, 1) * 1e3:.2f} ms per step "
        f"({steps} steps of {LM_SLOTS} slots); peak device memory {peak:.2f} GB; "
        f"backfills {sched.backfills}")
    say(f"quant_matmul launches by (M, K, N): {by_shape}")
    report["lm"] = {"tokens_per_s": new / t_run, "prefill_s": t_prefill,
                    "decode_ms_per_step": (t_run - t_prefill) / max(steps, 1) * 1e3,
                    "peak_gb": peak, "seconds": t_run, "new_tokens": new}

    # (b) every stream equals the slot-at-a-time oracle's
    t0 = time.perf_counter()
    solo = [engine._run_one(r) for r in lm_requests(cfg)]
    same = sum(a.out_tokens == b.out_tokens for a, b in zip(served, solo))
    say(f"streams equal to the slot-at-a-time _run_one: {same} of {len(served)} "
        f"({time.perf_counter() - t0:.1f} s for the oracle)")
    check(same == len(served), f"{len(served) - same} streams differ from _run_one")

    # (c) int8 prefill logits against the same weights unquantized.  The 20 %
    # bound was pinned on the reference's 2-layer smoke model; on random
    # weights the int8 error grows with depth in the reference as much as
    # here (tests/test_torch_lm.py::test_int8_logit_error_grows_with_depth),
    # so that bound is held at full width on the first 2 layers, and all 28
    # layers are held to INT8_LOGIT_TOL_DEEP, which int8 weights shifted by
    # one layer (each layer given the next one's) must exceed.
    sub = lm_requests(cfg)[:4]
    S = max(len(r.prompt) for r in sub)
    toks = np.zeros((len(sub), S), np.int32)
    for i, r in enumerate(sub):
        toks[i, :len(r.prompt)] = r.prompt
    n = torch.as_tensor(np.asarray([len(r.prompt) for r in sub]), device=DEVICE)
    toks = torch.as_tensor(toks, device=DEVICE)
    shifted = {**engine.params, "blocks": _roll_layers(engine.params["blocks"])}
    errs = {}
    for depth, trees in ((2, (engine.params, params)),
                         (cfg.num_layers, (engine.params, params)),
                         ("shifted", (shifted, params))):
        d = cfg.num_layers if depth == "shifted" else depth
        cut = TransformerLM(dataclasses.replace(cfg, num_layers=d), DEVICE)
        logits = []
        for tree in trees:
            tree = {**tree, "blocks": _first_layers(tree["blocks"], d)}
            out, _ = cut.prefill_ragged(tree, toks, n, cut.init_cache(len(sub), S))
            logits.append(out)
        check(bool(torch.isfinite(logits[0]).all())
              and logits[0].shape == (len(sub), 1, cfg.vocab_size),
              f"int8 logits at depth {depth} not finite or misshapen")
        errs[depth] = rel_err(*logits)
    deep = errs[cfg.num_layers]
    say(f"int8 vs unquantized prefill logits ({len(sub)} prompts, full width): "
        f"max abs error over max |logit| {errs[2]:.4f} at 2 layers (bound "
        f"{INT8_LOGIT_TOL}), {deep:.4f} at {cfg.num_layers} layers (bound "
        f"{INT8_LOGIT_TOL_DEEP}); int8 weights shifted by one layer read "
        f"{errs['shifted']:.4f}")
    check(errs[2] <= INT8_LOGIT_TOL, f"int8 logits {errs[2]} beyond {INT8_LOGIT_TOL}")
    check(deep <= INT8_LOGIT_TOL_DEEP,
          f"int8 logits at {cfg.num_layers} layers {deep} beyond {INT8_LOGIT_TOL_DEEP}")
    check(errs["shifted"] > INT8_LOGIT_TOL_DEEP,
          f"the {cfg.num_layers}-layer bound does not see weights shifted by "
          f"one layer: {errs['shifted']}")
    report["lm"]["int8_rel_err"] = errs
    del shifted
    counts["lm_profile_qmm_ms"] = decode_profile(
        engine, report["lm"]["decode_ms_per_step"])
    del engine, params, logits
    torch.cuda.empty_cache()


def decode_profile(engine, step_ms: float, steps: int = 3):
    """Where a decode step's time goes: device time by kernel over
    ``steps`` profiled steps (torch.profiler, CUDA activity), against the
    unprofiled step time of the serving run.  Returns quant_matmul's device
    ms per step, or None if the profiler saw no device time."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    B = engine.batch
    toks = engine._tensor(np.zeros((B, 1), np.int32))
    pos = engine._tensor(np.full(B, LM_PROMPT_MAX, np.int32))
    cache = engine.init_shared_cache()
    engine.model.decode_step(engine.params, toks, pos, cache)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.model.decode_step(engine.params, toks, pos, cache)
        sync()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if device_ms == 0:
        say("decode step profile: the profiler saw no device time (not measured)")
        return None
    qmm_ms = sum(e.self_device_time_total for e in kernels
                 if "qmm_" in e.key) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    say(f"decode step profile ({steps} steps, 8 slots): device busy {device_ms:.3f} ms "
        f"of the {step_ms:.2f} ms step ({device_ms / step_ms:.1%}; idle "
        f"{1 - device_ms / step_ms:.1%}), {launches:.0f} kernel launches a step; "
        f"quant_matmul {qmm_ms:.3f} ms")
    for e in top:
        say(f"    {e.self_device_time_total / 1e3 / steps:8.3f} ms  "
            f"{e.count // steps:5d} x  {e.key[:90]}")
    return qmm_ms


def _first_layers(tree, depth):
    """The first ``depth`` layers of a tree stacked on a layer axis."""
    from repro_torch.models.layers.quant import QTensor

    if isinstance(tree, dict):
        return {k: _first_layers(v, depth) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.qt[:depth], tree.scale[:depth], tree.n_contract,
                       (depth,) + tree.shape[1:])
    return tree[:depth]


def _roll_layers(tree):
    """The int8 weights of a stacked tree with layer i given layer i+1's
    (a fault the 28-layer int8 bound must see)."""
    from repro_torch.models.layers.quant import QTensor

    if isinstance(tree, dict):
        return {k: _roll_layers(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(torch.roll(tree.qt, -1, 0), torch.roll(tree.scale, -1, 0),
                       tree.n_contract, tree.shape)
    return tree


def _leaves(tree, qtensors=False):
    from repro_torch.models.layers.quant import QTensor

    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v, qtensors)
    elif isinstance(tree, QTensor) == qtensors:
        yield tree


def _qmm_operands(gen, M, K, N, extreme=False):
    if extreme:
        xq = torch.full((M, K), 127, dtype=torch.int8, device=DEVICE)
        wt = torch.full((N, K), -127, dtype=torch.int8, device=DEVICE)
    else:
        xq = torch.randint(-127, 128, (M, K), generator=gen, device=DEVICE,
                           dtype=torch.int8)
        wt = torch.randint(-127, 128, (N, K), generator=gen, device=DEVICE,
                           dtype=torch.int8)
    xs = torch.rand(M, generator=gen, device=DEVICE) * 0.02 + 1e-3
    ws = torch.rand(N, generator=gen, device=DEVICE) * 0.02 + 1e-3
    return xq, xs, wt.t(), ws           # wq as the (K, N) view QTensor gives


def phase_qmm_check(gen, counts) -> float:
    from repro_torch.kernels import quant_matmul as kqm

    phase("9. quant_matmul against its plain version (bitwise)")
    ragged = [(1, 1536, 1536), (5, 8960, 1536), (33, 1536, 8960), (8, 8960, 255),
              (5, 1537, 255), (33, 8960, 255), (1, 1537, 1)]
    worst = 0.0
    for M, K, N in counts["lm_shapes"] + ragged:
        ops = _qmm_operands(gen, M, K, N)
        a, b = kqm.quant_matmul(*ops), kqm.quant_matmul_plain(*ops)
        sync()
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        check(torch.equal(a, b), f"quant_matmul {(M, K, N)} differs: {err}")
    for M, K, N in ((8, 8960, 1536), (130, 8960, 257)):
        ops = _qmm_operands(gen, M, K, N, extreme=True)
        a, b = kqm.quant_matmul(*ops), kqm.quant_matmul_plain(*ops)
        sync()
        check(torch.equal(a, b), f"quant_matmul at ±127 {(M, K, N)} differs")
    say(f"bitwise equal at the {len(counts['lm_shapes'])} served shapes, "
        f"{len(ragged)} ragged shapes {ragged} and 2 at ±127 (K = 8960)")
    return worst


def phase_qmm_timing(gen, counts, worst) -> dict:
    from repro_torch.kernels import quant_matmul as kqm

    phase("10. quant_matmul timing at the serving shapes")
    d, kvd, f = counts["lm_widths"]
    prefill_M = max(M for M, _, _ in counts["lm_shapes"])
    rows = [("decode wq/wo", (LM_SLOTS, d, d)), ("decode wk/wv", (LM_SLOTS, d, kvd)),
            ("decode w_gate/w_up", (LM_SLOTS, d, f)), ("decode w_down", (LM_SLOTS, f, d)),
            ("prefill w_gate/w_up", (prefill_M, d, f))]
    timings = []
    for label, (M, K, N) in rows:
        xq, xs, wq, ws = _qmm_operands(gen, M, K, N)
        # copies of the weight, in both layouts, cycled through so that each
        # timed launch reads its weight from HBM and not from L2
        copies = max(1, math.ceil(COLD_BYTES / (K * N)))
        wqs = [wq.t().contiguous().t() for _ in range(copies)]
        wks = [wq.contiguous() for _ in range(copies)]
        ms = graph_ms([lambda w=w: kqm.quant_matmul(xq, xs, w, ws) for w in wqs])
        warm_ms = graph_ms(lambda: kqm.quant_matmul(xq, xs, wq, ws))
        eager_ms = cuda_ms(lambda: kqm.quant_matmul(xq, xs, wq, ws), 20)
        plain_ms = cuda_ms(lambda: kqm.quant_matmul_plain(xq, xs, wq, ws), 3)
        try:
            lib_ms, lib_note = graph_ms([lambda w=w: torch._int_mm(xq, w)
                                         for w in wks]), ""
        except RuntimeError as e:
            lib_ms, lib_note = None, str(e).splitlines()[0]
        del wqs, wks
        t_b, by = bound(M * K + K * N + 4 * (M + N + M * N), 2.0 * M * K * N,
                        INT8_OPS_PER_S)
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else f"none ({lib_note})"
        launched = counts["lm_by_shape"].get((M, K, N), 0)
        say(f"quant_matmul {label} (M, K, N) = {(M, K, N)}, {launched} launches on "
            f"the path: kernel {ms:.4f} ms with weights from HBM ({copies} copies; "
            f"{warm_ms:.4f} ms re-reading one copy from L2; eager back-to-back "
            f"{eager_ms:.4f} ms), plain {plain_ms:.4f} ms, torch._int_mm "
            f"{lib_txt}, bound {t_b:.4f} ms ({by}), {t_b / ms:.1%} of it")
        timings.append({"label": label, "shape": [M, K, N], "launches": launched,
                        "ms": ms, "warm_l2_ms": warm_ms,
                        "eager_ms": eager_ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "library_note": lib_note,
                        "bound_ms": t_b, "bound_by": by})
    # a decode step launches wq, wk, wv, wo, w_gate, w_up, w_down per layer
    layers = counts["lm_layers"]
    step_ms = layers * (2 * timings[0]["ms"] + 2 * timings[1]["ms"]
                        + 2 * timings[2]["ms"] + timings[3]["ms"])
    prof = counts.get("lm_profile_qmm_ms")
    say(f"quant_matmul per decode step from these rows: {step_ms:.3f} ms "
        f"({7 * layers} launches); the profiled decode step's quant_matmul: "
        + (f"{prof:.3f} ms" if prof else "not measured"))
    head = timings[2]                   # the widest decode launch: w_up
    return {
        "name": "quant_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:77",
        "launches": counts["lm"]["quant_matmul"],
        "max_abs_err": worst, "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": head["shape"],
        "library_note": head["library_note"] or None, "shapes": timings,
        "launches_by_path": {"lm_serve": counts["lm"]["quant_matmul"]},
    }


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import launch_counts, reset_launch_counts

    CARD = card_line()
    t_start = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    phase_device()
    phase_build()
    phase_kernels(gen)

    counts, report = {}, {}
    first_path = ("logreg_margin", "logreg_xt_z", "kmeans_assign")
    reset_launch_counts()            # the first path's run starts here
    phase_logreg(gen, counts, report)
    phase_kmeans(gen, counts, report)
    phase_serving(gen, counts, report)
    totals = launch_counts()         # ... and ends here
    say(f"launches on the first path: {totals}")
    check(all(totals[k] > 0 for k in first_path) and totals["quant_matmul"] == 0,
          f"a kernel of the first path never launched, or another did: {totals}")

    records = phase_timing(gen, counts, report)
    for r in records:
        check(r["launches"] == totals[r["name"]], f"{r['name']} launch bookkeeping")
    free_tables(report)

    phase_lm(counts, report)
    worst = phase_qmm_check(gen, counts)
    records.append(phase_qmm_timing(gen, counts, worst))
    say(f"smoke run {time.perf_counter() - t_start:.1f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB since phase 8")
    print(CARD)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
