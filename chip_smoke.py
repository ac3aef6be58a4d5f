#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each one that fails makes the script exit non-zero):

  1. device   — the card's name and power limit, torch and CUDA versions;
                TF32 is switched off, so fp32 means IEEE fp32 throughout.
  2. build    — the kernels from ``src/repro_torch/kernels/csrc`` (six
                sources) with nvcc (one process per source, in parallel),
                into ``build/``.
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
                quant_matmul and 57 rmsnorm launches per forward (7 and 2 a
                layer, and the final norm), 28 flash_attention launches per
                prefill wave and 28 flash_attention_decode per decode step
                (every attention through kernel 6), every stream
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
 11. Mamba2 serving — Mamba2-2.7B at full width (d_model 2560, 80 heads of
                P = 64, N = 128, vocab 50,280), its depth cut from 64 SSD
                layers to MB_LAYERS = 16 so that the whole run stays near
                four minutes as later paths join it, bf16 weights made from
                a seed, 8 slots, max_seq 2,048: 16
                requests, all at once (8 prompts of 256..1,024 tokens, a
                multiple of the 256 chunk, and 8 ragged ones of 142..998,
                one chunk each), 64 new tokens each, through ServeEngine.run
                with its per-request prefill.  Checked: one ssd_chunk_scan
                launch a layer a prefill and 2 rmsnorm launches a layer and
                the final norm per forward;
                every first token and every prefilled SSD state (bitwise)
                equal to the slot-at-a-time _run_one's; how many streams
                equal _run_one's, and where one leaves it, _run_one's top-2
                logit gap there; the same at a 2-layer cut; the last-token
                prefill logits through the kernels against the same model
                through the plain versions, at 2 and at 16 layers.
 12. rmsnorm and ssd_chunk_scan against their plain versions at every shape
                phases 8 and 11 launched, at ragged shapes, and (the scan)
                with and without an initial state; rmsnorm rows alone equal
                the same rows in a batch, bitwise.
 13. timing    — rmsnorm and ssd_chunk_scan at the served shapes (CUDA
                events around a CUDA graph), beside the plain versions, the
                library call where there is one (torch.nn.functional.
                rms_norm) and the bound.
 14. Gemma3 serving — Gemma3-1B at full width and depth (26 layers: 22
                sliding-window layers with 512-slot ring caches and 4 global
                ones; d_model 1152, 4 q heads over 1 kv head of 256, vocab
                262,144), bf16 weights made from a seed, int8 projections, 8
                slots, max_seq 2,048: 16 requests of 40..1,960 prompt tokens
                (some overflow the ring at prefill, some wrap it mid-decode;
                the global caches run to 2,024 positions), 64 new tokens
                each, all at once.  Checked: 26 flash_attention launches per
                prefill wave and 26 flash_attention_decode per decode step,
                182 quant_matmul and 53 rmsnorm per forward; every stream
                equal to _run_one's; the last-token prefill logits through
                the kernels against the plain versions at a 2-layer cut (the
                first local and the first global layer).
 15. flash_attention (both forms) against its plain versions at every shape
                phases 8 and 14 launched, and in fp32 and bf16 at hd 32, 128
                and 256, GQA 1:1 to 6:1, every mask, Sq < Sk, lengths that are
                not a multiple of the key tile, and rings that have wrapped
                (pos >= slots); a row bitwise the same at B = 1 and in a batch
                of 8, and at its exact length and padded; a plain version
                whose window is widened by one must read beyond the tolerance.
 16. timing    — flash_attention at the served shapes (CUDA events), beside
                the plain versions, one torch.nn.functional.
                scaled_dot_product_attention call (its backend named) and the
                bound.

Kernel launch counts are set to 0 just before each main path (phases 4-6,
then phase 8, then phase 11, then phase 14) and read just after it: they
count those paths only.  The
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
# the tensor cores (kernels 1-3, rmsnorm, ssd_chunk_scan and flash_attention
# do IEEE fp32 arithmetic) and the dense int8 tensor-core rate (quant_matmul)
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
# the Mamba2 serving phase: 8 prompts a multiple of the 256 chunk (each
# twice) and 8 ragged ones drawn from MB_RAGGED (one chunk of L = S each)
MB_ARCH, MB_SLOTS, MB_MAX_SEQ, MB_NEW = "mamba2-2.7b", 8, 2048, 64
MB_LAYERS = 16          # of the published 64
MB_ALIGNED, MB_RAGGED = (256, 512, 768, 1024), (142, 998)
# Where a stream leaves the slot-at-a-time oracle (the decode products are
# bf16 cuBLAS products, whose order depends on the batch), the oracle's gap
# between its two best logits at that step must stay under these limits:
# at a 2-layer cut a tie within rounding; at MB_LAYERS layers, where the
# random-weight stack is chaotic (tests/test_torch_mamba2.py::
# test_random_deep_stack_is_chaotic) and rounding moves logits by O(1),
# only a clear winner (the logits' std is 2, their top-2 spacing ~0.4).
MB_GAP_LIMIT, MB_GAP_LIMIT_DEEP = 0.05, 3.0
# last-token prefill logits through the kernels against the plain versions,
# max abs error over max |logit|, at a 2-layer cut (at MB_LAYERS printed)
MB_PLAIN_TOL = 0.02
RMS_BF16_TOL = 2.0 ** -7     # one bf16 step of the value
# the Gemma3 serving phase: the prompts are served short and long in turns,
# so that each admission wave pads short prompts to long ones
G3_ARCH, G3_SLOTS, G3_MAX_SEQ, G3_NEW = "gemma3-1b", 8, 2048, 64
G3_PROMPTS = (40, 127, 128, 300, 480, 500, 511, 512, 513, 700, 1023, 1024, 1300,
              1536, 1800, 1960)
# last-token prefill logits through the kernels against the plain versions,
# max abs error over max |logit|, at a 2-layer cut: fixed before the first
# run, as phase 11's bound (rounding alone, carried through bf16 casts and
# int8 activations, reads ~1e-3 there)
G3_PLAIN_TOL = 0.02
# flash_attention against its plain version: tests/test_kernels.py's fp32
# tolerance; in bf16 one bf16 step of each value (the kernel sums in fp32,
# the plain version in fp64, and the outputs round to bf16 either side of a
# boundary) plus 1e-6 for values near 0
FLASH_TOL = {torch.float32: dict(rtol=FP32_TOL, atol=FP32_TOL),
             torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-6)}
# prompt lengths of the bitwise invariance check: short of one key tile and
# past it, either side of the ring, the longest served
FLASH_INVARIANCE_LENS = (40, 127, 300, 511, 513, 1023, 1024, 1960)


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


def fmt(values) -> str:
    return ", ".join(f"{v:.3g}" for v in values)


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
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_decode
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.kernels.rmsnorm import rmsnorm
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
    rmsnorm.shapes.clear()
    flash_attention.shapes.clear()
    flash_attention_decode.shapes.clear()
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
    counts["lm_rms_shapes"] = dict(rmsnorm.shapes)
    counts["lm_flash_shapes"] = dict(flash_attention.shapes)
    counts["lm_flash_decode_shapes"] = dict(flash_attention_decode.shapes)
    counts["lm_shapes"] = shapes
    counts["lm_by_shape"] = by_shape
    counts["lm_layers"] = cfg.num_layers
    counts["lm_widths"] = (cfg.d_model, cfg.num_kv_heads * cfg.resolved_head_dim,
                           cfg.d_ff)
    norms = 2 * cfg.num_layers + 1
    say(f"launches in the serving run: {got}; {engine.calls['prefill_waves']} "
        f"prefill waves + {engine.calls['decode_steps']} decode steps = "
        f"{forwards} forwards x {per_forward} quant_matmul and x {norms} rmsnorm")
    check(got["quant_matmul"] == per_forward * forwards > 0,
          f"quant_matmul launches {got['quant_matmul']} != {per_forward} x {forwards}")
    check(got["rmsnorm"] == norms * forwards,
          f"rmsnorm launches {got['rmsnorm']} != {norms} x {forwards}")
    check_attention_launches(got, cfg.num_layers, engine.calls)
    check(all(v == 0 for k, v in got.items() if k not in LM_KERNELS),
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
    say(f"flash_attention launches by (B, H, KV, Sq, Sk, hd, (causal, window, chunk)): "
        f"{counts['lm_flash_shapes']}; flash_attention_decode by (B, H, KV, slots, "
        f"hd, mask): {counts['lm_flash_decode_shapes']}")
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
    prof = decode_profile(engine, report["lm"]["decode_ms_per_step"], LM_PROMPT_MAX)
    counts["lm_profile_qmm_ms"] = prof["quant_matmul"] if prof else None
    report["lm"]["decode_profile"] = prof
    del engine, params, logits
    torch.cuda.empty_cache()


# our kernels' names in a profile: the CUDA functions' names contain these
# (both forms of flash_attention are instances of flash_kernel; a decode step
# launches the decode form alone)
PROFILED = {"quant_matmul": "qmm_", "rmsnorm": "rmsnorm_kernel",
            "ssd_chunk_scan": "ssd_kernel", "flash_attention_decode": "flash_kernel"}
# the kernels an attention LM's serving path launches
LM_KERNELS = ("quant_matmul", "rmsnorm", "flash_attention", "flash_attention_decode")


def check_attention_launches(got, layers: int, calls) -> None:
    """Every attention layer of every forward went through kernel 6: one
    prefill launch a layer a wave, one decode launch a layer a step."""
    waves, steps = calls["prefill_waves"], calls["decode_steps"]
    say(f"attention launches: flash_attention {got['flash_attention']} = {layers} x "
        f"{waves} prefill waves, flash_attention_decode {got['flash_attention_decode']} "
        f"= {layers} x {steps} decode steps")
    check(got["flash_attention"] == layers * waves > 0,
          f"flash_attention launches {got['flash_attention']} != {layers} x {waves}")
    check(got["flash_attention_decode"] == layers * steps > 0,
          f"flash_attention_decode launches {got['flash_attention_decode']} != "
          f"{layers} x {steps}")


def decode_profile(engine, step_ms: float, pos: int, steps: int = 3):
    """Where a decode step's time goes: device time by kernel over
    ``steps`` profiled steps (torch.profiler, CUDA activity), against the
    unprofiled step time of the serving run.  Returns the device-busy ms
    per step and each of the port's kernels' device ms per step, or None
    if the profiler saw no device time."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    B = engine.batch
    toks = engine._tensor(np.zeros((B, 1), np.int32))
    pos = engine._tensor(np.full(B, pos, np.int32))
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
    ours = {name: sum(e.self_device_time_total for e in kernels if key in e.key)
            / 1e3 / steps for name, key in PROFILED.items()}
    launches = sum(e.count for e in kernels) / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    say(f"decode step profile ({steps} steps, {B} slots): device busy {device_ms:.3f} ms "
        f"of the {step_ms:.2f} ms step ({device_ms / step_ms:.1%}; idle "
        f"{1 - device_ms / step_ms:.1%}), {launches:.0f} kernel launches a step; "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ours.items() if v))
    for e in top:
        say(f"    {e.self_device_time_total / 1e3 / steps:8.3f} ms  "
            f"{e.count // steps:5d} x  {e.key[:90]}")
    return {"busy_ms": device_ms, "launches": launches, **ours}


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


# --------------------------------------------------------------------------- #
# the Mamba2 serving path
# --------------------------------------------------------------------------- #
def mamba_requests(cfg):
    """16 requests: MB_ALIGNED twice (L = 256, several chunks) interleaved
    with 8 lengths drawn from MB_RAGGED that are not a multiple of 256
    (one chunk of L = S)."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(SEED + 1)
    ragged = []
    while len(ragged) < 8:
        n = int(rng.integers(MB_RAGGED[0], MB_RAGGED[1] + 1))
        if n % 256:
            ragged.append(n)
    lens = [n for pair in zip(MB_ALIGNED * 2, ragged) for n in pair]
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=MB_NEW) for n in lens]


def _ssd_state(cache, slot: int) -> torch.Tensor:
    """Every layer's SSD state of one slot (or of a batch-1 cache), a copy."""
    return cache["b0"]["ssd"]["h"][:, slot].clone()


def _top2_gap(logits: torch.Tensor) -> float:
    v = logits[0, -1].float().topk(2).values
    return (v[0] - v[1]).item()


def oracle_streams(engine, cfg):
    """``_run_one`` on every request of ``mamba_requests``, recording each
    one's prefilled SSD state and, for every emitted token, the gap between
    its two best logits.  Returns (requests, states, gaps)."""
    states, gaps = [], []
    prefill, decode = engine._prefill, engine._decode

    def rec_prefill(params, tokens, cache):
        logits, cache = prefill(params, tokens, cache)
        states.append(_ssd_state(cache, 0))
        gaps.append([_top2_gap(logits)])
        return logits, cache

    def rec_decode(params, tokens, pos, cache):
        logits, cache = decode(params, tokens, pos, cache)
        gaps[-1].append(_top2_gap(logits))
        return logits, cache

    engine._prefill, engine._decode = rec_prefill, rec_decode
    try:
        solo = [engine._run_one(r) for r in mamba_requests(cfg)]
    finally:
        engine._prefill, engine._decode = prefill, decode
    return solo, states, gaps


def compare_streams(served, solo, gaps):
    """(streams equal, [(request, first differing step, oracle gap there)])."""
    differ = []
    for i, (a, b) in enumerate(zip(served, solo)):
        k = next((j for j, (u, v) in enumerate(zip(a.out_tokens, b.out_tokens))
                  if u != v), None)
        if k is not None:
            differ.append((i, k, gaps[i][k]))
    return len(served) - len(differ), differ


class swapped_ops:
    """Within the block the model's layers call the given functions
    (``rmsnorm=``, ``ssd_chunk_scan=``) instead of the kernels."""

    def __init__(self, **fns):
        self.fns = fns

    def __enter__(self):
        from repro_torch.kernels import ops

        self.saved = {k: getattr(ops, k) for k in self.fns}
        for k, f in self.fns.items():
            setattr(ops, k, f)

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for k, f in self.saved.items():
            setattr(ops, k, f)


def plain_kernels(rmsnorm: bool = True, scan: bool = True) -> swapped_ops:
    """The kernels' plain versions (on the card) in the model's layers: the
    oracle for the whole model, or for one of its two kernels."""
    from repro_torch.kernels import rmsnorm as krn
    from repro_torch.kernels import ssd_scan as kss

    fns = {}
    if rmsnorm:
        fns["rmsnorm"] = krn.rmsnorm_plain
    if scan:
        fns["ssd_chunk_scan"] = kss.ssd_chunk_scan_plain
    return swapped_ops(**fns)


# Variants of the scan's plain version that the 2-layer logit check is read
# against: one that computes the same function in fp64 (rounding alone
# moves the reading), and two wrong scans (controls the check must or
# cannot see).
def _scan_fp64(log_a, dx, Bm, Cm, h0=None, *, chunk):
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_plain

    y, h = ssd_chunk_scan_plain(log_a, dx, Bm, Cm, h0, chunk=chunk, dtype=torch.float64)
    return y.float(), h.float()


def _scan_decay_shifted(log_a, dx, Bm, Cm, h0=None, *, chunk):
    """Wrong: every step decays by its predecessor's log_a (an off-by-one
    in the running sum)."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_plain

    la = torch.cat([torch.zeros_like(log_a[..., :1]), log_a[..., :-1]], dim=-1)
    return ssd_chunk_scan_plain(la, dx, Bm, Cm, h0, chunk=chunk)


def _scan_no_inter_chunk(log_a, dx, Bm, Cm, h0=None, *, chunk):
    """Wrong: each chunk's output without the carried state's term."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan_plain

    S = dx.shape[2]
    L = min(chunk, S)
    ys = [ssd_chunk_scan_plain(log_a[..., i:i + L], dx[:, :, i:i + L], Bm[:, i:i + L],
                               Cm[:, i:i + L], None, chunk=L)[0] for i in range(0, S, L)]
    return torch.cat(ys, dim=2), ssd_chunk_scan_plain(log_a, dx, Bm, Cm, h0, chunk=chunk)[1]


def phase_mamba(counts) -> None:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan
    from repro_torch.models.transformer import TransformerLM, init_model
    from repro_torch.serve import ServeEngine, SlotScheduler

    cfg = dataclasses.replace(get_config(MB_ARCH), num_layers=MB_LAYERS)
    phase(f"11. Mamba2 serving: {cfg.name}, {cfg.num_layers} SSD layers, d_model "
          f"{cfg.d_model}, {cfg.ssd_heads} heads of P={cfg.ssd_head_dim}, "
          f"N={cfg.ssm_state}, vocab {cfg.vocab_size:,}, {cfg.dtype}, {MB_SLOTS} "
          f"slots, max_seq {MB_MAX_SEQ}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    engine = ServeEngine(cfg, params, batch_size=MB_SLOTS, max_seq=MB_MAX_SEQ,
                         device=DEVICE)
    sync()
    n_params = sum(t.numel() for t in _leaves(params))
    state_gb = (cfg.num_layers * cfg.ssd_heads * cfg.ssd_head_dim * cfg.ssm_state
                * 4 * MB_SLOTS / 1e9)
    say(f"weights made on the card from seed {SEED} in "
        f"{time.perf_counter() - t0:.2f} s: {n_params / 1e9:.3f} B params "
        f"({cfg.dtype}); SSD state {state_gb:.2f} GB for {MB_SLOTS} slots")
    engine.warmup(prompt_lens=[MB_ALIGNED[0]])
    sync()
    reqs = mamba_requests(cfg)
    lens = [len(r.prompt) for r in reqs]

    # time each admission (its first tokens come to the host, so the clock
    # covers the device work) and keep each admitted slot's prefilled state
    waves, states = [], {}
    prefill_into = engine._prefill_into

    def timed_prefill_into(cache, admits, **kw):
        t = time.perf_counter()
        cache, first = prefill_into(cache, admits, **kw)
        waves.append(time.perf_counter() - t)
        for slot, req in admits:
            states[id(req)] = _ssd_state(cache, slot)
        return cache, first

    engine._prefill_into = timed_prefill_into
    for k in engine.calls:
        engine.calls[k] = 0
    rmsnorm.shapes.clear()
    ssd_chunk_scan.shapes.clear()
    sched = SlotScheduler(MB_SLOTS)
    reset_launch_counts()            # the Mamba2 path's run starts here
    sync()
    t0 = time.perf_counter()
    served = engine.run(reqs, scheduler=sched)
    sync()
    t_run = time.perf_counter() - t0
    got = launch_counts()            # ... and ends here
    engine._prefill_into = prefill_into
    prefills, steps = engine.calls["prefills"], engine.calls["decode_steps"]
    forwards = prefills + steps
    norms = 2 * cfg.num_layers + 1
    counts["mamba"] = got
    counts["mamba_widths"] = (cfg.d_model, cfg.d_inner_ssd)
    counts["mamba_rms_shapes"] = dict(rmsnorm.shapes)
    counts["mamba_ssd_shapes"] = dict(ssd_chunk_scan.shapes)
    say(f"launches in the serving run: {got}; {prefills} per-request prefills + "
        f"{steps} decode steps; ssd_chunk_scan x {cfg.num_layers} a prefill, "
        f"rmsnorm x {norms} a forward")
    check(engine.calls["prefill_waves"] == 0 and prefills == len(reqs),
          f"Mamba2 admissions did not prefill per request: {engine.calls}")
    check(got["ssd_chunk_scan"] == cfg.num_layers * prefills > 0,
          f"ssd_chunk_scan launches {got['ssd_chunk_scan']} != "
          f"{cfg.num_layers} x {prefills}")
    check(got["rmsnorm"] == norms * forwards,
          f"rmsnorm launches {got['rmsnorm']} != {norms} x {forwards}")
    check(all(v == 0 for k, v in got.items() if k not in ("rmsnorm", "ssd_chunk_scan")),
          f"the Mamba2 path launched another kernel: {got}")
    check(all(r.done and len(r.out_tokens) == MB_NEW for r in served),
          "a request did not finish with its tokens")
    new = sum(len(r.out_tokens) for r in served)
    t_prefill = sum(waves)
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = (t_run - t_prefill) / max(steps, 1) * 1e3
    say(f"served {len(served)} requests (prompts {lens}, {sum(lens)} tokens) / "
        f"{new} new tokens in {t_run:.3f} s: {new / t_run:.1f} tokens/s; prefill "
        f"{t_prefill:.3f} s in {len(waves)} admissions; decode {step_ms:.2f} ms per "
        f"step ({steps} steps of {MB_SLOTS} slots); peak device memory {peak:.2f} GB; "
        f"backfills {sched.backfills}")

    # the slot-at-a-time oracle: first tokens and prefilled states must be
    # equal (both prefill at batch 1), streams are counted
    t0 = time.perf_counter()
    solo, solo_states, gaps = oracle_streams(engine, cfg)
    first_same = sum(a.out_tokens[0] == b.out_tokens[0] for a, b in zip(served, solo))
    state_same = sum(torch.equal(states[id(a)], h) for a, h in zip(served, solo_states))
    same, differ = compare_streams(served, solo, gaps)
    say(f"against the slot-at-a-time _run_one ({time.perf_counter() - t0:.1f} s): "
        f"first tokens equal {first_same} of {len(served)}, prefilled SSD states "
        f"bitwise equal {state_same} of {len(served)}, streams equal {same} of "
        f"{len(served)}")
    for i, k, gap in differ:
        say(f"    request {i} ({lens[i]} tokens) leaves _run_one at step {k}, where "
            f"_run_one's top-2 logit gap is {gap:.4f} (limit {MB_GAP_LIMIT_DEEP})")
    check(first_same == len(served), "a first token differs from _run_one's")
    check(state_same == len(served), "a prefilled SSD state differs from _run_one's")
    check(all(g <= MB_GAP_LIMIT_DEEP for _, _, g in differ),
          f"a stream left _run_one at a gap beyond {MB_GAP_LIMIT_DEEP}: {differ}")
    del states, solo_states

    # the same engine at a 2-layer cut of the model
    cut_cfg = dataclasses.replace(cfg, num_layers=2)
    cut = ServeEngine(cut_cfg, {**params, "blocks": _first_layers(params["blocks"], 2)},
                      batch_size=MB_SLOTS, max_seq=MB_MAX_SEQ, device=DEVICE)
    served2 = cut.run(mamba_requests(cfg))
    solo2, _, gaps2 = oracle_streams(cut, cfg)
    same2, differ2 = compare_streams(served2, solo2, gaps2)
    say(f"at 2 layers: streams equal to _run_one {same2} of {len(served2)}"
        + "".join(f"; request {i} leaves at step {k}, gap {g:.4f}" for i, k, g in differ2)
        + f" (limit {MB_GAP_LIMIT})")
    check(all(g <= MB_GAP_LIMIT for _, _, g in differ2),
          f"at 2 layers a stream left _run_one at a gap beyond {MB_GAP_LIMIT}: {differ2}")
    del cut, served2, solo2

    # the whole model through the kernels against the plain versions; at 2
    # layers also each kernel alone, the scan in fp64, and two wrong scans
    # the bound is read against
    errs = {}
    # the longest prompt that is a multiple of the chunk, and the longest one not
    sub = [max((r for r in reqs if bool(len(r.prompt) % cfg.ssd_chunk) == ragged),
               key=lambda r: len(r.prompt)) for ragged in (False, True)]
    variants = {"kernels": swapped_ops(),
                "ssd_chunk_scan kernel alone": plain_kernels(scan=False),
                "rmsnorm kernel alone": plain_kernels(rmsnorm=False),
                "plain, scan in fp64": swapped_ops(rmsnorm=rmsnorm_plain,
                                                   ssd_chunk_scan=_scan_fp64),
                "plain, wrong scan: decay shifted one step": swapped_ops(
                    rmsnorm=rmsnorm_plain, ssd_chunk_scan=_scan_decay_shifted),
                "plain, wrong scan: no inter-chunk term": swapped_ops(
                    rmsnorm=rmsnorm_plain, ssd_chunk_scan=_scan_no_inter_chunk)}
    for depth in (2, cfg.num_layers):
        model = TransformerLM(dataclasses.replace(cfg, num_layers=depth), DEVICE)
        tree = {**params, "blocks": _first_layers(params["blocks"], depth)}
        names = list(variants) if depth == 2 else ["kernels"]
        errs[depth] = {k: [] for k in names}
        for r in sub:
            toks = torch.as_tensor(r.prompt[None], device=DEVICE)
            with plain_kernels():
                b, _ = model.prefill(tree, toks, model.init_cache(1, len(r.prompt)))
            for k in names:
                with variants[k]:
                    a, _ = model.prefill(tree, toks, model.init_cache(1, len(r.prompt)))
                check(bool(torch.isfinite(a).all()) and a.shape == (1, 1, cfg.vocab_size),
                      f"Mamba2 logits at depth {depth} ({k}) not finite or misshapen")
                errs[depth][k].append(rel_err(a, b))
    say(f"last-token prefill logits against the plain versions (prompts of "
        f"{[len(r.prompt) for r in sub]} tokens), max abs error over max |logit|, "
        f"per prompt: through the kernels {fmt(errs[2]['kernels'])} at 2 layers "
        f"(bound {MB_PLAIN_TOL}), {fmt(errs[cfg.num_layers]['kernels'])} at "
        f"{cfg.num_layers} layers (printed: the random-weight stack is chaotic at "
        f"that depth)")
    for k in list(variants)[1:]:
        say(f"    at 2 layers, {k}: {fmt(errs[2][k])}")
    check(max(errs[2]["kernels"]) <= MB_PLAIN_TOL,
          f"Mamba2 logits kernels vs plain at 2 layers: {errs[2]['kernels']}")
    check(min(errs[2]["plain, wrong scan: decay shifted one step"]) > MB_PLAIN_TOL,
          f"the 2-layer logit bound {MB_PLAIN_TOL} does not see a scan whose decay "
          f"is shifted one step: {errs[2]}")

    decode_profile(engine, step_ms, max(lens))
    del engine, params
    torch.cuda.empty_cache()


def _ssd_operands(gen, B, H, S, P, N, with_h0, served=False):
    """The scan's inputs as tests/test_kernels.py draws them (mild decays,
    cum ≈ −0.08 a step), or, with ``served``, as the SSD layer makes them
    from a random model: log_a = −softplus(dt)·A with A from U(1, 16) per
    head (ssd_init's draw), dx = softplus(dt)·x, unit B and C, so cum falls
    by ≈ 7 a step and reaches −10⁴ over a chunk of 1,000."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)

    if served:
        A = 1.0 + 15.0 * torch.rand(H, generator=gen, device=DEVICE)
        dt = torch.nn.functional.softplus(randn(B, H, S))
        la, dx = -dt * A[:, None], dt[..., None] * randn(B, H, S, P)
        Bm, Cm = randn(B, S, N), randn(B, S, N)
    else:
        la = -randn(B, H, S).abs() * 0.1
        dx = randn(B, H, S, P)
        Bm, Cm = randn(B, S, N) * 0.3, randn(B, S, N) * 0.3
    h0 = randn(B, H, P, N) * 0.1 if with_h0 else None
    return la, dx, Bm, Cm, h0


def phase_new_kernels_check(gen, counts) -> dict:
    from repro_torch.kernels import rmsnorm as krn
    from repro_torch.kernels import ssd_scan as kss

    phase("12. rmsnorm and ssd_chunk_scan against their plain versions")
    worst = {"rmsnorm": 0.0, "ssd_chunk_scan": 0.0}
    rms_shapes = sorted(set(counts["lm_rms_shapes"]) | set(counts["mamba_rms_shapes"]))
    ragged = [(5, 37, "float32"), (3, 37, "bfloat16"), (7, 2561, "bfloat16"),
              (2, 5119, "float32"), (1, 1, "float32")]
    for rows, d, dt in rms_shapes + ragged:
        dtype = getattr(torch, dt)
        x = (torch.randn(rows, d, generator=gen, device=DEVICE) * 3).to(dtype)
        scale = (0.1 * torch.randn(d, generator=gen, device=DEVICE)).to(torch.bfloat16)
        # w as the tests give it (fp32), and as the models do: a bf16 scale
        # plus one (pre-norms) and a bf16 scale (the gated norm)
        for w, plus_one in ((1 + scale.float(), False), (scale, True), (scale, False)):
            a = krn.rmsnorm(x, w, plus_one=plus_one)
            b = krn.rmsnorm_plain(x, w, plus_one=plus_one)
            sync()
            err = (a.float() - b.float()).abs()
            if dtype == torch.float32:
                ok = rel_err(a, b) <= FP32_TOL
            else:
                ok = bool((err <= RMS_BF16_TOL * b.float().abs()).all())
            worst["rmsnorm"] = max(worst["rmsnorm"], err.max().item())
            what = f"rmsnorm {(rows, d, dt)}, w {w.dtype}, plus_one {plus_one}"
            check(ok, f"{what}: max abs err {err.max().item()}")
            alone = krn.rmsnorm(x[-1:].clone(), w, plus_one=plus_one)
            check(torch.equal(alone[0], a[-1]),
                  f"{what}: a row alone differs from the same row in the batch")
        check(torch.equal(krn.rmsnorm(x, scale, plus_one=True),
                          krn.rmsnorm(x, 1 + scale.float())),
              f"rmsnorm {(rows, d, dt)}: plus_one differs from w = 1 + scale in fp32")
    say(f"rmsnorm at the {len(rms_shapes)} served (rows, d, dtype) and {len(ragged)} "
        f"ragged ones, w fp32, bf16 and bf16 plus one: fp32 within {FP32_TOL} of max "
        f"|out|, bf16 within one bf16 step of each value; the last row alone bitwise "
        f"equal to it in the batch; plus_one bitwise equal to w = 1 + scale")

    ssd_shapes = sorted(set(counts["mamba_ssd_shapes"]))
    ragged = [(1, 80, 8, 64, 128, 1), (2, 3, 74, 64, 128, 37), (1, 80, 512, 64, 128, 256),
              (1, 80, 998, 64, 128, 998), (2, 16, 64, 16, 16, 32)]
    for B, H, S, P, N, L, *h in ssd_shapes + [c + (w,) for c in ragged
                                               for w in (True, False)]:
        la, dx, Bm, Cm, h0 = _ssd_operands(gen, B, H, S, P, N, h[0])
        y, hf = kss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L)
        yp, hp = kss.ssd_chunk_scan_plain(la, dx, Bm, Cm, h0, chunk=L)
        sync()
        ey, eh = rel_err(y, yp), rel_err(hf, hp)
        worst["ssd_chunk_scan"] = max(worst["ssd_chunk_scan"], (y - yp).abs().max().item(),
                                      (hf - hp).abs().max().item())
        check(ey <= FP32_TOL and eh <= FP32_TOL,
              f"ssd_chunk_scan {(B, H, S, P, N, L, h[0])}: y rel err {ey}, h rel err {eh}")
    say(f"ssd_chunk_scan at the {len(ssd_shapes)} served (B, H, S, P, N, L, h0) and "
        f"{2 * len(ragged)} ragged ones (L = 1, 37, 256, S; with and without h0): y "
        f"and h_final within {FP32_TOL} of their max |entry|")

    # the served decays, where cum reaches −10⁴ and the order of its running
    # sum moves the result: held against the function's value (fp64)
    cases = ssd_shapes + [c + (w,) for c in ragged[:4] for w in (True, False)]
    read = {"kernel": [], "plain": [], "kernel vs plain": []}
    cum_max = 0.0
    for B, H, S, P, N, L, *h in cases:
        la, dx, Bm, Cm, h0 = _ssd_operands(gen, B, H, S, P, N, h[0], served=True)
        y, hf = kss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L)
        yp, hp = kss.ssd_chunk_scan_plain(la, dx, Bm, Cm, h0, chunk=L)
        y64, h64 = kss.ssd_chunk_scan_plain(la, dx, Bm, Cm, h0, chunk=L,
                                            dtype=torch.float64)
        sync()
        cum_max = max(cum_max, la.reshape(B, H, S // L, L).double().cumsum(-1)
                      .abs().max().item())
        ek = max(rel_err(y, y64), rel_err(hf, h64))
        read["kernel"].append(ek)
        read["plain"].append(max(rel_err(yp, y64), rel_err(hp, h64)))
        read["kernel vs plain"].append(max(rel_err(y, yp), rel_err(hf, hp)))
        worst["ssd_chunk_scan"] = max(worst["ssd_chunk_scan"],
                                      (y.double() - y64).abs().max().item(),
                                      (hf.double() - h64).abs().max().item())
        check(ek <= FP32_TOL, f"ssd_chunk_scan {(B, H, S, P, N, L, h[0])} at the served "
              f"decays: kernel vs fp64 rel err {ek}")
        del y64, h64
    say(f"ssd_chunk_scan at the served decays (log_a = −softplus(dt)·A, A in [1, 16]; "
        f"max |cum| over a chunk {cum_max:.0f}), {len(cases)} shapes: y and h_final "
        f"against the same function in fp64, max over the shapes of the error over "
        f"max |entry|: kernel {max(read['kernel']):.3g} (bound {FP32_TOL}), plain "
        f"version {max(read['plain']):.3g}, kernel vs plain version "
        f"{max(read['kernel vs plain']):.3g}")
    return worst


def ssd_scan_ops(B, H, S, P, N, L, with_h0) -> float:
    """The fp32 operations the scan's function needs: C·Bᵀ on the causal
    triangle once per (b, chunk) (B and C have no head axis), and per head
    and chunk the masked product with Δx on that triangle, the state update
    (2·L·P·N) and the carried state's term C·h (2·L·P·N, none in the first
    chunk without h0)."""
    chunks, tri = S // L, L * (L + 1) / 2
    inter = B * H * (chunks - (0 if with_h0 else 1)) * 2.0 * L * P * N
    return (B * chunks * 2.0 * N * tri
            + B * H * chunks * (2.0 * P * tri + 2.0 * L * P * N) + inter)


def phase_new_kernels_timing(gen, counts, worst) -> list:
    from repro_torch.kernels import rmsnorm as krn
    from repro_torch.kernels import ssd_scan as kss

    phase("13. rmsnorm and ssd_chunk_scan timing at the served shapes")
    records = []
    rms_launched = {**counts["lm_rms_shapes"]}
    for k, v in counts["mamba_rms_shapes"].items():
        rms_launched[k] = rms_launched.get(k, 0) + v
    d_lm, (d_mb, d_in) = counts["lm_widths"][0], counts["mamba_widths"]

    def most_rows(shapes, d):
        return max((k for k in shapes if k[1] == d), key=lambda k: k[0])

    qwen_prefill = most_rows(counts["lm_rms_shapes"], d_lm)
    mb_prefill = most_rows(counts["mamba_rms_shapes"], d_mb)
    mb_gated = most_rows(counts["mamba_rms_shapes"], d_in)
    # (label, shape, plus_one): the weight is the bf16 scale as the models
    # pass it, plus one for the pre-norms
    rows = [("Mamba2 prefill pre-norm", mb_prefill, True),
            ("Mamba2 prefill gated norm", mb_gated, False),
            ("Mamba2 decode pre-norm", (MB_SLOTS, d_mb, mb_prefill[2]), True),
            ("Mamba2 decode gated norm", (MB_SLOTS, d_in, mb_gated[2]), False),
            ("Qwen2 decode", (LM_SLOTS, d_lm, qwen_prefill[2]), True),
            ("Qwen2 prefill wave", qwen_prefill, True)]
    timings = []
    for label, (n, d, dt), plus_one in rows:
        dtype = getattr(torch, dt)
        esize = torch.finfo(dtype).bits // 8
        copies = max(1, math.ceil(COLD_BYTES / (n * d * esize)))
        xs = [torch.randn(n, d, generator=gen, device=DEVICE).to(dtype)
              for _ in range(copies)]
        w = (0.1 * torch.randn(d, generator=gen, device=DEVICE)).to(torch.bfloat16)
        if not plus_one:
            w += 1
        ms = graph_ms([lambda x=x: krn.rmsnorm(x, w, plus_one=plus_one) for x in xs])
        plain_ms = cuda_ms(lambda: krn.rmsnorm_plain(xs[0], w, plus_one=plus_one), 5)
        try:
            wl = (1 + w.float() if plus_one else w.float()).to(dtype)
            lib_ms, lib_note = graph_ms([lambda x=x: torch.nn.functional.rms_norm(
                x, (d,), wl, 1e-6) for x in xs]), ""
        except RuntimeError as e:
            lib_ms, lib_note = None, str(e).splitlines()[0]
        del xs
        t_b, by = bound(2 * n * d * esize + 2 * d, 3.0 * n * d)
        launched = rms_launched.get((n, d, dt), 0)
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else f"none ({lib_note})"
        say(f"rmsnorm {label} ({n}, {d}) {dt}, {launched} launches on the paths: "
            f"kernel {ms:.4f} ms ({copies} copies of x, from HBM), plain {plain_ms:.4f} "
            f"ms, torch.nn.functional.rms_norm {lib_txt}, bound {t_b:.4f} ms ({by}), "
            f"{t_b / ms:.1%} of it")
        timings.append({"label": label, "shape": [n, d, dt], "launches": launched,
                        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "library_note": lib_note or None, "bound_ms": t_b,
                        "bound_by": by})
    head = timings[0]
    records.append({
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:43",
        "launches": counts["lm"]["rmsnorm"] + counts["mamba"]["rmsnorm"],
        "max_abs_err": worst["rmsnorm"], "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": head["shape"], "shapes": timings,
        "launches_by_path": {"lm_serve": counts["lm"]["rmsnorm"],
                             "mamba_serve": counts["mamba"]["rmsnorm"]},
    })

    ssd = counts["mamba_ssd_shapes"]
    multi = max((k for k in ssd if k[5] < k[2]), key=lambda k: k[2])
    single = max((k for k in ssd if k[5] == k[2]), key=lambda k: k[2])
    timings = []
    for label, (B, H, S, P, N, L, with_h0) in (("several chunks", multi),
                                              ("one ragged chunk", single)):
        la, dx, Bm, Cm, h0 = _ssd_operands(gen, B, H, S, P, N, with_h0)
        ms = graph_ms(lambda: kss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L), launches=5)
        plain_ms = cuda_ms(lambda: kss.ssd_chunk_scan_plain(la, dx, Bm, Cm, h0, chunk=L), 3)
        t_b, by = bound(4 * (B * H * S + 2 * B * H * S * P + 2 * B * S * N
                             + (2 if with_h0 else 1) * B * H * P * N),
                        ssd_scan_ops(B, H, S, P, N, L, with_h0))
        launched = ssd[(B, H, S, P, N, L, with_h0)]
        say(f"ssd_chunk_scan {label} (B, H, S, P, N, L) = {(B, H, S, P, N, L)}, "
            f"{launched} launches on the path: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, library none, bound {t_b:.4f} ms ({by}), {t_b / ms:.1%} of it")
        timings.append({"label": label, "shape": [B, H, S, P, N, L], "launches": launched,
                        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                        "bound_ms": t_b, "bound_by": by})
    head = timings[0]
    records.append({
        "name": "ssd_chunk_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:105",
        "launches": counts["mamba"]["ssd_chunk_scan"],
        "max_abs_err": worst["ssd_chunk_scan"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None, "shape": head["shape"],
        "shapes": timings,
        "launches_by_path": {"mamba_serve": counts["mamba"]["ssd_chunk_scan"]},
    })
    return records


# --------------------------------------------------------------------------- #
# the Gemma3 serving path, and kernel 6
# --------------------------------------------------------------------------- #
def gemma3_requests(cfg):
    """The 16 prompts of G3_PROMPTS, shortest and longest in turns, 64 new
    tokens each."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(SEED + 2)
    half = len(G3_PROMPTS) // 2
    lens = [n for pair in zip(G3_PROMPTS[:half], G3_PROMPTS[half:][::-1]) for n in pair]
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=G3_NEW) for n in lens]


def gemma3_cut(cfg, tree):
    """A 2-layer cut of Gemma3: its first local and its first global layer
    (layers 1 and 6), as the config and the tree of a 2-layer model."""
    import dataclasses

    from repro_torch.models.config import BlockKind

    local = cfg.pattern.index(BlockKind.ATTN_LOCAL)
    glob = cfg.pattern.index(BlockKind.ATTN)
    cut = dataclasses.replace(cfg, num_layers=2,
                              pattern=(BlockKind.ATTN_LOCAL, BlockKind.ATTN))
    blocks = {"b0": _first_layers(tree["blocks"][f"b{local}"], 1),
              "b1": _first_layers(tree["blocks"][f"b{glob}"], 1)}
    return cut, {**tree, "blocks": blocks}


def _flash_widened(q, k, v, *, causal=True, window=None, chunk=None, scale=None):
    """Wrong: the plain prefill form with its window widened by one key."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    return flash_attention_plain(q, k, v, causal=causal, chunk=chunk, scale=scale,
                                 window=None if window is None else window + 1)


def _flash_fp32(q, k, v, *, causal=True, window=None, chunk=None, scale=None):
    """The prefill form's function with every sum in fp32, in PyTorch's
    order: another rounding of the same function, a control for how far
    rounding alone moves the logits."""
    from repro_torch.kernels.flash_attention import NEG_INF, _admitted

    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    s = torch.einsum("bkgqd,bksd->bkgqs", q.float().reshape(B, KV, H // KV, Sq, hd),
                     k.float()) * (hd ** -0.5 if scale is None else scale)
    pq = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    valid = _admitted(pq, torch.arange(Sk, device=q.device)[None, :], causal, window, chunk)
    p = torch.softmax(torch.where(valid, s, torch.full((), NEG_INF, device=q.device)), -1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.to(q.dtype).reshape(B, H, Sq, hd)


def plain_attention_lm() -> swapped_ops:
    """Every kernel of the attention LM's path replaced by its plain version."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import quant_matmul as kqm
    from repro_torch.kernels import rmsnorm as krn

    return swapped_ops(flash_attention=kfa.flash_attention_plain,
                       flash_attention_decode=kfa.flash_attention_decode_plain,
                       rmsnorm=krn.rmsnorm_plain, quant_matmul=kqm.quant_matmul_plain)


def phase_gemma3(counts, report) -> None:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import quant_matmul as kqm
    from repro_torch.kernels import rmsnorm as krn
    from repro_torch.models.transformer import TransformerLM, init_model
    from repro_torch.serve import ServeEngine, SlotScheduler

    cfg = dataclasses.replace(get_config(G3_ARCH), quantize="int8")
    L = cfg.num_layers
    phase(f"14. Gemma3 serving: {cfg.name}, {L} layers (window {cfg.window} on the "
          f"local ones), d_model {cfg.d_model}, {cfg.num_heads} q heads over "
          f"{cfg.num_kv_heads} kv head of {cfg.resolved_head_dim}, vocab "
          f"{cfg.vocab_size:,}, {cfg.dtype}, int8 projections, {G3_SLOTS} slots, "
          f"max_seq {G3_MAX_SEQ}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    engine = ServeEngine(cfg, params, batch_size=G3_SLOTS, max_seq=G3_MAX_SEQ,
                         device=DEVICE)
    sync()
    n_params = sum(t.numel() for t in _leaves(params))
    q_bytes = sum(t.qt.numel() for t in _leaves(engine.params, qtensors=True))
    cache = engine.init_shared_cache()
    slots = sorted(c["attn"]["k"].shape[2] for c in cache.values()
                   for _ in range(cfg.num_periods))
    say(f"weights made on the card from seed {SEED} and quantized in "
        f"{time.perf_counter() - t0:.2f} s: {n_params / 1e9:.3f} B params "
        f"({cfg.dtype}), {q_bytes / 1e9:.3f} GB of int8 projections; cache slots "
        f"per layer: {slots.count(cfg.window)} x {cfg.window} (ring), "
        f"{slots.count(G3_MAX_SEQ)} x {G3_MAX_SEQ}")
    del cache
    engine.warmup(prompt_lens=[G3_PROMPTS[0]])
    sync()
    reqs = gemma3_requests(cfg)
    lens = [len(r.prompt) for r in reqs]
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
    for fn in (kfa.flash_attention, kfa.flash_attention_decode, kqm.quant_matmul,
               krn.rmsnorm):
        fn.shapes.clear()
    sched = SlotScheduler(G3_SLOTS)
    reset_launch_counts()            # the Gemma3 path's run starts here
    sync()
    t0 = time.perf_counter()
    served = engine.run(reqs, scheduler=sched)
    sync()
    t_run = time.perf_counter() - t0
    got = launch_counts()            # ... and ends here
    engine._prefill_into = prefill_into
    steps = engine.calls["decode_steps"]
    forwards = engine.calls["prefill_waves"] + steps
    counts["g3"] = got
    counts["g3_flash_shapes"] = dict(kfa.flash_attention.shapes)
    counts["g3_flash_decode_shapes"] = dict(kfa.flash_attention_decode.shapes)
    counts["g3_layers"] = L
    say(f"launches in the serving run: {got}; {engine.calls['prefill_waves']} prefill "
        f"waves + {steps} decode steps = {forwards} forwards x {7 * L} quant_matmul "
        f"and x {2 * L + 1} rmsnorm")
    check(got["quant_matmul"] == 7 * L * forwards > 0,
          f"quant_matmul launches {got['quant_matmul']} != {7 * L} x {forwards}")
    check(got["rmsnorm"] == (2 * L + 1) * forwards,
          f"rmsnorm launches {got['rmsnorm']} != {2 * L + 1} x {forwards}")
    check_attention_launches(got, L, engine.calls)
    check(all(v == 0 for k, v in got.items() if k not in LM_KERNELS),
          f"the Gemma3 path launched another kernel: {got}")
    check(all(r.done and len(r.out_tokens) == G3_NEW for r in served),
          "a request did not finish with its tokens")
    say(f"flash_attention launches by (B, H, KV, Sq, Sk, hd, (causal, window, chunk)): "
        f"{counts['g3_flash_shapes']}; flash_attention_decode by (B, H, KV, slots, "
        f"hd, mask): {counts['g3_flash_decode_shapes']}")
    over = [n for n in lens if n > cfg.window]
    wrap = [n for n in lens if n <= cfg.window < n + G3_NEW]
    say(f"prompts over the {cfg.window}-slot ring at prefill: {over}; wrapping it "
        f"mid-decode: {wrap}; the global caches reach position {max(lens) + G3_NEW - 1}")
    new = sum(len(r.out_tokens) for r in served)
    t_prefill = sum(waves)
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = (t_run - t_prefill) / max(steps, 1) * 1e3
    say(f"served {len(served)} requests (prompts {lens}, {sum(lens)} tokens) / {new} "
        f"new tokens in {t_run:.3f} s: {new / t_run:.1f} tokens/s; prefill "
        f"{t_prefill:.3f} s in {len(waves)} waves; decode {step_ms:.2f} ms per step "
        f"({steps} steps of {G3_SLOTS} slots); peak device memory {peak:.2f} GB; "
        f"backfills {sched.backfills}")
    report["gemma3"] = {"tokens_per_s": new / t_run, "prefill_s": t_prefill,
                        "decode_ms_per_step": step_ms, "peak_gb": peak,
                        "seconds": t_run, "new_tokens": new}

    # every stream equals the slot-at-a-time oracle's
    t0 = time.perf_counter()
    solo = [engine._run_one(r) for r in gemma3_requests(cfg)]
    same = sum(a.out_tokens == b.out_tokens for a, b in zip(served, solo))
    say(f"streams equal to the slot-at-a-time _run_one: {same} of {len(served)} "
        f"({time.perf_counter() - t0:.1f} s for the oracle)")
    check(same == len(served), f"{len(served) - same} streams differ from _run_one")

    # last-token prefill logits through the kernels against the plain
    # versions, at a 2-layer cut; beside it, each kernel alone, a plain
    # attention summed in fp32 (how far rounding alone moves the logits), one
    # whose window is one key wider, and the same weights unquantized
    cut_cfg, tree = gemma3_cut(cfg, engine.params)
    _, tree_bf16 = gemma3_cut(cfg, params)
    model = TransformerLM(cut_cfg, DEVICE)
    sub = sorted(reqs, key=lambda r: len(r.prompt))[-2:]
    plain = dict(rmsnorm=krn.rmsnorm_plain, quant_matmul=kqm.quant_matmul_plain)
    plain_attn = dict(flash_attention=kfa.flash_attention_plain,
                      flash_attention_decode=kfa.flash_attention_decode_plain)
    variants = {"kernels": (swapped_ops(), tree),
                "flash_attention kernel alone": (swapped_ops(**plain), tree),
                "rmsnorm kernel alone": (swapped_ops(
                    **plain_attn, quant_matmul=kqm.quant_matmul_plain), tree),
                "plain, attention summed in fp32": (swapped_ops(
                    flash_attention=_flash_fp32, **plain), tree),
                "plain, window widened by one": (swapped_ops(
                    flash_attention=_flash_widened, **plain), tree),
                "kernels, bf16 weights (no int8)": (swapped_ops(), tree_bf16)}
    errs = {k: [] for k in variants}
    for r in sub:
        toks = torch.as_tensor(r.prompt[None], device=DEVICE)
        want = {}
        for t in (tree, tree_bf16):
            with plain_attention_lm():
                want[id(t)], _ = model.prefill(t, toks, model.init_cache(1, len(r.prompt)))
        for k, (ctx, t) in variants.items():
            with ctx:
                a, _ = model.prefill(t, toks, model.init_cache(1, len(r.prompt)))
            check(bool(torch.isfinite(a).all()) and a.shape == (1, 1, cfg.vocab_size),
                  f"Gemma3 2-layer logits ({k}) not finite or misshapen")
            errs[k].append(rel_err(a, want[id(t)]))
    say(f"last-token prefill logits at a 2-layer cut (layers 1 and 6) against the "
        f"plain versions (prompts of {[len(r.prompt) for r in sub]} tokens), max abs "
        f"error over max |logit|: through the kernels {fmt(errs['kernels'])} (bound "
        f"{G3_PLAIN_TOL})")
    for k in list(variants)[1:]:
        say(f"    {k}: {fmt(errs[k])}")
    check(max(errs["kernels"]) <= G3_PLAIN_TOL,
          f"Gemma3 logits kernels vs plain at 2 layers: {errs['kernels']}")
    report["gemma3"]["plain_rel_err"] = errs
    prof = decode_profile(engine, step_ms, max(lens))
    report["gemma3"]["decode_profile"] = prof
    del engine, params, tree, model
    torch.cuda.empty_cache()


def _mask_kwargs(mask: tuple) -> dict:
    """The mask arguments of a flash_attention ``.shapes`` key's mask."""
    from repro_torch.kernels.flash_attention import MASK_ARGS

    return dict(zip(MASK_ARGS, mask))


def _flash_inputs(gen, dtype, B, H, KV, Sq, Sk, hd):
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)
    return randn(B, H, Sq, hd), randn(B, KV, Sk, hd), randn(B, KV, Sk, hd)


def _decode_inputs(gen, dtype, B, H, KV, slots, hd, pos_max):
    """q and caches drawn at random (stale slots included), and positions
    spread over [0, pos_max], the last rows past the ring's end."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)
    pos = torch.linspace(0, pos_max, B, device=DEVICE).long()
    return randn(B, H, hd), randn(B, slots, KV, hd), randn(B, slots, KV, hd), pos


def _flash_err(a, b, dtype):
    """(within the tolerance, max abs error, max error over the tolerance)."""
    tol = FLASH_TOL[dtype]
    err = (a.float() - b.float()).abs()
    allowed = tol["atol"] + tol["rtol"] * b.float().abs()
    return bool((err <= allowed).all()), err.max().item(), (err / allowed).max().item()


def phase_flash_check(gen, counts) -> dict:
    from repro_torch.kernels import flash_attention as kfa

    phase("15. flash_attention against its plain versions")
    say(f"tolerance: fp32 {FP32_TOL} (rtol and atol, tests/test_kernels.py's), bf16 "
        f"one bf16 step of each value (rtol 2^-7) + 1e-6")
    worst = {"flash_attention": 0.0, "flash_attention_decode": 0.0}
    served = list({**counts["lm_flash_shapes"], **counts["g3_flash_shapes"]})
    served_dec = list({**counts["lm_flash_decode_shapes"],
                       **counts["g3_flash_decode_shapes"]})
    # (B, H, KV, Sq, Sk, hd, mask kwargs, dtypes)
    both = (torch.float32, torch.bfloat16)
    cases = [(*k[:6], _mask_kwargs(k[6]), (torch.bfloat16,)) for k in served] + [
        (2, 12, 2, 100, 100, 128, dict(causal=True), both),          # 6:1, ragged
        (1, 4, 1, 37, 600, 256, dict(causal=True, window=512), both),  # Sq < Sk
        (2, 4, 1, 300, 300, 256, dict(causal=True, chunk=128), both),
        (3, 4, 4, 33, 33, 32, dict(causal=False), both),
        (1, 12, 2, 1, 777, 128, dict(causal=True, window=100), both),
        (2, 4, 1, 513, 513, 256, dict(causal=True, window=512), both)]
    for B, H, KV, Sq, Sk, hd, kw, dtypes in cases:
        for dtype in dtypes:
            q, k, v = _flash_inputs(gen, dtype, B, H, KV, Sq, Sk, hd)
            a, b = kfa.flash_attention(q, k, v, **kw), kfa.flash_attention_plain(q, k, v, **kw)
            sync()
            ok, err, ratio = _flash_err(a, b, dtype)
            worst["flash_attention"] = max(worst["flash_attention"], err)
            check(ok, f"flash_attention {(B, H, KV, Sq, Sk, hd)} {kw} {dtype}: max abs "
                  f"err {err} ({ratio:.3g} x the tolerance)")
            del q, k, v, a, b
    say(f"prefill form at the {len(served)} served shapes (bf16) and {len(cases) - len(served)} "
        f"others in fp32 and bf16 (hd 32, 128, 256; GQA 1:1, 4:1, 6:1; causal, window, "
        f"chunk, not causal; Sq < Sk; Sk 33, 100, 300, 513, 600, 777): within the "
        f"tolerance, max abs error {worst['flash_attention']:.3g}")
    dec = [(*k[:5], _mask_kwargs(k[5]), 2 * G3_MAX_SEQ - 1, (torch.bfloat16,))
           for k in served_dec] + [
        (8, 4, 1, 512, 256, dict(causal=True, window=512), 2047, both),
        (8, 12, 2, 2048, 128, dict(causal=True), 2047, both),
        (3, 4, 1, 16, 32, dict(causal=True, chunk=16), 100, both),
        (5, 6, 1, 77, 64, dict(causal=True, window=50), 300, both)]
    for B, H, KV, slots, hd, kw, pos_max, dtypes in dec:
        for dtype in dtypes:
            q, kc, vc, pos = _decode_inputs(gen, dtype, B, H, KV, slots, hd, pos_max)
            a = kfa.flash_attention_decode(q, kc, vc, pos, **kw)
            b = kfa.flash_attention_decode_plain(q, kc, vc, pos, **kw)
            sync()
            ok, err, ratio = _flash_err(a, b, dtype)
            worst["flash_attention_decode"] = max(worst["flash_attention_decode"], err)
            check(ok, f"flash_attention_decode {(B, H, KV, slots, hd)} {kw} {dtype} "
                  f"pos {pos.tolist()}: max abs err {err} ({ratio:.3g} x the tolerance)")
    say(f"decode form at the {len(served_dec)} served shapes (bf16, positions up to "
        f"{2 * G3_MAX_SEQ - 1}: every ring wrapped) and {len(dec) - len(served_dec)} "
        f"others in fp32 and bf16 (hd 32, 64, 128, 256; GQA 4:1, 6:1; window, chunk; "
        f"pos >= slots): within the tolerance, max abs error "
        f"{worst['flash_attention_decode']:.3g}")

    # bitwise: a row alone (B = 1) at its exact length equals the same row in a
    # right-padded batch of 8; decode rows alone, and over exactly pos + 1
    # slots, equal the batch's over 2,048
    lens = list(FLASH_INVARIANCE_LENS)
    S = max(lens)
    for H, KV, hd, kw in ((4, 1, 256, dict(window=512)), (4, 1, 256, dict()),
                          (12, 2, 128, dict())):
        q, k, v = _flash_inputs(gen, torch.bfloat16, 8, H, KV, S, S, hd)
        batch = kfa.flash_attention(q, k, v, **kw)
        for b, n in enumerate(lens):
            alone = kfa.flash_attention(q[b:b + 1, :, :n], k[b:b + 1, :, :n],
                                        v[b:b + 1, :, :n], **kw)
            check(torch.equal(alone[0], batch[b, :, :n]),
                  f"flash_attention {kw}: a prompt of {n} alone differs from the "
                  f"same rows in a padded batch of 8")
        qd, kc, vc, _ = _decode_inputs(gen, torch.bfloat16, 8, H, KV, G3_MAX_SEQ, hd, 0)
        pos = torch.tensor(lens, device=DEVICE) - 1
        batch = kfa.flash_attention_decode(qd, kc, vc, pos, **kw)
        for b, n in enumerate(lens):
            alone = kfa.flash_attention_decode(qd[b:b + 1], kc[b:b + 1], vc[b:b + 1],
                                               pos[b:b + 1], **kw)
            exact = kfa.flash_attention_decode(qd[b:b + 1], kc[b:b + 1, :n],
                                               vc[b:b + 1, :n], pos[b:b + 1], **kw)
            check(torch.equal(alone[0], batch[b]) and torch.equal(exact[0], batch[b]),
                  f"flash_attention_decode {kw}: row at {n - 1} differs alone or over "
                  f"{n} slots")
        del q, k, v, qd, kc, vc
    say(f"bitwise invariance (bf16; hd 256 with and without the 512 window, hd 128): "
        f"prompts of {lens} alone at their exact length equal their rows in a batch "
        f"of 8 padded to {S}; decode rows alone and over exactly pos + 1 slots equal "
        f"their rows in a batch of 8 over {G3_MAX_SEQ}")

    # the check sees a fault: a plain version whose window is one key wider,
    # at the served local prefill shape
    local = [k for k in served if _mask_kwargs(k[6])["window"] is not None]
    B, H, KV, Sq, Sk, hd, key = max(local, key=lambda k: k[4])
    kw = _mask_kwargs(key)
    reads = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _flash_inputs(gen, dtype, B, H, KV, Sq, Sk, hd)
        a = kfa.flash_attention(q, k, v, **kw)
        ok, _, ratio = _flash_err(a, _flash_widened(q, k, v, **kw), dtype)
        ok_sound, _, sound = _flash_err(a, kfa.flash_attention_plain(q, k, v, **kw), dtype)
        reads.append((str(dtype)[6:], sound, ratio))
        check(ok_sound and not ok, f"the tolerance does not tell a window widened by one "
              f"at {(B, H, KV, Sq, Sk, hd)} {kw} {dtype}: {ratio:.3g} x the tolerance")
        del q, k, v, a
    say(f"at the served local shape {(B, H, KV, Sq, Sk, hd)} {kw}: the kernel against "
        f"its plain version reads " + ", ".join(f"{d} {s:.3g}" for d, s, _ in reads)
        + " x the tolerance; against a plain version whose window is one key wider "
        + ", ".join(f"{d} {r:.3g}" for d, _, r in reads) + " x (must exceed 1)")
    return worst


def _attention_pairs(B, H, Sq, Sk, kw, pos=None, slots=None) -> float:
    """The admitted (query, key) pairs summed over batch rows and q heads:
    the work this run's data needs."""
    from repro_torch.kernels.flash_attention import _admitted, slot_positions

    if pos is None:
        pq = torch.arange(Sq, device=DEVICE)[:, None] + (Sk - Sq)
        pk = torch.arange(Sk, device=DEVICE)[None, :]
        return float(_admitted(pq, pk, **kw).sum().item()) * B * H
    sp = slot_positions(pos, slots)
    valid = (sp >= 0) & _admitted(pos.long()[:, None], sp, **kw)
    return float(valid.sum().item()) * H


def _ms(t) -> str:
    return "none" if t is None else f"{t:.4f} ms"


def sdpa_yardstick(q, k, v, *, scale, attn_mask=None, is_causal=False):
    """One scaled_dot_product_attention call on the kernel's inputs (GQA
    by enable_gqa, as kernel 6 reads K/V), and the backend PyTorch picks
    for it (``torch._fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend

    kw = dict(attn_mask=attn_mask, is_causal=is_causal, scale=scale, enable_gqa=True)

    def fn():
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, **kw)
    try:
        name = SDPBackend(torch._fused_sdp_choice(q, k, v, **kw)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        name = f"backend unknown: {str(e).splitlines()[0][:80]}"
    return fn, name


def library_time(fn, backend: str, eager: bool):
    """(ms, note) of one scaled_dot_product_attention call: CUDA events
    around eager calls, or around a CUDA graph of calls (as the kernel it
    stands beside is timed); (None, why) where it refuses the inputs."""
    try:
        ms = cuda_ms(fn, 5) if eager else graph_ms(fn)
    except RuntimeError as e:
        sync()
        return None, f"refused: {str(e).splitlines()[0][:120]}"
    return ms, backend


def phase_flash_timing(gen, counts, worst) -> list:
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.flash_attention import _admitted, slot_positions

    phase("16. flash_attention timing at the served shapes")
    g3, lm = counts["g3_flash_shapes"], counts["lm_flash_shapes"]
    g3d, lmd = counts["g3_flash_decode_shapes"], counts["lm_flash_decode_shapes"]

    def widest(shapes, pred):
        return max((k for k in shapes if pred(k)), key=lambda k: (k[0], k[4]))

    def local(mask):
        return _mask_kwargs(mask)["window"] is not None

    pre_rows = [("Gemma3 prefill, global", widest(g3, lambda k: not local(k[6]))),
                ("Gemma3 prefill, local", widest(g3, lambda k: local(k[6]))),
                ("Qwen2 prefill", widest(lm, lambda k: True))]
    dec_rows = [("Gemma3 decode, global", widest(g3d, lambda k: not local(k[5]))),
                ("Gemma3 decode, local ring", widest(g3d, lambda k: local(k[5]))),
                ("Qwen2 decode", widest(lmd, lambda k: True))]
    records = []
    timings = []
    for label, key in pre_rows:
        B, H, KV, Sq, Sk, hd, mk = key
        kw = _mask_kwargs(mk)
        q, k, v = _flash_inputs(gen, torch.bfloat16, B, H, KV, Sq, Sk, hd)
        ms = cuda_ms(lambda: kfa.flash_attention(q, k, v, **kw), 5)
        plain_ms = cuda_ms(lambda: kfa.flash_attention_plain(q, k, v, **kw), 1)
        pq = torch.arange(Sq, device=DEVICE)[:, None] + (Sk - Sq)
        mask = _admitted(pq, torch.arange(Sk, device=DEVICE)[None, :], **kw)
        if kw["window"] is not None or kw["chunk"] is not None:
            lib, backend = sdpa_yardstick(q, k, v, attn_mask=mask, scale=hd ** -0.5)
        else:
            lib, backend = sdpa_yardstick(q, k, v, is_causal=True, scale=hd ** -0.5)
        lib_ms, backend = library_time(lib, backend, eager=True)
        pairs = _attention_pairs(B, H, Sq, Sk, kw)
        t_b, by = bound(2 * (2 * B * H * Sq * hd + 2 * B * KV * Sk * hd), 4.0 * hd * pairs)
        launched = {**g3, **lm}.get(key, 0)
        say(f"flash_attention {label} (B, H, KV, Sq, Sk, hd) = {(B, H, KV, Sq, Sk, hd)} "
            f"{kw}, bf16, {launched} launches on the path: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, scaled_dot_product_attention {_ms(lib_ms)} ({backend}), "
            f"bound {t_b:.4f} ms ({by}; {pairs:.4g} admitted pairs), {t_b / ms:.1%} of it")
        timings.append({"label": label, "shape": [B, H, KV, Sq, Sk, hd], "mask": kw,
                        "launches": launched, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "library_note": backend,
                        "bound_ms": t_b, "bound_by": by})
        del q, k, v, mask
    head = timings[0]
    records.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:123",
        "launches": counts["lm"]["flash_attention"] + counts["g3"]["flash_attention"],
        "max_abs_err": worst["flash_attention"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "library_note": head["library_note"], "shape": head["shape"], "shapes": timings,
        "launches_by_path": {"lm_serve": counts["lm"]["flash_attention"],
                             "gemma3_serve": counts["g3"]["flash_attention"]},
    })
    timings = []
    for label, key in dec_rows:
        B, H, KV, slots, hd, mk = key
        kw = _mask_kwargs(mk)
        # every row at the end of its stream: the served run's last positions
        pos_max = G3_MAX_SEQ - 1 if not local(mk) else 2 * slots + 100
        q, kc, vc, pos = _decode_inputs(gen, torch.bfloat16, B, H, KV, slots, hd, pos_max)
        pos = torch.clamp(pos + pos_max // 2, max=pos_max)
        ms = graph_ms(lambda: kfa.flash_attention_decode(q, kc, vc, pos, **kw))
        plain_ms = cuda_ms(lambda: kfa.flash_attention_decode_plain(q, kc, vc, pos, **kw), 3)
        sp = slot_positions(pos, slots)
        valid = (sp >= 0) & _admitted(pos[:, None], sp, **kw)
        kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
        lib, backend = sdpa_yardstick(q[:, :, None], kt, vt, scale=hd ** -0.5,
                                      attn_mask=valid[:, None, None, :])
        lib_ms, backend = library_time(lib, backend, eager=False)
        pairs = _attention_pairs(B, H, 1, slots, kw, pos=pos, slots=slots)
        n_valid = float(valid.sum().item())
        t_b, by = bound(2 * (2 * n_valid * KV * hd + 2 * B * H * hd), 4.0 * hd * pairs)
        launched = {**g3d, **lmd}.get(key, 0)
        say(f"flash_attention_decode {label} (B, H, KV, slots, hd) = {(B, H, KV, slots, hd)} "
            f"{kw}, bf16, positions {pos.tolist()}, {launched} launches on the path: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention "
            f"{_ms(lib_ms)} ({backend}), bound {t_b:.4f} ms ({by}; {n_valid:.0f} valid "
            f"slots), {t_b / ms:.1%} of it")
        timings.append({"label": label, "shape": [B, H, KV, slots, hd], "mask": kw,
                        "positions": pos.tolist(), "launches": launched, "ms": ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms,
                        "library_note": backend, "bound_ms": t_b, "bound_by": by})
        del q, kc, vc, kt, vt
    head = timings[0]
    records.append({
        "name": "flash_attention_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:123",
        "launches": counts["lm"]["flash_attention_decode"]
        + counts["g3"]["flash_attention_decode"],
        "max_abs_err": worst["flash_attention_decode"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "library_note": head["library_note"], "shape": head["shape"], "shapes": timings,
        "launches_by_path": {"lm_serve": counts["lm"]["flash_attention_decode"],
                             "gemma3_serve": counts["g3"]["flash_attention_decode"]},
    })
    return records


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
    check(all(totals[k] > 0 for k in first_path)
          and all(v == 0 for k, v in totals.items() if k not in first_path),
          f"a kernel of the first path never launched, or another did: {totals}")

    records = phase_timing(gen, counts, report)
    for r in records:
        check(r["launches"] == totals[r["name"]], f"{r['name']} launch bookkeeping")
    free_tables(report)

    phase_lm(counts, report)
    worst = phase_qmm_check(gen, counts)
    records.append(phase_qmm_timing(gen, counts, worst))
    phase_mamba(counts)
    worst = phase_new_kernels_check(gen, counts)
    records.extend(phase_new_kernels_timing(gen, counts, worst))
    phase_gemma3(counts, report)
    worst = phase_flash_check(gen, counts)
    records.extend(phase_flash_timing(gen, counts, worst))
    check(len(records) == 8 and all(r["launches"] > 0 for r in records),
          f"a kernel was never launched on its path: "
          f"{[(r['name'], r['launches']) for r in records]}")
    say(f"smoke run {time.perf_counter() - t_start:.1f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB since phase 14")
    print(CARD)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
