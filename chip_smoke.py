#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each one that fails makes the script exit non-zero):

  1. device   — the card's name and power limit, torch and CUDA versions;
                TF32 is switched off, so fp32 means IEEE fp32 throughout.
  2. build    — the kernels from ``src/repro_torch/kernels/csrc`` (thirteen
                libraries from ten sources and their shared header) with
                nvcc (one process per library, in parallel), into ``build/``.
  3. kernels  — each kernel of the first path against its plain PyTorch
                version on the card, in fp32 and bf16, with ragged n, d and k,
                k = 65 and 257, planted ties, and a small fit on the card
                against the same fit on the CPU; logreg_grad (the one-pass
                gradient, every launch on its one_pass route) also bitwise
                the same for 8 and 4 + 4 partitions, for a strided view and
                its copy, and over GRAD_REPEATS launches, and the clusters
                the card holds for its plans; kmeans_assign's rows bitwise
                the same across n, P, offset, form (stream, split) and route
                (TMA, general: contiguous, 16-byte-aligned and unaligned row
                strides, bf16, d = 1031, 4099 and 1), and the plain version's
                picks but for ties within fp32 rounding at d of several slices
                in both forms.
  4. logistic regression at the paper's width: a 65,536 x (1 + 160,000) fp32
                table made on the card from a seed (the paper's 200K rows do
                not fit 80 GB at fp32, so rows are cut), 8 partitions, 3 rounds
                of each solver through the kernels (one logreg_grad launch a
                step, no logreg_margin or logreg_xt_z), against the plain
                path.
  5. k-means   — 1,048,576 x 4,096 (synth_imagenet_features' width), k = 50
                (Fig. A2), 8 partitions, 3 Lloyd rounds through the kernel,
                against plain Lloyd rounds that sum in the kernel's order
                (the distance to the plain expanded form's printed).
  6. serving   — 16 requests of mixed sizes to each fitted model through the
                port's ModelPredictor.
  7. timing    — each kernel of the first path at its shapes with CUDA events,
                beside its plain version, a one-call library yardstick where
                there is one, and its bound; logreg_grad at the gd shape and
                the sgd chunk also beside the standalone pair (logreg_margin,
                logreg_xt_z) and logreg_margin + torch.matmul(Xᵀ, z), with its
                two bars (GRAD_BOUND_BAR of the one-pass bound; faster than
                logreg_margin + torch.matmul) printed met or MISSED.  For
                kmeans_assign also: each of 3 Lloyd rounds' picks against the
                expanded form's on the same
                centroids; every served pick bitwise the full table's launch's;
                a serving microbatch (1, 2048, 4096), the wrapper's call in a
                CUDA graph and its kernel alone by torch.profiler; a fit round
                by CUDA events after a warm round (the kernel's fit and the
                plain one in turns) and a torch.profiler split of one round
                (assignment kernel, one_hot, batched product, combine, update,
                the rest; a window that lost the kernel's record is taken
                again, up to SPLIT_WINDOWS); its two bars (KMEANS_FIT_BAR, KMEANS_SERVE_BAR)
                printed met or MISSED; its registers (no spill).  The two
                tables are freed in phase 21, after its GLM part.
  8. LM serving — Qwen2-1.5B at full width and depth (28 layers, d_model 1536,
                vocab 151,936), bf16 weights made from a seed, int8
                projections (quantize="int8"), 8 slots, max_seq 2,048: 16
                requests of 128..1,024 prompt tokens and 16 new tokens each,
                all at once, through ServeEngine.run, whose decode steps are
                CUDA graph replays (the warm-up captured the graph).
                Checked: the int8 projections as 4 quant_linear groups a
                layer (q/k/v, o, gate/up, down): one grouped qmm_group launch
                each at a decode step, one quantize_rows and one qmm_wgmma a
                weight (4 and 7 a layer) at a prefill wave, no quant_matmul
                launch; 57 rmsnorm launches per forward (2 a layer, and the
                final norm), one lm_head
                launch per forward, 28 flash_attention launches per prefill
                wave and 28 flash_attention_decode per decode step (every
                attention through kernel 6), every decode step of the run a
                graph replay, every stream equal to the slot-at-a-time
                _run_one's (whose steps replay a batch-1 graph after one
                eager warm-up), and the int8 prefill
                logits within 20 % of the same weights unquantized at the
                2-layer depth that bound was pinned on, and within 100 % at
                28 layers (on random weights the error grows with depth, in
                the reference as much as here), where a model whose int8
                weights are shifted by one layer must read beyond it; the
                prefill logits of a 2-layer cut bitwise equal to the same cut
                through the composition the projections had before the
                grouped call (quantize_rows's plain version, quant_matmul,
                a cast).  The device memory each step peaked at, with what
                holds it, a profile of an eager decode step and of a graph
                replay (launches a step and the projection kernels' device
                time within DECODE_STEP_LIMITS), and one of a prefill wave
                (kernel time by name).
  9. quant_matmul's kernels against their plain versions, bitwise:
                quant_linear at every group (M, K, (N, ...)) phases 8 and 14
                launched, in bf16 and fp32, row-strided, at ragged K and N,
                at ±127 and on tie and zero rows; quantize_rows at every
                served prefill (M, K), ragged, ties and zeros; quant_matmul
                at every (M, K, N) and ragged shape, and at ±127.
 10. timing    — at every group and shape phases 8 and 14 launched: device
                time per launch (CUDA events around a CUDA graph of
                launches): the decode groups (quant_linear, M = 8; each
                launch reads its own copy of the weights, so that they miss
                L2) beside their plain version, their members' qmm_skinny
                times (QMM_SKINNY_MS, the decode form before the grouped
                launch) and one bf16 F.linear of the same (M, K, sum N) (a
                reference point, not the same function); the prefill products
                (qmm_wgmma, bf16 out) beside the same launch with fp32 out,
                the plain version, torch._int_mm, the first prefill form
                (QMM_TILED_MS, which every one must beat); bf16 out within
                5 % of the fp32-out launch timed beside it (QMM_WGMMA_FP32_MS,
                the form before the bf16 epilogue, printed); (8000, 1536, 8960) within QMM_LIMIT_MS; quantize_rows
                at every served prefill (M, K), each launch on its own copy
                of x (so x comes from HBM), at least QROWS_MIN_SHARE of its
                byte bound;
                the bounds, launches on the path, and registers of every
                instance (no spill).
                Phases 9 and 10 run after phase 14.
 11. Mamba2 serving — Mamba2-2.7B at full width and MB_LAYERS (32) of its
                64 SSD layers (d_model 2560, 80 heads of P = 64, N = 128, vocab 50,280),
                bf16 weights made from a seed, 8 slots, max_seq 2,048: 16
                requests, all at once (8 prompts of 256..1,024 tokens, a
                multiple of the 256 chunk, and 8 ragged ones of 142..998,
                one chunk each), 16 new tokens each, through ServeEngine.run
                with its per-request prefill.  Checked: one ssd_chunk_scan
                launch a layer a prefill and 2 rmsnorm launches a layer and
                the final norm per prefill; a decode step as 2 fixed_linear
                launches a layer (the in-projections with the block's norm
                folded in, the out-projection with the gated norm's RMSNorm
                folded in) and one ssd_decode (which writes the gate
                y·silu(z)), and 1 rmsnorm (the final norm);
                every first token and every prefilled SSD state (bitwise)
                equal to the slot-at-a-time _run_one's; every stream equal
                to _run_one's at MB_LAYERS layers and at a 2-layer cut (where one
                leaves it, _run_one's top-2 logit gap there is printed); the
                last-token prefill logits through the kernels against the
                same model through the plain versions, at 2 and at MB_LAYERS
                layers; a profile of the graph-replayed decode step.
 12. rmsnorm and ssd_chunk_scan against their plain versions at every shape
                phases 8 and 11 launched, at ragged shapes, and (the scan)
                with and without an initial state, and at the served decays
                against the same function in fp64; rmsnorm rows alone equal
                the same rows in a batch, bitwise; a scan head bitwise the
                same at B = 1 and in a batch of 3, and from call to call.
 13. timing    — rmsnorm and ssd_chunk_scan at the served shapes (CUDA
                events around a CUDA graph), beside the plain versions, the
                library call where there is one (torch.nn.functional.
                rms_norm) and the bound; the scan at every shape phase 11
                launched (faster than its plain version), with its stages'
                device times (torch.profiler), registers and spills (no
                spill) and its first version's times.
 14. Gemma3 serving — Gemma3-1B at full width and depth (26 layers: 22
                sliding-window layers with 512-slot ring caches and 4 global
                ones; d_model 1152, 4 q heads over 1 kv head of 256, vocab
                262,144), bf16 weights made from a seed, int8 projections, 8
                slots, max_seq 2,048: 16 requests of 40..1,960 prompt tokens
                (some overflow the ring at prefill, some wrap it mid-decode;
                the global caches run to 1,975 positions), 16 new tokens
                each, all at once.  Checked: 26 flash_attention launches per
                prefill wave and 26 flash_attention_decode per decode step,
                4 quant_linear groups a layer per forward (launches as in
                phase 8), 53 rmsnorm and one lm_head per forward;
                every decode step a graph replay; every stream equal to
                _run_one's; the last-token prefill logits through the
                kernels against the plain versions at a 2-layer cut (the
                first local and the first global layer), and bitwise equal
                to the same cut through the projections' earlier
                composition (as in phase 8); no fp64 copy of a
                table on the card; the device memory of weight generation,
                the served run, the oracle and the cut, each peak on its own
                line, the served run's with the holders that account for it;
                profiles of a decode step and of a prefill wave.
 15. flash_attention (both forms) against its plain versions at every shape
                phases 8 and 14 launched, and in fp32 and bf16 at hd 32, 64,
                128 and 256, GQA 1:1 to 6:1, every mask, Sq < Sk, lengths that
                are not a multiple of the key tile, and rings that have
                wrapped (pos >= slots); a row bitwise the same at B = 1 and in
                a batch of 8, and at its exact length and padded; a plain
                version whose window is widened by one must read beyond the
                tolerance.  Every served prefill launch (bf16) and every bf16
                case took the tensor-core route, every fp32 case the fp32
                kernel; the tensor-core kernel with p in 1, 2 and 3 bf16 terms
                against the plain version at the served global shapes (3, the
                served kernel, within the tolerance).
 16. timing    — flash_attention at the served shapes (CUDA events), beside
                the plain versions, one torch.nn.functional.
                scaled_dot_product_attention call (its backend named), the
                fp32 kernel on the same values in fp32, and the bounds at the
                bf16 tensor-core and the fp32 rate; the tensor-core instances'
                registers and spills from phase 2's -Xptxas -v (no spill).
 17. lm_head   — against its plain version at every (M, D, V) the serving
                phases launched (M = 8 and 1; tied; and untied at a small
                shape), row m bitwise the same at M = 1 and M = 8, every
                served launch on the bf16 tensor-core route; timed at the
                served decode shapes in a CUDA graph beside one cuBLAS call
                of the same function (torch.mm with out_dtype=float32, the
                yardstick; F.linear, bf16 out, printed beside it), the bound,
                the FMA kernel's times (LM_HEAD_FMA_MS) and LM_HEAD_LIMIT_MS
                at M = 8.
 18. LM serving, plain weights — Qwen2-1.5B at full width (bf16 weights from
                the seed, quantize="none", 8 slots, max_seq 2,048, the 16
                requests of phase 8; its depth is LM_PLAIN_LAYERS, printed):
                every projection through fixed_linear, 4 launches a layer a
                decode step (q/k/v and gate/up with the block's norm folded
                in; the decode form, "mma_bf16") and a prefill wave (whose
                rows cuBLAS would sum in an order that depends on the wave;
                the tiled form, "mma_bf16_tiled"); rmsnorm 57 times a
                prefill wave and once a decode step; every stream equal to
                _run_one's; a profile of the graph-replayed step.
                Runs after phase 10 (phases 15-17 count its launches).
 19. fixed_linear and ssd_decode — fixed_linear against
                its plain version at every shape the serving phases launched
                (with their prologues) and ragged ones, each folded-norm
                launch bitwise equal to the unfused composition (the rmsnorm
                kernel, or PyTorch's silu and product, the rmsnorm kernel
                and the cast, then the product), row m bitwise the same at
                M = 1 and M = 8; ssd_decode against its plain version (the
                state bitwise) at the served shape and ragged ones, a slot
                bitwise the same alone; a prefill wave's rows (the tiled
                form) bitwise equal to the same rows alone and in launches
                of its first 16 (the decode form) and 17 rows.  Timed in
                CUDA graphs with weights from HBM: fixed_linear at the
                served decode shapes beside its plain version and one
                torch.mm(out_dtype=float32) of the same (M, K, sum N), with
                and without its folded norm, and its tiled form at each
                group's widest prefill wave beside the same call;
                ssd_decode against its byte bound, each with its bars
                (FIXED_LIB_RATIO at Mamba2's two shapes, FIXED_NORM_US at
                every normed shape, FIXED_TILED_RATIO at every wave,
                SSD_DECODE_MIN_SHARE) printed met or MISSED; registers and
                spills of the kernels (none may spill).
 21. estimators — the paper's §IV-B and the other estimators, right after
                phase 7 (before phase 20); no kernel of the port runs here,
                and the phase checks that none launched.  (c) first, on
                phase 4's table: LinearRegression with an elastic net and
                LinearSVM (labels mapped to ±1 in place and back, exactly),
                3 rounds of 256-row chunks at lr = 0.5 / λ_max, each held
                within GLM_TOL of fp64 SGD over the same chunks, 32 served
                requests bitwise the offline prediction; then the first
                path's tables are freed.  (a) BroadcastALS at the Netflix
                Prize's shape (480,184 users x 17,768 movies, ~1.0e8 ratings
                drawn on the card with synth_netflix_tiled's recipe, packed
                by pack_csr_table on the card; rank 10, λ 0.01, 10
                iterations, GATHER_BROADCAST, 8 partitions): training RMSE by
                iteration (falls, ends <= ALS_RMSE_BAR), the fit bitwise the
                same with 1 partition and as ten chained one-iteration
                fits, a half-sweep of each table against fp64
                (ALS_HALF_TOL), examples/als_recommender.py's table fitted on
                the card and on the CPU from one init (ALS_DEVICE_TOL), 256
                requests of 1..64 (user, item) pairs served bitwise the
                offline prediction, user 0's top-5 unseen movies; printed:
                generation and packing seconds, each half-sweep's ms (CUDA
                events) against its bound, a torch.profiler split of the
                users' half-sweep, the peak memory.  Within (a), while its
                tables are resident (phase 23's leg (e)):
                BroadcastALS.train_stacked with K = 4, λ in {0.01, 0.03, 0.1,
                0.3}, rank 10, 10 iterations, every lane from the fit's seed
                (lane 0 is the fit's config) — lane 0 within
                ALS_STACKED_TOL of the fit (bitwise or not printed), each
                lane's training RMSE, its seconds beside 4 x the fit's, its
                peak memory (< 80 GB).  (b)
                examples/pca_naive_bayes.py at 1,048,576 x 4,096 (50
                Gaussian classes): PCA(64) against fp64 eigh of the fp64
                covariance (PCA_TOL; components up to sign) and with 1
                partition, GaussianNaiveBayes(50) on [y | Z] against fp64
                (NB_TOL) and with 1 partition, accuracy > 0.9, 256 served
                requests bitwise the offline prediction.
 20. Fig. A2   — the paper's own program end to end, between phases 21
                and 8: 8,192 labeled raw-text docs of
                128 words (fig_corpus; cut from 32,768 for the run's time)
                through two pipelines of
                8 partitions on the card: (a) NGrams(n=2, top=30,000) ->
                TfIdf -> KMeans(k=50, 10 rounds, kernel 3) and (b) NGrams ->
                TfIdf -> Standardizer -> LogisticRegression (kernels 1-2,
                examples/text_pipeline.py's parameters); 256 raw-text
                requests of 1..16 docs to each through ModelPredictor.
                Checked: the launches of kernels 1-3 on this path and no
                other kernel; the vocabulary 30,000 bigrams; (b) bitwise its
                hand-composed chain (statistics, weights, predictions); the
                tables (8,192 x 30,000 and x 30,001, fp32) and (b)'s IDF
                weights, tf-idf rows, shift and scale against fp64 on the
                card (FIG_TOL); (a)'s centroids within 1e-3 of plain rounds
                in kmeans_assign's order, the three schedules' inertia
                within 1e-3, fitted.predict of raw docs bitwise the model's
                picks on the table; (b)'s weights within FIG_TOL of the
                use_kernel=False fit, and the same fit on the table rounded
                to bf16 beyond FIG_TOL; every served result bitwise
                the offline prediction.  Printed: the seconds of each stage,
                serving latency, the memo's hits and misses, the peak
                memory (kernels 1-3 at this path's shapes: phase 25).  It
                runs after phase 21.
 22. streaming + checkpoint — right after phase 20 (before phase 8): the
                port's streaming epochs, atomic checkpoints and exact resume
                on kernels 1-3 at the paper's widths.  (a) Logistic
                regression at 160,000 features from windows of 4,096 rows
                (8 partitions, 4 rounds an epoch, one SGD step of 128 rows a
                partition a round; window step mod 2 of a 5.2 GB pool made
                on the card from the seed and kept in pinned host memory),
                16 epochs: leg 1 uninterrupted in this process; leg 2 the
                same fit in a child process (chip_smoke.py --stream-child)
                with a snapshot every epoch, whose stream sends it SIGKILL
                when asked for step 8 (rc -9, newest snapshot epoch 8); leg
                3 a resume here, bitwise leg 1's weights; leg 1's weights at
                epoch 4 within 1e-3 of use_kernel=False's.  (b) K-means at
                d = 4,096, k = 50 from windows of 131,072 rows, 8 epochs of
                4 rounds, stopped with a snapshot at epoch 4 and resumed,
                bitwise the uninterrupted centroids; one streamed round's
                picks against use_kernel=False's (near-ties only).  (c) Fig.
                A2's demo 3: NGrams(n=2, top=30,000) -> TfIdf -> KMeans(k=50)
                with fit_stream (8 partitions, 6 epochs of 2 rounds) on
                8,192 docs of phase 20's generator, preempted at epoch 3 and
                resumed (centroids bitwise, vocabulary equal), then
                FittedPipeline.save -> Pipeline.load and 256 raw-text
                requests through ModelPredictor(loaded) bitwise the fitted
                pipeline's offline predictions.  (d) python -m
                repro_torch.launch.fit --algorithm kmeans with --ckpt-dir in
                a child process (on the card), then with --resume (prints
                "resuming from step ..."), started with phase 20.
                Printed: host->device GB/s and s an epoch, snapshot write ms
                and resume s, peak memory, launches by kernel (kernels 1-3
                at the stream's shapes: phase 25).
 23. model search — right after phase 22 (before phase 8); no kernel of
                the port runs here (the trial forms refuse the kernel paths,
                as the reference's do), and the phase checks that none
                launched.  (a) Logistic regression at 160,000 features: a
                16,384-row table made on the card with phase 4's recipe, 8
                partitions, holdout 0.25 (12,288 train rows, 4,096
                validation); the grid {learning_rate 0.05, 0.1, 0.2, 0.3} x
                {l2 0, 0.01} (benchmarks/model_search.py's), local batch
                128, 3 epochs of one round; stacked (one unit of 8 lanes) and
                sequential (8 units) under each of the three schedules:
                stacked == sequential bitwise, every trial within
                SEARCH_FIT_TOL of LogisticRegression(**config).fit on the
                train view (bitwise or not printed), one best config in all
                six runs, scores across schedules within 1e-4; then a
                median-rule search with record_evaluation, one epoch a rung:
                a frozen lane keeps its bits, the history equals the rung
                scores.  (b) ASHA on (a)'s table: 16 configs sampled (lr
                loguniform 0.01..1, l2 0 or 0.01), reduction factor 3, 8
                slots, 9 epochs (rungs 1, 3, 9): stacked and sequential make
                the same (trial, rungs, stopped) sequence with bitwise
                scores, every finisher has 3 rung scores.  (c) K-means at d
                = 4,096 on 131,072 rows, {k 25, 50} x {seed 0..3} (two stacked
                units of 4 lanes), silhouette_lite: stacked == sequential
                bitwise.  (d) Pipeline search on phase 22 (c)'s 8,192 docs:
                NGrams(n=2) -> TfIdf -> Standardizer -> LogisticRegression,
                {ngrams.top 10,000, 30,000} x {logreg.learning_rate 0.1,
                0.5}: one featurization per top, fit on the train fold only;
                the winner's fitted pipeline serves 64 raw-text requests
                through ModelPredictor bitwise its offline predictions.  (f)
                python -m repro_torch.launch.tune killed by SIGKILL after
                its third trial, then --resume, in child processes started
                with phase 20 (their start-up runs beside phases 20-22):
                the resumed RESULT line equals an uninterrupted run's (this
                process); beside them the same flags with --schedule
                gather_broadcast --hosts 2 --devices-per-host 2 --device
                cuda (a launcher and two gloo host processes on this card):
                host 0's RESULT line equals this process's run of the same
                flags character for character.  Printed: each leg's seconds (host
                clock, ended by a sync), stacked against sequential seconds
                and trials/s, ASHA's trials evaluated and slot-epochs, the
                peak memory with its holders.

 24. mesh mode — right after phase 23 (before phase 8): (a) MESH_HOSTS host
                processes (python3 chip_smoke.py --mesh-host, started with
                phase 20 and held until the card is free) x MESH_LOCAL
                partitions joined by a gloo group on this one card (NCCL
                refuses two ranks on one GPU; CUDA partials cross through
                pinned host buffers): each makes its own 32,768 rows of
                phase 4's table from the seed on the card and runs phase 4's
                sgd fit through kernels 1-2 under the three schedules —
                gather_broadcast bitwise phase 4's 8 emulated partitions,
                allreduce and reduce_scatter within MESH_TOL of max |w| (the
                distance printed) — then its rows of a {0,1} lattice table
                (131,072 x 4,096) and k-means k = 50 through kernel 3, every
                schedule bitwise this process's 1 x 8 emulated fit, and a
                concat gather bitwise under all three; the gloo combine's ms
                a round.  (b) An NCCL group of one in this process, 8 local
                partitions: k-means and logistic regression at (a)'s
                lattice shape bitwise the emulated fits under every
                schedule; the group torn down; the same tables fitted with
                use_kernel=False: logistic regression within FP32_TOL,
                k-means bitwise or every differing pick a tie within fp32
                rounding.  (c) repro_torch.launch.fit --algorithm logreg
                --hosts 2 --staleness 0 at 160,000 features (phase 22's
                4,096-row windows, drawn on the card by card_windows through
                python3 chip_smoke.py --fit, which passes them to
                launch.fit's main): both hosts bitwise each other
                and a sequential replay of both here; then --staleness 1
                with a delay fault on host 1: every traced read within the
                bound, host 0's waits printed.  (d) launch.fit --hosts 2
                --devices-per-host 4 --elastic with host 1 SIGKILLed at step
                MESH_KILL: generation 1 (1 host x 4 partitions) resumes with
                allow_resize, bitwise a 1-host resume of the same snapshot
                here; the restart latency printed.  (c) and (d) run in
                threads started with phase 20.  (e) In (a)'s host
                processes, once (a) has freed its rows (no new process):
                (e1) a model search on the 2 x 4 mesh, 8,192 rows of phase
                4's recipe x 160,000 (each host makes its rows from the
                seed), SEARCH_GRID, 2 folds, 2 epochs of 2 chunks, stacked
                and sequential under gather_broadcast, stacked under
                allreduce and reduce_scatter, and ASHA over 8 sampled
                configs: each held against the same search run here in 8
                emulated partitions on the same rows (bitwise under
                gather_broadcast and for ASHA, within MESH_TOL of max |w|
                under the reduction schedules), stacked == sequential
                bitwise; the fold views' rows and bytes across hosts and
                the gloo combine's ms printed.  (e2) Fig. A2's pipelines
                (a) and (b) with mesh= on phase 20's corpus (every host
                fits the host tier on all of it and commits its rows):
                IDF, shift, scale, centroids and weights bitwise phase 20's
                fits, kernels 1-3 launched in the hosts.  (e3) each fitted
                pipeline behind ModelPredictor(mesh=, max_batch=256) on
                both hosts serving phase 20's 256 raw-text requests: every
                served row bitwise phase 20's one-process service.  The
                mesh path's launches of kernels 1-3 ((a)'s and (e)'s hosts'
                and (b)'s mesh fits, each counted from 0) go under
                launches_by_path["mesh"].
 25. kernels 1-3 at the shapes of phases 20, 22 and 24 — right after
                phase 24, once every child process has ended, so that no
                other work shares the card: each held against its plain
                version and timed beside it, the library call where there
                is one and the bound (phase 24's: (a)'s per-host chunks,
                (b)'s, (c)'s and (d)'s, (e2)'s per-host Fig. A2 shapes and
                (e3)'s served partition); logreg_grad also beside the pair
                and logreg_margin + torch.matmul, with that bar.
 26. the model zoo — last, on an otherwise empty card: Granite-3-8B (40
                layers, GQA 32/8, vocab 49,155), RecurrentGemma-9B (38
                layers: 26 RG-LRU blocks and 12 local-attention ones with 16
                q heads on one kv head of 256, window 2,048; every block
                with its MLP) and Qwen1.5-32B (64 layers, MHA 40/40 with QKV
                bias, d_ff 27,392, vocab 152,064) at their published widths
                and depths, bf16 weights made from the seed and quantized to
                int8 a block at a time as they are drawn (the 32B model's
                bf16 tree, ≈ 69 GB, never exists), 8 slots, max_seq 2,048:
                16, 16 and 8 requests (prompts of 128..1,024 tokens, the
                hybrid's up to 1,960) of 16 new tokens each (cut from 64, 64
                and 32 in two steps, the last for phases 27-28) through
                ServeEngine.run (the dense two in ragged waves, the hybrid
                per request), decode steps as CUDA graph replays.  Checked
                for each: every launch count of the path from its layers
                (an attention layer 4 projection groups, a recurrent one 2
                and 3 fixed_linear launches a forward, one rglru_scan a
                recurrent layer a prefill, the norms, kernel 6's two forms,
                one lm_head a forward; no other kernel), a decode step's
                launches by kernel (one more replay), every stream equal to
                _run_one's; printed: weight generation's seconds and peak,
                tokens/s, prefill s, decode ms a step, the served run's and
                the oracle's peak memory, a profile of the replayed step.
                Each model is freed before the next.  26b, after phases 27
                to 29: every kernel held against its plain version at every
                shape that the served runs of phases 26-29 launched (kernel
                6 at FLASH_TOL; quant_linear, quantize_rows and rglru_scan
                bitwise; lm_head, rmsnorm, layernorm and fixed_linear at
                their tolerances), and timed beside its plain version, the
                library call where there is one and the bound: kernel 6's
                decode at each served batch and slot count (groups 16, 7, 6,
                5, 4, 1, Whisper's cross decode with every row at position 1,499
                of the 1,500-slot cross cache, causal=False: all slots
                admitted; every head bitwise alone) and each model's widest
                prefill of each mask, self or cross (the plain version in
                blocks of 1,024 queries above 2^30 scores); rglru_scan at the
                longest prompt (a row bitwise alone in a batch of 3; no
                spill); lm_head at every served M of each table;
                quant_linear at every decode group (M up to 16) and each
                model's widest prefill product, quantize_rows at each
                model's widest rows; rmsnorm at the decode rows and the
                widest prefill rows of each width; fixed_linear at every
                decode shape (the folded norm bitwise the unfused row) and
                each model's widest product at its most and fewest prefill
                rows (Whisper's encoder at 12,000 rows, its decoder's
                32-row prefill; the MoE models' router on fp32 rows and
                weights, every expert and shared-expert shape); layernorm
                at every Whisper shape, every row
                bitwise alone, beside F.layer_norm (its record joins the
                kernels line: fifteen records, seventeen with phase 30's
                two).  The zoo's launches join
                the kernels line.
 27. Whisper-small — after phase 26: the encoder-decoder at its published
                widths and depths (12 + 12 layers, d_model 768, 12 heads of
                64, vocab 51,865, LayerNorm, GELU, a learned 448-row position
                table), weights from the seed, frames (8, 1,500, 768) bf16
                drawn from the seed (the reference stubs the conv frontend),
                a prompt of WH_PROMPT = 4 tokens a row, WH_NEW = 64 greedy new
                tokens (the first from the prefill), through the model's own
                entry points (the serving engine takes no frames and refuses
                a cross-attention config, where the reference's engine
                fails): prefill(encoder_frames=) at batch 8, then eager
                decode_step calls.  Twice: quantize="int8" (as the zoo runs)
                and plain bf16 (every projection through fixed_linear) at
                WH_PLAIN_LAYERS = 4 encoder and decoder layers (cut for the
                run's time).
                Checked for each: every launch count of the path (the
                encoder's and the decoder's layernorm, projection groups and
                kernel 6 launches, the cross K/V from the cache at a decode
                step; no rmsnorm), finite logits of (B, 1, V), and each row
                alone at batch 1 bitwise the batch's: its stream, its prefill
                and last logits, its cross caches in every layer.  Printed:
                the encoder's ms (CUDA events), prefill s, decode ms a step,
                tokens/s, launches by kernel, peak memory.
 28. LLaVA-NeXT-34B — after phase 27: the language backbone at its
                published widths and depth (60 layers, d_model 7,168, 56 q
                heads over 8 kv heads, d_ff 20,480, vocab 64,000), int8
                drawn a block at a time.  (a) The engine's text-only path,
                served as phase 26 serves a model (8 requests of 128..1,024
                prompt tokens, 16 new tokens each, per-request prefill: a
                vision config takes no ragged wave; every stream equal to
                _run_one's, every launch count, a decode step's launches, its
                profile).  (b) Once (a) is freed, on the same weights drawn
                again: prefill(vision_embeds=) of LLAVA_ROWS = 2 rows of the
                published 2,880 patch embeddings (drawn from the seed) before
                a 64-token prompt, then 16 greedy decode steps (eager): every
                launch count, and each row alone at batch 1 bitwise the
                batch's (stream, prefill and last logits).  Printed: prefill s
                of the 2,944-token rows, decode ms a step, peak memory and
                what holds it (weights, cache, activations).
 29. the MoE models — after phase 28: Mixtral-8x22B (8 experts top-2,
                sliding window 4,096, GQA 48/8) and Llama-4-Scout-17B-16E
                (16 experts top-1 and a shared expert, 3 chunked layers
                (chunk 8,192) to 1 NoPE, GQA 40/8, vocab 202,048) at their
                published widths and MOE = 8 layers each (of 56 and 48,
                cut from 12 when phase 30 came in:
                their experts stay bf16 at int8, as the reference's int8
                leaves them, ≈ 4.9 and 4.3 GB a layer), attention int8,
                drawn a block at a time; fixed_linear.max_k checked at
                K = 16,384 (bf16) and 6,144 (fp32).  (a) Served as phase 26
                serves a model (8 requests of 128..1,024 prompt tokens, 16
                new tokens, per-request prefill; every stream equal to
                _run_one's; every launch count: an MoE layer 2·E + 1
                fixed_linear launches a forward, 2 more for the shared
                expert; a replayed step's profile and fixed_linear's share;
                peak memory and what holds it).  (b) Once (a) is freed, on
                the same weights drawn again: one request of MOE_LONG =
                6,144 / 10,240 prompt tokens (3 / 5 dispatch groups of
                2,048), past the window or the chunk (the chunked layers'
                ring of 8,192 slots), and 16 greedy tokens through a 1-slot
                engine (every launch count, finite logits), then the first
                layer's moe_apply at that prefill's input held against its
                plain composition (fixed_linear_plain): gates within
                ROUTER_TOL, choices equal beyond the top-k gap, every expert
                product within fixed_linear's tolerance of its plain version
                on the same rows, the output bitwise its parts.  26b holds and
                times kernel 6, quant_linear, fixed_linear, rmsnorm and
                lm_head at phase 29's shapes.

 30. the serving stack — after phase 19 (before phase 26): (a) the int8 KV
                cache: Qwen2-1.5B at full width and depth, int8
                projections and cache_dtype="int8" (codes and an fp32 scale
                a slot and kv head), 8 slots, max_seq 2,048, phase 8's 16
                requests (128..1,024 prompt tokens, 16 new tokens): every
                stream equal to _run_one's, every decode step a graph
                replay, 28 decode launches a step all on kernel 6's int8
                route, quantize_rows 4 a layer a wave for the projections
                and 2 a layer a forward for K and V; the cache's bytes
                beside the bf16 cache's.  (b) The radix prefix cache
                (blocks of PREFIX_BLOCK = 32, PREFIX_CAPACITY = 512): 16
                requests of a shared 512-token prefix and tails of 64..512
                through Qwen2-1.5B (int8 projections, bf16 cache), served
                three times — cache off, on (cold), on again (warm, the
                same trie) — every stream and first token equal across the
                three and to _run_one's; per run the hit statistics, the
                prefill seconds, one full-prefill launch a layer a miss
                wave and one tail-form launch a layer a hit wave; one wave
                off and one warm profiled (torch.profiler); then Gemma3-1B
                at full width and a 6-layer cut (5 local, window 512, and
                1 global) with a 768-token prefix, its first request the
                bare prefix (ring truncation: a ring layer restores a block
                only where the prompt that wrote it left it in the ring),
                the same three runs and checks.  (c) ReplicaRouter over
                Qwen2-1.5B int8: 4 replicas x 4 slots on one shared cache,
                QueueAutoscaler(min_replicas=1), the prefix cache on, every
                span's CUDA graph captured by warmup; 32 requests of (b)'s
                prefix (half at 0, half 50 ms later) on the host clock:
                every stream equal to _run_one's, the autoscaler's events
                an up and a down, every decode step a replay of its span's
                graph; then a PredictorFleet of two ModelPredictors of
                phase 6's k-means model over 16 blocks of up to 4,095 rows,
                every pick bitwise the single predictor's.  (d) Kernel 6's
                int8 route bitwise the bf16 / fp32 route over caches
                dequantized as _cache_read does (Qwen2's, Gemma3's global
                and ring shapes, fp32 and bf16 q, ragged and stale
                positions), within FLASH_TOL of its plain version, timed at
                (a)'s shape beside the plain version, the bf16 route on the
                dequantized caches, dequantize + SDPA and its bound (bytes:
                hd codes and a 4-byte scale a slot and kv head for K and
                for V); the tail form's rows bitwise the full prefill's at
                their positions (global, window, chunk; prefixes of 37,
                100, 300 and 513 tokens), within FLASH_TOL of its plain
                version, timed at (b)'s widest Qwen2 hit wave beside the
                plain version, the full prefill of the same rows, SDPA with
                the explicit mask and its bound; its instances' -Xptxas -v.
                Their records join the kernels line.

Every phase prints its seconds.  On one H100 80GB HBM3 at 700 W the run
ended in about 320 s on the fastest hosts seen before phase 30 (227-239 s
before phases 27-28; 242 s with them, which took ≈ 50 s, after the zoo's
cut to 16 new tokens and Whisper's plain run's to 4 + 4 layers; 262 s once
26b held every served shape; 321 s with phase 29, ≈ 36 s, and its 26b
rows, ≈ 28 s); slower hosts have taken it to 247-392 s.  Phase 30 takes ≈
20 s (358.2 s in all on a host where the other phases took 338 s, with
phase 29 at 12 layers, 37.8 s of it); phase 29 was cut to 8 layers a
model for it (30.7 s; 355.5 s in all on a host like that one).  On the
fastest hosts the run is not measured with phase 30 (320.7 s before it,
+ ≈ 21 s, − ≈ 7 s of phase 29 gives ≈ 335 s).  Every run stays well
inside the 1,200 s a run is allowed.

Kernel launch counts are set to 0 just before each main path (phases 4-6,
then phase 21, then phase 20, then phase 22, then phase 23, then phase 24,
then phase 8,
then phase 11, then phase 14, then phase 18, then each model of phase 26,
then each of phase 27's two runs, then phase 28's (a) and (b), then each
MoE model's (a) and (b) in phase 29, then each of phase 30's runs)
and read just after it: they
count those paths only (phases 21 and 23 must launch none; phase 20's launches are added to
kernels 1-3's records under "fig_a2", phase 22's under "stream", phase
24's under "mesh": its host processes report theirs, and its emulated
twins' do not count; the launches of phase 22's child processes are their
own; phases 26-29's are added under "zoo_<model>", phase 28 (b)'s under
"zoo_llava-next-34b+vision", phase 29 (b)'s under "zoo_<model>+long",
phase 27's plain run's under
"zoo_whisper-small plain"; phase 30's runs, each counted from 0, under
"kv8_serve", "prefix_qwen_<off|cold|warm>", "prefix_gemma3_<off|cold|warm>",
"fleet" and, for kmeans_assign, "predictor_fleet").  A decode step that
replays a CUDA graph adds the launches the graph holds (``ServeEngine``),
so the counts stay exact.  The
second-to-last line of the output is one JSON object with a record per
kernel; the last line is the device summary.  The script needs the
repository's ``src/`` beside it and one CUDA card.
"""
from __future__ import annotations

import collections
import itertools
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
# the tensor cores (kernels 1-3, rmsnorm, ssd_chunk_scan, lm_head, the decode
# form of flash_attention and its prefill form on fp32 operands do IEEE fp32
# arithmetic), the dense bf16 tensor-core rate (the prefill form on bf16
# operands) and the dense int8 tensor-core rate (quant_matmul)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12

DEVICE = "cuda"
SEED = 0
LOGREG_ROWS, LOGREG_FEATURES = 65_536, 160_000
KMEANS_ROWS, KMEANS_FEATURES, KMEANS_K = 1_048_576, 4_096, 50
# kmeans_assign's bars, printed met or MISSED (a kernel that misses one stays
# in, with its times): at the fit's shape below the plain composition and at
# this share of the operations bound or more; at a serving microbatch of
# KMEANS_SERVE_ROWS rows this share of its bound or more
KMEANS_FIT_BAR, KMEANS_SERVE_BAR, KMEANS_SERVE_ROWS = 0.50, 0.25, 2048
# the elements of d each of kmeans_assign's chains runs over (kSlice)
KMEANS_SLICE = 512
SHARDS, ROUNDS, SGD_BATCH = 8, 3, 256
FP32_TOL = 2e-4      # tests/test_kernels.py's fp32 tolerance
# logreg_grad's bars, printed met or MISSED (a kernel that misses one stays
# in, with its times): at phase 4's gd shape and sgd chunk this share of the
# one-pass byte bound or more; at every shape timed, faster than
# logreg_margin followed by one torch.matmul(Xᵀ, z)
GRAD_BOUND_BAR = 0.75
# launches of logreg_grad held bitwise the first one's (phase 3)
GRAD_REPEATS = 300
# torch.profiler windows phase 7's Lloyd-round split may take: a window that
# lost the assignment kernel's record is taken again (a warm window has lost it)
SPLIT_WINDOWS = 3
# phase 20, the paper's Fig. A2 program: FIG_DOCS labeled docs of FIG_WORDS
# words drawn from FIG_VOCAB made-up words (fig_corpus), NGrams(n=2,
# top=FIG_TOP) -> TfIdf -> KMeans(k=FIG_K, max_iter=FIG_ROUNDS) (pipeline a)
# and -> Standardizer -> LogisticRegression(**FIG_LOGREG) (pipeline b, the
# stages and parameters of examples/text_pipeline.py); FIG_REQUESTS raw-text
# requests of 1..FIG_REQ_MAX docs from the first FIG_SERVE_POOL docs to each;
# fitted.predict replayed on the first FIG_REPLAY raw docs.  FIG_DOCS is cut
# from 32,768 to 16,384 with phase 23 and to 8,192 with phase 24 (the depth,
# not the 30,000-wide vocabulary) to keep the run within its time
FIG_DOCS, FIG_WORDS, FIG_VOCAB, FIG_TOP, FIG_K, FIG_ROUNDS = 8_192, 128, 4_096, 30_000, 50, 10
FIG_LOGREG = dict(learning_rate=0.5, max_iter=8, local_batch_size=4)
FIG_REQUESTS, FIG_REQ_MAX, FIG_SERVE_POOL, FIG_REPLAY = 256, 16, 1_024, 4_096
# phase 20's tolerances, fixed before its first run: against the same
# formulas in fp64, the IDF weights and tf-idf rows (max error over the
# largest entry; fp32 rounds each to ~6e-8 of itself), the Standardizer's
# shift (over the largest) and scale (entry by entry: ss/N − mean² in fp32
# loses digits where mean² is near ss/N); (b)'s weights against the same
# fit with use_kernel=False (max error over the largest).  The weights'
# bound is not phase 4's 1e-3: SGD at learning rate 0.5 on 30,000
# standardized features moves a row's margin by ~0.125·|x|² ≈ 4·10³ a step,
# so rounding in a margin near 0 is amplified before the sigmoid saturates:
# the same plain fit read 5.44e-3 apart in two summation orders of its
# gradient (fp32 and fp64-accumulated products; H100, PERF.md §6), and the
# phase checks that the fit on the table rounded to bf16 lies above the bound
FIG_TOL = {"idf": 1e-6, "tfidf": 1e-6, "shift": 1e-5, "scale": 1e-4, "weights": 2e-2}
BF16_TOL = 5e-2      # and its bf16 one
# phase 21 (a): BroadcastALS at the Netflix Prize's shape (480,189 users x
# 17,770 movies, 100,480,507 ratings), cut to NF_USERS x NF_ITEMS so that
# SHARDS partitions divide both tables; the paper's hyperparameters
NF_USERS, NF_ITEMS = 480_184, 17_768
NF_DENSITY = 100_480_507 / (480_189 * 17_770)
NF_RANK, NF_LAM, NF_ITERS, NF_GEN_USERS = 10, 0.01, 10, 16_384
# ALS_REQUESTS requests of 1..ALS_REQ_MAX (user, item) pairs drawn from a pool
# of ALS_SERVE_POOL, served in microbatches of ALS_SERVE_BATCH pairs
ALS_REQUESTS, ALS_REQ_MAX, ALS_SERVE_BATCH, ALS_SERVE_POOL = 256, 64, 256, 65_536
# (a)'s tolerances, fixed before its first run (PERF.md §6, PR 25): the
# training RMSE after NF_ITERS iterations (the ratings' noise floor is
# 1.5 · 0.1 = 0.15, but rank 10 cannot hold the offset 2.5 beside the rank-10
# base, and a rehearsal on the CPU at 24,000 users stalled at 0.2016); one
# fp32 half-sweep against the fitted factor against the same in fp64 (max
# abs error over max |factor|); the example's fit on the card against the
# CPU's from the same init (of max |factor|)
ALS_RMSE_BAR = 0.22
ALS_HALF_TOL = 1e-4
ALS_DEVICE_TOL = 1e-3
# phase 21 (b): examples/pca_naive_bayes.py at the card's scale: PCA_ROWS
# rows of PCA_FEATURES (synth_imagenet_features' width, phase 5's rows) in
# PCA_CLASSES Gaussian classes, PCA to PCA_K, GaussianNaiveBayes on [y | Z];
# fp64 sums over row slabs of PCA_SLAB; PCA_REQUESTS requests of
# 1..PCA_REQ_MAX Z rows from the first PCA_SERVE_POOL
PCA_ROWS, PCA_FEATURES, PCA_CLASSES, PCA_K, PCA_SLAB = 1_048_576, 4_096, 50, 64, 65_536
PCA_REQUESTS, PCA_REQ_MAX, PCA_SERVE_POOL = 256, 16, 4_096
# (b)'s tolerances, fixed before its first run: PCA against fp64 (and 8
# partitions against 1): explained variance over the largest; components up
# to sign where the fp64 gap to both neighbours is >= PCA_GAP of the largest
# eigenvalue (max abs error); every component's eigen-residual over the
# largest; naive Bayes' priors and means (over the largest) and variances
# (entry by entry, over s2/cnt) against fp64 and 8 partitions against 1
PCA_GAP = 1e-3
PCA_TOL = {"variance": 1e-5, "component": 1e-3, "residual": 2e-5}
NB_TOL = 1e-5
# phase 21 (c): LinearRegression (elastic net, alpha GLM_ALPHA, l1_ratio 0.5)
# and LinearSVM (its default l2) on phase 4's table, GLM_ROUNDS rounds of
# GLM_BATCH-row chunks at lr = GLM_LR_SCALE / λ_max; GLM_REQUESTS requests of
# 1..GLM_REQ_MAX rows from the first GLM_SERVE_POOL; the weights against fp64
# SGD over the same chunks within GLM_TOL (max abs error over max |w|)
GLM_ROUNDS, GLM_BATCH, GLM_LR_SCALE, GLM_ALPHA = 3, 256, 0.5, 0.5
GLM_REQUESTS, GLM_REQ_MAX, GLM_SERVE_POOL = 32, 16, 512
GLM_TOL = 1e-3
# phase 22, streaming epochs with atomic checkpoints and exact kill-and-resume.
# (a) LogisticRegression(**STREAM_LR, use_kernel=True).fit_stream at
# LOGREG_FEATURES features: windows of STREAM_LR_ROWS rows (SHARDS partitions,
# STREAM_CHUNKS rounds an epoch, one local batch a chunk), window step mod
# STREAM_LR_POOL of a pool made on the card from the seed and kept in pinned
# host memory, STREAM_LR_EPOCHS epochs; a child process killed by SIGKILL
# when its stream is asked for step STREAM_KILL; the weights after
# STREAM_PLAIN_EPOCHS epochs against use_kernel=False at phase 4's 1e-3.
# (b) KMeans(k=KMEANS_K) at KMEANS_FEATURES from windows of STREAM_KM_ROWS
# rows (a pool of STREAM_KM_POOL), STREAM_KM_EPOCHS epochs, stopped at
# STREAM_KM_STOP and resumed.  (c) Fig. A2's demo 3 on the first
# STREAM_FIG_DOCS docs of fig_corpus's generator (cut from FIG_DOCS for the
# run's time), STREAM_FIG_EPOCHS epochs of STREAM_FIG_CHUNKS rounds,
# preempted at STREAM_FIG_STOP.  STREAM_LR_POOL is cut from 4 windows to 2
# with phase 24 (the pool's depth, not the windows' width)
STREAM_LR_ROWS, STREAM_LR_POOL, STREAM_LR_EPOCHS, STREAM_KILL = 4_096, 2, 16, 8
STREAM_CHUNKS, STREAM_PLAIN_EPOCHS = 4, 4
STREAM_LR = dict(learning_rate=1e-7, local_batch_size=128)
STREAM_KM_ROWS, STREAM_KM_POOL, STREAM_KM_EPOCHS, STREAM_KM_STOP = 131_072, 2, 8, 4
STREAM_FIG_DOCS, STREAM_FIG_EPOCHS, STREAM_FIG_CHUNKS, STREAM_FIG_STOP = 8_192, 6, 2, 3
# phase 23, model search.  (a) SEARCH_ROWS rows of phase 4's recipe at
# LOGREG_FEATURES (10.49 GB), SEARCH_GRID with SEARCH_LR, SEARCH_EPOCHS
# epochs of one round, holdout 0.25; the median-rule search over
# SEARCH_MEDIAN_LRS (around phase 4's SGD rate, where the accuracies differ)
# one epoch a rung.  (b) ASHA: SEARCH_ASHA_SAMPLES configs of
# SEARCH_ASHA_SPACE, reduction factor 3, SEARCH_ASHA_SLOTS slots,
# SEARCH_ASHA_EPOCHS epochs.  (c) k-means: SEARCH_KM_ROWS x KMEANS_FEATURES
# of phase 5's recipe, SEARCH_KM_GRID, SEARCH_KM_EPOCHS epochs.  (d) the
# first STREAM_FIG_DOCS docs of fig_corpus, SEARCH_PIPE_GRID,
# SEARCH_PIPE_EPOCHS epochs, SEARCH_REQUESTS raw-text requests of
# 1..FIG_REQ_MAX docs.  (e) BroadcastALS.train_stacked over SEARCH_ALS_LAMS.
# (f) launch.tune with SEARCH_CLI_ARGS, killed after SEARCH_CLI_KILL trials.
SEARCH_ROWS, SEARCH_EPOCHS = 16_384, 3
SEARCH_GRID = {"learning_rate": [0.05, 0.1, 0.2, 0.3], "l2": [0.0, 0.01]}
SEARCH_LR = dict(local_batch_size=128)
SEARCH_MEDIAN_LRS = [1e-9, 1e-8, 3e-8, 1e-7, 3e-7, 1e-6, 3e-6, 1e-5]
SEARCH_ASHA_SPACE = {"learning_rate": ("loguniform", 0.01, 1.0), "l2": [0.0, 0.01]}
# SEARCH_ASHA_SAMPLES cut from 32 to 16 with phase 24 (the pool's depth)
SEARCH_ASHA_SAMPLES, SEARCH_ASHA_SLOTS, SEARCH_ASHA_EPOCHS = 16, 8, 9
SEARCH_KM_ROWS, SEARCH_KM_EPOCHS = 131_072, 2
SEARCH_KM_GRID = {"k": [25, 50], "seed": [0, 1, 2, 3]}
SEARCH_PIPE_GRID = {"ngrams.top": [10_000, 30_000], "logreg.learning_rate": [0.1, 0.5]}
SEARCH_PIPE_LR = dict(local_batch_size=16)
SEARCH_PIPE_EPOCHS, SEARCH_REQUESTS = 2, 64
SEARCH_ALS_LAMS = (NF_LAM, 0.03, 0.1, 0.3)
SEARCH_CLI_ARGS = ["--algorithm", "logreg", "--grid", "learning_rate=0.05,0.1,0.3;l2=0.0,0.01",
                   "--rows", "64", "--features", "6", "--epochs", "3",
                   "--chunks-per-epoch", "2", "--folds", "2", "--exec", "sequential",
                   "--seed", "0", "--json"]
SEARCH_CLI_KILL = 3
# phase 23's tolerances, fixed before its first run: a trial against the
# same config's fit on the train view (max abs error over max |w|): the
# reference's 1e-5 (tests/test_tune.py); the port runs a trial's launches as
# the fit runs them, so the run expects 0 and prints whether it is bitwise.
# Scores across schedules: tests/test_tune_determinism.py's 1e-4.  ALS's
# stacked lane 0 against the fit (of max |factor|): the batched solve sees
# another batch size than the fit's, so phase 21's card-vs-CPU ALS_DEVICE_TOL
SEARCH_FIT_TOL, SEARCH_SCORE_TOL, ALS_STACKED_TOL = 1e-5, 1e-4, 1e-3
# phase 24, mesh mode across host processes on this card.  (a) MESH_HOSTS
# host processes x MESH_LOCAL partitions (gloo: the hosts share the card):
# phase 4's sgd fit on phase 4's table (each host makes its rows with
# logreg_rows, generators from MESH_LR_SEED) and k-means on MESH_KM_ROWS
# {0,1} lattice rows (MESH_KM_SEED), under MESH_SCHEDULES; (b) the same
# lattice in this process on an NCCL group of one; (c) launch.fit --hosts 2
# --staleness 0, then 1 with a MESH_SSP_DELAY (host, round, seconds) delay,
# MESH_SSP_EPOCHS epochs of phase 22 (a)'s windows; (d) launch.fit --hosts 2
# --elastic for MESH_ELASTIC_EPOCHS epochs, host 1 killed at step MESH_KILL.
# MESH_TOL, fixed before the first run: the reduction schedules' weights
# against phase 4's, max abs over max |w| (tests/chaos/
# test_multihost_determinism.py's 1e-5).  MESH_TIMEOUT: every group's and
# child's limit
MESH_HOSTS, MESH_LOCAL, MESH_KM_ROWS, MESH_TIMEOUT = 2, 4, 131_072, 300.0
MESH_LR_SEED, MESH_KM_SEED = SEED + 4, SEED + 24
MESH_SCHEDULES = ("gather_broadcast", "allreduce", "reduce_scatter")
MESH_SSP_EPOCHS, MESH_SSP_DELAY = 4, (1, 1, 1.0)
MESH_ELASTIC_EPOCHS, MESH_KILL = 6, 3
MESH_LR_BATCH = 128      # (c) and (d)'s SGD batch: one a partition's chunk
MESH_TOL = 1e-5
# phase 24 (e), in (a)'s host processes once (a) has freed its tables: (e1)
# a model search on the 2 x 4 mesh over MESH_SEARCH_ROWS rows of phase 4's
# recipe (logreg_rows) x LOGREG_FEATURES, SEARCH_GRID with SEARCH_LR,
# MESH_SEARCH_FOLDS folds, MESH_SEARCH_EPOCHS epochs of MESH_SEARCH_CHUNKS
# chunks: stacked and sequential under gather_broadcast, stacked under
# allreduce and reduce_scatter; then ASHA over MESH_ASHA_SAMPLES configs of
# SEARCH_ASHA_SPACE (reduction factor 3, MESH_ASHA_SLOTS slots,
# MESH_ASHA_EPOCHS epochs), each against this process's 8-partition
# emulated search on the same rows.  MESH_SEARCH_ROWS is phase 23's 16,384
# cut to 8,192 for the run's time (the depth, not the 160,000-wide rows).
# (e2) phase 20's pipelines with mesh= on phase 20's corpus, against phase
# 20's fits; (e3) each fitted pipeline behind ModelPredictor(mesh=,
# max_batch=MESH_SERVE_BATCH) serving phase 20's FIG_REQUESTS requests
MESH_SEARCH_ROWS, MESH_SEARCH_FOLDS, MESH_SEARCH_EPOCHS, MESH_SEARCH_CHUNKS = 8_192, 2, 2, 2
MESH_ASHA_SAMPLES, MESH_ASHA_SLOTS, MESH_ASHA_EPOCHS = 8, 4, 3
MESH_SERVE_BATCH = 256

# the LM serving phase
LM_ARCH, LM_SLOTS, LM_MAX_SEQ = "qwen2-1.5b", 8, 2048
LM_REQUESTS, LM_PROMPT_MIN, LM_PROMPT_MAX, LM_NEW = 16, 128, 1024, 16   # new tokens cut from 64 for the run's time
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
# quant_matmul's first prefill form (qmm_tiled: mma.sync, two buffers),
# device ms at each served prefill shape (M, K, N), timed by phase 10 before
# its redesign (NVIDIA H100 80GB HBM3 at 700 W): every served prefill shape
# must beat it
QMM_TILED_MS = {
    (7168, 1536, 256): 0.0271, (7168, 1536, 1536): 0.1455, (7168, 1536, 8960): 0.7163,
    (7168, 8960, 1536): 0.6939, (8000, 1536, 256): 0.0278, (8000, 1536, 1536): 0.1509,
    (8000, 1536, 8960): 0.8012, (8000, 8960, 1536): 0.7014,
    (8192, 1024, 1152): 0.0981, (8192, 1152, 256): 0.0241, (8192, 1152, 1024): 0.0851,
    (8192, 1152, 6912): 0.5294, (8192, 6912, 1152): 0.4427,
    (15680, 1024, 1152): 0.1724, (15680, 1152, 256): 0.0454, (15680, 1152, 1024): 0.1631,
    (15680, 1152, 6912): 0.9750, (15680, 6912, 1152): 0.7962}
# ... and the time the redesign must reach and the one it aims at, in ms
QMM_LIMIT_MS = {(8000, 1536, 8960): (0.40, 0.25)}
# qmm_wgmma with fp32 output (before its epilogue wrote x's dtype), device ms
# at the served prefill shapes (NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6
# row 4), printed: with bf16 output it may be at most 5 % slower than the
# fp32-out form timed beside it in the same run
QMM_WGMMA_FP32_MS = {
    (7168, 1536, 256): 0.0108, (7168, 1536, 1536): 0.0503, (7168, 1536, 8960): 0.2304,
    (7168, 8960, 1536): 0.1557, (8000, 1536, 256): 0.0104, (8000, 1536, 1536): 0.0520,
    (8000, 1536, 8960): 0.2405, (8000, 8960, 1536): 0.1596,
    (8192, 1024, 1152): 0.0400, (8192, 1152, 256): 0.0092, (8192, 1152, 1024): 0.0346,
    (8192, 1152, 6912): 0.1718, (8192, 6912, 1152): 0.1401,
    (15680, 1024, 1152): 0.0646, (15680, 1152, 256): 0.0153, (15680, 1152, 1024): 0.0583,
    (15680, 1152, 6912): 0.3429, (15680, 6912, 1152): 0.2663}
# quant_matmul's decode form before the grouped launch (qmm_skinny: one
# launch a weight on rows PyTorch had quantized, fp32 out), device ms at the
# served decode shapes (M, K, N) with the weights from HBM (NVIDIA H100 80GB
# HBM3 at 700 W, PERF.md §6 row 4): a group's row prints its members' sum
QMM_SKINNY_MS = {
    (8, 1536, 1536): 0.0031, (8, 1536, 256): 0.0026, (8, 1536, 8960): 0.0061,
    (8, 8960, 1536): 0.0094, (8, 1152, 1024): 0.0029, (8, 1152, 256): 0.0026,
    (8, 1024, 1152): 0.0025, (8, 1152, 6912): 0.0047, (8, 6912, 1152): 0.0075}
# a graph-replayed decode step: the most kernel launches it may take, and
# the most device ms its projection kernels may take (qmm_skinny's alone in
# the profiles before the grouped launch, which added ~9 PyTorch launches a
# projection around it; NVIDIA H100 80GB HBM3 at 700 W)
DECODE_STEP_LIMITS = {"Qwen2": (1800, 1.315), "Gemma3": (1700, 0.936)}
# quantize_rows at the served prefill shapes: the least share of its byte
# bound it must read; the decode gate/up and down groups' target share
QROWS_MIN_SHARE, GROUP_TARGET_SHARE = 0.5, 0.7
# lm_head at the served decode shapes (M, D, V): the device ms of its FMA
# kernel, before the tensor-core route (NVIDIA H100 80GB HBM3 at 700 W), and
# the time the tensor-core kernel must reach and the one it aims at
LM_HEAD_FMA_MS = {(8, 1152, 262144): 0.4363, (1, 1152, 262144): 0.2183,
                  (8, 1536, 151936): 0.3043, (1, 1536, 151936): 0.1621,
                  (8, 2560, 50280): 0.1707, (1, 2560, 50280): 0.0911}
LM_HEAD_LIMIT_MS = {(8, 1152, 262144): (0.26, 0.21), (8, 1536, 151936): (0.19, 0.16),
                    (8, 2560, 50280): (0.11, 0.09)}
# the Mamba2 serving phase: 8 prompts a multiple of the 256 chunk (each
# twice) and 8 ragged ones drawn from MB_RAGGED (one chunk of L = S each)
MB_ARCH, MB_SLOTS, MB_MAX_SEQ, MB_NEW = "mamba2-2.7b", 8, 2048, 16   # new tokens cut from 64 for the run's time
MB_LAYERS = 32          # of the published 64, cut for the run's time
MB_ALIGNED, MB_RAGGED = (256, 512, 768, 1024), (142, 998)
# the plain-weight LM serving phase (18): Qwen2-1.5B with quantize="none" at
# this depth (of the published 28, cut for the run's 240 s)
LM_PLAIN_LAYERS = 14
# The bars of the decode step's kernels, printed met or MISSED and kept in
# the kernels line (a kernel that misses one stays in, with its times):
# fixed_linear's product alone at Mamba2's decode shapes within this many
# times one torch.mm(out_dtype=float32) of the same (M, K, sum N), weights
# from HBM; its folded norm at most this many µs more than the product
# alone at every served normed decode shape; its tiled form at each of the
# plain-weight path's prefill waves within this many times the same call
# (and the ratio and share of its operations bound it aims at, printed);
# ssd_decode at the served shape at this share of its byte bound or more.
FIXED_LIB_RATIO = 1.25
FIXED_NORM_US = 2.0
FIXED_TILED_RATIO = 2.0
FIXED_TILED_AIM = (1.25, 0.40)
SSD_DECODE_MIN_SHARE = 0.5
# last-token prefill logits through the kernels against the plain versions,
# max abs error over max |logit|, at a 2-layer cut (at MB_LAYERS printed)
MB_PLAIN_TOL = 0.02
RMS_BF16_TOL = 2.0 ** -7     # one bf16 step of the value
# ssd_chunk_scan at the served shapes with several chunks and with one
# ragged chunk: the first version's device time (one block per (b, h),
# chunks in order; NVIDIA H100 80GB HBM3 at 700 W), and the time the staged
# kernel must reach and the one it aims at, in ms
SSD_FIRST_MS = {"several chunks": 0.9126, "one ragged chunk": 1.8671}
SSD_LIMIT_MS = {"several chunks": (0.30, 0.15), "one ragged chunk": (0.45, 0.27)}
# ssd_chunk_scan's CUDA functions, in launch order
SSD_STAGES = ("ssd_cum_kernel", "ssd_state_kernel", "ssd_pass_kernel", "ssd_out_kernel")
# the Gemma3 serving phase: the prompts are served short and long in turns,
# so that each admission wave pads short prompts to long ones
G3_ARCH, G3_SLOTS, G3_MAX_SEQ, G3_NEW = "gemma3-1b", 8, 2048, 16   # new tokens cut from 64 for the run's time
G3_PROMPTS = (40, 127, 128, 300, 480, 500, 511, 512, 513, 700, 1023, 1024, 1300,
              1536, 1800, 1960)
# last-token prefill logits through the kernels against the plain versions,
# max abs error over max |logit|, at a 2-layer cut: fixed before the first
# run, as phase 11's bound (rounding alone, carried through bf16 casts and
# int8 activations, reads ~1e-3 there)
G3_PLAIN_TOL = 0.02
# the model zoo's phase (26): each configuration at its published widths and
# depth, int8 projections: (requests, new tokens each), in the order served
# (new tokens cut from 64 to 32 for granite-3-8b and recurrentgemma-9b with
# phase 24 (e), for the run's time: each slot-at-a-time oracle decoded 1,024
# steps, ≈ 12.5 s; and to 16 for all three with phases 27 and 28)
ZOO = {"granite-3-8b": (16, 16), "recurrentgemma-9b": (16, 16), "qwen1.5-32b": (8, 16)}
ZOO_SLOTS, ZOO_MAX_SEQ = 8, 2048
# rows up to which fixed_linear takes its decode forms (kDecodeRows)
ZOO_DECODE_ROWS = 16
# phase 28 (a): LLaVA-NeXT-34B's text-only path through the engine, served
# as the zoo's models are: (requests, new tokens each)
LLAVA_ARCH = "llava-next-34b"
# phase 29: the MoE models at their published widths, int8 attention and
# bf16 experts, at a depth cut (layers served of 56 and 48: every expert of
# a layer is bf16, as the reference's int8 leaves it, ≈ 4.9 and 4.3 GB a
# layer); (a) served as the zoo's models are; (b) one request of MOE_LONG
# prompt tokens past Mixtral's window (4,096) and Llama4's chunk (8,192),
# then MOE_LONG_NEW greedy tokens
# (12 each until phase 30 came in; cut to 8 for the run's time)
MOE = {"mixtral-8x22b": 8, "llama4-scout-17b-16e": 8}
MOE_LONG = {"mixtral-8x22b": 6144, "llama4-scout-17b-16e": 10240}
MOE_LONG_NEW = 16
# moe_apply against its plain composition at (b)'s first layer: the router's
# gates within ROUTER_TOL (fp32 sums of K = 5,120-6,144 products in the
# kernel's order against fp64), choices equal wherever the plain gates' k-th
# and (k+1)-th lie further apart than 2 ROUTER_TOL; the expert products at
# fixed_linear's own tolerance (_close_fixed)
ROUTER_TOL = 1e-4
ZOO_REQUESTS = {**ZOO, LLAVA_ARCH: (8, 16), **{arch: (8, 16) for arch in MOE}}
# phase 28 (b): the vision prefix (rows, patches of the published anyres
# tiling) before a prompt of LLAVA_TEXT tokens, then LLAVA_NEW greedy decode
# steps, into a cache of LLAVA_VISION_SEQ slots
LLAVA_ROWS, LLAVA_TEXT, LLAVA_NEW, LLAVA_VISION_SEQ = 2, 64, 16, 3072
# phase 27: Whisper-small, WH_BATCH rows of the encoder's 1,500 frames, a
# prompt of WH_PROMPT tokens, WH_NEW greedy new tokens (the first from the
# prefill), into a cache of WH_MAX_SEQ slots (within the 448-row table); the
# plain-weight run at WH_PLAIN_LAYERS encoder and decoder layers (of 12, cut
# for the run's time)
WH_ARCH, WH_BATCH, WH_PROMPT, WH_NEW, WH_MAX_SEQ = "whisper-small", 8, 4, 64, 128
WH_PLAIN_LAYERS = 4
# layernorm against its plain version: fp32 rtol = atol = 1e-5 (the plain
# version takes the kernel's order; only a library's sqrt or division could
# round apart), bf16 one bf16 step of the value plus 1e-6 near 0
LN_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
          torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-6)}
# prompt lengths drawn from the seed; the hybrid's reach ≈ 2,000 tokens so
# that its scan runs at a full prompt (a 2,048-slot window: no ring wrap)
ZOO_PROMPT_MIN, ZOO_PROMPT_MAX = 128, 1024
RG_ARCH, RG_PROMPT_MAX = "recurrentgemma-9b", 1960
# flash_attention against its plain version: tests/test_kernels.py's fp32
# tolerance; in bf16 one bf16 step of each value (the kernel sums in fp32,
# the plain version in fp64, and the outputs round to bf16 either side of a
# boundary) plus 1e-6 for values near 0
FLASH_TOL = {torch.float32: dict(rtol=FP32_TOL, atol=FP32_TOL),
             torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-6)}
# the longest row FLASH_TOL was held at before the MoE models (LLaVA (b)'s
# 2,944 keys).  A row's fp32 sum rounds by about sqrt(keys) ulps of its
# terms, which the 1e-6 floor stops covering for an output that cancels to
# about 0 in a longer row (a Llama4 chunked row of 7,913 keys, exact output
# -1.06e-6, came out 3.3e-8): past it the bf16 floor grows as
# sqrt(keys / FLASH_TOL_KEYS); at or under it FLASH_TOL is as it was
FLASH_TOL_KEYS = 2944
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


# seconds of each phase, by its number
PHASE_SECONDS: dict = {}
_CURRENT = {"name": None, "t0": 0.0}


def end_phase() -> None:
    """Print and keep the seconds of the phase that is running."""
    name = _CURRENT["name"]
    if name is not None:
        secs = time.perf_counter() - _CURRENT["t0"]
        PHASE_SECONDS[name.split(".")[0]] = round(secs, 1)
        print(f"   (phase {name.split('.')[0]}: {secs:.1f} s)", flush=True)
        _CURRENT["name"] = None


def phase(name: str):
    end_phase()
    print(f"== {name}", flush=True)
    _CURRENT.update(name=name, t0=time.perf_counter())


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


def alternating_ms(fns) -> list:
    """Device time of one call of each of ``fns``, read in turn: each
    captured once as 20 calls in a CUDA graph, then 5 rounds in which every
    graph is replayed 5 times between CUDA events, one after the other; the
    median of each one's rounds.  Two forms of a few-microsecond kernel
    compared so see the same clocks and the same neighbours, each read from
    100 launches a round."""
    launches, reps, pairs = 20, 5, 5
    graphs = []
    for fn in fns:
        fn()
        sync()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                fn()
        graph.replay()
        sync()
        graphs.append(graph)
    reads = [[] for _ in fns]
    for _ in range(pairs):
        for graph, read in zip(graphs, reads):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                graph.replay()
            end.record()
            sync()
            read.append(start.elapsed_time(end) / (reps * launches))
    return [sorted(r)[len(r) // 2] for r in reads]


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


# each source's compiler output from phase 2 (-Xptxas -v), by source stem
BUILD_LOGS: dict = {}


def phase_build() -> None:
    from repro_torch.kernels import _build

    phase("2. build")
    t0 = time.perf_counter()
    logs = _build.build()
    BUILD_LOGS.update(logs)
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
                gg, ggp = klg.logreg_grad(X, y, w), klg.logreg_grad_plain(X, y, w)
                sync()
                ez, eg, egg = (z - zp).abs().max().item(), rel_err(g, gp), rel_err(gg, ggp)
                check(ez <= tol and eg <= tol and egg <= tol,
                      f"logreg X{(P, n, d)} {dtype} w{tuple(w.shape)}: "
                      f"z err {ez}, g rel err {eg}, one-pass g rel err {egg}")
            say(f"logreg {str(dtype)[6:]} X{(P, n, d)} (strided view), shared "
                f"and per-partition w: z err {ez:.3g}, g rel err {eg:.3g}, "
                f"logreg_grad (one pass, plan {grad_plan_text(n, d)}) rel err {egg:.3g}")
    routes = dict(klg.logreg_grad.routes)
    check(set(routes) == {"one_pass"}, f"logreg_grad routes {routes}")
    logreg_grad_invariance(gen)
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
    kmeans_invariance(gen)

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


def logreg_grad_routes():
    """logreg_grad's launches by route since the last reset_launch_counts."""
    from repro_torch.kernels.logreg_grad import logreg_grad

    return logreg_grad.routes


def grad_plan_text(n: int, d: int) -> str:
    from repro_torch.kernels.logreg_grad import grad_plan

    p = grad_plan(n, d)
    return (f"C={p.clusters} W={p.width} Rc={p.chunk_rows} Q={p.chunks} "
            f"R={p.group_rows} S={p.stages}")


def logreg_grad_invariance(gen: torch.Generator) -> None:
    """logreg_grad's partitions bitwise the same in a launch of 8 and of
    4 + 4, for the table's strided view and its contiguous copy, and over
    repeated launches (GRAD_REPEATS), at the main path's (8, 256, 160,000)
    sgd chunk and Fig. A2's (8, 4, 30,000); and the cluster counts the card
    holds for the plans of phases 4, 20 and 24 (b)."""
    from repro_torch.kernels import logreg_grad as klg

    for P, n, d in ((SHARDS, SGD_BATCH, LOGREG_FEATURES), (SHARDS, 4, FIG_TOP)):
        table = torch.randn(P, n, d + 1, generator=gen, device=DEVICE).clamp_(min=0.0)
        X, y = table[..., 1:], (table[..., 0] > 0.5).float()
        W = torch.randn(P, d, generator=gen, device=DEVICE) * 0.01
        g = klg.logreg_grad(X, y, W)
        half = P // 2
        split = torch.cat([klg.logreg_grad(X[i:i + half], y[i:i + half], W[i:i + half])
                           for i in (0, half)])
        check(torch.equal(g, split), f"logreg_grad X{(P, n, d)}: {P} partitions differ from "
              f"{half} + {half}")
        check(torch.equal(g, klg.logreg_grad(X.contiguous(), y.contiguous(), W)),
              f"logreg_grad X{(P, n, d)}: the strided view differs from its copy")
        same = sum(torch.equal(klg.logreg_grad(X, y, W), g) for _ in range(GRAD_REPEATS))
        check(same == GRAD_REPEATS, f"logreg_grad X{(P, n, d)}: {GRAD_REPEATS - same} of "
              f"{GRAD_REPEATS} repeated launches differ")
        say(f"logreg_grad X{(P, n, d)}: bitwise {P} vs {half} + {half} partitions, strided "
            f"vs contiguous, and over {GRAD_REPEATS} repeated launches")
        del table, X
    held = {f"(n, d) = {(n, d)}": klg.grad_clusters(klg.grad_plan(n, d))
            for n, d in ((SGD_BATCH, LOGREG_FEATURES), (4, FIG_TOP), (SGD_BATCH, 4096))}
    say(f"logreg_grad: clusters the card holds at once (cudaOccupancyMaxActiveClusters) "
        f"for the plans {held}")


def kmeans_invariance(gen: torch.Generator) -> None:
    """kmeans_assign's picks bitwise the same for a row wherever it lies:
    at n = 1, 7, 128 and 2048, at offsets, as (P, n, d) and (n, d), in a
    launch of 8,192 rows (the split form) and of 32,768 (the stream form);
    and contiguous, in a 16-byte-aligned strided view (the TMA route) and
    an unaligned one (row stride d + 1, the general route), in fp32 and
    bf16 at ragged n and d; and at shapes of several 512-element slices in
    both forms, the plain version's picks but for ties within fp32 rounding
    (tests/test_torch_cuda.py's shapes)."""
    from repro_torch.kernels import kmeans_assign as kka

    forms, routes = kka.kmeans_assign.forms, kka.kmeans_assign.routes
    forms.clear()
    big = torch.randn(2, 16384, 4096, generator=gen, device=DEVICE)
    X = big[:, :4096]
    for k in (1, 50, 64, 65, 257):
        C = torch.randn(k, 4096, generator=gen, device=DEVICE)
        full = kka.kmeans_assign(X, C)
        check(torch.equal(full, kka.kmeans_assign(big, C)[:, :4096]),
              f"kmeans_assign k={k}: X's rows differ between the forms")
        for n, off in itertools.product((1, 7, 128, 2048), (0, 1, 1000)):
            off = min(off, 4096 - n)
            check(torch.equal(kka.kmeans_assign(X[:, off:off + n], C), full[:, off:off + n])
                  and torch.equal(kka.kmeans_assign(X[1, off:off + n], C),
                                  full[1, off:off + n]),
                  f"kmeans_assign k={k}: rows {off}..{off + n} differ from X's launch")
    check(forms["stream"] > 0 and forms["split"] > 0, f"kmeans_assign forms {dict(forms)}")
    say(f"kmeans_assign: every row's pick bitwise the same at n = 1, 7, 128, 2048, "
        f"4096, 16384, at offsets, P = 1, 2, k = 1, 50, 64, 65, 257; launches by "
        f"form {dict(forms)}")
    del big, X
    routes.clear()
    for n, d, k in ((300, 1031, 50), (77, 4099, 65), (1000, 4096, 50), (2500, 33, 7),
                    (129, 1, 3), (5, 512, 257)):
        for dtype in (torch.float32, torch.bfloat16):
            Xr = torch.randn(2, n, d, generator=gen, device=DEVICE).to(dtype)
            C = torch.randn(k, d, generator=gen, device=DEVICE)
            step = 16 // Xr.element_size()
            aligned = torch.zeros(2, n, -(-d // step) * step + step, dtype=dtype,
                                  device=DEVICE)
            aligned[..., :d] = Xr
            unaligned = torch.zeros(2, n, d + 1, dtype=dtype, device=DEVICE)
            unaligned[..., 1:] = Xr
            want = kka.kmeans_assign(Xr, C)
            differ, gap, ratio = score_gap(Xr, C, want, kka.kmeans_assign_plain(Xr, C))
            check(ratio <= 1.0, f"kmeans_assign X{(2, n, d)} k={k} {dtype}: {differ} picks "
                  f"differ from the plain version's beyond rounding ({ratio}x)")
            for view in (aligned[..., :d], unaligned[..., 1:]):
                check(torch.equal(kka.kmeans_assign(view, C), want)
                      and torch.equal(kka.kmeans_assign(view[:, 1:], C), want[:, 1:]),
                      f"kmeans_assign X{(2, n, d)} k={k} {dtype}: a strided view differs")
    check(routes["tma"] > 0 and routes["general"] > 0, f"kmeans_assign routes {dict(routes)}")
    say(f"kmeans_assign: the same picks contiguous, 16-byte-aligned and unaligned, "
        f"the plain version's but for ties within fp32 rounding (fp32, bf16; d = 1031, "
        f"4099, 4096, 33, 1, 512); launches by route {dict(routes)}")
    forms.clear()
    for shape in ((3, 333, 1031, 50), (1, 2048, 4096, 50), (2, 12000, 1031, 50),
                  (1, 20000, 4096, 50)):
        *xs, k = shape
        Xm = torch.randn(*xs, generator=gen, device=DEVICE)
        C = torch.randn(k, xs[-1], generator=gen, device=DEVICE)
        differ, gap, ratio = score_gap(Xm, C, kka.kmeans_assign(Xm, C),
                                       kka.kmeans_assign_plain(Xm, C))
        check(ratio <= 1.0, f"kmeans_assign X{tuple(xs)} k={k}: {differ} picks differ "
              f"from the plain version's beyond rounding ({ratio}x)")
    check(forms["stream"] == 2 and forms["split"] == 2, f"kmeans_assign forms {dict(forms)}")
    say(f"kmeans_assign: several slices (d = 1031, 4096) in both forms {dict(forms)}, "
        f"the plain version's picks but for ties within fp32 rounding")


def logreg_rows(keep: slice, rows: int = LOGREG_ROWS) -> torch.Tensor:
    """Rows ``keep`` of phase 4's (rows, 1 + d) fp32 table, made on the card:
    ReLU'd gaussian features (as synth_imagenet_features), each 4,096-row
    slab from its own generator (seed MESH_LR_SEED + 1 + slab), labels from
    a planted linear model (seed MESH_LR_SEED) split at the median of every
    row's margin.  A host process thus makes its own rows bitwise those of
    the whole table, at the cost of drawing every slab once for the
    margins; ``keep`` must lie on slab boundaries."""
    n, d, slab = rows, LOGREG_FEATURES, 4096
    gen = torch.Generator(device=DEVICE).manual_seed(MESH_LR_SEED)
    w_true = torch.randn(d, generator=gen, device=DEVICE) / math.sqrt(d)
    table = torch.empty((keep.stop - keep.start, d + 1), dtype=torch.float32, device=DEVICE)
    margins = torch.empty(n, dtype=torch.float32, device=DEVICE)
    scratch = None
    for i in range(0, n, slab):
        gen.manual_seed(MESH_LR_SEED + 1 + i // slab)
        if keep.start <= i < keep.stop:
            block = table[i - keep.start:i - keep.start + slab]
        else:
            if scratch is None:
                scratch = torch.empty((slab, d + 1), dtype=torch.float32, device=DEVICE)
            block = scratch
        x = block[:, 1:]
        x.normal_(generator=gen).clamp_(min=0.0)
        margins[i:i + slab] = x @ w_true
    table[:, 0] = (margins[keep] > margins.median()).float()
    return table


def phase_logreg(gen, counts, report) -> None:
    from repro_torch.core.algorithms.logistic_regression import LogisticRegression
    from repro_torch.core.numeric_table import MLNumericTable
    from repro_torch.kernels import launch_counts

    phase(f"4. logistic regression, {LOGREG_ROWS:,} x {LOGREG_FEATURES:,}, "
          f"{SHARDS} partitions")
    t0 = time.perf_counter()
    data = logreg_rows(slice(0, LOGREG_ROWS))
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
        got = {k: after[k] - before[k] for k in ("logreg_grad", "logreg_margin", "logreg_xt_z")}
        counts[solver] = got
        say(f"launches in the {solver} fit: {got} over {ROUNDS} rounds "
            f"(expected {per_round} logreg_grad per round, one a step, and no other)")
        check(got == {"logreg_grad": per_round * ROUNDS, "logreg_margin": 0, "logreg_xt_z": 0},
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


def kmeans_table(gen: torch.Generator, rows: int = KMEANS_ROWS) -> torch.Tensor:
    n, d = rows, KMEANS_FEATURES
    data = torch.empty((n, d), dtype=torch.float32, device=DEVICE)
    data.normal_(generator=gen).clamp_(min=0.0)
    return data


def rounds_ms(fit, rounds: int) -> float:
    """Device ms a round of ``fit()`` (``rounds`` rounds), by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    fit()
    end.record()
    sync()
    return start.elapsed_time(end) / rounds


def kmeans_round_split(blocks: torch.Tensor, C: torch.Tensor) -> dict:
    """Device ms of one Lloyd round through the kernel by part
    (torch.profiler over a round after a warm one), the round made of the
    calls the port's KMeans makes each round (``_local_stats``, the
    runner's combine, ``_centroid_update``): the assignment kernel (by its
    name, ``assign_``), one_hot, the batched product (aten::bmm), the
    combine and the update (each under a label), and the rest (||c||², the
    one-hot's dtype copy, counts, concatenation); ``round`` is every kernel
    of the round."""
    import repro_torch.core.algorithms.kmeans as km
    from repro_torch.core.runner import _emulated_combine
    from torch.profiler import DeviceType, record_function

    def lloyd_round():
        stats = km._local_stats(blocks, C, use_kernel=True)
        with record_function("kmeans.combine"):
            tot = _emulated_combine(stats, "sum")
        with record_function("kmeans.update"):
            return km._centroid_update(C, tot)

    lloyd_round()
    sync()
    # a window that recorded no assign_ kernel (a lost profiler record: the
    # kernel's launches and CUDA-event times are checked elsewhere) is
    # profiled again, up to SPLIT_WINDOWS windows
    for window in range(SPLIT_WINDOWS):
        events = profile_steps(lloyd_round, 1).events()
        kernels = collections.Counter()  # the kernels, without the labels' ranges
        for e in events:
            if e.device_type == DeviceType.CUDA and not e.name.startswith(("kmeans.",
                                                                           "ProfilerStep")):
                kernels[e.name[:60]] += e.self_device_time_total / 1e3
        if any("assign_" in k for k in kernels):
            break
    lost = window if any("assign_" in k for k in kernels) else SPLIT_WINDOWS
    say(f"the round's split: {lost} of {min(lost + 1, SPLIT_WINDOWS)} profiler windows lost "
        f"the assign_ kernel's record")

    def part(name):
        return sum(e.device_time_total for e in events
                   if e.device_type == DeviceType.CPU and e.name == name) / 1e3

    parts = {"assignment kernel": sum(v for k, v in kernels.items() if "assign_" in k),
             "one_hot": part("aten::one_hot"), "batched product": part("aten::bmm"),
             "combine": part("kmeans.combine"), "update": part("kmeans.update")}
    check(parts["assignment kernel"] > 0, f"the round's split saw no assign_ kernel in "
          f"{SPLIT_WINDOWS} profiler windows")
    parts["lost_windows"] = lost
    parts["round"] = sum(kernels.values())
    parts["rest"] = parts["round"] - sum(v for k, v in parts.items()
                                         if k not in ("round", "lost_windows"))
    parts["kernels"] = dict(kernels.most_common(6))
    return parts


def sliced_plain_assign(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """The plain composition in kmeans_assign's order: d in slices of
    KMEANS_SLICE elements (csrc/kmeans_assign.cu's kSlice), each slice's
    products by one matmul, the slices' products added in slice order onto
    0, then the first argmin of ||c||² − 2·sum."""
    Cf = C.float()
    total = torch.zeros(X.shape[:-1] + (C.shape[0],), dtype=torch.float32, device=X.device)
    for s0 in range(0, X.shape[-1], KMEANS_SLICE):
        total = total + X[..., s0:s0 + KMEANS_SLICE].float() @ Cf[:, s0:s0 + KMEANS_SLICE].T
    return torch.argmin((Cf * Cf).sum(dim=1) - 2.0 * total, dim=-1).to(torch.int32)


def plain_lloyd(blocks: torch.Tensor, C: torch.Tensor, rounds: int, assign=None):
    """Lloyd rounds with a plain assignment (the expanded form
    ``kmeans_assign_plain`` unless ``assign`` is given), written out
    independently of the port's KMeans."""
    from repro_torch.kernels.kmeans_assign import kmeans_assign_plain

    assign = assign or kmeans_assign_plain
    k = C.shape[0]
    for _ in range(rounds):
        a = assign(blocks, C).long()
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
    blocks = data.view(SHARDS, -1, KMEANS_FEATURES)
    t0 = time.perf_counter()
    C_plain = plain_lloyd(blocks, init, ROUNDS)
    sync()
    t_plain = (time.perf_counter() - t0) / ROUNDS
    C = model.centroids
    check(C.shape == (KMEANS_K, KMEANS_FEATURES) and bool(torch.isfinite(C).all()),
          "centroids not finite or misshapen")
    # The kernel sums each row's products in 512-element slices added in
    # order; the expanded form's matmul sums them in one chain.  Rows whose
    # two best scores lie within fp32 rounding may go either way, and one
    # such row moving between clusters of 1 to ~4·10^4 rows shifts a
    # coordinate of a small one by up to ~4·10^-2.  So the fit is held at
    # 1e-3 against plain Lloyd rounds that sum in the kernel's order; each
    # round's picks are held against the expanded form's in phase 7 (every
    # difference a tie within fp32 rounding), and the distance between the
    # two fits is printed.
    e = (C - plain_lloyd(blocks, init, ROUNDS, assign=sliced_plain_assign)).abs().max().item()
    check(e <= 1e-3, f"centroids kernel vs plain in the kernel's order max abs err {e}")
    e_plain = (C - C_plain).abs().max().item()
    say(f"fit: {t_fit:.4f} s/round through the kernel (1 launch a round), "
        f"{t_plain:.4f} s/round plain expanded form (host clock, the first fit); "
        f"centroids max abs err vs plain rounds in the kernel's order {e:.3g}, vs the "
        f"expanded form's {e_plain:.3g}")
    report["kmeans"] = {"table": table, "model": model, "init": init}


def kmeans_rounds_against_plain(blocks: torch.Tensor, init: torch.Tensor,
                                fitted: torch.Tensor) -> None:
    """Lloyd rounds from ``init`` through the kernel, each round's picks
    held against the expanded form's on the same centroids (every
    difference a tie within fp32 rounding, ``score_gap``), and the last
    round's centroids against the fit's."""
    from repro_torch.kernels import kmeans_assign as kka

    rounds = []

    def checked(X, C):
        a = kka.kmeans_assign(X, C)
        ties, gap, ratio = score_gap(X, C, a, kka.kmeans_assign_plain(X, C))
        check(ratio <= 1.0, f"round {len(rounds) + 1}: {ties} picks differ from the "
              f"expanded form's beyond rounding (gap {gap}, {ratio}x the scale)")
        smallest = int(torch.bincount(a.flatten().long(), minlength=C.shape[0]).min())
        rounds.append(f"{ties} (gap {gap:.3g}, {ratio:.3g}x; smallest cluster {smallest})")
        return a

    e = (plain_lloyd(blocks, init, ROUNDS, assign=checked) - fitted).abs().max().item()
    check(e <= 1e-3, f"Lloyd rounds through the kernel vs the fit: max abs err {e}")
    say(f"k-means rounds 1..{ROUNDS} through the kernel: picks that differ from the "
        f"expanded form's on the same centroids, each a tie within fp32 rounding: "
        f"{'; '.join(rounds)}; centroids vs the fit's max abs err {e:.3g}")


def kmeans_round_times(table, init) -> dict:
    """Device ms a fit round by CUDA events after a warm round, the
    kernel's fit (KMeans) and the plain expanded form's in turns."""
    from repro_torch.core.algorithms.kmeans import KMeans

    blocks = table.data.view(SHARDS, -1, KMEANS_FEATURES)
    fits = {"kernel": lambda r: KMeans(k=KMEANS_K, max_iter=r, seed=SEED,
                                       use_kernel=True).fit(table, init_centroids=init),
            "plain": lambda r: plain_lloyd(blocks, init, r)}
    got = {name: [] for name in fits}
    for fit in fits.values():
        fit(1)
    for _ in range(2):
        for name, fit in fits.items():
            got[name].append(rounds_ms(lambda: fit(ROUNDS), ROUNDS))
    return got


def kmeans_round_timing(report) -> None:
    """Phase 7's fit round: its time and its split by part."""
    table, init = report["kmeans"]["table"], report["kmeans"]["init"]
    got = kmeans_round_times(table, init)
    split = kmeans_round_split(table.data.view(SHARDS, -1, KMEANS_FEATURES), init)
    say(f"a fit round by CUDA events (after a warm round; kernel and plain in turns): "
        f"kernel {', '.join(f'{v:.4f}' for v in got['kernel'])} ms, plain "
        f"{', '.join(f'{v:.4f}' for v in got['plain'])} ms")
    say("one round through the kernel by part (torch.profiler, device ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()
                    if k not in ("kernels", "lost_windows")))
    say("its largest kernels (device ms): "
        + "; ".join(f"{k} {v:.4f}" for k, v in split["kernels"].items()))
    report["kmeans"]["round_ms"] = got
    report["kmeans"]["round_split"] = split


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
        # each result against the plain path on the same rows (the k-means
        # picks against the full table's launch in phase 7)
        mismatched = 0
        if name == "k-means":
            report["kmeans"]["served"] = list(zip(starts, sizes, results))
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

    # the one-pass gradient, the fits' kernel, at both shapes
    gd, sgd = grad_row("gd", X, y, w), grad_row("sgd chunk", Xs, ys, Ws)
    bars = grad_bars([gd, sgd], share_bar=True)
    records.insert(0, {
        "name": "logreg_grad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/logreg_grad.cu",
        "replaces": "src/repro/kernels/logreg_grad.py:128",
        "launches": counts["sgd"]["logreg_grad"] + counts["gd"]["logreg_grad"],
        "max_abs_err": max(gd["max_abs_err"], sgd["max_abs_err"]),
        "ms": gd["ms"], "plain_ms": gd["plain_ms"], "bound_ms": gd["bound_ms"],
        "bound_by": gd["bound_by"], "library_ms": None, "shape": gd["shape"],
        "pair_ms": gd["pair_ms"], "margin_matmul_ms": gd["margin_matmul_ms"],
        "sgd_shape": sgd["shape"], "sgd_ms": sgd["ms"], "sgd_plain_ms": sgd["plain_ms"],
        "sgd_bound_ms": sgd["bound_ms"], "sgd_pair_ms": sgd["pair_ms"],
        "sgd_margin_matmul_ms": sgd["margin_matmul_ms"], "plans": [gd["plan"], sgd["plan"]],
        "bars": bars,
        "launches_by_path": {"fit_sgd": counts["sgd"]["logreg_grad"],
                             "fit_gd": counts["gd"]["logreg_grad"]}})
    records.append(kmeans_timing(counts, report))
    return records


def grad_row(label: str, X: torch.Tensor, y: torch.Tensor, W: torch.Tensor) -> dict:
    """logreg_grad on the chunk view X (P, n, d) against logreg_grad_plain
    (within FP32_TOL of its largest entry), timed beside its plain version,
    the standalone pair (logreg_margin, then logreg_xt_z), logreg_margin
    followed by one torch.matmul(Xᵀ, z), and its one-pass bound (X, y, w and
    g moved once; 4 operations an element of X); in CUDA graphs where the
    bound is under 20 µs.  No one PyTorch call computes the gradient, so
    library_ms is None."""
    from repro_torch.kernels import logreg_grad as klg

    P, n, d = X.shape
    g, gp = klg.logreg_grad(X, y, W), klg.logreg_grad_plain(X, y, W)
    sync()
    err = rel_err(g, gp)
    check(err <= FP32_TOL, f"logreg_grad at {label} {tuple(X.shape)}: rel err {err}")
    t_b, by = bound(4.0 * (P * n * d + P * n + W.numel() + P * d), 4.0 * P * n * d)
    timer = graph_ms if t_b < 0.02 else (lambda f: cuda_ms(f, 5 if n > 1024 else 20))
    return {"label": label, "shape": [P, n, d], "row_stride": X.stride(1),
            "partition_stride": X.stride(0), "plan": grad_plan_text(n, d),
            "ms": timer(lambda: klg.logreg_grad(X, y, W)),
            "plain_ms": timer(lambda: klg.logreg_grad_plain(X, y, W)),
            "pair_ms": timer(lambda: klg.logreg_xt_z(X, klg.logreg_margin(X, y, W))),
            "margin_matmul_ms": timer(lambda: torch.matmul(
                X.transpose(1, 2), klg.logreg_margin(X, y, W).unsqueeze(-1))),
            "bound_ms": t_b, "bound_by": by, "library_ms": None,
            "max_abs_err": (g - gp).abs().max().item(), "rel_err": err}


def grad_bars(rows: list, share_bar: bool) -> dict:
    """Print each row of grad_row and logreg_grad's bars, met or MISSED: at
    least GRAD_BOUND_BAR of the one-pass bound (share_bar: phase 7's gd and
    sgd shapes) and faster than logreg_margin + torch.matmul at every row."""
    for r in rows:
        say(f"logreg_grad {r['label']} X{tuple(r['shape'])} (row stride {r['row_stride']:,}; "
            f"{r['plan']}): kernel {r['ms']:.4f} ms, {r['bound_ms'] / r['ms']:.1%} of the "
            f"one-pass bound {r['bound_ms']:.4f} ms ({r['bound_by']}); the pair (logreg_margin, "
            f"logreg_xt_z) {r['pair_ms']:.4f} ms; logreg_margin + torch.matmul "
            f"{r['margin_matmul_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms; max abs err "
            f"{r['max_abs_err']:.3g} (rel {r['rel_err']:.3g})")
    shapes = ", ".join(str(tuple(r["shape"])) for r in rows)
    bars = {f"faster than logreg_margin + torch.matmul at {shapes}":
            "met" if all(r["ms"] < r["margin_matmul_ms"] for r in rows) else "MISSED"}
    if share_bar:
        bars[f">= {GRAD_BOUND_BAR:.0%} of the one-pass bound at {shapes}"] = (
            "met" if all(r["bound_ms"] / r["ms"] >= GRAD_BOUND_BAR for r in rows) else "MISSED")
    say(f"logreg_grad bars (a kernel that misses one stays; its times are in the kernels "
        f"line): {bars}")
    return bars


def kernel_device_ms(fn, key: str, calls: int = 20) -> float:
    """Mean device time of the CUDA functions whose name holds ``key``, a
    call of ``fn`` (torch.profiler over ``calls`` calls after a warm one)."""
    from torch.profiler import DeviceType

    fn()
    sync()
    prof = profile_steps(fn, calls)
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and key in e.key) / 1e3 / calls


def kmeans_shape_times(Xk: torch.Tensor, Xs: torch.Tensor, C: torch.Tensor) -> dict:
    """kmeans_assign at the fit's shape ``Xk`` (CUDA events) and at a
    serving microbatch ``Xs`` (the wrapper's call, as the served path makes
    it, in a CUDA graph), each beside its plain version, and the
    microbatch's kernel alone (torch.profiler: the functions whose name
    holds ``assign_``)."""
    from repro_torch.kernels import kmeans_assign as kka

    return {"ms": cuda_ms(lambda: kka.kmeans_assign(Xk, C), 5),
            "plain_ms": cuda_ms(lambda: kka.kmeans_assign_plain(Xk, C), 5),
            "serve_call_ms": graph_ms(lambda: kka.kmeans_assign(Xs, C)),
            "serve_plain_ms": graph_ms(lambda: kka.kmeans_assign_plain(Xs, C)),
            "serve_kernel_ms": kernel_device_ms(lambda: kka.kmeans_assign(Xs, C), "assign_")}


def kmeans_timing(counts, report) -> dict:
    """kmeans_assign at the fit's shape and at a serving microbatch, beside
    its plain version and both bounds, with its bars; each fit round's
    picks against the expanded form's; the served picks against the full
    table's launch; the fit round's time and split; its registers (no
    spill)."""
    from repro_torch.kernels import kmeans_assign as kka

    data = report["kmeans"]["table"].data
    Xk = data.view(SHARDS, -1, KMEANS_FEATURES)
    C = report["kmeans"]["model"].centroids
    forms = kka.kmeans_assign.forms
    before = forms["stream"]
    a, ap = kka.kmeans_assign(Xk, C), kka.kmeans_assign_plain(Xk, C)
    sync()
    check(forms["stream"] == before + 1, "kmeans_assign at the fit's shape: not the stream form")
    differ, gap, ratio = score_gap(Xk, C, a, ap)
    check(ratio <= 1.0, f"kmeans_assign at the main shape: {differ} picks "
          f"differ beyond rounding")
    kmeans_rounds_against_plain(Xk, report["kmeans"]["init"], C)
    table_picks = a.flatten()
    for s0, m, r in report["kmeans"]["served"]:
        check(torch.equal(torch.from_numpy(r).to(DEVICE).to(torch.int32),
                          table_picks[s0:s0 + m]),
              f"served picks of rows {s0}..{s0 + m} differ from the table's launch")
    Xs = Xk[0, :KMEANS_SERVE_ROWS].unsqueeze(0)
    before = forms["split"]
    check(torch.equal(kka.kmeans_assign(Xs, C), a[:1, :KMEANS_SERVE_ROWS])
          and forms["split"] == before + 1,
          "kmeans_assign: a serving microbatch's picks differ from the fit shape's, "
          "or it did not take the split form")
    say(f"kmeans_assign: every served pick ({len(report['kmeans']['served'])} requests) "
        f"bitwise the full table's launch's; a microbatch X(1, {KMEANS_SERVE_ROWS}, "
        f"{KMEANS_FEATURES}) (the split form) bitwise the fit shape's (the stream form)")
    times = kmeans_shape_times(Xk, Xs, C)
    check(times["serve_kernel_ms"] > 0, "torch.profiler saw no assign_ kernel at the microbatch")
    kmeans_round_timing(report)

    def bounds(rows):
        return (4.0 * (rows * KMEANS_FEATURES + KMEANS_K * KMEANS_FEATURES + rows)
                / HBM_BYTES_PER_S * 1e3,
                2.0 * rows * KMEANS_FEATURES * KMEANS_K / FP32_OPS_PER_S * 1e3)

    nk = Xk.shape[0] * Xk.shape[1]
    fit_bytes, fit_ops = bounds(nk)
    serve_bytes, serve_ops = bounds(KMEANS_SERVE_ROWS)
    t_b, by = max((fit_bytes, "bytes"), (fit_ops, "operations"))
    s_b = max(serve_bytes, serve_ops)
    ms, plain_ms, serve_ms = times["ms"], times["plain_ms"], times["serve_call_ms"]
    # the serving bar reads the wrapper's call, its ||c||² (two PyTorch
    # launches) included, as every served microbatch pays it
    bars = {
        f"fit below the plain composition and >= {KMEANS_FIT_BAR:.0%} of its bound":
            "met" if ms < plain_ms and t_b / ms >= KMEANS_FIT_BAR else "MISSED",
        f"serving microbatch (the wrapper's call) >= {KMEANS_SERVE_BAR:.0%} of its bound":
            "met" if s_b / serve_ms >= KMEANS_SERVE_BAR else "MISSED"}
    say(f"kmeans_assign X{tuple(Xk.shape)} k={KMEANS_K}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library none, bound {t_b:.4f} ms ({by}; operations "
        f"{fit_ops:.4f}, bytes {fit_bytes:.4f}; {t_b / ms:.1%}); {differ} "
        f"assignments differ from the plain version, each a tie within fp32 "
        f"rounding (largest gap {gap:.3g}, {ratio:.3g}x the rounding scale)")
    say(f"kmeans_assign X(1, {KMEANS_SERVE_ROWS}, {KMEANS_FEATURES}) k={KMEANS_K} (a serving "
        f"microbatch): the wrapper's call {serve_ms:.4f} ms ({s_b / serve_ms:.1%} of the "
        f"bound; {'faster' if serve_ms < times['serve_plain_ms'] else 'slower'} than plain) and "
        f"plain {times['serve_plain_ms']:.4f} ms (CUDA graph); the kernel alone "
        f"{times['serve_kernel_ms']:.4f} ms (torch.profiler; {s_b / times['serve_kernel_ms']:.1%}); "
        f"bound {s_b:.4f} ms (operations {serve_ops:.4f}, bytes {serve_bytes:.4f})")
    say(f"kmeans_assign bars (a kernel that misses one stays in): {bars}")
    check_no_spill("kmeans_assign", {
        f"{form} {t} TN={tn}": rf"assign_{form}I{m}Li{tn}E"
        for form in ("stream", "split") for t, m in (("fp32", "f"), ("bf16", "13__nv_bfloat16"))
        for tn in (4, 8, 13, 16)})
    return {
        "name": "kmeans_assign", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans_assign.py:75",
        "launches": counts["kmeans_fit"] + counts["serve_k-means"],
        "max_abs_err": gap, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": t_b, "bound_by": by, "library_ms": None,
        "shape": list(Xk.shape) + [KMEANS_K], "tie_picks": differ,
        "bound_ops_ms": fit_ops, "bound_bytes_ms": fit_bytes,
        "serve_shape": [1, KMEANS_SERVE_ROWS, KMEANS_FEATURES, KMEANS_K],
        "serve_ms": serve_ms, "serve_kernel_ms": times["serve_kernel_ms"],
        "serve_plain_ms": times["serve_plain_ms"], "serve_bound_ms": s_b,
        "serve_bound_ops_ms": serve_ops, "serve_bound_bytes_ms": serve_bytes,
        "round_ms": report["kmeans"]["round_ms"], "bars": bars,
        "launches_by_path": {"fit": counts["kmeans_fit"], "serve": counts["serve_k-means"]},
    }


def free_tables(report) -> None:
    """Drop the first path's tables (41.9 GB and 17.2 GB): phase 21 calls it
    after its GLM part, which reads phase 4's table."""
    report.pop("logreg", None)
    report.pop("kmeans", None)
    free_device_memory()
    say(f"tables freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
        f"allocated")


# --------------------------------------------------------------------------- #
# phase 20: the paper's Fig. A2 program end to end
# --------------------------------------------------------------------------- #
def fig_corpus(seed: int, docs: int = None) -> list:
    """``docs`` (FIG_DOCS by default) (label, text) rows of FIG_WORDS words:
    made-up words of two or three consonant-vowel syllables, FIG_VOCAB of them, drawn with Zipf
    weights (exponent 1.1), each class tripling the weight of its half of
    the vocabulary (as synth_labeled_text favours half its words).  The
    package's generators draw from 26 words, so they make at most 676
    bigrams, which cannot fill top = 30,000."""
    rng = np.random.default_rng(seed)
    cons, vows = np.array(list("bcdfghjklmnprstvz")), np.array(list("aeiou"))
    words = set()
    while len(words) < FIG_VOCAB:
        words.add("".join(rng.choice(cons) + rng.choice(vows)
                          for _ in range(int(rng.integers(2, 4)))))
    words = np.array(sorted(words))
    rng.shuffle(words)
    zipf = 1.0 / np.arange(1, FIG_VOCAB + 1) ** 1.1
    docs = FIG_DOCS if docs is None else docs
    labels = np.arange(docs) % 2
    idx = np.empty((docs, FIG_WORDS), np.int64)
    for c in (0, 1):
        w = zipf.copy()
        w[np.arange(FIG_VOCAB) % 2 == c] *= 3.0
        rows = labels == c
        idx[rows] = rng.choice(FIG_VOCAB, size=(int(rows.sum()), FIG_WORDS), p=w / w.sum())
    return [(float(y), " ".join(words[i])) for y, i in zip(labels, idx)]


def fig_pipelines(mesh=None):
    """Pipelines (a) and (b) of phase 20: Fig. A2's k-means program and its
    supervised twin (examples/text_pipeline.py's stages and parameters), in
    SHARDS emulated partitions or on ``mesh`` (phase 24 (e2)).  The k-means
    combine is gather_broadcast: one order for the partitions' sums on a
    mesh, the same arithmetic as any schedule in emulated mode."""
    from repro_torch.core.algorithms.kmeans import KMeans
    from repro_torch.core.algorithms.logistic_regression import LogisticRegression
    from repro_torch.features import NGrams, Standardizer, TfIdf
    from repro_torch.pipeline import Pipeline

    layout = (dict(mesh=mesh) if mesh is not None
              else dict(num_shards=SHARDS, device=DEVICE))
    a = Pipeline([NGrams(n=2, top=FIG_TOP, column="text", keep_columns=False), TfIdf(),
                  KMeans(k=FIG_K, max_iter=FIG_ROUNDS, seed=SEED, use_kernel=True,
                         schedule="gather_broadcast")], **layout)
    b = Pipeline([NGrams(n=2, top=FIG_TOP, column="text"), TfIdf(), Standardizer(),
                  LogisticRegression(**FIG_LOGREG, use_kernel=True)], **layout)
    return a, b


def fig_hashes(fit_a, fit_b) -> dict:
    """The fitted statistics and models of pipelines (a) and (b), hashed:
    what phase 24 (e2) holds its mesh fits to."""
    return {"a/idf": sha(fit_a["tfidf"].idf), "a/centroids": sha(fit_a.model.centroids),
            "b/idf": sha(fit_b["tfidf"].idf), "b/shift": sha(fit_b["standardizer"].shift),
            "b/scale": sha(fit_b["standardizer"].scale), "b/weights": sha(fit_b.model.weights)}


def np_sha(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def fig_requests() -> list:
    """FIG_REQUESTS requests of 1..FIG_REQ_MAX docs, drawn with repeats from
    the first FIG_SERVE_POOL docs (so the featurize memo is hit): a list of
    doc index arrays."""
    rng = np.random.default_rng(SEED + 1)
    sizes = rng.integers(1, FIG_REQ_MAX + 1, size=FIG_REQUESTS)
    return [rng.integers(0, FIG_SERVE_POOL, size=int(m)) for m in sizes]


def serve_blocks(model, blocks: list, max_batch: int) -> dict:
    """Each block through a ModelPredictor of ``model``, one flush each,
    timed by the host clock (a flush ends in the result's copy to the
    host, which waits for the card)."""
    from repro_torch.serve.predictor import ModelPredictor, PredictRequest

    svc = ModelPredictor(model, max_batch=max_batch, device=DEVICE)
    latencies, results = [], []
    t0 = time.perf_counter()
    for block in blocks:
        t1 = time.perf_counter()
        req = svc.submit(PredictRequest(features=block))
        svc.flush()
        latencies.append((time.perf_counter() - t1) * 1e3)
        results.append(req.result)
    return {"seconds": time.perf_counter() - t0, "latencies": latencies,
            "results": results, "report": svc.report()}


def _rel64(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got − want| over max|want|, in fp64."""
    return ((got.double() - want).abs().max() / want.abs().max().clamp(min=1e-300)).item()


def fig_fp64_errors(counts: torch.Tensor, tfidf: torch.Tensor, fitted,
                    rows: int = 2048) -> dict:
    """Pipeline (b)'s statistics against the same formulas in fp64 on the
    card (in row chunks): the IDF weights log((1 + N) / (1 + df)) from the
    count table, the tf-idf rows count / row total · idf from the counts,
    and the Standardizer's shift (the mean) and scale (sqrt(ss/N − mean²) +
    1e-8, identity where that variance is ≤ 1e-12) from the fp32 tf-idf
    table it was fitted on.  Column 0 is the label."""
    n = counts.shape[0]
    df = torch.zeros(counts.shape[1] - 1, dtype=torch.float64, device=counts.device)
    for i in range(0, n, rows):
        df += (counts[i:i + rows, 1:] > 0).sum(0).double()
    idf64 = torch.log((1.0 + n) / (1.0 + df))
    s, ss = torch.zeros_like(df), torch.zeros_like(df)
    tf_err = tf_max = 0.0
    for i in range(0, n, rows):
        c = counts[i:i + rows, 1:].double()
        want = c / c.sum(1, keepdim=True).clamp(min=1.0) * idf64
        got = tfidf[i:i + rows, 1:].double()
        tf_err = max(tf_err, (got - want).abs().max().item())
        tf_max = max(tf_max, want.abs().max().item())
        s += got.sum(0)
        ss += (got * got).sum(0)
    mean = s / n
    var = (ss / n - mean * mean).clamp(min=0.0)
    live = var > 1e-12
    shift_want = torch.where(live, mean, 0.0)
    scale_want = torch.where(live, var.sqrt() + 1e-8, 1.0)
    idf = fitted["tfidf"].idf
    st = fitted["standardizer"]
    return {"idf": _rel64(idf[1:], idf64), "tfidf": tf_err / tf_max,
            "shift": _rel64(st.shift[1:], shift_want),
            "scale": ((st.scale[1:].double() - scale_want).abs() / scale_want).max().item(),
            "label": [idf[0].item(), st.shift[0].item(), st.scale[0].item()],
            "passthrough": [int((~live).sum()),
                            int(((st.shift[1:] == 0) & (st.scale[1:] == 1)).sum())]}


def fig_kernel_times(table_a, centroids, final, w) -> dict:
    """Kernels 1-3 at phase 20's shapes (kmeans_shape_row,
    logreg_pair_times): kmeans_assign at the fit's (P, n, 30,000), k = 50;
    logreg_margin and logreg_xt_z at the fit's chunk (P, local_batch_size,
    30,000) of the table's feature columns (row stride 30,001), and
    logreg_margin at a served microbatch (FIG_REQ_MAX, 30,000) against zero
    labels, a few µs a launch, so in CUDA graphs (graph_ms)."""
    from repro_torch.kernels import logreg_grad as klg

    out = {"kmeans_assign": kmeans_shape_row(
        "Fig. A2", table_a.data.view(SHARDS, -1, FIG_TOP), centroids)}
    bs = FIG_LOGREG["local_batch_size"]
    blocks = final.data.view(SHARDS, -1, final.num_cols)
    out.update(logreg_pair_times("Fig. A2 chunk", blocks[:, :bs, 1:],
                                 blocks[:, :bs, 0].contiguous(),
                                 w.expand(SHARDS, -1).contiguous()))
    Xs = final.data[:FIG_REQ_MAX, 1:].contiguous()
    # as predict_proba serves it: no labels, σ(Xw) alone
    err = (klg.logreg_margin(Xs, None, w)
           - klg.logreg_margin_plain(Xs, None, w)).abs().max().item()
    check(err <= FP32_TOL, f"logreg_margin at a served microbatch: err {err}")
    t_s, by_s = bound(4.0 * (FIG_REQ_MAX * FIG_TOP + FIG_TOP + 2 * FIG_REQ_MAX),
                      2.0 * FIG_REQ_MAX * FIG_TOP)
    r = out["logreg_margin"]
    r.update(serve_shape=[FIG_REQ_MAX, FIG_TOP], serve_bound_ms=t_s, serve_bound_by=by_s,
             serve_ms=graph_ms(lambda: klg.logreg_margin(Xs, None, w)),
             serve_plain_ms=graph_ms(lambda: klg.logreg_margin_plain(Xs, None, w)),
             serve_max_abs_err=err)
    for name, row in out.items():
        if name != "logreg_grad":    # grad_bars printed it
            say_kernel_row(name, row)
    say(f"logreg_margin X({FIG_REQ_MAX}, {FIG_TOP}) (a served microbatch): kernel "
        f"{r['serve_ms']:.4f} ms, plain {r['serve_plain_ms']:.4f} ms, bound "
        f"{r['serve_bound_ms']:.5f} ms ({r['serve_bound_by']}); max abs err {err:.3g}")
    return out


def phase_fig_a2() -> dict:
    """Phase 20: pipelines (a) and (b) fitted on a raw-text table and
    served raw-text requests, its launches counted; then the checks.
    Returns each kernel's launches on this path, and under "times" the
    call that holds and times the kernels at its shapes (phase 25 makes
    it, once no child process shares the card)."""
    from repro_torch.core.algorithms.kmeans import KMeans
    from repro_torch.core.algorithms.logistic_regression import LogisticRegression
    from repro_torch.core.collectives import CollectiveSchedule
    from repro_torch.core.mltable import MLTable
    from repro_torch.core.numeric_table import MLNumericTable
    from repro_torch.features import NGrams, Standardizer, TfIdf
    from repro_torch.kernels import launch_counts, reset_launch_counts

    phase(f"20. Fig. A2: {FIG_DOCS:,} raw docs -> NGrams(n=2, top={FIG_TOP:,}) -> TfIdf -> "
          f"KMeans(k={FIG_K}) | Standardizer -> LogisticRegression, served as raw text "
          f"(its stage seconds read beside the child processes of phases 22-24; its "
          f"kernels timed alone in phase 25)")
    mem_reset()
    t0 = time.perf_counter()
    rows = fig_corpus(SEED)
    texts = [t for _, t in rows]
    raw = MLTable.from_rows(rows, names=["label", "text"], num_partitions=SHARDS)
    requests = fig_requests()
    say(f"corpus: {FIG_DOCS} labeled docs of {FIG_WORDS} words from {FIG_VOCAB} made-up words "
        f"(Zipf 1.1, class-biased), {SHARDS} partitions, made in "
        f"{time.perf_counter() - t0:.2f} s; cut from 32,768 docs for the run's time")
    pipe_a, pipe_b = fig_pipelines()
    secs = {}

    reset_launch_counts()            # phase 20's path starts here
    for name, pipe in (("a", pipe_a), ("b", pipe_b)):
        t0 = time.perf_counter()
        fitted = pipe.fit(raw)
        sync()
        secs[f"pipeline ({name}) fit"] = time.perf_counter() - t0
        if name == "a":
            fit_a = fitted
        else:
            fit_b = fitted
    blocks = [[texts[i] for i in idx] for idx in requests]
    served_a = serve_blocks(fit_a, blocks, FIG_REQ_MAX)
    served_b = serve_blocks(fit_b, blocks, FIG_REQ_MAX)
    got = launch_counts()            # ... and ends here
    steps = FIG_LOGREG["max_iter"] * (FIG_DOCS // SHARDS // FIG_LOGREG["local_batch_size"])
    # the fit one logreg_grad a step, the served path one logreg_margin a
    # microbatch
    want = {"kmeans_assign": FIG_ROUNDS + served_a["report"]["batches"],
            "logreg_grad": steps, "logreg_margin": served_b["report"]["batches"],
            "logreg_xt_z": 0}
    path = tuple(want)
    say(f"launches on phase 20's path: {got} (expected {want}; every other kernel 0); "
        f"logreg_grad by route {dict(logreg_grad_routes())}")
    check(all(got[k] == want[k] for k in path)
          and all(v == 0 for k, v in got.items() if k not in path)
          and set(logreg_grad_routes()) == {"one_pass"},
          f"phase 20 launched {got}, expected {want}, routes {dict(logreg_grad_routes())}")
    vocab = fit_a["ngrams"].vocab
    check(len(vocab) == FIG_TOP and vocab == fit_b["ngrams"].vocab,
          f"the vocabulary holds {len(vocab)} bigrams, not {FIG_TOP} (fewer distinct "
          f"bigrams in the corpus?), or differs between the pipelines")

    # ---- pipeline (b) against its hand-composed chain, stage by stage ----
    t0 = time.perf_counter()
    ngrams = NGrams(n=2, top=FIG_TOP, column="text").fit(raw)
    secs["NGrams fit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    count_table = ngrams.transform(raw)
    secs["host transform"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = count_table.to_numeric(num_shards=SHARDS, device=DEVICE)
    sync()
    secs["commit to the card"] = time.perf_counter() - t0
    del count_table
    t0 = time.perf_counter()
    tfidf = TfIdf().fit(counts, default_skip=(0,))
    scaled = tfidf.transform(counts)
    sync()
    secs["TfIdf"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    std = Standardizer().fit(scaled, default_skip=(0,))
    final = std.transform(scaled)
    sync()
    secs["Standardizer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hand = LogisticRegression(**FIG_LOGREG, use_kernel=True).fit(final)
    sync()
    secs["LogisticRegression fit"] = time.perf_counter() - t0
    check(ngrams.vocab == vocab and torch.equal(tfidf.idf, fit_b["tfidf"].idf)
          and torch.equal(std.shift, fit_b["standardizer"].shift)
          and torch.equal(std.scale, fit_b["standardizer"].scale)
          and torch.equal(hand.weights, fit_b.model.weights),
          "pipeline (b) differs from its hand-composed chain (vocabulary, IDF, "
          "shift, scale or weights)")
    check(tuple(counts.data.shape) == (FIG_DOCS, FIG_TOP + 1) and final.data.dtype == torch.float32
          and final.device.type == DEVICE and tuple(final.data.shape) == (FIG_DOCS, FIG_TOP + 1),
          f"table (b) {tuple(final.data.shape)} {final.data.dtype} {final.data.device}")
    errs = fig_fp64_errors(counts.data, scaled.data, fit_b)
    say(f"(b) against fp64 on the card: IDF {errs['idf']:.3g} (tol {FIG_TOL['idf']}), tf-idf "
        f"rows {errs['tfidf']:.3g} (tol {FIG_TOL['tfidf']}), shift {errs['shift']:.3g} (tol "
        f"{FIG_TOL['shift']}), scale {errs['scale']:.3g} (tol {FIG_TOL['scale']}, entry by "
        f"entry); label column idf/shift/scale {errs['label']}; pass-through columns "
        f"(fp64, fitted) {errs['passthrough']}")
    check(all(errs[k] <= FIG_TOL[k] for k in ("idf", "tfidf", "shift", "scale"))
          and errs["label"] == [0.0, 0.0, 1.0]
          and errs["passthrough"][0] == errs["passthrough"][1],
          f"(b)'s statistics against fp64: {errs}")
    del counts

    # ---- pipeline (a): the featurized table and the k-means fit ----
    t0 = time.perf_counter()
    table_a = fit_a.transform(raw)
    sync()
    secs["pipeline (a) transform"] = time.perf_counter() - t0
    check(tuple(table_a.data.shape) == (FIG_DOCS, FIG_TOP) and table_a.device.type == DEVICE
          and table_a.data.dtype == torch.float32
          and torch.equal(table_a.data, scaled.data[:, 1:])
          and torch.equal(fit_a["tfidf"].idf, tfidf.idf[1:]),
          "table (a) is not (b)'s tf-idf columns bitwise, or misshapen")
    del scaled
    C = fit_a.model.centroids
    init = KMeans(k=FIG_K, max_iter=0, seed=SEED).fit(table_a).centroids
    blocks = table_a.data.view(SHARDS, -1, FIG_TOP)
    e = (C - plain_lloyd(blocks, init, FIG_ROUNDS, assign=sliced_plain_assign)).abs().max().item()
    e_exp = (C - plain_lloyd(blocks, init, FIG_ROUNDS)).abs().max().item()
    check(bool(torch.isfinite(C).all()) and e <= 1e-3,
          f"(a)'s centroids vs plain rounds in the kernel's order: max abs err {e}")
    inertia = {}
    for sched in CollectiveSchedule:
        t0 = time.perf_counter()
        m = KMeans(k=FIG_K, max_iter=FIG_ROUNDS, seed=SEED, schedule=sched,
                   use_kernel=True).fit(table_a)
        sync()
        secs.setdefault("KMeans fit", time.perf_counter() - t0)
        inertia[sched.value] = m.inertia(table_a.data).item()
    spread = max(inertia.values()) - min(inertia.values())
    check(spread <= 1e-3 * max(inertia.values()), f"schedules disagree: {inertia}")
    offline_a = fit_a.model.predict(table_a.data)
    check(torch.equal(fit_a.predict(texts[:FIG_REPLAY]), offline_a[:FIG_REPLAY]),
          f"(a): fitted.predict of the first {FIG_REPLAY} raw docs differs from the "
          f"model's picks on the table")
    sizes = torch.bincount(offline_a.long(), minlength=FIG_K)
    say(f"(a): centroids vs plain rounds in the kernel's order max abs err {e:.3g}, vs the "
        f"expanded form's {e_exp:.3g}; inertia by schedule {inertia} (spread {spread:.3g}); "
        f"fitted.predict({FIG_REPLAY} raw docs) bitwise the model's picks on the table; "
        f"cluster sizes {sizes.min().item()}..{sizes.max().item()}")

    # ---- pipeline (b): the classifier ----
    offline_b = fit_b.model.predict(final.data[:, 1:])
    check(torch.equal(hand.predict(final.data[:, 1:]), offline_b),
          "(b)'s predictions differ from the hand-composed chain's")
    plain = LogisticRegression(**FIG_LOGREG, use_kernel=False).fit(final)
    e_w = rel_err(fit_b.model.weights, plain.weights)
    # the bound's upper side: the same plain fit on the table rounded to bf16
    rounded = MLNumericTable(final.data.to(torch.bfloat16).float(),
                             num_shards=final.num_shards, names=final.names)
    e_bf16 = rel_err(LogisticRegression(**FIG_LOGREG, use_kernel=False).fit(rounded).weights,
                     plain.weights)
    del rounded
    y = final.data[:, 0]
    acc = (offline_b == y).float().mean().item()
    plain_pred = plain.predict(final.data[:, 1:])
    acc_plain = (plain_pred == y).float().mean().item()
    say(f"(b): weights bitwise the hand-composed chain's; vs use_kernel=False rel err "
        f"{e_w:.3g} (tol {FIG_TOL['weights']}; the plain fit vs the same on the table "
        f"rounded to bf16 {e_bf16:.3g}); training accuracy {acc:.4f} (plain fit "
        f"{acc_plain:.4f}; {(plain_pred == offline_b).float().mean().item():.4f} of the "
        f"labels the same)")
    check(bool(torch.isfinite(fit_b.model.weights).all()) and e_w <= FIG_TOL["weights"],
          f"(b)'s weights vs use_kernel=False: rel err {e_w}")
    check(e_bf16 > FIG_TOL["weights"],
          f"the weights' bound does not see the fit on a bf16-rounded table: {e_bf16}")

    # ---- serving: every served result bitwise the offline prediction ----
    for name, served, offline in (("a", served_a, offline_a), ("b", served_b, offline_b)):
        host = offline.cpu().numpy()
        bad = sum(not np.array_equal(r, host[idx])
                  for idx, r in zip(requests, served["results"]))
        rep = served["report"]
        secs[f"serving ({name})"] = served["seconds"]
        say(f"({name}) served {len(requests)} raw-text requests of 1..{FIG_REQ_MAX} docs "
            f"({rep['rows_served']} rows) in {rep['batches']} microbatches of {FIG_REQ_MAX}: "
            f"latency median {float(np.median(served['latencies'])):.3f} ms, max "
            f"{max(served['latencies']):.3f} ms; memo hits {rep['featurize_hits']}, misses "
            f"{rep['featurize_misses']}; {bad} requests differ from the offline prediction")
        check(bad == 0, f"({name}): {bad} served results differ from the offline prediction")

    w_b = fit_b.model.weights
    say("stage seconds (host clock, each ended by a sync; the NGrams, TfIdf, Standardizer "
        "and LogisticRegression stages of (b)'s hand-composed chain, which makes the "
        "pipeline's calls): " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    peak = mem_peak("phase 20")
    # what phase 24 (e2) and (e3) hold their mesh fits and services to
    hashes = dict(fig_hashes(fit_a, fit_b),
                  **{f"{k}/served": np_sha(np.concatenate(s["results"]))
                     for k, s in (("a", served_a), ("b", served_b))})
    return {"kernels": {name: {"launches": got[name]} for name in path},
            "times": lambda: fig_kernel_times(table_a, C, final, w_b),
            "hashes": hashes,
            "tables": {"table_a": table_a, "C": C, "final": final, "w": w_b},
            "seconds": secs, "peak_gb": peak,
            "latency_ms": {k: float(np.median(s["latencies"]))
                           for k, s in (("a", served_a), ("b", served_b))}}


# --------------------------------------------------------------------------- #
# phase 22: streaming epochs, atomic checkpoints and exact kill-and-resume
# --------------------------------------------------------------------------- #
class KillAt:
    """The reference's ChaosInjector pattern (its chaos harness is not
    ported): a stream wrapper that sends this process SIGKILL when the
    stream is asked for window ``step`` — an uncatchable preemption, with
    the snapshots before it on disk."""

    def __init__(self, stream, step: int):
        self.stream, self.kill = stream, step

    def __getattr__(self, name):
        return getattr(self.stream, name)

    def __iter__(self):
        return self

    def __next__(self):
        if self.stream.step == self.kill:
            import signal

            os.kill(os.getpid(), signal.SIGKILL)
        return next(self.stream)


class StoreTimes:
    """Host seconds of every snapshot write (``save_checkpoint``) and
    restore (``restore_with_metadata``) while the block runs: the store's
    functions are wrapped, and the runner and the pipeline look them up at
    each call."""

    def __enter__(self):
        from repro_torch.checkpoint import store

        self.store, self.saves, self.restores = store, [], []
        self.orig = (store.save_checkpoint, store.restore_with_metadata)

        def timed(fn, into):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                into.append(time.perf_counter() - t0)
                return out
            return call

        store.save_checkpoint = timed(self.orig[0], self.saves)
        store.restore_with_metadata = timed(self.orig[1], self.restores)
        return self

    def __exit__(self, *exc):
        self.store.save_checkpoint, self.store.restore_with_metadata = self.orig

    def line(self) -> str:
        ms = [1e3 * t for t in self.saves]
        return (f"{len(ms)} snapshot writes, median {float(np.median(ms)) if ms else 0:.2f} "
                f"ms (max {max(ms, default=0):.2f}); {len(self.restores)} restores, "
                f"{1e3 * sum(self.restores):.2f} ms in all")


def pool_source(pool: torch.Tensor):
    """A stream source over a pool of windows: window ``step mod len(pool)``,
    a read-only slice of the pool (pinned on the card's machine, so the
    copy to the card is non-blocking; nothing overwrites the pool)."""
    return lambda step: {"data": pool[step % pool.shape[0]]}


def pinned(shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, pin_memory=DEVICE == "cuda")


def stream_logreg_pool() -> torch.Tensor:
    """Phase 22 (a)'s pool: STREAM_LR_POOL windows of STREAM_LR_ROWS x (1 +
    LOGREG_FEATURES) fp32, each made on the card as logreg_rows makes its
    table (ReLU'd gaussian features, labels from a planted linear model
    split at the window's median) and copied to pinned host memory; the
    generator is seeded SEED + 22, so a child process makes the same bits."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    n, d = STREAM_LR_ROWS, LOGREG_FEATURES
    pool = pinned((STREAM_LR_POOL, n, d + 1))
    w_true = torch.randn(d, generator=gen, device=DEVICE) / math.sqrt(d)
    window = torch.empty((n, d + 1), dtype=torch.float32, device=DEVICE)
    for i in range(STREAM_LR_POOL):
        window[:, 1:].normal_(generator=gen).clamp_(min=0.0)
        margin = window[:, 1:] @ w_true
        window[:, 0] = (margin > margin.median()).float()
        pool[i].copy_(window)
    sync()
    return pool


def stream_kmeans_pool() -> torch.Tensor:
    """Phase 22 (b)'s pool: STREAM_KM_POOL windows of STREAM_KM_ROWS x
    KMEANS_FEATURES fp32 made on the card as kmeans_table makes its table,
    in pinned host memory."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    pool = pinned((STREAM_KM_POOL, STREAM_KM_ROWS, KMEANS_FEATURES))
    window = torch.empty(pool.shape[1:], dtype=torch.float32, device=DEVICE)
    for i in range(STREAM_KM_POOL):
        pool[i].copy_(window.normal_(generator=gen).clamp_(min=0.0))
    sync()
    return pool


def stream_logreg_fit(pool, epochs: int, ckpt=None, resume: bool = False,
                      use_kernel: bool = True, kill=None):
    """LogisticRegression.fit_stream over ``pool``'s windows (phase 22 (a));
    returns the weights and the stream."""
    from repro_torch.core.algorithms.logistic_regression import LogisticRegression
    from repro_torch.data import BatchIterator

    stream = BatchIterator(pool_source(pool), device=DEVICE)
    model = LogisticRegression(**STREAM_LR, use_kernel=use_kernel).fit_stream(
        stream if kill is None else KillAt(stream, kill), num_epochs=epochs,
        num_shards=SHARDS, chunks_per_epoch=STREAM_CHUNKS, checkpoint=ckpt, resume=resume)
    return model.weights, stream


def stream_child(ckpt_dir: str) -> int:
    """``python3 chip_smoke.py --stream-child DIR``: leg 2 of phase 22 (a).
    It makes the pool from the seed and runs leg 1's fit with a snapshot
    every epoch into DIR; its stream sends it SIGKILL when asked for window
    STREAM_KILL, so it never returns."""
    from repro_torch.core.runner import CheckpointPolicy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    pool = stream_logreg_pool()
    print(f"stream child: pool made in {time.perf_counter() - t0:.2f} s", flush=True)
    stream_logreg_fit(pool, STREAM_LR_EPOCHS, ckpt=CheckpointPolicy(ckpt_dir, every_epochs=1),
                      kill=STREAM_KILL)
    print("stream child: the SIGKILL did not fire", flush=True)
    return 3


def stream_child_cmd(ckpt_dir: str) -> list:
    """The command of leg 2's child process."""
    return [sys.executable, os.path.abspath(__file__), "--stream-child", ckpt_dir]


def h2d_gbps(window: torch.Tensor) -> float:
    """Host→device GB/s of one window's copy from the pool (CUDA events
    around a non-blocking copy from pinned memory)."""
    dst = torch.empty(window.shape, dtype=window.dtype, device=DEVICE)
    ms = cuda_ms(lambda: dst.copy_(window, non_blocking=True), 3)
    return window.numel() * window.element_size() / ms / 1e6


def start_fit_cli(ckpt_dir: str, procs: list):
    """Part (d): ``python -m repro_torch.launch.fit --algorithm kmeans`` at
    its default sizes with ``--ckpt-dir``, then again with ``--resume``, in
    child processes one after the other, beside the phases that run
    meanwhile (a thread waits for them); returns the future of their
    outputs."""
    import concurrent.futures

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "repro_torch.launch.fit", "--algorithm", "kmeans",
           "--ckpt-dir", ckpt_dir]

    def run():
        outs = []
        for extra in ([], ["--resume"]):
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd + extra, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            procs.append(proc)
            out, _ = proc.communicate(timeout=180)
            outs.append((proc.returncode, out, time.perf_counter() - t0))
            if proc.returncode:
                break
        return outs

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run)
    pool.shutdown(wait=False)
    return future


def stream_part_a(work: str, procs: list, out: dict) -> None:
    """Part (a): the 160,000-feature logistic regression streamed; leg 2
    (the child, started first) runs beside legs 1 and the plain run."""
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.core.runner import CheckpointPolicy

    killed_dir, leg1_dir = os.path.join(work, "a-killed"), os.path.join(work, "a-leg1")
    log = open(os.path.join(work, "a-child.log"), "w")
    child = subprocess.Popen(stream_child_cmd(killed_dir), stdout=log, stderr=subprocess.STDOUT)
    procs.append(child)
    t0 = time.perf_counter()
    pool = stream_logreg_pool()
    t_pool = time.perf_counter() - t0
    window_gb = pool[0].numel() * 4 / 1e9
    mem_reset()
    with StoreTimes() as st1:
        t0 = time.perf_counter()
        w1, s1 = stream_logreg_fit(pool, STREAM_LR_EPOCHS,
                                   ckpt=CheckpointPolicy(leg1_dir, every_epochs=4))
        sync()
        t_leg1 = time.perf_counter() - t0
    check(s1.step == STREAM_LR_EPOCHS and latest_step(leg1_dir) == STREAM_LR_EPOCHS,
          f"leg 1 ended at step {s1.step}, snapshot {latest_step(leg1_dir)}")
    # leg 1's weights after STREAM_PLAIN_EPOCHS epochs against the plain path
    w4, _ = restore_checkpoint(leg1_dir, w1, step=STREAM_PLAIN_EPOCHS, device=DEVICE)
    plain, _ = stream_logreg_fit(pool, STREAM_PLAIN_EPOCHS, use_kernel=False)
    e_plain = rel_err(w4, plain)
    check(bool(torch.isfinite(w1).all()) and e_plain <= 1e-3,
          f"(a) weights after {STREAM_PLAIN_EPOCHS} epochs vs use_kernel=False: rel err {e_plain}")
    out["a"] = dict(pool=pool, w1=w1, child=child, log=log, killed_dir=killed_dir,
                    window_gb=window_gb)
    mem_peak("phase 22 (a), leg 1")
    say(f"(a) pool {STREAM_LR_POOL} x {STREAM_LR_ROWS} x {LOGREG_FEATURES + 1} fp32 "
        f"({STREAM_LR_POOL * window_gb:.2f} GB pinned) made in {t_pool:.2f} s; leg 1: "
        f"{STREAM_LR_EPOCHS} epochs in {t_leg1:.2f} s ({t_leg1 / STREAM_LR_EPOCHS:.4f} s an "
        f"epoch, {window_gb * STREAM_LR_EPOCHS / t_leg1:.2f} GB/s of windows, with the "
        f"child on the card beside it); {st1.line()}; weights after "
        f"{STREAM_PLAIN_EPOCHS} epochs vs use_kernel=False rel err {e_plain:.3g} (tol 1e-3)")


def stream_part_a_resume(out: dict) -> None:
    """Legs 2 (the child's end) and 3 of part (a)."""
    from repro_torch.checkpoint import latest_step, load_metadata
    from repro_torch.core.runner import CheckpointPolicy

    a = out["a"]
    rc = a["child"].wait(timeout=300)
    a["log"].close()
    with open(a["log"].name) as f:
        child_log = f.read().strip()
    check(rc == -9, f"(a) the child ended with rc {rc}, not -9 (SIGKILL): {child_log[-2000:]}")
    newest = latest_step(a["killed_dir"])
    meta = load_metadata(a["killed_dir"])
    check(newest == STREAM_KILL and meta["epoch"] == STREAM_KILL
          and meta["stream_step"] == STREAM_KILL,
          f"(a) the newest snapshot is step {newest}, {meta}")
    mem_reset()
    with StoreTimes() as st3:
        t0 = time.perf_counter()
        w3, s3 = stream_logreg_fit(a["pool"], STREAM_LR_EPOCHS,
                                   ckpt=CheckpointPolicy(a["killed_dir"]), resume=True)
        sync()
        t_leg3 = time.perf_counter() - t0
    check(s3.step == STREAM_LR_EPOCHS and torch.equal(w3, a["w1"]),
          f"(a) the resumed weights differ from leg 1's (max abs "
          f"{(w3 - a['w1']).abs().max().item()}), or the stream ended at {s3.step}")
    gbps = h2d_gbps(a["pool"][0])
    epochs3 = STREAM_LR_EPOCHS - STREAM_KILL
    mem_peak("phase 22 (a), leg 3")
    say(f"(a) leg 2: the child died of SIGKILL (rc {rc}) asked for window {STREAM_KILL}; "
        f"newest snapshot epoch {meta['epoch']}, stream step {meta['stream_step']} "
        f"({child_log.splitlines()[0] if child_log else 'no output'}); leg 3: resumed "
        f"{epochs3} epochs in {t_leg3:.2f} s ({t_leg3 / epochs3:.4f} s an epoch, restore "
        f"{1e3 * sum(st3.restores):.2f} ms; {st3.line()}); weights bitwise leg 1's; "
        f"host->device {gbps:.2f} GB/s (one {a['window_gb']:.2f} GB window from pinned "
        f"memory, CUDA events)")


def stream_part_b(out: dict) -> None:
    """Part (b): k-means streamed at d = 4,096, k = KMEANS_K, stopped with a
    snapshot at STREAM_KM_STOP and resumed."""
    import tempfile

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core.algorithms.kmeans import KMeans
    from repro_torch.core.runner import CheckpointPolicy
    from repro_torch.data import BatchIterator

    t0 = time.perf_counter()
    pool = stream_kmeans_pool()
    t_pool = time.perf_counter() - t0
    mem_reset()

    def fit(epochs, ckpt=None, resume=False):
        stream = BatchIterator(pool_source(pool), device=DEVICE)
        return KMeans(k=KMEANS_K, use_kernel=True).fit_stream(
            stream, num_epochs=epochs, num_shards=SHARDS, chunks_per_epoch=STREAM_CHUNKS,
            checkpoint=ckpt, resume=resume).centroids

    t0 = time.perf_counter()
    straight = fit(STREAM_KM_EPOCHS)
    sync()
    t_straight = time.perf_counter() - t0
    work = tempfile.mkdtemp(prefix="chip_smoke_kmeans_")
    with StoreTimes() as st:
        fit(STREAM_KM_STOP, CheckpointPolicy(work))
        t0 = time.perf_counter()
        resumed = fit(STREAM_KM_EPOCHS, CheckpointPolicy(work), resume=True)
        sync()
        t_resume = time.perf_counter() - t0
    check(bool(torch.isfinite(straight).all()) and torch.equal(resumed, straight),
          f"(b) resumed centroids differ from the uninterrupted run's: max abs "
          f"{(resumed - straight).abs().max().item()}")
    C4, _ = restore_checkpoint(work, straight, step=STREAM_KM_STOP, device=DEVICE)
    window = pool[STREAM_KM_STOP % STREAM_KM_POOL].to(DEVICE)
    chunk = window.view(SHARDS, -1, KMEANS_FEATURES)[:, :STREAM_KM_ROWS // SHARDS // STREAM_CHUNKS]
    window_gb = pool[0].numel() * 4 / 1e9
    gbps = h2d_gbps(pool[0])
    out["b"] = dict(chunk=chunk, C4=C4, work=work)
    mem_peak("phase 22 (b)")
    epochs = STREAM_KM_EPOCHS - STREAM_KM_STOP
    say(f"(b) pool {STREAM_KM_POOL} x {STREAM_KM_ROWS} x {KMEANS_FEATURES} fp32 "
        f"({STREAM_KM_POOL * window_gb:.2f} GB pinned) made in {t_pool:.2f} s; "
        f"{STREAM_KM_EPOCHS} epochs in {t_straight:.2f} s ({t_straight / STREAM_KM_EPOCHS:.4f} "
        f"s an epoch); stopped at epoch {STREAM_KM_STOP} and resumed: {epochs} epochs in "
        f"{t_resume:.2f} s (restore {1e3 * sum(st.restores):.2f} ms; {st.line()}); "
        f"centroids bitwise the uninterrupted run's; host->device {gbps:.2f} GB/s")


def stream_part_c(out: dict) -> None:
    """Part (c): Fig. A2's demo 3 at its widths — NGrams(n=2, top=FIG_TOP)
    -> TfIdf -> KMeans(k=FIG_K) fitted from a stream, preempted at
    STREAM_FIG_STOP and resumed, then saved, loaded and served."""
    import tempfile

    from repro_torch.core.algorithms.kmeans import KMeans
    from repro_torch.core.mltable import MLTable
    from repro_torch.features import NGrams, TfIdf
    from repro_torch.pipeline import Pipeline

    def pipe():
        return Pipeline([NGrams(n=2, top=FIG_TOP, column="text", keep_columns=False),
                         TfIdf(), KMeans(k=FIG_K, seed=SEED, use_kernel=True)],
                        num_shards=SHARDS, device=DEVICE)

    mem_reset()
    rows = fig_corpus(SEED, STREAM_FIG_DOCS)
    texts = [t for _, t in rows]
    raw = MLTable.from_rows(rows, names=["label", "text"], num_partitions=SHARDS)
    kw = dict(chunks_per_epoch=STREAM_FIG_CHUNKS)
    secs = {}
    t0 = time.perf_counter()
    straight = pipe().fit_stream(raw, num_epochs=STREAM_FIG_EPOCHS, **kw)
    sync()
    secs["uninterrupted fit_stream"] = time.perf_counter() - t0
    vocab = straight["ngrams"].vocab
    check(len(vocab) == FIG_TOP, f"(c) the vocabulary holds {len(vocab)} bigrams, not {FIG_TOP}")
    work = tempfile.mkdtemp(prefix="chip_smoke_fig_")
    ckdir, artifact = os.path.join(work, "ck"), os.path.join(work, "artifact")
    with StoreTimes() as st:
        t0 = time.perf_counter()
        pipe().fit_stream(raw, num_epochs=STREAM_FIG_STOP, checkpoint=ckdir, **kw)
        sync()
        secs["preempted fit_stream"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = pipe().fit_stream(raw, num_epochs=STREAM_FIG_EPOCHS, checkpoint=ckdir,
                                    resume=True, **kw)
        sync()
        secs["resume"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        straight.save(artifact)
        secs["save"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = pipe().load(artifact)
        secs["load"] = time.perf_counter() - t0
    C = straight.model.centroids
    check(resumed["ngrams"].vocab == vocab and torch.equal(resumed.model.centroids, C)
          and torch.equal(resumed["tfidf"].idf, straight["tfidf"].idf),
          f"(c) the resumed pipeline differs from the uninterrupted one (centroids max abs "
          f"{(resumed.model.centroids - C).abs().max().item()})")
    check(loaded["ngrams"].vocab == vocab and torch.equal(loaded.model.centroids, C)
          and torch.equal(loaded["tfidf"].idf, straight["tfidf"].idf)
          and loaded.model.centroids.device.type == DEVICE,
          "(c) the loaded pipeline differs from the saved one")
    requests = fig_requests()
    t0 = time.perf_counter()
    offline = straight.predict(texts[:FIG_SERVE_POOL]).cpu().numpy()
    secs["offline predict"] = time.perf_counter() - t0
    served = serve_blocks(loaded, [[texts[i] for i in idx] for idx in requests], FIG_REQ_MAX)
    bad = sum(not np.array_equal(r, offline[idx]) for idx, r in zip(requests, served["results"]))
    check(bad == 0, f"(c) {bad} requests served by the loaded pipeline differ from the fitted "
          f"pipeline's offline predictions")
    out["c"] = dict(served=served, table=resumed, raw=raw, work=work)
    mem_peak("phase 22 (c)")
    rep = served["report"]
    say(f"(c) {STREAM_FIG_DOCS} docs, vocabulary {len(vocab)} bigrams, {STREAM_FIG_EPOCHS} "
        f"epochs of {STREAM_FIG_CHUNKS} rounds (the window is the featurized table on the "
        f"card, so no epoch copies it): preempted at epoch {STREAM_FIG_STOP} and resumed "
        f"bitwise (featurizers restored, not refit); save -> load exact; "
        f"{len(requests)} raw-text requests ({rep['rows_served']} docs, {rep['batches']} "
        f"microbatches) through ModelPredictor(loaded) bitwise the offline predictions, "
        f"latency median {float(np.median(served['latencies'])):.3f} ms; {st.line()}; "
        f"seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))


def stream_part_d(future) -> None:
    """Part (d)'s two launcher runs: the second must resume."""
    outs = future.result(timeout=300)
    check(len(outs) == 2 and all(rc == 0 for rc, _, _ in outs),
          f"(d) launch.fit failed: {[(rc, out[-1500:]) for rc, out, _ in outs]}")
    (_, first, t1), (_, second, t2) = outs
    check("resuming from step " in second and "on cuda" in first,
          f"(d) the --resume run did not resume, or ran off the card: {second[-1500:]}")
    line = next(ln for ln in second.splitlines() if ln.startswith("resuming from step"))
    say(f"(d) python -m repro_torch.launch.fit --algorithm kmeans --ckpt-dir D: {t1:.2f} s "
        f"({first.splitlines()[0]}); again with --resume: {t2:.2f} s, '{line.split(' in ')[0]}'")


def stream_kernel_times(out: dict) -> dict:
    """Kernels 1-3 at phase 22's shapes (logreg_pair_times,
    kmeans_shape_row): logreg_margin and logreg_xt_z at (a)'s chunk
    (SHARDS, local batch, LOGREG_FEATURES) of a window on the card (row
    stride 1 + d, partition stride rows/P·(1 + d)); kmeans_assign at (b)'s
    chunk and at (c)'s (SHARDS, docs/P/chunks, FIG_TOP); (b)'s picks on the
    centroids of its epoch-STREAM_KM_STOP snapshot also held against
    use_kernel=False's (the direct form) as phase 7 holds a Lloyd round:
    near-ties only."""
    from repro_torch.core.algorithms import kmeans as km
    from repro_torch.kernels import kmeans_assign as kka

    a = out["a"]
    bs = STREAM_LR["local_batch_size"]
    blocks = a["pool"][0].to(DEVICE).view(SHARDS, -1, LOGREG_FEATURES + 1)
    times = logreg_pair_times("phase 22 (a)'s chunk", blocks[:, :bs, 1:],
                              blocks[:, :bs, 0].contiguous(),
                              a["w1"].expand(SHARDS, -1).contiguous())
    del blocks

    chunk, C4 = out["b"]["chunk"], out["b"]["C4"]
    times["kmeans_assign"] = kmeans_shape_row("phase 22 (b)'s chunk", chunk, C4)
    ties, gap, ratio = score_gap(chunk, C4, kka.kmeans_assign(chunk, C4),
                                 km._assign(chunk, C4, use_kernel=False))
    check(ratio <= 1.0, f"(b) a streamed round's picks: {ties} differ from use_kernel=False's "
          f"beyond rounding (gap {gap}, {ratio}x the scale)")
    c = out["c"]
    table = c["table"].transform(c["raw"]).data
    fchunk = table.view(SHARDS, -1, FIG_TOP)[:, :STREAM_FIG_DOCS // SHARDS // STREAM_FIG_CHUNKS]
    fig = kmeans_shape_row("phase 22 (c)'s chunk", fchunk, c["table"].model.centroids)
    times["kmeans_assign"]["fig_a2_stream"] = fig
    for name, r in list(times.items()) + [("kmeans_assign", fig)]:
        if name != "logreg_grad":    # grad_bars printed it
            say_kernel_row(name, r)
    say(f"(b) a streamed round's picks (epoch {STREAM_KM_STOP}'s first chunk on its snapshot's "
        f"centroids) vs use_kernel=False's direct form: {ties} differ, each a near-tie (gap "
        f"{gap:.3g}, {ratio:.3g}x the fp32 scale)")
    return times


class FitCLI:
    """Part (d)'s two launcher runs (``start_fit_cli``), started with phase
    20 beside the other phases' children (each child spends ≈ 8-15 s
    reaching the card); phase 22 reads the results.  ``close`` stops
    whatever still runs and removes the work directory."""

    def __init__(self):
        import tempfile

        self.work = tempfile.mkdtemp(prefix="chip_smoke_fit_")
        self.procs: list = []
        self.future = start_fit_cli(os.path.join(self.work, "d"), self.procs)

    def close(self) -> None:
        import shutil

        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.work, ignore_errors=True)


def phase_stream(fit_cli: FitCLI) -> dict:
    """Phase 22: streaming epochs with atomic checkpoints and exact
    kill-and-resume on kernels 1-3 at the paper's widths.  Returns each
    kernel's launches on this path, and under "times" the call that holds
    and times the kernels at its shapes (made in phase 25)."""
    import shutil
    import tempfile

    from repro_torch.kernels import launch_counts, reset_launch_counts

    phase(f"22. streaming + checkpoint: logreg {STREAM_LR_ROWS:,}-row windows x "
          f"{LOGREG_FEATURES:,} (SIGKILL at step {STREAM_KILL}), k-means {STREAM_KM_ROWS:,} x "
          f"{KMEANS_FEATURES:,} k={KMEANS_K}, Fig. A2 demo 3 on {STREAM_FIG_DOCS:,} docs, "
          f"launch.fit --resume")
    work = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    procs, out = [], {}
    try:
        reset_launch_counts()        # phase 22's path starts here
        stream_part_a(work, procs, out)
        stream_part_b(out)
        stream_part_c(out)
        stream_part_a_resume(out)
        got = launch_counts()        # ... and ends here
        stream_part_d(fit_cli.future)
        lr_steps = (2 * STREAM_LR_EPOCHS - STREAM_KILL) * STREAM_CHUNKS * (
            STREAM_LR_ROWS // SHARDS // STREAM_CHUNKS // STREAM_LR["local_batch_size"])
        fig_rounds = 2 * STREAM_FIG_EPOCHS * STREAM_FIG_CHUNKS
        want = {"logreg_grad": lr_steps, "logreg_margin": 0, "logreg_xt_z": 0,
                "kmeans_assign": 2 * STREAM_KM_EPOCHS * STREAM_CHUNKS + fig_rounds
                + out["c"]["served"]["report"]["batches"] + 1}
        path = tuple(want)
        say(f"launches on phase 22's path (this process; the children's are their own): "
            f"{got} (expected {want}; every other kernel 0); logreg_grad by route "
            f"{dict(logreg_grad_routes())}")
        check(all(got[k] == want[k] for k in path)
              and all(v == 0 for k, v in got.items() if k not in path)
              and set(logreg_grad_routes()) == {"one_pass"},
              f"phase 22 launched {got}, expected {want}, routes {dict(logreg_grad_routes())}")
        kept = {"a": {"pool": out["a"]["pool"][:1].clone(), "w1": out["a"]["w1"]},
                "b": {k: out["b"][k] for k in ("chunk", "C4")},
                "c": {k: out["c"][k] for k in ("table", "raw")}}
        return {"kernels": {name: {"launches": got[name]} for name in path},
                "times": lambda: stream_kernel_times(kept)}
    finally:
        if "a" in out:
            out["a"]["log"].close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for part in ("b", "c"):
            if part in out:
                shutil.rmtree(out[part]["work"], ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
        out.clear()
        free_device_memory()


# --------------------------------------------------------------------------- #
# phase 23: model search
# --------------------------------------------------------------------------- #
def timed(fn):
    """``(fn(), seconds)`` on the host clock, ended by a sync."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def same_trials(a, b) -> bool:
    """Two searches' trials equal bit for bit: configs, rung scores,
    stopped flags and states."""
    return len(a.trials) == len(b.trials) and all(
        x.index == y.index and x.config == y.config and x.rung_scores == y.rung_scores
        and x.stopped == y.stopped and torch.equal(x.state, y.state)
        for x, y in zip(a.trials, b.trials))


#: part (f)'s mesh run: launch.tune on 2 host processes of 2 partitions on
#: this card (gloo), against this process's run of the same flags
SEARCH_CLI_HOSTS = ["--schedule", "gather_broadcast", "--hosts", "2", "--devices-per-host",
                    "2", "--device", "cuda"]


def start_tune_cli(work: str, procs: list):
    """Part (f): ``python -m repro_torch.launch.tune`` with --ckpt-dir and
    --kill-after-trial SEARCH_CLI_KILL in a child process on the card, then
    again with --resume, one after the other (a thread waits for them);
    beside them, in a second thread, the same flags with SEARCH_CLI_HOSTS
    (a launcher and its two host processes).  Returns the futures of their
    outputs: ``(kill and resume, hosts)``."""
    import concurrent.futures

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "repro_torch.launch.tune", *SEARCH_CLI_ARGS]

    def launch(args):
        t0 = time.perf_counter()
        proc = subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append(proc)
        out, _ = proc.communicate(timeout=180)
        return proc.returncode, out, time.perf_counter() - t0

    def run():
        return [launch(cmd + ["--ckpt-dir", os.path.join(work, "f"), *extra])
                for extra in (["--kill-after-trial", str(SEARCH_CLI_KILL)], ["--resume"])]

    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = (pool.submit(run), pool.submit(lambda: launch(cmd + SEARCH_CLI_HOSTS)))
    pool.shutdown(wait=False)
    return futures


def search_part_a(gen, out: dict) -> None:
    """Part (a): the grid at 160,000 features, stacked and sequential under
    the three schedules, each trial against its fit; then a median-rule
    search with record_evaluation."""
    from repro_torch.core.algorithms.logistic_regression import LogisticRegression
    from repro_torch.core.numeric_table import MLNumericTable
    from repro_torch.eval.metrics import MetricHistory
    from repro_torch.tune import (MedianStoppingRule, ModelSearch, fold_view, grid,
                                  holdout_split, record_evaluation)

    mem_reset()
    (data, t_table) = timed(lambda: logreg_rows(slice(0, SEARCH_ROWS), SEARCH_ROWS))
    table = MLNumericTable(data, num_shards=SHARDS)
    configs = [{**c, **SEARCH_LR} for c in grid(SEARCH_GRID)]
    kw = dict(num_epochs=SEARCH_EPOCHS, chunks_per_epoch=1, val_fraction=0.25, seed=SEED)
    runs, secs = {}, {}
    for sched in ("allreduce", "gather_broadcast", "reduce_scatter"):
        for mode in ("stacked", "sequential"):
            runs[sched, mode], secs[sched, mode] = timed(lambda: ModelSearch(
                "logreg", configs, schedule=sched, execution=mode, **kw).run(table))
    ref = runs["allreduce", "stacked"]
    best = {key: r.best.config for key, r in runs.items()}
    spread = max(abs(a - b) for r in runs.values() for a, b in zip(r.scores, ref.scores))
    tr, _ = holdout_split(SEARCH_ROWS, 0.25, seed=SEED)
    view = fold_view(table, tr)
    errs, bitwise, t_fits = [], 0, 0.0
    for t in ref.trials:
        solo, secs_fit = timed(lambda: LogisticRegression(
            max_iter=SEARCH_EPOCHS, schedule="allreduce", **t.config).fit(view))
        t_fits += secs_fit
        errs.append(rel_err(t.state, solo.weights))
        bitwise += int(torch.equal(t.state, solo.weights))
    del view
    # the median rule: a frozen lane keeps its bits (a stopped trial's final
    # state is its state at the rung it was stopped at, read by a
    # rung-boundary callback), the history is the rung scores
    history, seen = MetricHistory(), []

    def watch(env):
        if env.evals:                # a rung boundary (not an epoch inside one)
            seen.append(env.state.clone())
    med_configs = [{"learning_rate": lr, **SEARCH_LR} for lr in SEARCH_MEDIAN_LRS]
    med, t_med = timed(lambda: ModelSearch(
        "logreg", med_configs, execution="stacked", rung_epochs=1, metric="log_loss",
        early_stop=MedianStoppingRule(), callbacks=(record_evaluation(history), watch),
        **kw).run(table))
    stopped = [t for t in med.trials if t.stopped]
    frozen = sum(len(seen) - len(t.rung_scores) for t in stopped)
    out["a"] = dict(seconds=secs)
    peak = mem_peak("phase 23 (a): the table, its train and validation views")
    n = len(configs)
    say(f"(a) table {SEARCH_ROWS:,} x {LOGREG_FEATURES + 1:,} fp32 ({data.numel() * 4 / 1e9:.2f} "
        f"GB) made in {t_table:.3f} s; {n} configs x {SEARCH_EPOCHS} epochs: "
        + "; ".join(f"{s} stacked {secs[s, 'stacked']:.3f} s ({n / secs[s, 'stacked']:.2f} "
                    f"trials/s), sequential {secs[s, 'sequential']:.3f} s "
                    f"({n / secs[s, 'sequential']:.2f} trials/s)"
                    for s in ("allreduce", "gather_broadcast", "reduce_scatter")))
    say(f"(a) stacked against sequential bitwise under each schedule: "
        f"{[same_trials(runs[x, 'stacked'], runs[x, 'sequential']) for x in ('allreduce', 'gather_broadcast', 'reduce_scatter')]}; "
        f"best {ref.best.config} (score {ref.best.score:.6f}); bests {len(set(json.dumps(b, sort_keys=True) for b in best.values()))} "
        f"distinct over the six runs; scores {fmt(ref.scores)}, spread "
        f"across schedules {spread:.3g} (tol {SEARCH_SCORE_TOL}); each trial against "
        f"LogisticRegression(**config).fit on the train view: max rel err {max(errs):.3g} "
        f"(tol {SEARCH_FIT_TOL}), {bitwise} of {n} bitwise; the {n} fits {t_fits:.3f} s")
    for sched in ("allreduce", "gather_broadcast", "reduce_scatter"):
        check(same_trials(runs[sched, "stacked"], runs[sched, "sequential"]),
              f"(a) {sched}: stacked differs from sequential")
    check(len({json.dumps(b, sort_keys=True) for b in best.values()}) == 1,
          f"(a) the best config differs between runs: {best}")
    check(spread <= SEARCH_SCORE_TOL, f"(a) scores across schedules {spread}")
    check(max(errs) <= SEARCH_FIT_TOL, f"(a) a trial against its fit: {errs}")
    say(f"(a) median rule over lr {fmt(SEARCH_MEDIAN_LRS)}, one epoch a rung, negated "
        f"log loss: rung scores {[fmt(t.rung_scores) for t in med.trials]}; "
        f"{len(stopped)} of {len(med.trials)} stopped, their lanes frozen for {frozen} "
        f"rungs; best {med.best.config}; {t_med:.3f} s; peak {peak:.2f} GB (the table "
        f"{data.numel() * 4 / 1e9:.2f} GB, its fold views the same again)")
    check(frozen >= 1, "(a) the median rule froze no lane")
    for t in stopped:
        check(torch.equal(seen[len(t.rung_scores) - 1][t.index], t.state),
              f"(a) the frozen lane of trial {t.index} moved")
    check(all([v for _, v in history.series(t.index, "log_loss")] == t.rung_scores
               for t in med.trials), "(a) the recorded history differs from the rung scores")
    out["table"] = table


def search_part_b(out: dict) -> None:
    """Part (b): ASHA over SEARCH_ASHA_SAMPLES sampled configs on (a)'s
    table, stacked and sequential."""
    from repro_torch.tune import AsyncSuccessiveHalving, ModelSearch, sample

    table = out.pop("table")
    configs = [{**c, **SEARCH_LR} for c in
               sample(SEARCH_ASHA_SPACE, SEARCH_ASHA_SAMPLES, seed=SEED)]
    rule = AsyncSuccessiveHalving(reduction_factor=3, min_rounds=1, slots=SEARCH_ASHA_SLOTS)
    runs, secs = {}, {}
    for mode in ("stacked", "sequential"):
        runs[mode], secs[mode] = timed(lambda: ModelSearch(
            "logreg", configs, num_epochs=SEARCH_ASHA_EPOCHS, execution=mode,
            early_stop=rule, seed=SEED).run(table))
    a, b = runs["stacked"], runs["sequential"]
    check(same_trials(a, b), "(b) ASHA: stacked and sequential differ")
    ladder = rule.rung_epochs(SEARCH_ASHA_EPOCHS)
    finished = [t for t in a.trials if not t.stopped]
    check(finished and all(len(t.rung_scores) == len(ladder) for t in finished),
          f"(b) a finisher without {len(ladder)} rung scores")
    slot_epochs = sum(ladder[len(t.rung_scores) - 1] for t in a.trials)
    say(f"(b) ASHA (rf 3, {SEARCH_ASHA_SLOTS} slots, rungs {ladder}) over "
        f"{len(configs)} sampled configs: {len(a.trials)} trials evaluated, "
        f"{len(finished)} finished, {slot_epochs} slot-epochs "
        f"(of {len(configs) * SEARCH_ASHA_EPOCHS} for the whole pool); stacked "
        f"{secs['stacked']:.3f} s, sequential {secs['sequential']:.3f} s, the same "
        f"(trial, rungs, stopped) sequence, scores bitwise; best {a.best.config} "
        f"({a.best.score:.6f})")
    out["b"] = dict(seconds=secs, slot_epochs=slot_epochs)
    del table
    free_device_memory()


def search_part_c(gen, out: dict) -> None:
    """Part (c): k-means at d = 4,096 over SEARCH_KM_GRID (two stacked
    units of 4 lanes), stacked against sequential."""
    from repro_torch.core.numeric_table import MLNumericTable
    from repro_torch.tune import ModelSearch, grid

    mem_reset()
    data = kmeans_table(gen, SEARCH_KM_ROWS)
    table = MLNumericTable(data, num_shards=SHARDS)
    configs = grid(SEARCH_KM_GRID)
    runs, secs = {}, {}
    for mode in ("stacked", "sequential"):
        runs[mode], secs[mode] = timed(lambda: ModelSearch(
            "kmeans", configs, num_epochs=SEARCH_KM_EPOCHS, execution=mode,
            seed=SEED).run(table))
    check(same_trials(runs["stacked"], runs["sequential"]),
          "(c) k-means: stacked differs from sequential")
    res = runs["stacked"]
    check(all(np.isfinite(t.score) for t in res.trials), "(c) a score is not finite")
    peak = mem_peak("phase 23 (c)")
    say(f"(c) k-means {SEARCH_KM_ROWS:,} x {KMEANS_FEATURES:,} ({data.numel() * 4 / 1e9:.2f} "
        f"GB), {len(configs)} configs, {SEARCH_KM_EPOCHS} epochs: stacked "
        f"{secs['stacked']:.3f} s, sequential {secs['sequential']:.3f} s, bitwise; "
        f"silhouette_lite {fmt(res.scores)}; best {res.best.config}; peak {peak:.2f} GB")
    out["c"] = dict(seconds=secs)
    del table, data
    free_device_memory()


def search_part_d(out: dict) -> None:
    """Part (d): a pipeline search on phase 22 (c)'s docs; the winner serves
    raw text."""
    from repro_torch.core.algorithms.logistic_regression import LogisticRegression
    from repro_torch.core.mltable import MLTable
    from repro_torch.features import NGrams, Standardizer, TfIdf
    from repro_torch.pipeline import Pipeline
    from repro_torch.tune import ModelSearch, grid, holdout_split

    mem_reset()
    rows = fig_corpus(SEED, STREAM_FIG_DOCS)
    texts = [t for _, t in rows]
    raw = MLTable.from_rows(rows, names=["label", "text"], num_partitions=SHARDS)
    pipe = Pipeline([NGrams(n=2, top=FIG_TOP, column="text"), TfIdf(), Standardizer(),
                     LogisticRegression(**SEARCH_PIPE_LR)], num_shards=SHARDS, device=DEVICE)
    fits, originals = [], {}
    for cls in (NGrams, TfIdf, Standardizer):
        originals[cls] = cls.fit

        def fit(self, table, *a, _orig=cls.fit, **k):
            fits.append((type(self).__name__, getattr(self, "top", None), table.num_rows))
            return _orig(self, table, *a, **k)
        cls.fit = fit
    try:
        res, t_search = timed(lambda: ModelSearch(
            pipe, grid(SEARCH_PIPE_GRID), num_epochs=SEARCH_PIPE_EPOCHS, seed=SEED).run(raw))
    finally:
        for cls, f in originals.items():
            cls.fit = f
    n_train = len(holdout_split(STREAM_FIG_DOCS, 0.25, seed=SEED)[0])
    tops = sorted(t for name, t, _ in fits if name == "NGrams")
    check(tops == sorted(SEARCH_PIPE_GRID["ngrams.top"])
          and all(n == n_train for _, _, n in fits) and len(fits) == 3 * len(tops),
          f"(d) featurizer fits {fits}: want one per top, each on the {n_train} train docs")
    best = res.best.pipeline
    requests = [np.random.default_rng(SEED + 23 + i).integers(
        0, FIG_SERVE_POOL, size=int(m)) for i, m in enumerate(
        np.random.default_rng(SEED + 23).integers(1, FIG_REQ_MAX + 1, SEARCH_REQUESTS))]
    offline = best.predict(texts[:FIG_SERVE_POOL]).cpu().numpy()
    served = serve_blocks(best, [[texts[i] for i in idx] for idx in requests], FIG_REQ_MAX)
    bad = sum(not np.array_equal(r, offline[idx]) for idx, r in zip(requests, served["results"]))
    check(bad == 0, f"(d) {bad} served requests differ from the winner's offline predictions")
    peak = mem_peak("phase 23 (d)")
    say(f"(d) pipeline search on {STREAM_FIG_DOCS:,} docs, {len(res.trials)} configs "
        f"{SEARCH_PIPE_GRID}: {t_search:.3f} s; featurizer fits (stage, top, rows) {fits}; "
        f"scores {fmt(res.scores)}; best {res.best.config}; {len(requests)} raw-text requests "
        f"through ModelPredictor(winner) bitwise its offline predictions, latency median "
        f"{float(np.median(served['latencies'])):.3f} ms; peak {peak:.2f} GB")
    out["d"] = dict(seconds=t_search)


def search_part_f(futures) -> None:
    """Part (f): the killed and resumed launcher runs against an
    uninterrupted run in this process; the --hosts 2 run against this
    process's run of the same flags."""
    import contextlib
    import io

    from repro_torch.launch import tune

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, t_here = timed(lambda: tune.main(SEARCH_CLI_ARGS))
    one = io.StringIO()
    with contextlib.redirect_stdout(one):
        _, t_one = timed(lambda: tune.main(SEARCH_CLI_ARGS + SEARCH_CLI_HOSTS[:2]))

    def result(text):
        lines = [ln for ln in text.splitlines() if ln.startswith("RESULT::")]
        return json.loads(lines[-1][len("RESULT::"):]) if lines else None

    future, hosts = futures
    outs = future.result(timeout=300)
    (rc1, killed, t1), (rc2, resumed, t2) = outs
    check(rc1 == -9, f"(f) the killed run ended with rc {rc1}, not -9: {killed[-1500:]}")
    check(rc2 == 0 and f"resuming from unit {SEARCH_CLI_KILL}" in resumed,
          f"(f) the --resume run did not resume: {resumed[-1500:]}")
    check(f"on {DEVICE}" in resumed, f"(f) the launcher ran off the card: {resumed[-800:]}")
    want, got = result(buf.getvalue()), result(resumed)
    check(want is not None and got == want,
          "(f) the resumed RESULT line differs from the uninterrupted run's")
    say(f"(f) python -m repro_torch.launch.tune {' '.join(SEARCH_CLI_ARGS)}: SIGKILLed after "
        f"trial {SEARCH_CLI_KILL} ({t1:.2f} s, rc {rc1}), --resume {t2:.2f} s; its RESULT "
        f"line equals this process's uninterrupted run ({t_here:.2f} s), "
        f"{len(got['trials'])} trials, best {got['best']['config']}")
    rc, text, t_hosts = hosts.result(timeout=300)
    check(rc == 0 and "2 hosts x 2 partitions (gloo) on cuda" in text,
          f"(f) launch.tune {' '.join(SEARCH_CLI_HOSTS)} failed or ran elsewhere: rc {rc}: "
          f"{text[-2000:]}")
    want = [ln for ln in one.getvalue().splitlines() if ln.startswith("RESULT::")]
    got = [ln for ln in text.splitlines() if ln.startswith("RESULT::")]
    check(len(want) == 1 and got == want,
          "(f) the --hosts 2 RESULT line differs from this process's run of the same flags")
    say(f"(f) the same flags with {' '.join(SEARCH_CLI_HOSTS)}: the launcher and its 2 host "
        f"processes {t_hosts:.2f} s (beside phases 20-23); host 0's RESULT line (every "
        f"host's the same, the launcher checks) equals this process's run ({t_one:.2f} s) "
        f"character for character")


class TuneCLI:
    """Part (f)'s two launcher runs (``start_tune_cli``), started when
    phase 20 starts: each child spends ≈ 8-12 s reaching the card, so the
    pair runs beside phases 20-23 and phase 23 reads the results.
    ``close`` stops whatever is still running and removes the work
    directory."""

    def __init__(self):
        import tempfile

        self.work = tempfile.mkdtemp(prefix="chip_smoke_tune_")
        self.procs: list = []
        self.futures = start_tune_cli(self.work, self.procs)

    def close(self) -> None:
        import shutil

        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.work, ignore_errors=True)


def phase_search(gen, cli: TuneCLI) -> dict:
    """Phase 23: model search at the paper's widths; no kernel of the port
    may launch.  ``cli`` holds part (f)'s launcher runs."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    phase(f"23. model search: logreg {SEARCH_ROWS:,} x {LOGREG_FEATURES:,} (grid x 3 "
          f"schedules x stacked/sequential, median rule, ASHA over {SEARCH_ASHA_SAMPLES}), "
          f"k-means {SEARCH_KM_ROWS:,} x {KMEANS_FEATURES:,}, pipeline search on "
          f"{STREAM_FIG_DOCS:,} docs, launch.tune kill + resume (no kernel of the port)")
    out = {}
    try:
        reset_launch_counts()        # phase 23's path starts here
        for part, fn in (("a", lambda: search_part_a(gen, out)),
                         ("b", lambda: search_part_b(out)),
                         ("c", lambda: search_part_c(gen, out)),
                         ("d", lambda: search_part_d(out))):
            _, out[f"{part}_s"] = timed(fn)
        search_part_f(cli.futures)
        got = launch_counts()        # ... and ends here
        say(f"launches of the port's kernels on phase 23's path: {got} (every one 0); "
            f"seconds " + ", ".join(f"({p}) {out[p + '_s']:.1f}" for p in "abcd"))
        check(all(v == 0 for v in got.values()), f"a kernel of the port launched in phase 23: {got}")
        return out
    finally:
        out.pop("table", None)
        free_device_memory()


# --------------------------------------------------------------------------- #
# phase 24: mesh mode across host processes, the SSP lane, elastic resize
# --------------------------------------------------------------------------- #
def lattice_rows(keep: slice, rows: int = MESH_KM_ROWS) -> torch.Tensor:
    """Rows ``keep`` of phase 24's {0,1} lattice table (rows x
    KMEANS_FEATURES fp32): slab i of 4,096 rows from generator MESH_KM_SEED
    + i, so a host makes its own rows.  Cluster sums and counts of such rows
    are integers below 2^24, exact in fp32 in any order."""
    out = torch.empty((keep.stop - keep.start, KMEANS_FEATURES), dtype=torch.float32,
                      device=DEVICE)
    for i in range(keep.start, keep.stop, 4096):
        g = torch.Generator(device=DEVICE).manual_seed(MESH_KM_SEED + i // 4096)
        out[i - keep.start:i - keep.start + 4096] = torch.randint(
            0, 2, (4096, KMEANS_FEATURES), generator=g, device=DEVICE, dtype=torch.float32)
    return out


def mesh_logreg(table, schedule: str, use_kernel: bool = True):
    """Phase 4's sgd fit (through the kernels unless ``use_kernel`` is
    False) on ``table`` (emulated or on a mesh) under ``schedule``."""
    from repro_torch.core.algorithms.logistic_regression import LogisticRegression

    return LogisticRegression(solver="sgd", learning_rate=1e-7, max_iter=ROUNDS,
                              local_batch_size=SGD_BATCH, use_kernel=use_kernel,
                              schedule=schedule).fit(table).weights


def mesh_kmeans(table, schedule: str, use_kernel: bool = True, rounds: int = ROUNDS):
    """KMeans(k=KMEANS_K), ``rounds`` Lloyd rounds from rows drawn with
    SEED, through the kernel unless ``use_kernel`` is False."""
    from repro_torch.core.algorithms.kmeans import KMeans

    return KMeans(k=KMEANS_K, seed=SEED, max_iter=rounds, use_kernel=use_kernel,
                  schedule=schedule).fit(table).centroids


def mesh_concat_view(blocks: torch.Tensor) -> torch.Tensor:
    """What (a)'s concat combine gathers: each partition's first 256 rows'
    first 64 columns."""
    return blocks[:, :256, :64]


def sha(x: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(x.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def mesh_search_runs() -> dict:
    """Phase 24 (e1)'s searches by name: ModelSearch keyword arguments."""
    from repro_torch.tune import AsyncSuccessiveHalving, grid, sample

    kw = dict(configs=[{**c, **SEARCH_LR} for c in grid(SEARCH_GRID)],
              num_epochs=MESH_SEARCH_EPOCHS, chunks_per_epoch=MESH_SEARCH_CHUNKS,
              folds=MESH_SEARCH_FOLDS, seed=SEED)
    runs = {f"{s}/stacked": dict(kw, schedule=s, execution="stacked") for s in MESH_SCHEDULES}
    runs["gather_broadcast/sequential"] = dict(kw, schedule="gather_broadcast",
                                               execution="sequential")
    runs["asha"] = dict(
        configs=[{**c, **SEARCH_LR} for c in
                 sample(SEARCH_ASHA_SPACE, MESH_ASHA_SAMPLES, seed=SEED)],
        num_epochs=MESH_ASHA_EPOCHS, schedule="gather_broadcast", seed=SEED,
        early_stop=AsyncSuccessiveHalving(reduction_factor=3, min_rounds=1,
                                          slots=MESH_ASHA_SLOTS))
    return runs


def trial_digest(result) -> list:
    """A search's trials as (index, rung scores, stopped, sha of the
    state): equal digests are bitwise equal searches."""
    return [[t.index, t.rung_scores, t.stopped, sha(t.state)] for t in result.trials]


def mesh_host_search(mesh, work: str, spent: list, out: dict) -> None:
    """(e1) in a host: its rows of the MESH_SEARCH_ROWS-row table made on
    the card, the searches of mesh_search_runs on the mesh; host 0 saves
    the reduction schedules' states in WORK."""
    from repro_torch.core import hostmesh
    from repro_torch.core.numeric_table import MLNumericTable
    from repro_torch.tune import ModelSearch, cv

    mem_reset()
    t = time.perf_counter()
    table = MLNumericTable(logreg_rows(hostmesh.local_row_slice(MESH_SEARCH_ROWS, mesh),
                                       MESH_SEARCH_ROWS), mesh=mesh)
    sync()
    out["e1_table_s"] = time.perf_counter() - t
    cv.fold_view.rows_moved = cv.fold_view.bytes_moved = 0
    for name, kw in mesh_search_runs().items():
        spent.clear()
        res, secs = timed(lambda: ModelSearch("logreg", **kw).run(table))
        out[f"e1/{name}"] = {"trials": trial_digest(res), "s": secs,
                             "combines": len(spent),
                             "combine_ms": 1e3 * sum(spent) / max(1, len(spent))}
        if mesh.host_id == 0 and name in ("allreduce/stacked", "reduce_scatter/stacked"):
            torch.save([t.state.cpu() for t in res.trials],
                       os.path.join(work, "e1_" + name.replace("/", "_") + ".pt"))
    out["e1_moved"] = [cv.fold_view.rows_moved, cv.fold_view.bytes_moved]
    out["e1_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del table
    torch.cuda.empty_cache()


def mesh_host_pipelines(mesh, out: dict) -> None:
    """(e2) and (e3) in a host: phase 20's corpus made here, pipelines (a)
    and (b) fitted with mesh=, their hashes (fig_hashes); then each fitted
    pipeline behind ModelPredictor(mesh=, max_batch=MESH_SERVE_BATCH)
    serving phase 20's requests, every result hashed."""
    from repro_torch.core.mltable import MLTable
    from repro_torch.serve.predictor import ModelPredictor, PredictRequest

    mem_reset()
    t = time.perf_counter()
    rows = fig_corpus(SEED)
    raw = MLTable.from_rows(rows, names=["label", "text"], num_partitions=SHARDS)
    texts = [t for _, t in rows]
    out["e2_corpus_s"] = time.perf_counter() - t
    fits = {}
    for name, pipe in zip("ab", fig_pipelines(mesh)):
        fits[name], out[f"e2/{name}_s"] = timed(lambda: pipe.fit(raw))
    out["e2"] = fig_hashes(fits["a"], fits["b"])
    requests = fig_requests()
    for name, fitted in fits.items():
        svc = ModelPredictor(fitted, mesh=mesh, max_batch=MESH_SERVE_BATCH)
        reqs = [svc.submit(PredictRequest(features=[texts[i] for i in idx]))
                for idx in requests]
        _, secs = timed(svc.flush)
        rep = svc.report()
        out[f"e3/{name}"] = {"sha": np_sha(np.concatenate([r.result for r in reqs])),
                             "s": secs, "batches": rep["batches"],
                             "rows": rep["rows_served"], "shards": rep["shards"]}
    out["e2_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del fits
    torch.cuda.empty_cache()


def mesh_host(work: str) -> int:
    """``python3 chip_smoke.py --mesh-host WORK``: one host of phase 24 (a)
    and (e).  It joins the gloo group of MESH_HOSTS host processes on this
    card (REPRO_* variables), waits for WORK/go (the parent writes it when
    the card's memory is free), then makes its rows of phase 4's table and
    fits it under the three schedules, makes its rows of the lattice table
    and fits k-means, and gathers a concat; host 0 saves the states in
    WORK; it writes (a)'s result.  Then (e): the model searches of
    mesh_host_search and the pipelines and services of mesh_host_pipelines,
    its launches counted from 0, and (e)'s result.  Each result (shas,
    seconds, gloo combine ms a round, peak memory, kernel launches) is a
    file in WORK and a RESULT:: line."""
    from repro_torch.checkpoint import atomic_write_text
    from repro_torch.core import hostmesh
    from repro_torch.core.numeric_table import MLNumericTable
    from repro_torch.core.runner import DistributedRunner
    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    hostmesh.initialize_from_env(DEVICE, timeout=MESH_TIMEOUT)
    mesh = hostmesh.make_mesh(MESH_LOCAL, DEVICE)
    out = {"host": mesh.host_id, "backend": mesh.backend, "ready_s": time.perf_counter() - t0}
    deadline = time.monotonic() + MESH_TIMEOUT
    while not os.path.exists(os.path.join(work, "go")):
        if time.monotonic() > deadline:
            print("mesh host: no go within the timeout", flush=True)
            return 3
        time.sleep(0.02)
    spent = []
    combine = DistributedRunner._combine

    def timed_combine(self, stacked, how):
        sync()
        t = time.perf_counter()
        got = combine(self, stacked, how)
        sync()
        spent.append(time.perf_counter() - t)
        return got

    DistributedRunner._combine = timed_combine
    t_go = time.perf_counter()
    for what, make, fit, rows in (("lr", logreg_rows, mesh_logreg, LOGREG_ROWS),
                                  ("km", lattice_rows, mesh_kmeans, MESH_KM_ROWS)):
        mem_reset()
        t = time.perf_counter()
        table = MLNumericTable(make(hostmesh.local_row_slice(rows, mesh)), mesh=mesh)
        sync()
        out[f"{what}_table_s"] = time.perf_counter() - t
        for s in MESH_SCHEDULES:
            spent.clear()
            t = time.perf_counter()
            state = fit(table, s)
            sync()
            out[f"{what}/{s}"] = {"sha": sha(state), "s": time.perf_counter() - t,
                                  "combine_ms": 1e3 * sum(spent) / max(1, len(spent)),
                                  "rounds": len(spent)}
            if mesh.host_id == 0:
                torch.save(state.cpu(), os.path.join(work, f"{what}_{s}.pt"))
            if what == "km":
                cat = DistributedRunner.for_table(table, schedule=s).partition_apply(
                    table.data, mesh_concat_view, combine="concat")
                out[f"concat/{s}"] = sha(cat)
        out[f"{what}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del table
        torch.cuda.empty_cache()
    out["work_s"] = time.perf_counter() - t_go
    out["launches"] = launch_counts()
    # the result file first: the parent reads it without waiting for this
    # process's exit (the group's and the card's teardown)
    atomic_write_text(os.path.join(work, f"host{mesh.host_id}.json"), json.dumps(out))
    print("RESULT::" + json.dumps(out), flush=True)
    e = {"host": mesh.host_id}
    t_e = time.perf_counter()
    reset_launch_counts()            # (e)'s path starts here
    mesh_host_search(mesh, work, spent, e)
    mesh_host_pipelines(mesh, e)
    e["launches"] = launch_counts()  # ... and ends here
    e["s"] = time.perf_counter() - t_e
    atomic_write_text(os.path.join(work, f"host{mesh.host_id}_e.json"), json.dumps(e))
    print("RESULT::" + json.dumps(e), flush=True)
    hostmesh.shutdown()
    return 0


def fit_cli_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def card_windows(algorithm: str, rows: int, features: int, seed: int, device):
    """launch.fit's logreg windows (make_source's recipe: gaussian rows,
    labels from the planted model linspace(-1, 1)) drawn on the card from a
    generator seeded ``seed * 100_003 + step``, a pure function of the step
    as make_source is, but not its numbers: a 4,096 x 160,000 window takes
    milliseconds here and seconds of numpy sampling on the host."""
    check(algorithm == "logreg", f"card_windows draws logreg windows, not {algorithm}")

    def source(step: int):
        g = torch.Generator(device=device).manual_seed(seed * 100_003 + step)
        X = torch.randn((rows, features), generator=g, device=device)
        y = (X @ torch.linspace(-1, 1, features, device=device) > 0).to(torch.float32)
        return {"data": torch.cat([y[:, None], X], 1)}
    return source


def fit_main(args: list):
    """``python3 chip_smoke.py --fit ARGS``: launch.fit's main on
    card_windows; in driver mode each host process runs this entry too."""
    from repro_torch.launch import fit as tfit

    return tfit.main(args, source=card_windows,
                     child=[sys.executable, os.path.abspath(__file__), "--fit"])


def fit_cli_args(work: str) -> list:
    """launch.fit at phase 22 (a)'s widths: windows of STREAM_LR_ROWS rows x
    LOGREG_FEATURES drawn on the card (card_windows), SGD batches of 128
    rows, lr 1e-7, through the kernels."""
    return [sys.executable, os.path.abspath(__file__), "--fit", "--algorithm", "logreg",
            "--use-kernel", "--json",
            "--features", str(LOGREG_FEATURES), "--rows-per-epoch", str(STREAM_LR_ROWS),
            "--chunks-per-epoch", str(STREAM_CHUNKS), "--local-batch-size", str(MESH_LR_BATCH),
            "--lr", "1e-7", "--seed", str(SEED), "--ckpt-dir", work]


class MeshChildren:
    """Phase 24's child processes, started with phase 20 so that their
    start-up (≈ 8-15 s each to reach the card) runs beside phases 20-23:
    (a)'s MESH_HOSTS host processes (gloo on this card; they wait for
    ``go``) and, in two threads, (c)'s two SSP launcher runs and (d)'s
    elastic launcher run.  ``close`` stops whatever still runs and removes
    the work directory."""

    def __init__(self):
        import concurrent.futures
        import tempfile

        self.work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
        self.procs: list = []
        self.logs = []
        for h in range(MESH_HOSTS):
            log = open(os.path.join(self.work, f"host{h}.log"), "w+")
            self.logs.append(log)
            env = dict(fit_cli_env(), REPRO_COORDINATOR=f"file://{self.work}/rendezvous",
                       REPRO_NUM_HOSTS=str(MESH_HOSTS), REPRO_HOST_ID=str(h))
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-host", self.work],
                env=env, stdout=log, stderr=subprocess.STDOUT))
        pool = concurrent.futures.ThreadPoolExecutor(2)
        self.ssp = pool.submit(self._run_ssp)
        self.elastic = pool.submit(self._run_elastic)
        pool.shutdown(wait=False)

    def _launch(self, args: list, chaos=None):
        from repro_torch.testing import faults_to_env

        env = fit_cli_env()
        env.pop("REPRO_CHAOS", None)
        if chaos:
            env.update(faults_to_env(chaos))
        t0 = time.perf_counter()
        proc = subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        self.procs.append(proc)
        out, _ = proc.communicate(timeout=MESH_TIMEOUT)
        return proc.returncode, out, time.perf_counter() - t0

    def _run_ssp(self):
        from repro_torch.testing import Fault

        host, rnd, secs = MESH_SSP_DELAY
        base = fit_cli_args(os.path.join(self.work, "c")) + [
            "--hosts", "2", "--devices-per-host", str(SHARDS), "--epochs", str(MESH_SSP_EPOCHS)]
        first = self._launch(base + ["--staleness", "0"])
        base[base.index("--ckpt-dir") + 1] = os.path.join(self.work, "c1")
        second = self._launch(base + ["--staleness", "1"],
                              [Fault(host=host, round=rnd, action="delay", seconds=secs)])
        return first, second

    def _run_elastic(self):
        from repro_torch.testing import Fault

        args = fit_cli_args(os.path.join(self.work, "d")) + [
            "--hosts", "2", "--devices-per-host", str(MESH_LOCAL), "--elastic",
            "--epochs", str(MESH_ELASTIC_EPOCHS), "--schedule", "gather_broadcast"]
        return self._launch(args, [Fault(host=1, round=MESH_KILL, action="kill")])

    def go(self) -> None:
        from repro_torch.checkpoint import atomic_write_text

        atomic_write_text(os.path.join(self.work, "go"), "go")

    def host_results(self, part: str = "") -> list:
        """Each host's result file of (a) (``part=""``) or (e)
        (``part="_e"``), as soon as it is written (a host that ends without
        one fails the phase)."""
        out = []
        deadline = time.monotonic() + MESH_TIMEOUT
        for h, proc in enumerate(self.procs[:MESH_HOSTS]):
            path = os.path.join(self.work, f"host{h}{part}.json")
            while not os.path.exists(path):
                rc = proc.poll()
                if rc is not None or time.monotonic() > deadline:
                    self.logs[h].seek(0)
                    check(False, f"mesh host {h} ended with rc {rc} and no result "
                                 f"{path}: {self.logs[h].read()[-2500:]}")
                time.sleep(0.01)
            with open(path) as f:
                out.append(json.load(f))
        return out

    def close(self) -> None:
        import shutil

        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in self.logs:
            log.close()
        shutil.rmtree(self.work, ignore_errors=True)


def mesh_part_b(out: dict) -> None:
    """(b): an NCCL group of one in this process, 8 local partitions:
    k-means on the lattice table and logistic regression at its shape
    (labels from a planted model) through the kernels, bitwise the
    8-partition emulated fits under every schedule."""
    from repro_torch.core import hostmesh
    from repro_torch.core.numeric_table import MLNumericTable
    from repro_torch.kernels import launch_counts, reset_launch_counts

    lattice = out["lattice"]
    g = torch.Generator(device=DEVICE).manual_seed(MESH_KM_SEED - 1)
    X = torch.empty((MESH_KM_ROWS, KMEANS_FEATURES + 1), dtype=torch.float32, device=DEVICE)
    X[:, 1:] = lattice
    X[:, 0] = (lattice @ torch.randn(KMEANS_FEATURES, generator=g, device=DEVICE) > 0).float()
    t0 = time.perf_counter()
    info = hostmesh.initialize(f"file://{out['work']}/nccl", 1, 0, device=DEVICE,
                               timeout=MESH_TIMEOUT)
    try:
        mesh = hostmesh.make_mesh(SHARDS, DEVICE)
        want = "nccl" if DEVICE == "cuda" else "gloo"
        check(info.backend == mesh.backend == want,
              f"(b) a world of one on {DEVICE} chose {info.backend}, not {want}")
        launches = collections.Counter()
        fits = {}
        for s in MESH_SCHEDULES:
            for name, fit, data in (("logreg", mesh_logreg, X), ("kmeans", mesh_kmeans, lattice)):
                reset_launch_counts()
                got = fit(MLNumericTable(data, mesh=mesh), s)
                launches.update(launch_counts())
                want = fit(MLNumericTable(data, num_shards=SHARDS), s)
                check(torch.equal(got, want) and sha(got) == sha(want),
                      f"(b) {name} under {s} on an NCCL world of 1 differs from the "
                      f"emulated fit: max abs {(got - want).abs().max().item():.3g}")
                fits[name, s] = got
    finally:
        hostmesh.shutdown()
    sync()
    out["b_s"] = time.perf_counter() - t0
    out["b_launches"] = {k: v for k, v in launches.items() if v}
    launches = out["b_launches"]
    say(f"(b) NCCL group of 1, {SHARDS} local partitions: logreg {MESH_KM_ROWS:,} x "
        f"{KMEANS_FEATURES + 1:,} and k-means {MESH_KM_ROWS:,} x {KMEANS_FEATURES:,} "
        f"bitwise the emulated fits under all three schedules; {out['b_s']:.2f} s with "
        f"the emulated twins; the group torn down; launches {dict(launches)}")
    # the same tables fitted with use_kernel=False: logistic regression
    # within FP32_TOL; k-means bitwise, or else every pick where the kernel's
    # rounds part from the plain version's a tie within fp32 rounding
    t1 = time.perf_counter()
    w_k, c_k = fits["logreg", "gather_broadcast"], fits["kmeans", "gather_broadcast"]
    w_p = mesh_logreg(MLNumericTable(X, num_shards=SHARDS), "gather_broadcast", False)
    e_lr = rel_err(w_k, w_p)
    check(e_lr <= FP32_TOL, f"(b) logreg through the kernels vs use_kernel=False: rel err "
          f"{e_lr} over {FP32_TOL}")
    km_table = MLNumericTable(lattice, num_shards=SHARDS)
    c_p = mesh_kmeans(km_table, "gather_broadcast", False)
    km_same = torch.equal(c_k, c_p)
    if not km_same:
        init = mesh_kmeans(km_table, "gather_broadcast", rounds=0)
        kmeans_rounds_against_plain(lattice.view(SHARDS, -1, KMEANS_FEATURES), init, c_k)
    out["b_plain_s"] = time.perf_counter() - t1
    out["b_fits"] = {"X": X, "lattice": lattice, "w": w_k, "centroids": c_k}
    say(f"(b) the same tables with use_kernel=False: logreg weights rel err {e_lr:.3g} "
        f"(<= {FP32_TOL}); k-means centroids "
        + ("bitwise the kernel fit's" if km_same else
           f"max abs {(c_k - c_p).abs().max().item():.3g} from the kernel fit's, every "
           f"differing pick a tie (above)") + f"; {out['b_plain_s']:.2f} s")


def mesh_part_a(children: MeshChildren, out: dict, phase4_w: torch.Tensor) -> None:
    """(a)'s checks: the hosts' states against phase 4's 8 emulated
    partitions (logreg) and this process's 1 x 8 emulated lattice fit."""
    res = children.host_results()
    h0, h1 = res
    check(h0["backend"] == h1["backend"] == "gloo", f"(a) backend {h0['backend']}, not gloo")
    for key in [k for k in h0 if "/" in k]:
        a, b = h0[key], h1[key]
        check((a["sha"] if isinstance(a, dict) else a) == (b["sha"] if isinstance(b, dict) else b),
              f"(a) the two hosts' {key} differ")
    lr = {s: torch.load(os.path.join(children.work, f"lr_{s}.pt")).to(DEVICE)
          for s in MESH_SCHEDULES}
    check(torch.equal(lr["gather_broadcast"], phase4_w) and
          h0["lr/gather_broadcast"]["sha"] == sha(phase4_w),
          f"(a) logreg gather_broadcast on 2 x {MESH_LOCAL} differs from phase 4's "
          f"{SHARDS} emulated partitions: max abs "
          f"{(lr['gather_broadcast'] - phase4_w).abs().max().item():.3g}")
    scale = phase4_w.abs().max().item()
    dist = {s: (lr[s] - phase4_w).abs().max().item() / scale
            for s in ("allreduce", "reduce_scatter")}
    check(all(v <= MESH_TOL for v in dist.values()),
          f"(a) logreg reduction schedules beyond {MESH_TOL} of max |w|: {dist}")
    want_km = mesh_kmeans(out["lattice_table"], "gather_broadcast")
    for s in MESH_SCHEDULES:
        check(h0[f"km/{s}"]["sha"] == sha(want_km),
              f"(a) k-means lattice under {s} on 2 x {MESH_LOCAL} differs from the 1 x "
              f"{SHARDS} emulated fit")
    cat = mesh_concat_view(out["lattice"].view(SHARDS, -1, KMEANS_FEATURES)).flatten(0, 1)
    check(all(h0[f"concat/{s}"] == sha(cat) for s in MESH_SCHEDULES),
          "(a) concat differs across schedules or from the table's rows")
    lr_steps = ROUNDS * (LOGREG_ROWS // SHARDS // SGD_BATCH) * len(MESH_SCHEDULES)
    want = {"logreg_grad": lr_steps, "kmeans_assign": ROUNDS * len(MESH_SCHEDULES)}
    for r in res:
        got = {k: v for k, v in r["launches"].items() if v}
        check(got == want, f"(a) host {r['host']} launched {got}, expected {want}")
    out["a_launches"] = {k: sum(r["launches"][k] for r in res) for k in want}
    out["a_hosts"] = res
    say(f"(a) {MESH_HOSTS} host processes x {MESH_LOCAL} partitions on this card, gloo "
        f"(CUDA partials through pinned host buffers): logreg {LOGREG_ROWS:,} x "
        f"{LOGREG_FEATURES + 1:,} sgd {ROUNDS} rounds, gather_broadcast bitwise phase 4's "
        f"{SHARDS} emulated partitions; allreduce / reduce_scatter at "
        f"{dist['allreduce']:.3g} / {dist['reduce_scatter']:.3g} of max |w| (<= {MESH_TOL}); "
        f"k-means lattice {MESH_KM_ROWS:,} x {KMEANS_FEATURES:,} k={KMEANS_K} bitwise the "
        f"1 x {SHARDS} emulated fit under all three schedules; concat bitwise")
    for r in res:
        say(f"(a) host {r['host']}: reached the group in {r['ready_s']:.2f} s (beside "
            f"phases 20-23); after go {r['work_s']:.2f} s: its {LOGREG_ROWS // MESH_HOSTS:,} "
            f"logreg rows made in {r['lr_table_s']:.2f} s, fits "
            + ", ".join(f"{s} {r['lr/' + s]['s']:.2f} s (gloo combine "
                        f"{r['lr/' + s]['combine_ms']:.3f} ms a round)" for s in MESH_SCHEDULES)
            + f"; lattice rows {r['km_table_s']:.2f} s, k-means "
            + ", ".join(f"{s} {r['km/' + s]['s']:.2f} s ({r['km/' + s]['combine_ms']:.3f} ms)"
                        for s in MESH_SCHEDULES)
            + f"; peak memory {r['lr_peak_gb']:.2f} GB (logreg), {r['km_peak_gb']:.2f} GB "
              f"(k-means); launches {({k: v for k, v in r['launches'].items() if v})}")


def mesh_search_twin(out: dict) -> None:
    """(e1)'s emulated twin in this process: the same rows in SHARDS
    emulated partitions, the gather_broadcast grid search and the ASHA
    search (in emulated mode every schedule is the same arithmetic)."""
    from repro_torch.core.numeric_table import MLNumericTable
    from repro_torch.tune import ModelSearch

    table = MLNumericTable(logreg_rows(slice(0, MESH_SEARCH_ROWS), MESH_SEARCH_ROWS),
                           num_shards=SHARDS)
    runs, twin = mesh_search_runs(), {}
    for name in ("gather_broadcast/stacked", "asha"):
        res, twin[name + "_s"] = timed(lambda: ModelSearch("logreg", **runs[name]).run(table))
        twin[name] = trial_digest(res)
        if name == "gather_broadcast/stacked":
            twin["states"] = [t.state for t in res.trials]
            twin["scores"] = [t.rung_scores for t in res.trials]
    out["twin"] = twin
    del table
    free_device_memory()


def mesh_e_launches() -> dict:
    """(e)'s launches of kernels 1-3 in each host: k-means one assignment a
    Lloyd round over the host's partitions and one a served partition;
    logistic regression one logreg_grad a step and one logreg_margin a
    served partition."""
    rows = sum(len(idx) for idx in fig_requests())
    served = MESH_LOCAL * -(-rows // MESH_SERVE_BATCH)
    steps = FIG_LOGREG["max_iter"] * (FIG_DOCS // SHARDS // FIG_LOGREG["local_batch_size"])
    return {"kmeans_assign": FIG_ROUNDS + served, "logreg_grad": steps,
            "logreg_margin": served}


def mesh_part_e(children: MeshChildren, out: dict, fig: dict) -> None:
    """(e)'s checks: the hosts' searches against the emulated twin, their
    pipelines and services against phase 20's, their launches."""
    res = children.host_results("_e")
    h0 = res[0]
    for r in res[1:]:
        for key in [k for k in h0 if k.startswith(("e1/", "e2", "e3/"))]:
            a, b = h0[key], r[key]
            if key.startswith("e1/"):
                a, b = a["trials"], b["trials"]
            elif key.startswith("e3/"):
                a, b = a["sha"], b["sha"]
            if not key.endswith("_s"):
                check(a == b, f"(e) host {r['host']}'s {key} differs from host 0's")
    twin = out["twin"]
    for name in ("gather_broadcast/stacked", "gather_broadcast/sequential"):
        check(h0[f"e1/{name}"]["trials"] == twin["gather_broadcast/stacked"],
              f"(e1) the {name} search on 2 x {MESH_LOCAL} differs from the {SHARDS}-partition "
              f"emulated search")
    check(h0["e1/asha"]["trials"] == twin["asha"],
          f"(e1) ASHA on 2 x {MESH_LOCAL} differs from the emulated ASHA")
    dist, score_gap = {}, {}
    for sched in ("allreduce", "reduce_scatter"):
        states = torch.load(os.path.join(children.work, f"e1_{sched}_stacked.pt"))
        dist[sched] = max((got.to(DEVICE) - want).abs().max().item() / want.abs().max().item()
                          for got, want in zip(states, twin["states"]))
        score_gap[sched] = max(abs(a - b) for t, w in zip(h0[f"e1/{sched}/stacked"]["trials"],
                                                          twin["scores"])
                               for a, b in zip(t[1], w))
    check(all(v <= MESH_TOL for v in dist.values()),
          f"(e1) the reduction schedules' trials beyond {MESH_TOL} of max |w|: {dist}")
    check(all(v <= SEARCH_SCORE_TOL for v in score_gap.values()),
          f"(e1) the reduction schedules' scores beyond {SEARCH_SCORE_TOL}: {score_gap}")
    for key, want in fig["hashes"].items():
        got = h0[f"e3/{key[0]}"]["sha"] if key.endswith("/served") else h0["e2"][key]
        check(got == want, f"(e) {key} on 2 x {MESH_LOCAL} differs from phase 20's")
    want = mesh_e_launches()
    for r in res:
        got = {k: v for k, v in r["launches"].items() if v}
        check(got == want, f"(e) host {r['host']} launched {got}, expected {want}")
    out["e_launches"] = {k: sum(r["launches"][k] for r in res) for k in want}
    moved, nbytes = h0["e1_moved"]
    say(f"(e1) model search on {MESH_HOSTS} hosts x {MESH_LOCAL} partitions, "
        f"{MESH_SEARCH_ROWS:,} x {LOGREG_FEATURES + 1:,} ({MESH_SEARCH_FOLDS} folds, "
        f"{MESH_SEARCH_EPOCHS} epochs of {MESH_SEARCH_CHUNKS} chunks, {len(twin['states'])} "
        f"configs): gather_broadcast stacked and sequential bitwise the {SHARDS}-partition "
        f"emulated search (and each other), ASHA bitwise; allreduce / reduce_scatter at "
        f"{dist['allreduce']:.3g} / {dist['reduce_scatter']:.3g} of max |w| (<= {MESH_TOL}), "
        f"scores within {max(score_gap.values()):.3g}; fold views moved {moved:,} rows "
        f"({nbytes / 1e6:.1f} MB) across hosts; emulated twin "
        f"{twin['gather_broadcast/stacked_s']:.2f} s + ASHA {twin['asha_s']:.2f} s")
    for r in res:
        say(f"(e) host {r['host']}: {r['s']:.2f} s; table {r['e1_table_s']:.2f} s; searches "
            + ", ".join(f"{n} {r['e1/' + n]['s']:.2f} s ({r['e1/' + n]['combines']} combines, "
                        f"{r['e1/' + n]['combine_ms']:.3f} ms each)"
                        for n in mesh_search_runs())
            + f"; corpus {r['e2_corpus_s']:.2f} s, pipeline fits (a) {r['e2/a_s']:.2f} s, "
              f"(b) {r['e2/b_s']:.2f} s; served (a) {r['e3/a']['rows']} rows in "
              f"{r['e3/a']['batches']} microbatches {r['e3/a']['s']:.2f} s, (b) "
              f"{r['e3/b']['s']:.2f} s; peaks {r['e1_peak_gb']:.2f} GB (search), "
              f"{r['e2_peak_gb']:.2f} GB (pipelines); launches "
              f"{({k: v for k, v in r['launches'].items() if v})}")
    say(f"(e2) Fig. A2's pipelines with mesh= on 2 x {MESH_LOCAL}: IDF, shift, scale, "
        f"centroids and weights bitwise phase 20's {SHARDS}-partition fits; (e3) "
        f"ModelPredictor(mesh=, max_batch={MESH_SERVE_BATCH}) on both hosts: every served "
        f"row of both pipelines bitwise phase 20's one-process service")


def host_lines(text: str, gen: int) -> dict:
    """Each host's RESULT of generation ``gen`` in a launch.fit driver's
    output, by host id."""
    out = {}
    for ln in text.splitlines():
        if ln.startswith(f"[generation {gen} ") and "RESULT::" in ln:
            res = json.loads(ln.split("RESULT::", 1)[1])
            out[res["host"]] = res
    return out


def ssp_replay(epochs: int, work: str) -> str:
    """The sequential replay of (c)'s s = 0 cohort in this process: each
    host's epoch (its own windows, seed SEED + 7919·host) from the merged
    state through ``run_epochs_ssp`` on a one-host store, then the merge in
    host-id order — the simulator of tests/chaos/test_ssp_executor.py."""
    from repro_torch.core.algorithms.logistic_regression import (
        LogisticRegressionParameters, _make_gradient)
    from repro_torch.core.exchange import ParamStore
    from repro_torch.core.optimizer import (StochasticGradientDescent,
                                            StochasticGradientDescentParameters)
    from repro_torch.core.runner import DistributedRunner
    from repro_torch.data import BatchIterator
    from repro_torch.launch.fit import SSP_SEED_STRIDE

    p = LogisticRegressionParameters(learning_rate=1e-7, local_batch_size=MESH_LR_BATCH,
                                     schedule="allreduce", use_kernel=True)
    step = StochasticGradientDescent._local_round(StochasticGradientDescentParameters(
        w_init=None, grad=_make_gradient(p), learning_rate=p.learning_rate,
        schedule=p.schedule, local_batch_size=p.local_batch_size, lr_decay=p.lr_decay))
    runner = DistributedRunner(num_shards=SHARDS, schedule=p.schedule)
    streams = [BatchIterator(card_windows(
        "logreg", STREAM_LR_ROWS, LOGREG_FEATURES, SEED + SSP_SEED_STRIDE * h, DEVICE),
        device=DEVICE) for h in range(2)]
    w = torch.zeros(LOGREG_FEATURES, dtype=torch.float32, device=DEVICE)
    for e in range(epochs):
        mines = [runner.run_epochs_ssp(
            streams[h], w, step, e + 1, store=ParamStore(os.path.join(work, f"solo{h}_{e}"), 0, 1),
            staleness=0, chunks_per_epoch=STREAM_CHUNKS, start_epoch=e) for h in range(2)]
        w = torch.stack(mines).mean(dim=0)
    return sha(w)


def mesh_part_c(children: MeshChildren, out: dict) -> None:
    """(c): the two SSP launcher runs — s = 0 bitwise across hosts and
    against the replay; s = 1 under a delay fault within its bound."""
    (rc0, text0, t0), (rc1, text1, t1) = children.ssp.result(timeout=MESH_TIMEOUT)
    check(rc0 == 0 and rc1 == 0, f"(c) launch.fit --staleness failed: {rc0} {text0[-2000:]} "
          f"| {rc1} {text1[-2000:]}")
    s0 = host_lines(text0, 0)
    check(sorted(s0) == [0, 1] and s0[0]["sha"] == s0[1]["sha"],
          f"(c) staleness 0: the two hosts' weights differ: {s0}")
    check(all(t["reads"] == {str(1 - h): t["epoch"]} for h in (0, 1) for t in s0[h]["trace"]),
          "(c) staleness 0 read another round than its own")
    t_replay = time.perf_counter()
    replay = ssp_replay(MESH_SSP_EPOCHS, out["work"])
    t_replay = time.perf_counter() - t_replay
    check(s0[0]["sha"] == replay, "(c) staleness 0 differs from the sequential replay")
    s1 = host_lines(text1, 0)
    host, rnd, secs = MESH_SSP_DELAY
    reads = [(h, t["epoch"], r) for h in (0, 1) for t in s1[h]["trace"]
             for r in t["reads"].values()]
    check(all(e - 1 <= r <= e for _, e, r in reads),
          f"(c) staleness 1: a read outside the bound: {reads}")
    stale = sum(r < e for _, e, r in reads)
    waits = [round(t["wait_seconds"], 3) for t in s1[0]["trace"]]
    say(f"(c) python -m repro_torch.launch.fit --hosts 2 --staleness 0 ({SHARDS} partitions "
        f"a host, {STREAM_LR_ROWS:,}-row windows x {LOGREG_FEATURES:,} drawn on the card, "
        f"{MESH_SSP_EPOCHS} epochs): both hosts bitwise each other and the sequential "
        f"replay here ({t_replay:.2f} s); {t0:.2f} s (read beside phases 20-23)")
    say(f"(c) --staleness 1 with a {secs:.1f} s delay on host {host} at round {rnd}: every "
        f"read within the bound ({stale} stale of {len(reads)}); host 0's waits by round "
        f"{waits} s; {t1:.2f} s")


def mesh_part_d(children: MeshChildren, out: dict) -> None:
    """(d): the elastic launcher run — a kill on host 1, a restart on one
    host, an allow_resize resume bitwise the same resume run here."""
    import contextlib
    import io
    import shutil

    from repro_torch.launch import fit as tfit

    rc, text, t_all = children.elastic.result(timeout=MESH_TIMEOUT)
    check(rc == 0, f"(d) the elastic run failed: rc {rc}: {text[-2500:]}")
    gen1 = host_lines(text, 1)
    check(0 in gen1 and gen1[0]["partitions"] == MESH_LOCAL and gen1[0]["num_hosts"] == 1,
          f"(d) no generation 1 on one host of {MESH_LOCAL} partitions: {text[-2000:]}")
    m = gen1[0]
    check(1 <= m["resumed_from"] <= MESH_KILL and m["stream_step"] == MESH_ELASTIC_EPOCHS,
          f"(d) generation 1 resumed from {m['resumed_from']} to {m['stream_step']}")
    lat = next((ln for ln in text.splitlines() if ln.startswith("elastic:")), "")
    ck = os.path.join(children.work, "d")
    ref = os.path.join(out["work"], "d-ref")
    shutil.copytree(ck, ref, ignore=shutil.ignore_patterns("rendezvous"))
    for fn in os.listdir(ref):
        if fn.startswith("step_") and int(fn[5:-4]) > m["resumed_from"]:
            os.remove(os.path.join(ref, fn))
    args = fit_cli_args(ref)[3:] + ["--num-shards", str(MESH_LOCAL), "--elastic", "--resume",
                                    "--epochs", str(MESH_ELASTIC_EPOCHS),
                                    "--schedule", "gather_broadcast"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        model, t_here = timed(lambda: tfit.main(args, source=card_windows))
    check(sha(model.weights) == m["sha"],
          "(d) generation 1's weights differ from the 1-host resume of the same snapshot")
    say(f"(d) launch.fit --hosts 2 --devices-per-host {MESH_LOCAL} --elastic, SIGKILL on "
        f"host 1 at step {MESH_KILL}: generation 1 on 1 host x {MESH_LOCAL} resumed from "
        f"step {m['resumed_from']} with allow_resize ({2 * MESH_LOCAL} -> {MESH_LOCAL} "
        f"partitions), bitwise this process's 1-host resume ({t_here:.2f} s); {lat}; "
        f"{t_all:.2f} s in all (read beside phases 20-23)")


def say_kernel_row(name: str, r: dict) -> None:
    """One line for a kernel's row of logreg_pair_times / kmeans_shape_row."""
    lib = f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None else "none"
    say(f"{name} {r['label']} X{tuple(r['shape'])} (partition stride "
        f"{r['partition_stride']:,}): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
        f"{r['bound_ms'] / r['ms']:.1%}); max abs err {r['max_abs_err']:.3g}")


def logreg_pair_times(label: str, X: torch.Tensor, y: torch.Tensor,
                      W: torch.Tensor) -> dict:
    """logreg_grad (grad_row, its bar printed), logreg_margin and
    logreg_xt_z on the chunk view X (P, n, d) against their plain versions
    (margin within FP32_TOL absolute, Xᵀz within FP32_TOL relative), each
    timed beside its plain version, the library call where there is one
    (Xᵀz: torch.matmul) and the bound; in CUDA graphs where the bound is
    under 20 µs."""
    from repro_torch.kernels import logreg_grad as klg

    P, n, d = X.shape
    z, zp = klg.logreg_margin(X, y, W), klg.logreg_margin_plain(X, y, W)
    g, gp = klg.logreg_xt_z(X, zp), klg.logreg_xt_z_plain(X, zp)
    sync()
    err_z, err_g = (z - zp).abs().max().item(), rel_err(g, gp)
    check(err_z <= FP32_TOL and err_g <= FP32_TOL,
          f"kernels 1-2 at {label} {tuple(X.shape)}: margin err {err_z}, xt_z rel err {err_g}")
    rows = {}
    for name, moved, fn, plain, lib in (
            ("logreg_margin", P * n * d + P * d + 2 * P * n,
             lambda: klg.logreg_margin(X, y, W), lambda: klg.logreg_margin_plain(X, y, W), None),
            ("logreg_xt_z", P * n * d + P * n + P * d,
             lambda: klg.logreg_xt_z(X, zp), lambda: klg.logreg_xt_z_plain(X, zp),
             lambda: torch.matmul(X.transpose(1, 2), zp.unsqueeze(-1)))):
        t_b, by = bound(4.0 * moved, 2.0 * P * n * d)
        timer = graph_ms if t_b < 0.02 else (lambda f: cuda_ms(f, 10))
        rows[name] = {"label": label, "shape": [P, n, d], "row_stride": X.stride(1),
                      "partition_stride": X.stride(0), "ms": timer(fn), "plain_ms": timer(plain),
                      "bound_ms": t_b, "bound_by": by,
                      "library_ms": timer(lib) if lib else None,
                      "max_abs_err": err_z if name == "logreg_margin"
                      else (g - gp).abs().max().item()}
    rows["logreg_grad"] = grad_row(label, X, y, W)
    rows["logreg_grad"]["bars"] = grad_bars([rows["logreg_grad"]], share_bar=False)
    return rows


def kmeans_shape_row(label: str, X: torch.Tensor, C: torch.Tensor) -> dict:
    """kmeans_assign on X (P, n, d) against its plain version (a differing
    pick must be a tie within fp32 rounding, score_gap), timed beside it
    and the bound."""
    from repro_torch.kernels import kmeans_assign as kka

    P, n, d = X.shape
    k = C.shape[0]
    ties, gap, ratio = score_gap(X, C, kka.kmeans_assign(X, C), kka.kmeans_assign_plain(X, C))
    check(ratio <= 1.0, f"kmeans_assign at {label} {tuple(X.shape)}: {ties} picks differ from "
          f"the plain version beyond rounding ({ratio}x)")
    t_b, by = bound(4.0 * (P * n * d + k * d + P * n), 2.0 * P * n * k * d)
    return {"label": label, "shape": [P, n, d, k], "partition_stride": X.stride(0),
            "ms": cuda_ms(lambda: kka.kmeans_assign(X, C), 10),
            "plain_ms": cuda_ms(lambda: kka.kmeans_assign_plain(X, C), 10),
            "bound_ms": t_b, "bound_by": by, "library_ms": None, "max_abs_err": gap,
            "tie_picks": ties}


def served_margin_row(label: str, Xs: torch.Tensor, w: torch.Tensor) -> dict:
    """logreg_margin as predict_proba serves a (n, d) block (no labels, σ(Xw)
    alone) against its plain version, a row of logreg_pair_times' form;
    in CUDA graphs (a few µs a launch)."""
    from repro_torch.kernels import logreg_grad as klg

    n, d = Xs.shape
    err = (klg.logreg_margin(Xs, None, w) - klg.logreg_margin_plain(Xs, None, w)).abs().max().item()
    check(err <= FP32_TOL, f"logreg_margin at {label} {tuple(Xs.shape)}: err {err}")
    t_b, by = bound(4.0 * (n * d + d + n), 2.0 * n * d)
    return {"label": label, "shape": [1, n, d], "row_stride": Xs.stride(0),
            "partition_stride": Xs.numel(), "ms": graph_ms(lambda: klg.logreg_margin(Xs, None, w)),
            "plain_ms": graph_ms(lambda: klg.logreg_margin_plain(Xs, None, w)),
            "bound_ms": t_b, "bound_by": by, "library_ms": None, "max_abs_err": err}


def mesh_kernel_times(kept: dict) -> dict:
    """Kernels 1-3 at the shapes the mesh path gave them, against their
    plain versions and timed: (a)'s per-host chunks (MESH_LOCAL, SGD_BATCH,
    LOGREG_FEATURES) of host 0's rows (remade here) and (MESH_LOCAL,
    MESH_KM_ROWS / SHARDS, 4,096) of the lattice; (b)'s (SHARDS, SGD_BATCH,
    4,096) and (SHARDS, MESH_KM_ROWS / SHARDS, 4,096); (c)'s (SHARDS,
    MESH_LR_BATCH, LOGREG_FEATURES) and (d)'s (MESH_LOCAL, MESH_LR_BATCH,
    LOGREG_FEATURES) chunks of a card_windows window; (e2)'s per-host Fig.
    A2 shapes (MESH_LOCAL, FIG_DOCS / SHARDS, FIG_TOP) and its chunk, and
    (e3)'s served partition (MESH_SERVE_BATCH / SHARDS rows), on phase 20's
    tables."""
    d, dk = LOGREG_FEATURES, KMEANS_FEATURES
    lr, km = [], []
    host = logreg_rows(slice(0, LOGREG_ROWS // MESH_HOSTS)).view(MESH_LOCAL, -1, d + 1)
    W4 = kept["phase4_w"].expand(MESH_LOCAL, -1).contiguous()
    lr.append(logreg_pair_times("(a) a host's chunk", host[:, :SGD_BATCH, 1:],
                                host[:, :SGD_BATCH, 0].contiguous(), W4))
    del host
    free_device_memory()
    window = card_windows("logreg", STREAM_LR_ROWS, d, SEED, DEVICE)(0)["data"]
    W8 = kept["phase4_w"].expand(SHARDS, -1).contiguous()
    for label, P, W in (("(c) an SSP host's chunk", SHARDS, W8),
                        ("(d) an elastic generation's chunk", MESH_LOCAL, W4)):
        blocks = window.view(P, -1, d + 1)
        lr.append(logreg_pair_times(label, blocks[:, :MESH_LR_BATCH, 1:],
                                    blocks[:, :MESH_LR_BATCH, 0].contiguous(), W))
    del window, blocks
    Xb = kept["X"].view(SHARDS, -1, dk + 1)
    lr.append(logreg_pair_times("(b) NCCL world of 1, chunk", Xb[:, :SGD_BATCH, 1:],
                                Xb[:, :SGD_BATCH, 0].contiguous(),
                                kept["w"].expand(SHARDS, -1).contiguous()))
    lattice, C = kept["lattice"], kept["centroids"]
    km.append(kmeans_shape_row("(a) a host's partitions",
                               lattice[:MESH_KM_ROWS // MESH_HOSTS].view(MESH_LOCAL, -1, dk), C))
    km.append(kmeans_shape_row("(b) NCCL world of 1", lattice.view(SHARDS, -1, dk), C))
    # (e2)'s and (e3)'s per-host shapes, on phase 20's tables (host 0's rows)
    fig, per_host = kept["fig"], FIG_DOCS // MESH_HOSTS
    bs, part = FIG_LOGREG["local_batch_size"], MESH_SERVE_BATCH // SHARDS
    km.append(kmeans_shape_row("(e2) a host's Fig. A2 partitions", fig["table_a"].data[
        :per_host].view(MESH_LOCAL, -1, FIG_TOP), fig["C"]))
    km.append(kmeans_shape_row("(e3) a served partition", fig["table_a"].data[
        :part].view(1, part, FIG_TOP), fig["C"]))
    blocks = fig["final"].data[:per_host].view(MESH_LOCAL, -1, FIG_TOP + 1)
    lr.append(logreg_pair_times("(e2) a host's Fig. A2 chunk", blocks[:, :bs, 1:],
                                blocks[:, :bs, 0].contiguous(),
                                fig["w"].expand(MESH_LOCAL, -1).contiguous()))
    served = served_margin_row("(e3) a served partition",
                               fig["final"].data[:part, 1:].contiguous(), fig["w"])
    out = {"logreg_grad": [r["logreg_grad"] for r in lr],
           "logreg_margin": [r["logreg_margin"] for r in lr] + [served],
           "logreg_xt_z": [r["logreg_xt_z"] for r in lr], "kmeans_assign": km}
    for name, rows in out.items():
        for r in rows:
            if name != "logreg_grad":    # grad_bars printed it
                say_kernel_row(name, r)
    return {name: {"shapes": rows} for name, rows in out.items()}


def phase_mesh(children: MeshChildren, phase4_w: torch.Tensor, fig: dict) -> dict:
    """Phase 24: mesh mode across host processes on this card, the SSP lane
    and elastic resize, and (e) the rest of mesh mode in (a)'s hosts (a
    model search, Fig. A2's pipelines, the shard-aware predictor; ``fig``
    is phase 20's result).  Returns kernels 1-3's launches on the mesh
    path: (a)'s and (e)'s hosts' and (b)'s (every launch of a mesh run; the
    emulated twins do not count), and under "times" the call that holds
    and times the kernels at the path's shapes (made in phase 25)."""
    import shutil
    import tempfile

    from repro_torch.core.numeric_table import MLNumericTable

    phase(f"24. mesh mode: {MESH_HOSTS} host processes x {MESH_LOCAL} partitions (gloo) on "
          f"logreg {LOGREG_ROWS:,} x {LOGREG_FEATURES:,} and k-means lattice {MESH_KM_ROWS:,} "
          f"x {KMEANS_FEATURES:,}, NCCL at a world of 1, SSP s=0 and s=1 with a delay, "
          f"elastic kill-resize-resume; (e) a model search at {MESH_SEARCH_ROWS:,} x "
          f"{LOGREG_FEATURES:,}, Fig. A2's pipelines and the shard-aware predictor on the mesh")
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_parent_")
    out = {"work": work}
    try:
        mem_reset()
        children.go()                # (a)'s hosts make their rows and fit now
        out["lattice"] = lattice_rows(slice(0, MESH_KM_ROWS))
        out["lattice_table"] = MLNumericTable(out["lattice"], num_shards=SHARDS)
        (_, t_b) = timed(lambda: mesh_part_b(out))
        _, t_a = timed(lambda: mesh_part_a(children, out, phase4_w))
        mem_peak("phase 24 (this process; read beside the hosts)")
        _, t_twin = timed(lambda: mesh_search_twin(out))
        _, t_c = timed(lambda: mesh_part_c(children, out))
        _, t_d = timed(lambda: mesh_part_d(children, out))
        _, t_e = timed(lambda: mesh_part_e(children, out, fig))
        launches = {k: out["a_launches"].get(k, 0) + out["b_launches"].get(k, 0)
                    + out["e_launches"].get(k, 0)
                    for k in set(out["a_launches"]) | set(out["e_launches"])}
        say(f"launches of kernels 1-3 on the mesh path: {launches} ((a)'s hosts "
            f"{out['a_launches']}, (b) {out['b_launches']}, (e)'s hosts {out['e_launches']}); "
            f"seconds here: (b) {t_b:.1f}, (a) wait + checks {t_a:.1f}, (e1)'s emulated twin "
            f"{t_twin:.1f}, (c) {t_c:.1f}, (d) {t_d:.1f}, (e) wait + checks {t_e:.1f}")
        check(all(v > 0 for v in launches.values()), f"a kernel never launched on the mesh "
              f"path: {launches}")
        kept = dict(out["b_fits"], phase4_w=phase4_w, fig=fig["tables"])
        return {"kernels": {k: {"launches": v} for k, v in launches.items()},
                "times": lambda: mesh_kernel_times(kept)}
    finally:
        out.clear()
        shutil.rmtree(work, ignore_errors=True)
        free_device_memory()


# --------------------------------------------------------------------------- #
# phase 21: the paper's §IV-B (BroadcastALS) and the other estimators
# --------------------------------------------------------------------------- #
def served_against_offline(what: str, model, pool: np.ndarray, requests: int,
                           req_max: int, max_batch: int, seed: int) -> dict:
    """``requests`` requests of 1..req_max consecutive rows of ``pool``
    served through ModelPredictor; each result must be bitwise the offline
    ``predict`` of the whole pool."""
    offline = model.predict(torch.from_numpy(pool).to(DEVICE)).cpu().numpy()
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, req_max + 1, size=requests)
    starts = rng.integers(0, len(pool) - req_max, size=requests)
    served = serve_blocks(model, [pool[s:s + m] for s, m in zip(starts, sizes)], max_batch)
    bad = sum(not np.array_equal(r, offline[s:s + m])
              for s, m, r in zip(starts, sizes, served["results"]))
    rep = served["report"]
    say(f"{what}: served {requests} requests of 1..{req_max} rows ({rep['rows_served']} rows) "
        f"in {rep['batches']} microbatches of {max_batch} ({rep['rows_padded']} pad rows): "
        f"latency median {float(np.median(served['latencies'])):.3f} ms, max "
        f"{max(served['latencies']):.3f} ms; {bad} requests differ from the offline "
        f"prediction of the pool ({len(pool)} rows)")
    check(bad == 0, f"{what}: {bad} served results differ from the offline prediction")
    return {"seconds": served["seconds"],
            "latency_ms": float(np.median(served["latencies"]))}


def netflix_ratings(gen: torch.Generator):
    """The §IV-B ratings on the card, with synth_netflix_tiled's recipe: a
    rank-NF_RANK base U·Vᵀ (U, V normal / √rank) plus 0.1·noise, mapped to
    2.5 + 1.5·(that) and clipped to [1, 5], kept where a Bernoulli(NF_DENSITY)
    mask is set; NF_GEN_USERS users at a time, as row-major COO (rows,
    cols int64, ratings fp32).  The noise is drawn for the kept entries
    only, which leaves their distribution as the recipe's."""
    Uf = torch.randn((NF_USERS, NF_RANK), generator=gen, device=DEVICE) / math.sqrt(NF_RANK)
    Vf = torch.randn((NF_ITEMS, NF_RANK), generator=gen, device=DEVICE) / math.sqrt(NF_RANK)
    rows, cols, vals = [], [], []
    for u0 in range(0, NF_USERS, NF_GEN_USERS):
        m = min(NF_GEN_USERS, NF_USERS - u0)
        keep = torch.rand((m, NF_ITEMS), generator=gen, device=DEVICE) < NF_DENSITY
        r, c = keep.nonzero(as_tuple=True)
        del keep
        r = r + u0
        base = (Uf[r] * Vf[c]).sum(1) + 0.1 * torch.randn(r.shape, generator=gen, device=DEVICE)
        rows.append(r)
        cols.append(c)
        vals.append(torch.clamp(2.5 + 1.5 * base, 1.0, 5.0))
    return torch.cat(rows), torch.cat(cols), torch.cat(vals)


def als_fp64_error(table, Y: torch.Tensor) -> float:
    """One half-sweep on ``table`` against ``Y`` in fp32 (compute_factor)
    against the same in fp64 (_local_als on fp64 copies, a partition at a
    time): max abs error over max |fp64 factor|."""
    from repro_torch.core.algorithms.als import BroadcastALS, _local_als

    got = BroadcastALS.compute_factor(table, Y, NF_LAM)
    blocks = table.data.view(SHARDS, -1, table.num_cols)
    want = torch.cat([_local_als(blocks[p:p + 1].double(), Y.double(), NF_LAM)[0]
                      for p in range(SHARDS)])
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def als_split(table, Y: torch.Tensor) -> dict:
    """Device ms of one half-sweep by part (torch.profiler over one after a
    warm one), the half-sweep made of the calls compute_factor makes
    (``_local_als``'s three steps and the runner's concat, each under a
    label); ``half-sweep`` is every kernel of it."""
    import repro_torch.core.algorithms.als as als
    from repro_torch.core.partition import partition_rows
    from repro_torch.core.runner import _emulated_combine
    from torch.profiler import DeviceType, record_function

    blocks = partition_rows(table.data, SHARDS)
    k = Y.shape[1]

    def half_sweep():
        with record_function("als.gather and mask"):
            idx, val, msk = als.unpack_csr_block(blocks.reshape(-1, blocks.shape[-1]))
            Yq = als._gather_masked(idx, msk, Y)
        with record_function("als.Gram and right-hand side"):
            A, b = als._normal_equations(Yq, val, msk, NF_LAM)
        with record_function("als.solve"):
            x = als._solve(A, b).reshape(SHARDS, -1, k)
        with record_function("als.concat"):
            return _emulated_combine(x, "concat")

    check(torch.equal(half_sweep(), als.BroadcastALS.compute_factor(table, Y, NF_LAM)),
          "the split's half-sweep is not compute_factor's, bitwise")
    sync()
    events = profile_steps(half_sweep, 1).events()

    def part(name):
        return sum(e.device_time_total for e in events
                   if e.device_type == DeviceType.CPU and e.name == name) / 1e3

    parts = {name: part(f"als.{name}") for name in
             ("gather and mask", "Gram and right-hand side", "solve", "concat")}
    kernels = collections.Counter()
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.name.startswith(("als.",
                                                                       "ProfilerStep")):
            kernels[e.name[:60]] += e.self_device_time_total / 1e3
    parts["half-sweep"] = sum(kernels.values())
    parts["kernels"] = dict(kernels.most_common(6))
    check(parts["half-sweep"] > 0, "the half-sweep's profile saw no device time")
    return parts


def als_example_card_vs_cpu() -> dict:
    """examples/als_recommender.py's table, packed and fitted on the card
    and on the CPU from the same init_factors (drawn on the host)."""
    from repro_torch.core.algorithms.als import BroadcastALS, pack_csr_table
    from repro_torch.data import synth_netflix_tiled

    M = synth_netflix_tiled(users=128, items=96, rank=6, tiles=2, density=0.15)
    m, n = M.shape
    r, c = np.nonzero(M)
    v = M[r, c]
    w = int(max((M != 0).sum(1).max(), (M != 0).sum(0).max()))
    gen = torch.Generator().manual_seed(SEED)
    init = (torch.rand((m, NF_RANK), generator=gen), torch.rand((n, NF_RANK), generator=gen))
    fits = {}
    for dev in (DEVICE, "cpu"):
        data = pack_csr_table(r, c, v, m, w, num_shards=4, device=dev)
        data_t = pack_csr_table(c, r, v, n, w, num_shards=4, device=dev)
        fits[dev] = BroadcastALS(rank=NF_RANK, lam=NF_LAM, max_iter=NF_ITERS).fit(
            data, data_transposed=data_t, init_factors=init)
    card, cpu = fits[DEVICE], fits["cpu"]
    err = max(rel_err(card.U.cpu(), cpu.U), rel_err(card.V.cpu(), cpu.V))
    rmse = (card.rmse(r, c, v).item(), cpu.rmse(r, c, v).item())
    seen = set(c[r == 0].tolist())

    def top5(model):
        scores = (model.U[0] @ model.V.T).cpu().numpy()
        return [int(j) for j in np.argsort(-scores) if j not in seen][:5]

    say(f"examples/als_recommender.py's table ({m} x {n}, {len(v)} ratings): the card's fit "
        f"vs the CPU's from the same init, max abs err over max |factor| {err:.3g} (tol "
        f"{ALS_DEVICE_TOL}); RMSE {rmse[0]:.6f} (card), {rmse[1]:.6f} (CPU); top-5 unseen "
        f"items for user 0: {top5(card)} (card), {top5(cpu)} (CPU)")
    check(err <= ALS_DEVICE_TOL and max(rmse) < 0.5,
          f"the example's fit on the card vs the CPU: err {err}, RMSE {rmse}")
    return {"err": err, "rmse": rmse}


def als_train_stacked(users, movies, ratings, fit, p, fit_s: float) -> dict:
    """Phase 23's leg (e), inside phase 21 (a) while its tables are
    resident: BroadcastALS.train_stacked over SEARCH_ALS_LAMS from the
    fit's seed; lane 0 (the fit's config) against the fit."""
    import dataclasses

    from repro_torch.core.algorithms.als import BroadcastALS

    ps = [dataclasses.replace(p, lam=lam, max_iter=NF_ITERS) for lam in SEARCH_ALS_LAMS]
    mem_reset()
    models, secs = timed(lambda: BroadcastALS.train_stacked(users, ps, movies))
    peak = mem_peak(f"phase 21 (a), train_stacked K = {len(ps)} (the packed tables, the "
                    f"ratings and the fit resident)")
    err = max(rel_err(models[0].U, fit.U), rel_err(models[0].V, fit.V))
    same = torch.equal(models[0].U, fit.U) and torch.equal(models[0].V, fit.V)
    rmse = [m.rmse(*ratings).item() for m in models]
    check(err <= ALS_STACKED_TOL and all(math.isfinite(r) for r in rmse) and peak < 80,
          f"(e) train_stacked: lane 0 vs the fit {err} (tol {ALS_STACKED_TOL}), RMSE "
          f"{rmse}, peak {peak:.2f} GB")
    say(f"(e) BroadcastALS.train_stacked, K = {len(ps)}, λ {SEARCH_ALS_LAMS}, rank "
        f"{NF_RANK}, {NF_ITERS} iterations: {secs:.3f} s (host clock) against 4 x the fit's "
        f"{fit_s:.3f} s = {4 * fit_s:.3f} s; lane 0 against the fit: rel err {err:.3g} "
        f"(tol {ALS_STACKED_TOL}), {'bitwise the same' if same else 'not bitwise'}; "
        f"training RMSE by lane {fmt(rmse)}; peak {peak:.2f} GB")
    return {"seconds": secs, "lane0_err": err, "bitwise": same, "rmse": rmse,
            "peak_gb": peak}


def phase_als(gen: torch.Generator) -> dict:
    """Part (a) of phase 21: BroadcastALS at the Netflix Prize's shape."""
    from repro_torch.core.algorithms.als import ALSParameters, BroadcastALS, pack_csr_table
    from repro_torch.core.collectives import CollectiveSchedule
    from repro_torch.core.numeric_table import MLNumericTable

    mem_reset()
    out = {}
    t0 = time.perf_counter()
    rows, cols, vals = netflix_ratings(gen)
    sync()
    out["generate_s"] = time.perf_counter() - t0
    nnz = rows.numel()
    deg_u = torch.bincount(rows, minlength=NF_USERS)
    deg_i = torch.bincount(cols, minlength=NF_ITEMS)
    w_u, w_i = int(deg_u.max()), int(deg_i.max())
    t0 = time.perf_counter()
    users = pack_csr_table(rows, cols, vals, NF_USERS, w_u, num_shards=SHARDS, device=DEVICE)
    movies = pack_csr_table(cols, rows, vals, NF_ITEMS, w_i, num_shards=SHARDS, device=DEVICE)
    sync()
    out["pack_s"] = time.perf_counter() - t0
    table_gb = (users.data.numel() + movies.data.numel()) * 4 / 1e9
    say(f"ratings: {NF_USERS:,} users x {NF_ITEMS:,} movies, {nnz:,} ratings (density "
        f"{nnz / (NF_USERS * NF_ITEMS):.6f}; Netflix {NF_DENSITY:.6f}), drawn on the card in "
        f"{out['generate_s']:.3f} s; degrees: users {deg_u.float().mean().item():.1f} mean, "
        f"{deg_u.min().item()}..{w_u}; movies {deg_i.float().mean().item():.1f} mean, "
        f"{deg_i.min().item()}..{w_i}")
    say(f"reduced: users 480,189 -> {NF_USERS:,} and movies 17,770 -> {NF_ITEMS:,} (8 partitions "
        f"divide both tables); degrees Binomial, not Netflix's skew (its widest movie has "
        f"~2.3e5 ratings: a table padded to it would not fit); ratings synthetic, not "
        f"Netflix's")
    say(f"packed on the card in {out['pack_s']:.3f} s: users ({NF_USERS:,}, 3 x {w_u}) and "
        f"movies ({NF_ITEMS:,}, 3 x {w_i}) fp32, {table_gb:.2f} GB together")
    check(int(torch.count_nonzero(users.data[:, 2 * w_u:])) == nnz
          and int(torch.count_nonzero(movies.data[:, 2 * w_i:])) == nnz,
          "a packed table lost ratings")

    p = ALSParameters(rank=NF_RANK, lam=NF_LAM, max_iter=1, seed=SEED,
                      schedule=CollectiveSchedule.GATHER_BROADCAST)
    # iteration by iteration: a half-sweep reads only the other factor, so
    # ten chained one-iteration fits are the ten-iteration fit
    model = BroadcastALS(p).fit(users, data_transposed=movies)
    rmse = [model.rmse(rows, cols, vals).item()]
    for _ in range(1, NF_ITERS):
        model = BroadcastALS(p).fit(users, data_transposed=movies,
                                    init_factors=(model.U, model.V))
        rmse.append(model.rmse(rows, cols, vals).item())
    sync()
    t0 = time.perf_counter()
    fit = BroadcastALS(p, max_iter=NF_ITERS).fit(users, data_transposed=movies)
    sync()
    out["fit_s"] = time.perf_counter() - t0
    say(f"BroadcastALS(rank={NF_RANK}, lam={NF_LAM}, {NF_ITERS} iterations, GATHER_BROADCAST, "
        f"{SHARDS} partitions): {out['fit_s']:.3f} s (host clock); training RMSE by iteration "
        f"{fmt(rmse)} (bar {ALS_RMSE_BAR}; noise floor 0.15)")
    check(torch.equal(fit.U, model.U) and torch.equal(fit.V, model.V),
          "the ten-iteration fit differs from ten chained one-iteration fits")
    check(bool(torch.isfinite(fit.U).all() and torch.isfinite(fit.V).all())
          and rmse[-1] < rmse[0] and rmse[-1] <= ALS_RMSE_BAR,
          f"training RMSE {rmse} (bar {ALS_RMSE_BAR})")
    out["rmse"] = rmse
    out["stacked"] = als_train_stacked(users, movies, (rows, cols, vals), fit, p,
                                       out["fit_s"])

    one = BroadcastALS(p, max_iter=NF_ITERS).fit(
        MLNumericTable(users.data, num_shards=1),
        data_transposed=MLNumericTable(movies.data, num_shards=1))
    same = torch.equal(one.U, fit.U) and torch.equal(one.V, fit.V)
    say(f"partition invariance: U and V with {SHARDS} partitions and with 1 "
        f"{'bitwise the same' if same else 'DIFFER'}")
    check(same, "the fit with 8 partitions differs from the fit with 1")

    err_u, err_i = als_fp64_error(users, fit.V), als_fp64_error(movies, fit.U)
    say(f"one half-sweep against the fitted factor, fp32 vs fp64 (max abs err over max "
        f"|factor|): users {err_u:.3g}, movies {err_i:.3g} (tol {ALS_HALF_TOL})")
    check(err_u <= ALS_HALF_TOL and err_i <= ALS_HALF_TOL,
          f"a half-sweep against fp64: {err_u}, {err_i}")
    out["fp64_err"] = {"users": err_u, "movies": err_i}

    # device time of each half-sweep (CUDA events, after the warm call
    # cuda_ms makes); the bound: the packed table read once at the memory
    # rate with both factors L2-resident, or the normal equations' and the
    # solves' operations at the fp32 rate, whichever is longer
    out["half_sweep"] = {}
    for name, table, Y, n_rows in (("users", users, fit.V, NF_USERS),
                                   ("movies", movies, fit.U, NF_ITEMS)):
        ms = cuda_ms(lambda: BroadcastALS.compute_factor(table, Y, NF_LAM), 3)
        k = NF_RANK
        ops = nnz * (2 * k * k + 2 * k) + n_rows * (2 * k ** 3 / 3 + 2 * k * k)
        t_b, by = bound(4 * (table.data.numel() + Y.numel() + n_rows * k), ops)
        out["half_sweep"][name] = {"ms": ms, "bound_ms": t_b, "bound_by": by,
                                   "table_gb": table.data.numel() * 4 / 1e9}
        say(f"half-sweep over the {name} table ({table.data.numel() * 4 / 1e9:.2f} GB): "
            f"{ms:.4f} ms (CUDA events), bound {t_b:.4f} ms ({by}; {t_b / ms:.1%}; "
            f"{ms / t_b:.1f}x the bound)")
    split = als_split(users, fit.V)
    out["split"] = split
    say("users half-sweep by part (torch.profiler, device ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items() if k != "kernels"))
    say(f"    its largest kernels: {split['kernels']}")

    g = np.random.default_rng(SEED + 2)
    pool = np.stack([g.integers(0, NF_USERS, ALS_SERVE_POOL),
                     g.integers(0, NF_ITEMS, ALS_SERVE_POOL)], 1)
    out["serving"] = served_against_offline(
        "(user, item) pairs", fit, pool, ALS_REQUESTS, ALS_REQ_MAX, ALS_SERVE_BATCH, SEED + 3)
    seen = set(cols[rows == 0].tolist())
    scores = (fit.U[0] @ fit.V.T).cpu().numpy()
    top = [int(j) for j in np.argsort(-scores) if j not in seen][:5]
    say(f"top-5 unseen movies for user 0 (of {len(seen)} rated): {top}, predicted "
        f"{fmt(scores[top])}")
    check(len(top) == 5 and not set(top) & seen, "user 0's recommendations")
    out["example"] = als_example_card_vs_cpu()
    out["peak_gb"] = mem_peak("phase 21 (a)")
    return out


def glm_learning_rate(X: torch.Tensor) -> tuple:
    """A learning rate with lr·λ_max < 1, where λ_max is the largest
    eigenvalue of a chunk's XᵀX/m (the squared loss's Hessian) over the
    first chunk of every partition: that of XXᵀ/m, m x m, in fp64."""
    blocks = X.view(SHARDS, -1, X.shape[1])
    lam = max(torch.linalg.eigvalsh((c @ c.T).double() / GLM_BATCH)[-1].item()
              for c in blocks[:, :GLM_BATCH])
    return GLM_LR_SCALE / lam, lam


def glm_fp64(table, kind: str, lr: float, reg) -> torch.Tensor:
    """The same SGD in fp64, written out: every partition steps through its
    GLM_BATCH-row chunks in order with the mean of its rows' (loss gradient
    + l2·w), then the L1 prox; the partitions' weights are averaged after
    each of GLM_ROUNDS rounds."""
    blocks = table.data.view(SHARDS, -1, table.num_cols)
    w = torch.zeros(table.num_cols - 1, dtype=torch.float64, device=DEVICE)
    for _ in range(GLM_ROUNDS):
        W = w.expand(SHARDS, -1).clone()
        for s in range(0, blocks.shape[1], GLM_BATCH):
            chunk = blocks[:, s:s + GLM_BATCH].double()
            x, y = chunk[..., 1:], chunk[..., 0]
            z = torch.bmm(x, W.unsqueeze(-1)).squeeze(-1)
            coef = z - y if kind == "linear regression" else \
                torch.where(y * z < 1.0, -y, torch.zeros_like(y))
            g = torch.bmm(coef.unsqueeze(1), x).squeeze(1) / GLM_BATCH + reg.l2 * W
            W = W - lr * g
            if reg.l1:
                W = torch.sign(W) * torch.clamp(W.abs() - reg.l1 * lr, min=0.0)
        w = W.mean(0)
    return w


def phase_glm(table) -> dict:
    """Part (c) of phase 21: LinearRegression (elastic net) and LinearSVM
    on phase 4's table, each against fp64 SGD over the same chunks."""
    from repro_torch.core.algorithms.linear_models import (
        LinearRegression, LinearSVM, Regularization)

    mem_reset()
    out = {}
    X = table.data[:, 1:]
    lr, lam = glm_learning_rate(X)
    say(f"learning rate {lr:.4g}: lr·λ_max = {lr * lam:.3f} (λ_max {lam:.5g}, the largest "
        f"eigenvalue of a {GLM_BATCH}-row chunk's XᵀX/m; rows have |x|² ≈ "
        f"{(X[:GLM_BATCH] ** 2).sum(1).mean().item():.4g}, so the reference's default 0.1 "
        f"diverges)")
    labels = table.data[:, 0].clone()
    reg_en = Regularization.elastic_net(GLM_ALPHA, 0.5)
    fits = (("linear regression", LinearRegression, reg_en),
            ("linear SVM", LinearSVM, Regularization(l2=1e-3)))
    for name, est, reg in fits:
        if name == "linear SVM":                      # {0, 1} -> {-1, +1}, exact
            table.data[:, 0].mul_(2.0).sub_(1.0)
        sync()
        t0 = time.perf_counter()
        model = est(learning_rate=lr, max_iter=GLM_ROUNDS, local_batch_size=GLM_BATCH,
                    reg=reg, schedule="gather_broadcast").fit(table)
        sync()
        secs = time.perf_counter() - t0
        want = glm_fp64(table, name, lr, reg)
        err = rel_err(model.weights.double(), want)
        zeros = int((model.weights == 0).sum())
        y = table.data[:GLM_SERVE_POOL, 0].cpu().numpy()
        pool = X[:GLM_SERVE_POOL].cpu().numpy()
        served = served_against_offline(f"{name}", model, pool, GLM_REQUESTS, GLM_REQ_MAX,
                                        GLM_REQ_MAX, SEED + 4)
        pred = model.predict(X[:GLM_SERVE_POOL]).cpu().numpy()
        quality = (f"accuracy {(pred == y).mean():.4f}" if name == "linear SVM" else
                   f"RMSE {np.sqrt(((pred - y) ** 2).mean()):.4f} (labels' std {y.std():.4f}, "
                   f"all-zero weights {np.sqrt((y ** 2).mean()):.4f})")
        if name == "linear SVM":                      # and back, exact
            table.data[:, 0].add_(1.0).mul_(0.5)
        say(f"{name} ({reg}), {GLM_ROUNDS} rounds of {GLM_BATCH}-row chunks: {secs:.3f} s "
            f"(host clock); weights vs fp64 SGD over the same chunks {err:.3g} (tol "
            f"{GLM_TOL}); {zeros} of {X.shape[1]:,} weights 0; {quality} on the first "
            f"{GLM_SERVE_POOL} rows")
        check(bool(torch.isfinite(model.weights).all()) and err <= GLM_TOL,
              f"{name}: weights vs fp64 {err}")
        out[name] = {"fit_s": secs, "err": err, "zero_weights": zeros, **served}
    check(torch.equal(table.data[:, 0], labels), "the labels did not come back exactly")
    check(out["linear regression"]["zero_weights"] > 0,
          "the elastic net's L1 prox zeroed no weight")
    out["peak_gb"] = mem_peak("phase 21 (c)")
    return out


def pca_data(gen: torch.Generator):
    """PCA_ROWS rows of PCA_FEATURES features on the card: PCA_CLASSES
    Gaussian classes (unit noise around centers ×3, as
    examples/pca_naive_bayes.py), row i of class i mod PCA_CLASSES."""
    centers = torch.randn((PCA_CLASSES, PCA_FEATURES), generator=gen, device=DEVICE) * 3
    y = torch.arange(PCA_ROWS, device=DEVICE) % PCA_CLASSES
    X = torch.empty((PCA_ROWS, PCA_FEATURES), dtype=torch.float32, device=DEVICE)
    for i in range(0, PCA_ROWS, PCA_SLAB):
        X[i:i + PCA_SLAB].normal_(generator=gen).add_(centers[y[i:i + PCA_SLAB]])
    return X, y


def pca_fp64(X: torch.Tensor):
    """The covariance in fp64 (sums over row slabs), its eigenvalues
    descending and eigenvectors as rows."""
    s = torch.zeros(X.shape[1], dtype=torch.float64, device=DEVICE)
    G = torch.zeros((X.shape[1], X.shape[1]), dtype=torch.float64, device=DEVICE)
    for i in range(0, X.shape[0], PCA_SLAB):
        x = X[i:i + PCA_SLAB].double()
        s += x.sum(0)
        G += x.T @ x
    mean = s / X.shape[0]
    cov = G / X.shape[0] - torch.outer(mean, mean)
    evals, evecs = torch.linalg.eigh(cov)
    return cov, evals.flip(0), evecs.flip(1).T


def pca_gapped(evals64: torch.Tensor) -> torch.Tensor:
    """The first PCA_K components whose fp64 eigenvalue lies at least
    PCA_GAP of the largest from both neighbours.  Inside the noise bulk
    neighbours lie ~1e-4 apart, and a component there is any vector of
    their span: rounding picks one."""
    lam = evals64[:PCA_K + 1]
    below = (lam[:-1] - lam[1:]).abs()
    above = torch.cat([torch.full_like(lam[:1], float("inf")), below[:-1]])
    return (torch.minimum(below, above) >= PCA_GAP * lam[0]).nonzero().flatten()


def pca_compare(model, ev_ref, vecs_ref, sel, top: float, cov64=None) -> dict:
    """``model``'s explained variance against ``ev_ref`` (over ``top``, the
    largest eigenvalue), its components ``sel`` against ``vecs_ref``'s each
    up to its sign, and with ``cov64`` every component's residual
    |cov·c − (cᵀ·cov·c)·c| over ``top``."""
    k = model.components.shape[0]
    ev = model.explained_variance.double()
    out = {"variance": ((ev - ev_ref[:k].double()).abs().max() / top).item()}
    C = model.components.double()
    ref = vecs_ref[:k].double()
    signs = torch.sign((C * ref).sum(1, keepdim=True))
    out["compared"] = int(sel.numel())
    out["component"] = ((C * signs - ref)[sel].abs().max().item()
                        if sel.numel() else 0.0)
    if cov64 is not None:
        Cc = C @ cov64
        rq = (Cc * C).sum(1, keepdim=True)
        out["residual"] = ((Cc - rq * C).norm(dim=1).max() / top).item()
    return out


def nb_fp64(Z: torch.Tensor, y: torch.Tensor, var_smoothing: float) -> dict:
    """Naive Bayes' statistics by the reference's formulas in fp64, with
    each variance's scale s2/cnt (the terms its formula subtracts)."""
    onehot = (y.unsqueeze(1) == torch.arange(PCA_CLASSES, device=DEVICE)).double()
    Zd = Z.double()
    cnt = torch.clamp(onehot.sum(0), min=1.0)
    s1, s2 = onehot.T @ Zd, onehot.T @ (Zd * Zd)
    mean = s1 / cnt[:, None]
    var = torch.clamp(s2 / cnt[:, None] - mean ** 2, min=0.0) + var_smoothing
    return {"priors": cnt / Z.shape[0], "means": mean, "variances": var,
            "scale": s2 / cnt[:, None]}


def phase_pca_nb(gen: torch.Generator) -> dict:
    """Part (b) of phase 21: examples/pca_naive_bayes.py's program at the
    card's scale."""
    from repro_torch.core.algorithms.naive_bayes import GaussianNaiveBayes
    from repro_torch.core.algorithms.pca import PCA
    from repro_torch.core.numeric_table import MLNumericTable

    mem_reset()
    out = {}
    t0 = time.perf_counter()
    X, y = pca_data(gen)
    sync()
    out["generate_s"] = time.perf_counter() - t0
    say(f"table {PCA_ROWS:,} x {PCA_FEATURES:,} fp32 ({X.numel() * 4 / 1e9:.1f} GB), "
        f"{PCA_CLASSES} Gaussian classes, made on the card in {out['generate_s']:.3f} s; "
        f"{SHARDS} partitions; XᵀX is {2 * PCA_ROWS * PCA_FEATURES ** 2 / 1e12:.1f} TFLOP of "
        f"IEEE fp32 (TF32 off)")
    fits = {}
    for shards in (SHARDS, 1):
        sync()
        t0 = time.perf_counter()
        fits[shards] = PCA(n_components=PCA_K).fit(MLNumericTable(X, num_shards=shards))
        sync()
        out[f"pca_fit_s_{shards}"] = time.perf_counter() - t0
    pca = fits[SHARDS]
    t0 = time.perf_counter()
    cov64, evals64, evecs64 = pca_fp64(X)
    sync()
    out["fp64_s"] = time.perf_counter() - t0
    sel, top = pca_gapped(evals64), evals64[0].item()
    vs64 = pca_compare(pca, evals64, evecs64, sel, top, cov64)
    vs1 = pca_compare(pca, fits[1].explained_variance, fits[1].components, sel, top)
    say(f"PCA(n_components={PCA_K}) fit {out[f'pca_fit_s_{SHARDS}']:.3f} s with {SHARDS} "
        f"partitions, {out['pca_fit_s_1']:.3f} s with 1 (host clock); explained variance "
        f"{fmt(pca.explained_variance[:3].tolist())} ... {fmt(pca.explained_variance[-2:].tolist())}")
    say(f"  against fp64 eigh of the fp64 covariance ({out['fp64_s']:.3f} s): variance "
        f"{vs64['variance']:.3g} of the largest (tol {PCA_TOL['variance']}); components up to "
        f"sign {vs64['component']:.3g} (tol {PCA_TOL['component']}) over the "
        f"{vs64['compared']} with a gap >= {PCA_GAP} of the largest; every component's "
        f"residual {vs64['residual']:.3g} (tol {PCA_TOL['residual']})")
    say(f"  {SHARDS} partitions against 1: variance {vs1['variance']:.3g}, components up to "
        f"sign {vs1['component']:.3g} over {vs1['compared']}")
    check(all(vs64[k] <= PCA_TOL[k] for k in ("variance", "component", "residual"))
          and vs1["variance"] <= PCA_TOL["variance"]
          and vs1["component"] <= PCA_TOL["component"] and vs64["compared"] > 0,
          f"PCA against fp64 {vs64}, 8 partitions against 1 {vs1}")
    del cov64

    t0 = time.perf_counter()
    Z = torch.cat([pca.transform(X[i:i + PCA_SLAB]) for i in range(0, PCA_ROWS, PCA_SLAB)])
    sync()
    out["transform_s"] = time.perf_counter() - t0
    labeled = torch.cat([y.unsqueeze(1).float(), Z], 1)
    nb_est = GaussianNaiveBayes(num_classes=PCA_CLASSES)
    nbs = {}
    for shards in (SHARDS, 1):
        sync()
        t0 = time.perf_counter()
        nbs[shards] = nb_est.fit(MLNumericTable(labeled, num_shards=shards))
        sync()
        out[f"nb_fit_s_{shards}"] = time.perf_counter() - t0
    nb = nbs[SHARDS]
    want = nb_fp64(Z, y, nb_est.params.var_smoothing)
    errs = {"priors": rel_err(nb.priors.double(), want["priors"]),
            "means": rel_err(nb.means.double(), want["means"]),
            "variances": ((nb.variances.double() - want["variances"]).abs()
                          / want["scale"]).max().item()}
    errs1 = {"priors": rel_err(nb.priors, nbs[1].priors),
             "means": rel_err(nb.means, nbs[1].means),
             "variances": ((nb.variances.double() - nbs[1].variances.double()).abs()
                           / want["scale"]).max().item()}
    t0 = time.perf_counter()
    pred = nb.predict(Z)
    sync()
    out["predict_s"] = time.perf_counter() - t0
    acc = (pred.long() == y).float().mean().item()
    say(f"GaussianNaiveBayes(num_classes={PCA_CLASSES}) on [y | Z] ({PCA_ROWS:,} x "
        f"{PCA_K + 1}): fit {out[f'nb_fit_s_{SHARDS}']:.4f} s; statistics against fp64: priors "
        f"{errs['priors']:.3g}, means {errs['means']:.3g} (of the largest), variances "
        f"{errs['variances']:.3g} (entry by entry, of s2/cnt: the formula cancels) (tol "
        f"{NB_TOL}); {SHARDS} partitions against 1: {fmt(errs1.values())} (tol {NB_TOL}); "
        f"predict {out['predict_s']:.4f} s, training accuracy {acc:.4f} (bar 0.9)")
    check(all(v <= NB_TOL for v in errs.values()) and all(v <= NB_TOL for v in errs1.values())
          and acc > 0.9, f"naive Bayes: vs fp64 {errs}, 8 vs 1 {errs1}, accuracy {acc}")
    out.update(pca_vs_fp64=vs64, pca_8_vs_1=vs1, nb_vs_fp64=errs, nb_8_vs_1=errs1, accuracy=acc)
    out["serving"] = served_against_offline(
        "naive Bayes on Z rows", nb, Z[:PCA_SERVE_POOL].cpu().numpy(), PCA_REQUESTS,
        PCA_REQ_MAX, PCA_REQ_MAX, SEED + 5)
    out["peak_gb"] = mem_peak("phase 21 (b)")
    return out


def phase_estimators(gen: torch.Generator, report) -> dict:
    """Phase 21: (c) the GLMs on phase 4's table, then the first path's
    tables freed, (a) BroadcastALS at the Netflix Prize's shape and (b)
    PCA -> naive Bayes; no kernel of the port may launch on this path."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    phase(f"21. BroadcastALS at the Netflix Prize's shape, PCA -> GaussianNaiveBayes, "
          f"LinearRegression and LinearSVM (no kernel of the port on this path)")
    reset_launch_counts()            # phase 21's path starts here
    t0 = time.perf_counter()
    out = {"c": phase_glm(report["logreg"]["table"])}
    out["c"]["seconds"] = time.perf_counter() - t0
    free_tables(report)
    for part, fn in (("a", phase_als), ("b", phase_pca_nb)):
        t0 = time.perf_counter()
        out[part] = fn(gen)
        free_device_memory()
        out[part]["seconds"] = time.perf_counter() - t0
    got = launch_counts()            # ... and ends here
    say(f"launches of the port's kernels on phase 21's path: {got} (every one 0); seconds "
        f"(a) {out['a']['seconds']:.1f}, (b) {out['b']['seconds']:.1f}, (c) "
        f"{out['c']['seconds']:.1f}")
    check(all(v == 0 for v in got.values()), f"a kernel of the port launched in phase 21: {got}")
    return out


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
    from repro_torch.kernels.lm_head import lm_head
    from repro_torch.kernels.quant_matmul import quant_linear, quantize_rows
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models.transformer import TransformerLM, init_model
    from repro_torch.serve import ServeEngine, SlotScheduler

    cfg = dataclasses.replace(get_config(LM_ARCH), quantize="int8")
    phase(f"8. LM serving: {cfg.name}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size:,}, {cfg.dtype}, int8 "
          f"projections, {LM_SLOTS} slots, max_seq {LM_MAX_SEQ}")
    mem_reset()
    t0 = time.perf_counter()
    # drawn plain (the checks below hold the engine's int8 tree against it);
    # the engine quantizes it
    params = init_model(torch.Generator(device=DEVICE).manual_seed(SEED),
                        dataclasses.replace(cfg, quantize="none"))
    engine = ServeEngine(cfg, params, batch_size=LM_SLOTS, max_seq=LM_MAX_SEQ,
                         device=DEVICE)
    sync()
    n_params = sum(t.numel() for t in _leaves(params))
    q_bytes = sum(t.qt.numel() for t in _leaves(engine.params, qtensors=True))
    say(f"weights made on the card from seed {SEED} and quantized in "
        f"{time.perf_counter() - t0:.2f} s: {n_params / 1e9:.3f} B params "
        f"({cfg.dtype}), {q_bytes / 1e9:.3f} GB of int8 projections")
    mem_peak("weights made and quantized")
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
    quant_linear.shapes.clear()
    quantize_rows.shapes.clear()
    rmsnorm.shapes.clear()
    flash_attention.shapes.clear()
    flash_attention_decode.shapes.clear()
    lm_head.shapes.clear()
    lm_head.routes.clear()
    sched = SlotScheduler(LM_SLOTS)
    sync()
    mem_reset()
    steady = torch.cuda.memory_allocated() / 1e9
    reset_launch_counts()            # the LM path's run starts here
    t0 = time.perf_counter()
    served = engine.run(reqs, scheduler=sched)
    sync()
    t_run = time.perf_counter() - t0
    got = launch_counts()            # ... and ends here
    run_peak = mem_peak("the served run")
    del engine._prefill_into         # the class's method again (no cycle)
    by_shape = dict(quant_linear.shapes)
    forwards = engine.calls["prefill_waves"] + engine.calls["decode_steps"]
    counts["lm"] = got
    counts["lm_rms_shapes"] = dict(rmsnorm.shapes)
    counts["lm_flash_shapes"] = dict(flash_attention.shapes)
    counts["lm_flash_routes"] = dict(flash_attention.routes)
    counts["lm_flash_decode_shapes"] = dict(flash_attention_decode.shapes)
    counts["lm_by_shape"] = by_shape
    counts["lm_head_shapes"] = dict(lm_head.shapes)
    counts["lm_head_routes"] = dict(lm_head.routes)
    counts["lm_layers"] = cfg.num_layers
    counts["lm_steps"] = engine.calls["decode_steps"]
    counts["lm_groups"] = group_names(cfg)
    counts["lm_widths"] = (cfg.d_model, cfg.num_kv_heads * cfg.resolved_head_dim,
                           cfg.d_ff)
    norms = 2 * cfg.num_layers + 1
    say(f"launches in the serving run: {got}; {engine.calls['prefill_waves']} "
        f"prefill waves + {engine.calls['decode_steps']} decode steps = "
        f"{forwards} forwards x {norms} rmsnorm")
    check_projection_launches(got, by_shape, cfg.num_layers, engine.calls)
    check(got["rmsnorm"] == norms * forwards,
          f"rmsnorm launches {got['rmsnorm']} != {norms} x {forwards}")
    check_attention_launches(got, cfg.num_layers, engine.calls)
    check(got["lm_head"] == forwards, f"lm_head launches {got['lm_head']} != {forwards}")
    check(all(v == 0 for k, v in got.items() if k not in LM_KERNELS),
          f"the LM path launched another kernel: {got}")
    check_graph_steps(engine, dict.fromkeys(engine.calls, 0), 0, "the served run")
    new = sum(len(r.out_tokens) for r in served)
    check(all(r.done and len(r.out_tokens) == LM_NEW for r in served),
          "a request did not finish with its tokens")
    t_prefill = sum(waves)
    steps = engine.calls["decode_steps"]
    peak = run_peak
    say(f"served {len(served)} requests ({min(lens)}..{max(lens)} prompt tokens, "
        f"{sum(lens)} in all) / {new} new tokens in {t_run:.3f} s: "
        f"{new / t_run:.1f} tokens/s; prefill {t_prefill:.3f} s in {len(waves)} "
        f"waves; decode {(t_run - t_prefill) / max(steps, 1) * 1e3:.2f} ms per step "
        f"({steps} steps of {LM_SLOTS} slots); peak device memory {peak:.2f} GB; "
        f"backfills {sched.backfills}")
    say(f"quant_linear calls by (M, K, (N, ...)): {by_shape}")
    say(f"flash_attention launches by (B, H, KV, Sq, Sk, hd, (causal, window, chunk)): "
        f"{counts['lm_flash_shapes']}; flash_attention_decode by (B, H, KV, slots, "
        f"hd, mask, cache dtype): {counts['lm_flash_decode_shapes']}")
    report["lm"] = {"tokens_per_s": new / t_run, "prefill_s": t_prefill,
                    "decode_ms_per_step": (t_run - t_prefill) / max(steps, 1) * 1e3,
                    "peak_gb": peak, "seconds": t_run, "new_tokens": new}
    wave_cache = _storage_bytes(_cache_tensors(engine.init_shared_cache()))
    S_wave = -(-max(lens) // 8) * 8
    report["lm"]["memory"] = memory_account(
        engine, params, steady, peak,
        prefill_scratch_gb(cfg, LM_SLOTS * S_wave, wave_cache))

    # (b) every stream equals the slot-at-a-time oracle's
    calls = dict(engine.calls)
    mem_reset()
    t0 = time.perf_counter()
    solo = [engine._run_one(r) for r in lm_requests(cfg)]
    t_oracle = time.perf_counter() - t0
    same = sum(a.out_tokens == b.out_tokens for a, b in zip(served, solo))
    say(f"streams equal to the slot-at-a-time _run_one: {same} of {len(served)} "
        f"({t_oracle:.1f} s for the oracle)")
    check(same == len(served), f"{len(served) - same} streams differ from _run_one")
    check_graph_steps(engine, calls, 1, "the oracle")
    mem_peak("the oracle")
    report["lm"]["oracle_s"] = t_oracle

    # (c) int8 prefill logits against the same weights unquantized.  The 20 %
    # bound was pinned on the reference's 2-layer smoke model; on random
    # weights the int8 error grows with depth in the reference as much as
    # here (tests/test_torch_lm.py::test_int8_logit_error_grows_with_depth),
    # so that bound is held at full width on the first 2 layers, and all 28
    # layers are held to INT8_LOGIT_TOL_DEEP, which int8 weights shifted by
    # one layer (each layer given the next one's) must exceed.
    mem_reset()
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
    mem_peak("the 2- and 28-layer int8 comparisons")
    del shifted
    cut = TransformerLM(dataclasses.replace(cfg, num_layers=2), DEVICE)
    tree = {**engine.params, "blocks": _first_layers(engine.params["blocks"], 2)}
    check_earlier_composition(
        "Qwen2", lambda: cut.prefill_ragged(tree, toks, n, cut.init_cache(len(sub), S))[0])
    del cut, tree
    prof = decode_profile(engine, report["lm"]["decode_ms_per_step"], LM_PROMPT_MAX)
    check_decode_step("Qwen2", prof)
    check_norms_per_step("Qwen2", prof, 2 * cfg.num_layers + 1)
    report["lm"]["decode_profile"] = prof
    report["lm"]["prefill_profile"] = prefill_profile(engine, lm_requests(cfg), "Qwen2")
    del engine, params, logits
    free_device_memory()


def phase_lm_plain(counts, report) -> None:
    """Phase 18: Qwen2-1.5B with plain bf16 weights (quantize="none")."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.fixed_linear import fixed_linear
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_decode
    from repro_torch.kernels.lm_head import lm_head
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import ServeEngine, SlotScheduler

    full = get_config(LM_ARCH)
    cfg = dataclasses.replace(full, num_layers=LM_PLAIN_LAYERS, quantize="none")
    L = cfg.num_layers
    phase(f"18. LM serving, plain weights: {cfg.name}, {L} of its {full.num_layers} "
          f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size:,}, {cfg.dtype} weights "
          f"(quantize=none), {LM_SLOTS} slots, max_seq {LM_MAX_SEQ}")
    mem_reset()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    engine = ServeEngine(cfg, params, batch_size=LM_SLOTS, max_seq=LM_MAX_SEQ,
                         device=DEVICE)
    sync()
    n_params = sum(t.numel() for t in _leaves(params))
    say(f"weights made on the card from seed {SEED} in {time.perf_counter() - t0:.2f} s: "
        f"{n_params / 1e9:.3f} B params ({cfg.dtype}), the projections in the decode "
        f"kernel's layout")
    mem_peak("weights made")
    engine.warmup(prompt_lens=[LM_PROMPT_MIN])
    sync()
    reqs = lm_requests(cfg)
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
    for fn in (fixed_linear, rmsnorm, flash_attention, flash_attention_decode, lm_head):
        fn.shapes.clear()
    sched = SlotScheduler(LM_SLOTS)
    sync()
    mem_reset()
    reset_launch_counts()            # the plain-weight LM path's run starts here
    t0 = time.perf_counter()
    served = engine.run(reqs, scheduler=sched)
    sync()
    t_run = time.perf_counter() - t0
    got = launch_counts()            # ... and ends here
    peak = mem_peak("the served run")
    del engine._prefill_into
    waves_n, steps = engine.calls["prefill_waves"], engine.calls["decode_steps"]
    counts["lmp"] = got
    counts["lmp_fixed_shapes"] = dict(fixed_linear.shapes)
    counts["lmp_fixed_routes"] = dict(fixed_linear.routes)
    counts["lmp_layers"] = L
    say(f"launches in the serving run: {got}; {waves_n} prefill waves x ({2 * L + 1} "
        f"rmsnorm + 4 x {L} fixed_linear) + {steps} decode steps x (4 x {L} fixed_linear "
        f"+ 1 rmsnorm)")
    say(f"fixed_linear launches by (M, K, (N, ...), prologue): {counts['lmp_fixed_shapes']}; "
        f"by route: {counts['lmp_fixed_routes']}")
    check(got["fixed_linear"] == 4 * L * (steps + waves_n) > 0,
          f"fixed_linear launches {got['fixed_linear']} != 4 x {L} x ({steps} steps + "
          f"{waves_n} waves)")
    check(sum(n for (_, _, _, pro), n in fixed_linear.shapes.items() if pro == "norm")
          == 2 * L * steps, f"the block norms are not folded into q/k/v and gate/up: "
          f"{dict(fixed_linear.shapes)}")
    want = {"mma_bf16": 4 * L * steps, "mma_bf16_tiled": 4 * L * waves_n}
    check(dict(fixed_linear.routes) == want,
          f"fixed_linear launches by route {dict(fixed_linear.routes)}, not {want}")
    check(got["rmsnorm"] == (2 * L + 1) * waves_n + steps,
          f"rmsnorm launches {got['rmsnorm']} != {2 * L + 1} x {waves_n} + {steps}")
    check_attention_launches(got, L, engine.calls)
    check(got["lm_head"] == waves_n + steps, f"lm_head launches {got['lm_head']}")
    check(all(v == 0 for k, v in got.items() if k not in (
        "fixed_linear", "rmsnorm", "flash_attention", "flash_attention_decode", "lm_head")),
          f"the plain-weight LM path launched another kernel: {got}")
    check_graph_steps(engine, dict.fromkeys(engine.calls, 0), 0, "the served run")
    check(all(r.done and len(r.out_tokens) == LM_NEW for r in served),
          "a request did not finish with its tokens")
    new = sum(len(r.out_tokens) for r in served)
    t_prefill = sum(waves)
    step_ms = (t_run - t_prefill) / max(steps, 1) * 1e3
    say(f"served {len(served)} requests / {new} new tokens in {t_run:.3f} s: "
        f"{new / t_run:.1f} tokens/s; prefill {t_prefill:.3f} s in {len(waves)} waves; "
        f"decode {step_ms:.2f} ms per step ({steps} steps of {LM_SLOTS} slots); peak "
        f"device memory {peak:.2f} GB")
    report["lm_plain"] = {"tokens_per_s": new / t_run, "prefill_s": t_prefill,
                          "decode_ms_per_step": step_ms, "peak_gb": peak, "layers": L}
    calls = dict(engine.calls)
    t0 = time.perf_counter()
    solo = [engine._run_one(r) for r in lm_requests(cfg)]
    first = sum(a.out_tokens[0] == b.out_tokens[0] for a, b in zip(served, solo))
    same = sum(a.out_tokens == b.out_tokens for a, b in zip(served, solo))
    say(f"against the slot-at-a-time _run_one ({time.perf_counter() - t0:.1f} s): first "
        f"tokens equal {first} of {len(served)}, streams equal {same} of {len(served)}")
    check(same == len(served), f"{len(served) - same} streams differ from _run_one")
    check_graph_steps(engine, calls, 1, "the oracle")
    prof = decode_profile(engine, step_ms, LM_PROMPT_MAX)
    check_norms_per_step("Qwen2 plain weights", prof)
    report["lm_plain"]["decode_profile"] = prof
    del engine, params
    free_device_memory()


# our kernels' names in a profile: the CUDA functions' names contain one of
# these (quant_matmul is qmm_group and qmm_wgmma, quantize_rows
# quantize_rows_kernel; the prefill form of
# flash_attention is flash_kernel and flash_mma_kernel, its decode form
# decode_span_kernel and decode_merge_kernel; ssd_chunk_scan's stages are
# ssd_cum_kernel, ssd_state_kernel, ssd_pass_kernel and ssd_out_kernel;
# ssd_decode is ssd_decode_kernel; lm_head is tied_mma_kernel, tied_kernel
# and untied_kernel; fixed_linear is fixed_mma_kernel, fixed_wgmma_kernel
# and fixed_fma_kernel)
PROFILED = {"quant_matmul": ("qmm_",), "quantize_rows": ("quantize_rows_kernel",),
            "rmsnorm": ("rmsnorm_kernel",),
            "ssd_chunk_scan": ("ssd_cum_", "ssd_state_", "ssd_pass_", "ssd_out_"),
            "ssd_decode": ("ssd_decode_kernel",), "fixed_linear": ("fixed_",),
            "flash_attention": ("flash_",), "flash_attention_decode": ("decode_span",
                                                                       "decode_merge"),
            "lm_head": ("tied_",)}
# the kernels an attention LM's serving path launches
LM_KERNELS = ("quant_linear", "quantize_rows", "rmsnorm", "flash_attention",
              "flash_attention_decode", "lm_head")


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


def check_projection_launches(got, groups, layers: int, calls) -> None:
    """Every int8 projection of every forward went through quant_linear, 4
    group calls a layer (q/k/v, o, gate/up, down): a decode step one grouped
    launch each, a prefill wave one quantize_rows launch each and one
    qmm_wgmma launch a weight (7 a layer); quant_matmul not at all.
    ``groups``: quant_linear's calls by (M, K, (N, ...))."""
    from repro_torch.kernels.quant_matmul import SKINNY_M

    waves, steps = calls["prefill_waves"], calls["decode_steps"]
    decode = sum(n for (M, _, _), n in groups.items() if M <= SKINNY_M)
    prefill = sum(n for (M, _, _), n in groups.items() if M > SKINNY_M)
    products = sum(n * len(Ns) for (M, _, Ns), n in groups.items() if M > SKINNY_M)
    say(f"projection launches: quant_linear {got['quant_linear']} = {decode} grouped "
        f"decode launches (4 x {layers} x {steps} steps) + {products} qmm_wgmma (7 x "
        f"{layers} x {waves} waves); quantize_rows {got['quantize_rows']} (4 x {layers} "
        f"x {waves}); quant_matmul {got['quant_matmul']}")
    check(decode == 4 * layers * steps > 0 and prefill == 4 * layers * waves > 0,
          f"quant_linear calls {groups} are not 4 a layer a forward")
    check(products == 7 * layers * waves
          and got["quant_linear"] == 4 * layers * steps + 7 * layers * waves,
          f"quant_linear launches {got['quant_linear']} != 4 x {layers} x {steps} + "
          f"7 x {layers} x {waves}")
    check(got["quantize_rows"] == 4 * layers * waves,
          f"quantize_rows launches {got['quantize_rows']} != 4 x {layers} x {waves}")
    check(got["quant_matmul"] == 0, f"quant_matmul launched {got['quant_matmul']} times")


def earlier_composition() -> swapped_ops:
    """The projections as they ran before the grouped call: quantize_rows's
    plain version, the quant_matmul kernel (fp32 out) and a cast, one weight
    at a time."""
    from repro_torch.kernels import quant_matmul as kqm

    def quant_linear(x, weights):
        xq, xs = kqm.quantize_rows_plain(x)
        return [kqm.quant_matmul(xq, xs, wq, ws).to(x.dtype) for wq, ws in weights]

    return swapped_ops(quant_linear=quant_linear)


def check_earlier_composition(model: str, logits) -> None:
    """``logits()`` (a 2-layer cut's prefill) bitwise the same through the
    grouped kernels as through :func:`earlier_composition`."""
    new = logits()
    with earlier_composition():
        old = logits()
    sync()
    check(bool(torch.isfinite(new).all()), f"{model} 2-layer logits not finite")
    say(f"{model} 2-layer prefill logits {tuple(new.shape)}: through quant_linear "
        f"bitwise equal to quantize_rows (plain) -> quant_matmul -> cast: "
        f"{torch.equal(new, old)} (max abs difference "
        f"{(new.float() - old.float()).abs().max().item():.3g})")
    check(torch.equal(new, old), f"{model} 2-layer logits differ from the earlier composition")


def check_decode_step(model: str, prof) -> None:
    """The graph-replayed decode step within DECODE_STEP_LIMITS: its kernel
    launches, and its projection kernels' device time."""
    most, qmm_ms = DECODE_STEP_LIMITS[model]
    graph = prof["graph"]
    check(graph is not None, f"{model}: the decode step's profile saw no device time")
    say(f"{model} graph step: {graph['launches']:.0f} launches (at most {most}); "
        f"projection kernels {graph['quant_matmul']:.3f} ms (qmm_skinny alone before "
        f"the grouped launch: {qmm_ms} ms)")
    check(graph["launches"] <= most, f"{model}: {graph['launches']:.0f} launches a step")
    check(graph["quant_matmul"] <= qmm_ms,
          f"{model}: projection kernels {graph['quant_matmul']:.3f} ms a step")


def _kernel_times(prof, per: int = 1):
    """The device kernels a torch.profiler run saw, their device-busy ms and
    each of the port's kernels' device ms, per ``per`` calls."""
    from torch.profiler import DeviceType

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]   # the step's own range
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / per
    ours = {name: sum(e.self_device_time_total for e in kernels
                      if any(k in e.key for k in keys)) / 1e3 / per
            for name, keys in PROFILED.items()}
    return kernels, busy, ours


def launches_of(kernels, name: str, per: int = 1) -> float:
    """Launches of one of the port's kernels in a profile, per ``per``."""
    return sum(e.count for e in kernels if any(k in e.key for k in PROFILED[name])) / per


def _print_top(kernels, n: int, per: int = 1) -> None:
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:n]:
        say(f"    {e.self_device_time_total / 1e3 / per:8.3f} ms  "
            f"{e.count // per:5d} x  {e.key[:90]}")


def profile_steps(step, steps: int):
    """torch.profiler (CUDA activity) over ``steps`` calls of ``step``,
    after one call that the profiler traces and discards (its schedule's
    warm-up).  A window opened cold lost the first device records of its
    first call now and then (4 to 54 of a decode step's, among them an
    rmsnorm, in 13 windows of 16) while every launch ran; no warm window
    lost one.  The schedule's "ProfilerStep" range is not a kernel."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        step()
        sync()
        prof.step()
        for _ in range(steps):
            step()
        sync()
        prof.step()
    return prof


def decode_profile(engine, step_ms: float, pos: int, steps: int = 3):
    """Where a decode step's time goes: device time by kernel over
    ``steps`` profiled steps (torch.profiler, CUDA activity), of an eager
    step (``TransformerLM.decode_step`` on a cache of its own) and of the
    engine's CUDA graph replay (``engine._decode`` on its shared cache),
    against the unprofiled step time of the serving run (a graph replay).
    Returns, for each kind, the device-busy ms per step and each of the
    port's kernels' device ms per step, or None where the profiler saw no
    device time."""
    B = engine.batch
    toks = engine._tensor(np.zeros((B, 1), np.int32))
    pos = engine._tensor(np.full(B, pos, np.int32))
    own = engine.model.init_cache(B, engine.max_seq)
    shared = engine.init_shared_cache()
    kinds = {"eager": lambda: engine.model.decode_step(engine.params, toks, pos, own),
             "graph": lambda: engine._decode(engine.params, toks, pos, shared)}
    out = {}
    for kind, step in kinds.items():
        step()
        sync()
        prof = profile_steps(step, steps)
        kernels, device_ms, ours = _kernel_times(prof, steps)
        if device_ms == 0:
            say(f"decode step profile ({kind}): the profiler saw no device time "
                f"(not measured)")
            out[kind] = None
            continue
        launches = sum(e.count for e in kernels) / steps
        norms = launches_of(kernels, "rmsnorm", steps)
        share = f"{device_ms / step_ms:.1%} of" if kind == "graph" else "against"
        say(f"decode step profile ({kind}, {steps} steps, {B} slots): device busy "
            f"{device_ms:.3f} ms, {share} the served run's {step_ms:.2f} ms graph step, "
            f"{launches:.0f} kernel launches a step ({norms:.0f} rmsnorm); "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in ours.items() if v))
        _print_top(kernels, 6, steps)
        out[kind] = {"busy_ms": device_ms, "launches": launches, "rmsnorm_launches": norms,
                     **ours}
    return out


def check_norms_per_step(model: str, prof, want: int = 1) -> None:
    """The graph-replayed decode step runs the rmsnorm kernel ``want`` times:
    once (the final norm) where every block norm is folded into the products
    that read it."""
    graph = prof["graph"]
    check(graph is not None, f"{model}: the decode step's profile saw no device time")
    check(graph["rmsnorm_launches"] == want,
          f"{model}: {graph['rmsnorm_launches']} rmsnorm launches a decode step, not {want}")


def prefill_profile(engine, reqs, model: str):
    """Where one prefill wave's time goes: device time by kernel over the
    wave of the served run's first admissions (the first ``engine.batch``
    requests, padded as the run pads them), under torch.profiler (CUDA
    activity), against the host clock around the same wave.  Returns the
    wave's host ms, device-busy ms and each of the port's kernels' device
    ms, or None where the profiler saw no device time."""
    admits = list(enumerate(reqs[:engine.batch]))
    S = -(-max(len(r.prompt) for _, r in admits) // 8) * 8
    cache = engine.init_shared_cache()
    walls = []

    def wave():
        t0 = time.perf_counter()
        engine._prefill_into(cache, admits)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)

    sync()
    prof = profile_steps(wave, 1)
    wall_ms = walls[-1]
    kernels, device_ms, ours = _kernel_times(prof)
    if device_ms == 0:
        say(f"{model} prefill wave profile: the profiler saw no device time (not measured)")
        return None
    qmm = launches_of(kernels, "quant_matmul")
    say(f"{model} prefill wave profile ({len(admits)} prompts padded to {S}, M = "
        f"{len(admits) * S}): host {wall_ms:.3f} ms (profiled), device busy "
        f"{device_ms:.3f} ms over {sum(e.count for e in kernels)} kernel launches; "
        f"quant_matmul {ours['quant_matmul']:.3f} ms in {qmm:.0f} launches "
        f"({ours['quant_matmul'] / device_ms:.1%} of the busy time); "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ours.items() if v and k != "quant_matmul"))
    _print_top(kernels, 8)
    return {"M": len(admits) * S, "wall_ms": wall_ms, "busy_ms": device_ms, **ours}


def check_graph_steps(engine, before: dict, eager: int, what: str) -> None:
    """Since ``before`` (a copy of ``engine.calls``) every decode step was a
    graph replay but ``eager`` warm-ups before a capture."""
    steps = engine.calls["decode_steps"] - before["decode_steps"]
    replays = engine.calls["decode_graph_replays"] - before["decode_graph_replays"]
    eagers = engine.calls["decode_eager"] - before["decode_eager"]
    say(f"{what}: {steps} decode steps, {replays} CUDA graph replays, {eagers} eager "
        f"(the warm-up before a capture)")
    check(eagers == eager and replays == steps - eager and steps > 0,
          f"{what}: {eagers} eager decode steps and {replays} replays of {steps}, "
          f"expected {eager} eager")


def free_device_memory() -> None:
    """Drop what a phase left: collect the garbage (cycles would keep a
    phase's engine and its weights alive into the next phase) and return
    the cached blocks."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def mem_reset() -> None:
    torch.cuda.reset_peak_memory_stats()


def mem_peak(label: str) -> float:
    """Print and return the device memory peak (GB) since the last reset."""
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"peak device memory, {label}: {peak:.3f} GB ({torch.cuda.memory_allocated() / 1e9:.3f}"
        f" GB allocated now)")
    return peak


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _cache_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _cache_tensors(v)
    else:
        yield tree


def memory_account(engine, params, steady: float, peak: float, scratch_est: float,
                   kept: dict = None) -> dict:
    """What holds the served run's device memory (GB): before the run, the
    bf16 weights (the seeded tree; embeddings and norms shared with the
    served tree), the int8 projections, the engine's decode caches and the
    captured graphs' live tensors, found by walking them, against what the
    allocator counted; during it, what the script ``kept`` for its checks
    and the prefill's scratch, measured (peak − allocated before − kept) and
    estimated from the shapes."""
    q_leaves = list(_leaves(engine.params, qtensors=True))
    hold = {"bf16 weights": _storage_bytes(_leaves(params)) / 1e9,
            "int8 weights": _storage_bytes([t for q in q_leaves for t in (q.qt, q.scale)])
            / 1e9,
            "decode caches": _storage_bytes(_cache_tensors(engine._caches)) / 1e9,
            "graph pools": engine.graph_pool_bytes / 1e9}
    kept = kept or {}
    held, extra = sum(hold.values()), sum(kept.values())
    scratch = peak - steady - extra
    say("memory account of the served run: " + ", ".join(
        f"{k} {v:.3f} GB" for k, v in hold.items())
        + f" = {held:.3f} GB, {held / steady:.1%} of the {steady:.3f} GB allocated before "
        f"the run; during it " + "".join(f"{k} {v:.3f} GB, " for k, v in kept.items())
        + f"prefill scratch {scratch:.3f} GB (estimated from the shapes {scratch_est:.3f} "
        f"GB); peak {peak:.3f} GB, of which the listed holders make "
        f"{(held + extra + scratch) / peak:.1%}, with the estimated scratch "
        f"{(held + extra + scratch_est) / peak:.1%}")
    return {**hold, **kept, "steady": steady, "peak": peak, "scratch": scratch,
            "scratch_est": scratch_est, "explained": (held + extra + scratch) / peak,
            "explained_est": (held + extra + scratch_est) / peak}


def prefill_scratch_gb(cfg, M: int, wave_cache_bytes: int) -> float:
    """The device memory a prefill of M tokens holds at its widest point,
    estimated from the shapes (GB), plus the wave's own cache.  An int8
    MLP's widest point is its (M, d_ff) hidden: the gate and up outputs,
    silu(gate) and the product, bf16 (2 bytes an element each): 8 bytes an
    element.  Mamba2's SSD layer holds about as many fp32
    and bf16 copies of its (M, d_inner) activations (the projections, dt·x,
    the scan's output and the gated norm): 30 bytes an element."""
    if cfg.d_ff:
        act = 8 * M * cfg.d_ff
    else:
        act = 30 * M * cfg.d_inner_ssd
    return (act + wave_cache_bytes) / 1e9


def fp64_on_card(*trees) -> int:
    """Bytes of fp64 tensors on the card: in the given trees, and anywhere
    the garbage collector sees one."""
    import gc

    found = [t for t in _leaves_any(trees) if t.is_cuda and t.dtype == torch.float64]
    found += [o for o in gc.get_objects() if isinstance(o, torch.Tensor) and o.is_cuda
              and o.dtype == torch.float64]
    return _storage_bytes(found)


def _leaves_any(tree):
    from repro_torch.models.layers.quant import QTensor

    if isinstance(tree, (dict, list, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves_any(v)
    elif isinstance(tree, QTensor):
        yield tree.qt
        yield tree.scale
    elif isinstance(tree, torch.Tensor):
        yield tree


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


def _group_operands(gen, M, K, Ns, dtype=torch.bfloat16, extreme=False, ties=False,
                    stride=0):
    """x (M, K) (a view with row stride K + stride) and the int8 group
    [(wq (K, N) as QTensor hands it over, ws)]; with ``ties`` row 0 has
    max |x| = 127 (a scale of exactly 1) and values k + 0.5, and row 1 is
    zero."""
    x = torch.randn(M, K + stride, generator=gen, device=DEVICE) * 3
    if extreme:
        x = torch.where(x > 0, 127.0, -127.0)
    if ties:
        x[0, :K] = (torch.arange(K, device=DEVICE) % 254 - 127) + 0.5
        x[0, 0] = 127.0
        if M > 1:
            x[1] = 0.0
    group = []
    for N in Ns:
        xq, _, wq, ws = _qmm_operands(gen, 1, K, N, extreme)
        group.append((wq, ws))
    return x.to(dtype)[:, :K], group


def group_names(cfg) -> dict:
    """The int8 projection groups of an attention LM by (K, (N, ...))."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, kv, f = cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.d_ff
    return {(d, (q, kv, kv)): "q/k/v", (q, (d,)): "o", (d, (f, f)): "gate/up",
            (f, (d,)): "down"}


def phase_qmm_check(gen, counts) -> dict:
    from repro_torch.kernels import quant_matmul as kqm

    phase("9. quant_matmul's kernels against their plain versions (bitwise)")
    worst = {"quant_matmul": 0.0, "quantize_rows": 0.0}

    def hold(x, group, what):
        a, b = kqm.quant_linear(x, group), kqm.quant_linear_plain(x, group)
        sync()
        err = max((p.float() - q.float()).abs().max().item() for p, q in zip(a, b))
        worst["quant_matmul"] = max(worst["quant_matmul"], err)
        check(all(p.dtype == x.dtype and torch.equal(p, q) for p, q in zip(a, b)),
              f"quant_linear {what} differs: {err}")

    # quant_linear: every served group; ragged K and N at M across the two
    # forms; fp32, row-strided, ±127, tie and zero rows
    groups = sorted({*counts["lm_by_shape"], *counts["g3_by_shape"]})
    ragged = [(M, K, Ns) for M in (1, 5, 8, 16, 17, 33)
              for K, Ns in ((1537, (1, 129, 255)), (255, (129, 255)), (8960, (1536,)))]
    ragged += [(130, 1537, (257,)), (4097, 1040, (300, 8)), (7999, 1536, (1000,))]
    for M, K, Ns in groups + ragged:
        hold(*_group_operands(gen, M, K, Ns), (M, K, Ns))
    variants = [dict(dtype=torch.float32), dict(stride=5), dict(extreme=True),
                dict(ties=True)]
    for M in (1, 8, 16, 17, 7168):
        for kw in variants:
            K, Ns = (8960, (1536,)) if kw.get("extreme") else (1536, (1536, 256, 256))
            hold(*_group_operands(gen, M, K, Ns, **kw), (M, K, Ns, kw))
    say(f"quant_linear bitwise equal to its plain version at the {len(groups)} served "
        f"groups (M, K, (N, ...)) {groups}, {len(ragged)} ragged ones, and at M in "
        f"(1, 8, 16, 17, 7168) in fp32, row-strided, at ±127 and on tie and zero rows")

    # quantize_rows alone
    shapes = sorted({(M, K) for M, K, _ in groups if M > kqm.SKINNY_M})
    shapes += [(1, 1537), (17, 1537), (33, 255), (5, 8960), (8000, 8960)]
    for M, K in shapes:
        for kw in (dict(ties=True), dict(dtype=torch.float32, stride=3)):
            x, _ = _group_operands(gen, M, K, (), **kw)
            a, b = kqm.quantize_rows(x), kqm.quantize_rows_plain(x)
            sync()
            err = max((a[0].int() - b[0].int()).abs().max().item(),
                      (a[1] - b[1]).abs().max().item())
            worst["quantize_rows"] = max(worst["quantize_rows"], err)
            check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                  f"quantize_rows {(M, K, kw)} differs: {err}")
    say(f"quantize_rows bitwise equal to its plain version at {shapes}, bf16 with a "
        f"tie row and a zero row, and fp32 row-strided")

    # quant_matmul, the reference's counterpart, at every served weight
    served = sorted({(M, K, N) for M, K, Ns in groups for N in Ns})
    ragged = [(1, 1536, 1536), (5, 8960, 1536), (33, 1536, 8960), (8, 8960, 255),
              (5, 1537, 255), (33, 8960, 255), (1, 1537, 1), (4097, 1040, 300),
              (130, 1537, 257), (7999, 1536, 1000), (8000, 1536, 129)]
    for M, K, N in served + ragged:
        ops = _qmm_operands(gen, M, K, N)
        a, b = kqm.quant_matmul(*ops), kqm.quant_matmul_plain(*ops)
        sync()
        check(torch.equal(a, b), f"quant_matmul {(M, K, N)} differs: "
              f"{(a - b).abs().max().item()}")
        del ops, a, b
    extreme = [(8, 8960, 1536), (130, 8960, 257), (8000, 8960, 1536)]
    for M, K, N in extreme:
        ops = _qmm_operands(gen, M, K, N, extreme=True)
        a, b = kqm.quant_matmul(*ops), kqm.quant_matmul_plain(*ops)
        sync()
        check(torch.equal(a, b), f"quant_matmul at ±127 {(M, K, N)} differs")
    say(f"quant_matmul bitwise equal at the {len(served)} served shapes {served}, "
        f"{len(ragged)} ragged shapes and {len(extreme)} at ±127 {extreme}")
    return worst


def _cold_sets(group, nbytes: int) -> list:
    """``group`` and copies of its weights (in the layout QTensor hands
    over) filling COLD_BYTES, so that launches cycled through them read the
    weights from HBM and not from L2."""
    copies = max(1, math.ceil(COLD_BYTES / nbytes))
    return [group] + [[(wq.t().contiguous().t(), ws) for wq, ws in group]
                      for _ in range(copies - 1)]


def phase_qmm_timing(gen, counts, worst) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels import quant_matmul as kqm

    phase("10. quant_matmul's kernels timed at the serving shapes")
    groups, products, rows_q = [], {}, {}
    for model, path in (("Qwen2", "lm"), ("Gemma3", "g3")):
        names = counts[f"{path}_groups"]
        for (M, K, Ns), calls in sorted(counts[f"{path}_by_shape"].items()):
            if M <= kqm.SKINNY_M:
                groups.append((model, path, names[(K, Ns)], (M, K, Ns), calls))
                continue
            rows_q.setdefault((model, M, K), 0)
            rows_q[(model, M, K)] += calls
            for N in Ns:
                key = (model, (M, K, N))
                products.setdefault(key, [names[(K, Ns)], 0])
                products[key][1] += calls

    # the decode groups: one grouped launch of x (M, K) bf16 over the weights
    timings = []
    for model, path, name, (M, K, Ns), calls in groups:
        x, group = _group_operands(gen, M, K, Ns)
        n = sum(Ns)
        sets = _cold_sets(group, K * n)
        t_b, by = bound(2 * M * K + K * n + 4 * n + 2 * M * n, 2.0 * M * K * n,
                        INT8_OPS_PER_S)
        row = {"label": f"{model} decode {name}", "model": model, "kind": "decode",
               "shape": [M, K, list(Ns)], "launches": calls, "bound_ms": t_b,
               "bound_by": by, "library_ms": None}
        row["ms"] = graph_ms([lambda g=g: kqm.quant_linear(x, g) for g in sets])
        row["warm_l2_ms"] = graph_ms(lambda: kqm.quant_linear(x, group))
        row["plain_ms"] = cuda_ms(lambda: kqm.quant_linear_plain(x, group), 3)
        first = [QMM_SKINNY_MS.get((M, K, N)) for N in Ns]
        skinny_sum = sum(first) if all(first) else None
        del sets
        free_device_memory()
        ws = [torch.randn(n, K, generator=gen, device=DEVICE).to(torch.bfloat16)
              for _ in range(max(1, math.ceil(COLD_BYTES / (2 * K * n))))]
        row["linear_ms"] = graph_ms([lambda w=w: F.linear(x, w) for w in ws])
        del ws
        free_device_memory()
        skinny = (f"; the members' qmm_skinny (PR 19 readings) {skinny_sum:.4f} ms, "
                  f"{skinny_sum / row['ms']:.2f}x" if skinny_sum else "")
        say(f"quant_linear {row['label']} (M, K, N) = {(M, K, Ns)}, {calls} launches on "
            f"the path: kernel {row['ms']:.4f} ms (weights from HBM; {row['warm_l2_ms']:.4f} "
            f"from L2), plain {row['plain_ms']:.4f} ms, bound {t_b:.4f} ms ({by}), "
            f"{t_b / row['ms']:.1%} of it{skinny}; one bf16 F.linear of (M, K, sum N) "
            f"{row['linear_ms']:.4f} ms (not the same function)")
        timings.append(row)

    # the prefill products: qmm_wgmma on quantized rows, bf16 out
    for (model, (M, K, N)), (name, launched) in sorted(products.items()):
        xq, xs, wq, ws = _qmm_operands(gen, M, K, N)
        wt = wq.t()
        out = torch.empty((M, N), dtype=torch.bfloat16, device=DEVICE)
        bn = kqm.tile_n(M, N, torch.cuda.get_device_properties(0).multi_processor_count)
        t_b, by = bound(M * K + K * N + 4 * (M + N) + 2 * M * N, 2.0 * M * K * N,
                        INT8_OPS_PER_S)
        row = {"label": f"{model} prefill {name}", "model": model, "kind": "prefill",
               "shape": [M, K, N], "launches": launched, "bound_ms": t_b, "bound_by": by}
        # the two forms read in turn, 100 launches a round, the median of 5
        # rounds each: their ≈ 10 µs at Gemma3's k/v are compared at 1.05x
        # below, which a reading of 20 launches each failed now and then
        row["ms"], row["fp32_out_ms"] = alternating_ms(
            [lambda: kqm._launch_product(xq, xs, wt, ws, out, M, N, K, bn),
             lambda: kqm.quant_matmul(xq, xs, wq, ws)])
        row["plain_ms"] = cuda_ms(
            lambda: kqm.quant_matmul_plain(xq, xs, wq, ws).to(torch.bfloat16), 1)
        wk = wq.contiguous()
        try:
            row["library_ms"] = graph_ms(lambda: torch._int_mm(xq, wk), 5, 4)
        except RuntimeError as e:
            row["library_ms"], row["library_note"] = None, str(e).splitlines()[0]
        tiled, fp32 = QMM_TILED_MS.get((M, K, N)), QMM_WGMMA_FP32_MS.get((M, K, N))
        lib_txt = (f"{row['library_ms']:.4f} ms" if row["library_ms"] is not None
                   else f"none ({row['library_note']})")
        say(f"qmm_wgmma {row['label']} (M, K, N) = {(M, K, N)}, {launched} launches on "
            f"the path: bf16 out {row['ms']:.4f} ms, fp32 out {row['fp32_out_ms']:.4f} ms "
            f"(before the bf16 epilogue {fp32} ms), plain {row['plain_ms']:.4f} ms, torch._int_mm "
            f"{lib_txt}, bound {t_b:.4f} ms ({by}), {t_b / row['ms']:.1%} of it"
            + (f"; qmm_tiled {tiled:.4f} ms, {tiled / row['ms']:.2f}x" if tiled else ""))
        timings.append(row)
        del xq, xs, wq, ws, wt, wk, out
        free_device_memory()

    # quantize_rows at the served prefill shapes: x read once, xq and xs
    # written once; each launch reads its own copy of x, so that x comes
    # from HBM whatever the phases before left in L2
    q_rows = []
    for (model, M, K), launched in sorted(rows_q.items()):
        x, _ = _group_operands(gen, M, K, ())
        xs = [x] + [x.clone() for _ in range(max(1, math.ceil(COLD_BYTES / (2 * M * K))) - 1)]
        t_b, by = bound(3 * M * K + 4 * M, 0.0)
        row = {"label": f"{model} prefill ({M}, {K}) bf16", "model": model,
               "shape": [M, K], "launches": launched, "bound_ms": t_b, "bound_by": by,
               "library_ms": None}
        row["ms"] = graph_ms([lambda x=x: kqm.quantize_rows(x) for x in xs])
        row["plain_ms"] = cuda_ms(lambda: kqm.quantize_rows_plain(x), 2)
        say(f"quantize_rows {row['label']}, {launched} launches on the path: kernel "
            f"{row['ms']:.4f} ms (x from HBM), plain {row['plain_ms']:.4f} ms, bound "
            f"{t_b:.4f} ms ({by}), {t_b / row['ms']:.1%} of it")
        q_rows.append(row)
        del x, xs
        free_device_memory()

    for model, path in (("Qwen2", "lm"), ("Gemma3", "g3")):
        mine = [r for r in timings if r["model"] == model]
        step = sum(r["ms"] * r["launches"] for r in mine if r["kind"] == "decode")
        pre = sum(r["ms"] * r["launches"] for r in mine if r["kind"] == "prefill")
        pre_b = sum(r["bound_ms"] * r["launches"] for r in mine if r["kind"] == "prefill")
        qr = sum(r["ms"] * r["launches"] for r in q_rows if r["model"] == model)
        qr_b = sum(r["bound_ms"] * r["launches"] for r in q_rows if r["model"] == model)
        say(f"{model}: quant_linear per decode step from these rows "
            f"{step / counts[f'{path}_steps']:.3f} ms; in the served run's prefill waves "
            f"qmm_wgmma {pre / 1e3:.4f} s (bound {pre_b / 1e3:.4f} s) and quantize_rows "
            f"{qr / 1e3:.4f} s (bound {qr_b / 1e3:.4f} s)")
    check_no_spill("quant_matmul", {
        **{f"qmm_group<{t}>": rf"qmm_groupI{m}EE"
           for t, m in (("int8, fp32", "af"), ("fp32, fp32", "ff"),
                        ("bf16, bf16", r"13__nv_bfloat16S\d*_"))},
        **{f"qmm_wgmma<{bn}, {store}, {t}>": rf"qmm_wgmmaILi{bn}ELb{int(store)}E{m}E"
           for bn in (128, 256) for store in (False, True)
           for t, m in (("fp32", "f"), ("bf16", "13__nv_bfloat16"))},
        **{f"quantize_rows_kernel<{t}>": rf"quantize_rows_kernelI{m}E"
           for t, m in (("fp32", "f"), ("bf16", "13__nv_bfloat16"))}})
    for r in timings:
        if r["kind"] == "decode":
            if r["label"].split()[-1] in ("gate/up", "down"):
                share = r["bound_ms"] / r["ms"]
                say(f"quant_linear {r['label']}: {share:.1%} of its byte bound (target "
                    f"{GROUP_TARGET_SHARE:.0%}: {'met' if share >= GROUP_TARGET_SHARE else 'missed'})")
            continue
        shape = tuple(r["shape"])
        if QMM_TILED_MS.get(shape):
            check(r["ms"] < QMM_TILED_MS[shape], f"qmm_wgmma {r['label']} {shape}: "
                  f"{r['ms']:.4f} ms, not faster than qmm_tiled's {QMM_TILED_MS[shape]} ms")
        fp32 = QMM_WGMMA_FP32_MS.get(shape)
        if fp32:
            # held against the fp32-out form timed beside it on this card:
            # the constant, another machine's reading, moves with the host
            check(r["ms"] <= 1.05 * r["fp32_out_ms"], f"qmm_wgmma {r['label']} {shape}: "
                  f"bf16 out {r['ms']:.4f} ms, over 1.05 x the fp32-out form's "
                  f"{r['fp32_out_ms']:.4f} ms timed beside it (the constant: {fp32} ms)")
        limit = QMM_LIMIT_MS.get(shape)
        if limit:
            say(f"qmm_wgmma {shape}: {r['ms']:.4f} ms against the must {limit[0]} ms and "
                f"the target {limit[1]} ms")
            check(r["ms"] <= limit[0], f"qmm_wgmma {shape}: {r['ms']:.4f} ms over its "
                  f"limit {limit[0]} ms")
    for r in q_rows:
        check(r["bound_ms"] / r["ms"] >= QROWS_MIN_SHARE,
              f"quantize_rows {r['label']}: {r['bound_ms'] / r['ms']:.1%} of its bound, "
              f"under {QROWS_MIN_SHARE:.0%}")
    # the headlines: Qwen2's decode gate/up group (the records before kept
    # its w_gate/w_up launch) and quantize_rows at Qwen2's widest prefill
    head = next(r for r in timings if r["label"] == "Qwen2 decode gate/up")
    qhead = max((r for r in q_rows if r["model"] == "Qwen2"),
                key=lambda r: r["shape"][0] * r["shape"][1])
    launches = {p: counts[p]["quant_linear"] for p in ("lm", "g3")}
    qlaunches = {p: counts[p]["quantize_rows"] for p in ("lm", "g3")}
    return [{
        "name": "quant_matmul", "route": "cuda", "wrapper": "quant_linear",
        "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:77",
        "launches": sum(launches.values()),
        "max_abs_err": worst["quant_matmul"], "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": head["shape"],
        "library_note": "none for the grouped function; the prefill rows' library_ms "
                        "is torch._int_mm (cuBLAS int8, int32 out), no epilogue",
        "shapes": timings,
        "launches_by_path": {"lm_serve": launches["lm"], "gemma3_serve": launches["g3"]},
    }, {
        "name": "quantize_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "none: src/repro/kernels/ops.py:85 quantize_rows, jnp left to XLA",
        "launches": sum(qlaunches.values()),
        "max_abs_err": worst["quantize_rows"], "ms": qhead["ms"],
        "plain_ms": qhead["plain_ms"], "bound_ms": qhead["bound_ms"],
        "bound_by": qhead["bound_by"], "library_ms": None, "shape": qhead["shape"],
        "shapes": q_rows,
        "launches_by_path": {"lm_serve": qlaunches["lm"], "gemma3_serve": qlaunches["g3"]},
    }]


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
        del engine._prefill, engine._decode   # the class's methods (no cycle)
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
    from repro_torch.kernels.fixed_linear import fixed_linear
    from repro_torch.kernels.lm_head import lm_head
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan, ssd_decode
    from repro_torch.models.transformer import TransformerLM, init_model
    from repro_torch.serve import ServeEngine, SlotScheduler

    cfg = dataclasses.replace(get_config(MB_ARCH), num_layers=MB_LAYERS)
    phase(f"11. Mamba2 serving: {cfg.name}, {cfg.num_layers} SSD layers, d_model "
          f"{cfg.d_model}, {cfg.ssd_heads} heads of P={cfg.ssd_head_dim}, "
          f"N={cfg.ssm_state}, vocab {cfg.vocab_size:,}, {cfg.dtype}, {MB_SLOTS} "
          f"slots, max_seq {MB_MAX_SEQ}")
    mem_reset()
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
    mem_peak("weights made")
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
    for fn in (rmsnorm, ssd_chunk_scan, ssd_decode, fixed_linear, lm_head):
        fn.shapes.clear()
    lm_head.routes.clear()
    sched = SlotScheduler(MB_SLOTS)
    sync()
    mem_reset()
    steady = torch.cuda.memory_allocated() / 1e9
    reset_launch_counts()            # the Mamba2 path's run starts here
    t0 = time.perf_counter()
    served = engine.run(reqs, scheduler=sched)
    sync()
    t_run = time.perf_counter() - t0
    got = launch_counts()            # ... and ends here
    peak = mem_peak("the served run")
    del engine._prefill_into         # the class's method again (no cycle)
    prefills, steps = engine.calls["prefills"], engine.calls["decode_steps"]
    forwards = prefills + steps
    L, norms = cfg.num_layers, 2 * cfg.num_layers + 1
    counts["mamba"] = got
    counts["mamba_widths"] = (cfg.d_model, cfg.d_inner_ssd)
    counts["mamba_rms_shapes"] = dict(rmsnorm.shapes)
    counts["mamba_ssd_shapes"] = dict(ssd_chunk_scan.shapes)
    counts["mamba_decode_shapes"] = dict(ssd_decode.shapes)
    counts["mamba_fixed_shapes"] = dict(fixed_linear.shapes)
    counts["mamba_fixed_routes"] = dict(fixed_linear.routes)
    counts["mamba_head_shapes"] = dict(lm_head.shapes)
    counts["mamba_head_routes"] = dict(lm_head.routes)
    say(f"launches in the serving run: {got}; {prefills} per-request prefills + "
        f"{steps} decode steps; a prefill: ssd_chunk_scan x {L}, rmsnorm x {norms}; "
        f"a decode step: fixed_linear x {2 * L}, ssd_decode x {L}, rmsnorm x 1")
    say(f"fixed_linear launches by (M, K, (N, ...), prologue): {counts['mamba_fixed_shapes']}"
        f"; by route: {counts['mamba_fixed_routes']}; ssd_decode by (B, H, P, N, dtype): "
        f"{counts['mamba_decode_shapes']}")
    check(engine.calls["prefill_waves"] == 0 and prefills == len(reqs),
          f"Mamba2 admissions did not prefill per request: {engine.calls}")
    check(got["ssd_chunk_scan"] == L * prefills > 0,
          f"ssd_chunk_scan launches {got['ssd_chunk_scan']} != {L} x {prefills}")
    check(got["rmsnorm"] == norms * prefills + steps,
          f"rmsnorm launches {got['rmsnorm']} != {norms} x {prefills} + {steps}")
    check(got["fixed_linear"] == 2 * L * steps > 0 and got["ssd_decode"] == L * steps,
          f"fixed_linear / ssd_decode launches {got['fixed_linear']} / "
          f"{got['ssd_decode']} != {2 * L} / {L} x {steps}")
    check(sum(n for (_, _, _, pro), n in fixed_linear.shapes.items() if pro == "norm")
          == 2 * L * steps and sum(n for (_, K, _, _), n in fixed_linear.shapes.items()
                                   if K == cfg.d_inner_ssd) == L * steps,
          f"the decode step's norms are not folded into fixed_linear: "
          f"{dict(fixed_linear.shapes)}")
    check(all(g for (*_, g) in ssd_decode.shapes),
          f"ssd_decode did not write the gated norm's gate: {dict(ssd_decode.shapes)}")
    check(set(fixed_linear.routes) == {"mma_bf16"},
          f"a fixed_linear launch left the tensor-core route: {dict(fixed_linear.routes)}")
    check(got["lm_head"] == forwards, f"lm_head launches {got['lm_head']} != {forwards}")
    check(all(v == 0 for k, v in got.items()
              if k not in ("rmsnorm", "ssd_chunk_scan", "lm_head", "fixed_linear",
                           "ssd_decode")),
          f"the Mamba2 path launched another kernel: {got}")
    check_graph_steps(engine, dict.fromkeys(engine.calls, 0), 0, "the served run")
    check(all(r.done and len(r.out_tokens) == MB_NEW for r in served),
          "a request did not finish with its tokens")
    new = sum(len(r.out_tokens) for r in served)
    t_prefill = sum(waves)
    step_ms = (t_run - t_prefill) / max(steps, 1) * 1e3
    say(f"served {len(served)} requests (prompts {lens}, {sum(lens)} tokens) / "
        f"{new} new tokens in {t_run:.3f} s: {new / t_run:.1f} tokens/s; prefill "
        f"{t_prefill:.3f} s in {len(waves)} admissions; decode {step_ms:.2f} ms per "
        f"step ({steps} steps of {MB_SLOTS} slots); peak device memory {peak:.2f} GB; "
        f"backfills {sched.backfills}")
    # a per-request prefill runs into a batch-1 cache of its own
    wave_cache = _storage_bytes(_cache_tensors(engine.init_shared_cache())) // MB_SLOTS
    memory_account(engine, params, steady, peak,
                   prefill_scratch_gb(cfg, max(lens), wave_cache),
                   kept={"SSD states kept for the bitwise check":
                         _storage_bytes(states.values()) / 1e9})

    # the slot-at-a-time oracle: first tokens and prefilled states must be
    # equal (both prefill at batch 1), streams are counted
    calls = dict(engine.calls)
    mem_reset()
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
            f"_run_one's top-2 logit gap is {gap:.4f}")
    check(first_same == len(served), "a first token differs from _run_one's")
    check(state_same == len(served), "a prefilled SSD state differs from _run_one's")
    check(same == len(served), f"{len(served) - same} streams differ from _run_one at "
          f"{L} layers: {differ}")
    check_graph_steps(engine, calls, 1, "the oracle")
    mem_peak("the oracle")
    del states, solo_states
    mem_reset()

    # the same engine at a 2-layer cut of the model
    cut_cfg = dataclasses.replace(cfg, num_layers=2)
    cut = ServeEngine(cut_cfg, {**params, "blocks": _first_layers(params["blocks"], 2)},
                      batch_size=MB_SLOTS, max_seq=MB_MAX_SEQ, device=DEVICE)
    served2 = cut.run(mamba_requests(cfg))
    solo2, _, gaps2 = oracle_streams(cut, cfg)
    same2, differ2 = compare_streams(served2, solo2, gaps2)
    say(f"at 2 layers: streams equal to _run_one {same2} of {len(served2)}"
        + "".join(f"; request {i} leaves at step {k}, gap {g:.4f}" for i, k, g in differ2))
    check(same2 == len(served2), f"at 2 layers {len(served2) - same2} streams differ from "
          f"_run_one: {differ2}")
    check_graph_steps(cut, dict.fromkeys(cut.calls, 0), 2, "the 2-layer cut, run and oracle")
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
    mem_peak("the 2-layer cut and the logit comparisons")

    counts["mamba_profile"] = decode_profile(engine, step_ms, max(lens))
    check_norms_per_step("Mamba2", counts["mamba_profile"])
    del engine, params
    free_device_memory()


def _ssd_operands(gen, B, H, S, P, N, with_h0, served=False, layer=False):
    """The scan's inputs as tests/test_kernels.py draws them (mild decays,
    cum ≈ −0.08 a step), or, with ``served``, as the SSD layer makes them
    from a random model: log_a = −softplus(dt)·A with A from U(1, 16) per
    head (ssd_init's draw), dx = softplus(dt)·x, unit B and C, so cum falls
    by ≈ 7 a step and reaches −10⁴ over a chunk of 1,000.  With ``layer``,
    log_a and dx are transposed views of (B, S, H[, P]) tensors, as the SSD
    layer passes them; else contiguous."""
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
    if layer:
        la = la.transpose(1, 2).contiguous().transpose(1, 2)
        dx = dx.transpose(1, 2).contiguous().transpose(1, 2)
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
    for (B, H, S, P, N, L, *h), layer in itertools.product(
            ssd_shapes + [c + (w,) for c in ragged for w in (True, False)], (True, False)):
        la, dx, Bm, Cm, h0 = _ssd_operands(gen, B, H, S, P, N, h[0], layer=layer)
        y, hf = kss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L)
        yp, hp = kss.ssd_chunk_scan_plain(la, dx, Bm, Cm, h0, chunk=L)
        sync()
        ey, eh = rel_err(y, yp), rel_err(hf, hp)
        worst["ssd_chunk_scan"] = max(worst["ssd_chunk_scan"], (y - yp).abs().max().item(),
                                      (hf - hp).abs().max().item())
        check(ey <= FP32_TOL and eh <= FP32_TOL,
              f"ssd_chunk_scan {(B, H, S, P, N, L, h[0])}, layer layout {layer}: y rel "
              f"err {ey}, h rel err {eh}")
    say(f"ssd_chunk_scan at the {len(ssd_shapes)} served (B, H, S, P, N, L, h0) and "
        f"{2 * len(ragged)} ragged ones (L = 1, 37, 256, S; with and without h0), each "
        f"with log_a and dx as the SSD layer passes them (transposed views) and "
        f"contiguous: y and h_final within {FP32_TOL} of their max |entry|")

    # the served decays, where cum reaches −10⁴ and the order of its running
    # sum moves the result: held against the function's value (fp64)
    cases = ssd_shapes + [c + (w,) for c in ragged[:4] for w in (True, False)]
    read = {"kernel": [], "plain": [], "kernel vs plain": []}
    cum_max = 0.0
    for (B, H, S, P, N, L, *h), layer in itertools.product(cases, (True, False)):
        la, dx, Bm, Cm, h0 = _ssd_operands(gen, B, H, S, P, N, h[0], served=True,
                                           layer=layer)
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
              f"decays, layer layout {layer}: kernel vs fp64 rel err {ek}")
        del y64, h64
    say(f"ssd_chunk_scan at the served decays (log_a = −softplus(dt)·A, A in [1, 16]; "
        f"max |cum| over a chunk {cum_max:.0f}), {len(cases)} shapes in both layouts: "
        f"y and h_final against the same function in fp64, max over the shapes of the error over "
        f"max |entry|: kernel {max(read['kernel']):.3g} (bound {FP32_TOL}), plain "
        f"version {max(read['plain']):.3g}, kernel vs plain version "
        f"{max(read['kernel vs plain']):.3g}")

    # every sum in an order fixed by (L, P, N) and the tile: head b of a
    # batch of 3 is bitwise the same at B = 1, and a call repeats its bits
    for B, H, S, P, N, L, *h in ssd_shapes:
        la, dx, Bm, Cm, h0 = _ssd_operands(gen, 3, H, S, P, N, h[0], served=True,
                                           layer=True)
        y, hf = kss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L)
        y2, hf2 = kss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L)
        y1, hf1 = kss.ssd_chunk_scan(la[1:2], dx[1:2], Bm[1:2], Cm[1:2],
                                     None if h0 is None else h0[1:2], chunk=L)
        sync()
        check(torch.equal(y, y2) and torch.equal(hf, hf2),
              f"ssd_chunk_scan {(3, H, S, P, N, L, h[0])}: a second call differs")
        check(torch.equal(y1, y[1:2]) and torch.equal(hf1, hf[1:2]),
              f"ssd_chunk_scan {(B, H, S, P, N, L, h[0])}: a head alone differs from "
              f"the same head in a batch of 3")
    say(f"ssd_chunk_scan at the {len(ssd_shapes)} served shapes (the layer's strided "
        f"log_a and dx, served decays): head b of a batch of 3 bitwise equal to it at "
        f"B = 1, and a second call bitwise equal to the first")

    # at small L the scratch would hold ~S/L states a head: the stages run
    # over segments of chunks within kss.WORKSPACE_BYTES, bitwise the same
    # as in one segment
    B, H, S, P, N, L = 1, 80, 512, 64, 128, 1
    la, dx, Bm, Cm, h0 = _ssd_operands(gen, B, H, S, P, N, True, layer=True)
    lib, bound_bytes = kss._lib(), kss.WORKSPACE_BYTES
    seg = lib.ssd_chunk_scan_segment(B, H, S, P, N, L, B * H * S + bound_bytes // 4)
    work = 4 * lib.ssd_chunk_scan_workspace(B, H, S, P, N, L, seg)
    y, hf = kss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L)
    yp, hp = kss.ssd_chunk_scan_plain(la, dx, Bm, Cm, h0, chunk=L)
    try:
        kss.WORKSPACE_BYTES = 1 << 40
        y1, hf1 = kss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L)
    finally:
        kss.WORKSPACE_BYTES = bound_bytes
    sync()
    worst["ssd_chunk_scan"] = max(worst["ssd_chunk_scan"], (y - yp).abs().max().item(),
                                  (hf - hp).abs().max().item())
    check(work <= 4 * (B * H * S + 4) + bound_bytes and seg < S // L,
          f"ssd_chunk_scan {(B, H, S, P, N, L)}: a workspace of {work} bytes, {seg} "
          f"chunks a segment")
    check(rel_err(y, yp) <= FP32_TOL and rel_err(hf, hp) <= FP32_TOL,
          f"ssd_chunk_scan {(B, H, S, P, N, L)} in segments: y rel err {rel_err(y, yp)}, "
          f"h rel err {rel_err(hf, hp)}")
    check(torch.equal(y, y1) and torch.equal(hf, hf1),
          f"ssd_chunk_scan {(B, H, S, P, N, L)}: segments of {seg} chunks differ from one "
          f"segment")
    say(f"ssd_chunk_scan at {(B, H, S, P, N, L)}: a workspace of {work} bytes (bound "
        f"{bound_bytes} beside the running sums), {seg} chunks a segment, "
        f"{-(-(S // L) // seg)} segments; within {FP32_TOL} of the plain version and "
        f"bitwise equal to one segment")
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
    labels = {multi: "several chunks", single: "one ragged chunk"}
    usage = ssd_stage_usage()
    say("ssd_chunk_scan's stages, -Xptxas -v (registers, spill store / load bytes): "
        + ", ".join(f"{k} {r} registers, {st} / {ld}" for k, (r, st, ld) in usage.items()))
    check(set(usage) == set(SSD_STAGES), f"ssd_chunk_scan's stages in the -Xptxas -v "
          f"report: {sorted(usage)}, not {list(SSD_STAGES)}")
    check(all(st == 0 and ld == 0 for _, st, ld in usage.values()),
          f"an ssd_chunk_scan stage spills: {usage}")
    # every served shape, with log_a and dx strided as the SSD layer passes
    # them: the kernel (CUDA graph) against the plain version
    timings = []
    for key in sorted(ssd, key=lambda k: (k[5] == k[2], k[2])):
        B, H, S, P, N, L, with_h0 = key
        la, dx, Bm, Cm, h0 = _ssd_operands(gen, B, H, S, P, N, with_h0, layer=True)

        def kernel():
            return kss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L)

        ms = graph_ms(kernel, launches=5)
        plain_ms = cuda_ms(lambda: kss.ssd_chunk_scan_plain(la, dx, Bm, Cm, h0, chunk=L), 3)
        check(ms < plain_ms, f"ssd_chunk_scan {key}: kernel {ms:.4f} ms is not faster "
              f"than its plain version {plain_ms:.4f} ms")
        if key not in labels:
            say(f"ssd_chunk_scan (B, H, S, P, N, L) = {key[:6]}, {ssd[key]} launches: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
            continue
        label = labels[key]
        t_b, by = bound(4 * (B * H * S + 2 * B * H * S * P + 2 * B * S * N
                             + (2 if with_h0 else 1) * B * H * P * N),
                        ssd_scan_ops(B, H, S, P, N, L, with_h0))
        stages = stage_ms(kernel)
        first, (limit, target) = SSD_FIRST_MS[label], SSD_LIMIT_MS[label]
        say(f"ssd_chunk_scan {label} (B, H, S, P, N, L) = {key[:6]}, {ssd[key]} launches "
            f"on the path: kernel {ms:.4f} ms (first version {first} ms), plain "
            f"{plain_ms:.4f} ms, library none, bound {t_b:.4f} ms ({by}), {t_b / ms:.1%} of "
            f"it; limit {limit} ms {'met' if ms <= limit else 'MISSED'}, target {target} ms "
            f"{'met' if ms <= target else 'missed'}; by stage (torch.profiler, ms a call): "
            + (", ".join(f"{k} {v:.4f}" for k, v in stages.items()) if stages
               else "not measured (no device time in the profile)"))
        timings.append({"label": label, "shape": [B, H, S, P, N, L], "launches": ssd[key],
                        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                        "bound_ms": t_b, "bound_by": by, "stages_ms": stages})
    head = timings[0]
    records.append({
        "name": "ssd_chunk_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:105",
        "launches": counts["mamba"]["ssd_chunk_scan"],
        "max_abs_err": worst["ssd_chunk_scan"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None, "shape": head["shape"],
        "shapes": timings, "registers": usage,
        "launches_by_path": {"mamba_serve": counts["mamba"]["ssd_chunk_scan"]},
    })
    return records


def stage_ms(fn, calls: int = 5) -> dict:
    """Device ms a call of each of ssd_chunk_scan's CUDA functions, from
    torch.profiler over ``calls`` calls (empty where it saw no device
    time)."""
    import re

    from torch.profiler import DeviceType

    fn()
    sync()
    prof = profile_steps(fn, calls)
    out = {}
    for e in prof.key_averages():
        m = re.search(r"ssd_[a-z]+_kernel", e.key)
        if e.device_type == DeviceType.CUDA and m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + e.self_device_time_total / 1e3 / calls
    return {k: v for k, v in out.items() if v > 0}


def ssd_stage_usage() -> dict:
    """Stage name → (registers, spill store bytes, spill load bytes) of
    ssd_chunk_scan's CUDA functions, from phase 2's -Xptxas -v report."""
    import re

    stages = {}
    for name, use in ptxas_usage("ssd_scan").items():
        m = re.search(r"ssd_[a-z]+_kernel", name)
        if m and m.group(0) in SSD_STAGES:
            stages[m.group(0)] = use[:3]
    return stages


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
                       rmsnorm=krn.rmsnorm_plain, quant_linear=kqm.quant_linear_plain)


def phase_gemma3(counts, report) -> None:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import lm_head as klm
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
    mem_reset()
    t0 = time.perf_counter()
    # drawn plain (the checks below hold the engine's int8 tree against it);
    # the engine quantizes it
    params = init_model(torch.Generator(device=DEVICE).manual_seed(SEED),
                        dataclasses.replace(cfg, quantize="none"))
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
    mem_peak("weights made and quantized")
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
    for fn in (kfa.flash_attention, kfa.flash_attention_decode, kqm.quant_linear,
               kqm.quantize_rows, krn.rmsnorm, klm.lm_head):
        fn.shapes.clear()
    klm.lm_head.routes.clear()
    sched = SlotScheduler(G3_SLOTS)
    sync()
    mem_reset()
    steady = torch.cuda.memory_allocated() / 1e9
    reset_launch_counts()            # the Gemma3 path's run starts here
    t0 = time.perf_counter()
    served = engine.run(reqs, scheduler=sched)
    sync()
    t_run = time.perf_counter() - t0
    got = launch_counts()            # ... and ends here
    peak = mem_peak("the served run")
    del engine._prefill_into         # the class's method again (no cycle)
    steps = engine.calls["decode_steps"]
    forwards = engine.calls["prefill_waves"] + steps
    counts["g3"] = got
    counts["g3_flash_shapes"] = dict(kfa.flash_attention.shapes)
    counts["g3_flash_routes"] = dict(kfa.flash_attention.routes)
    counts["g3_flash_decode_shapes"] = dict(kfa.flash_attention_decode.shapes)
    counts["g3_layers"] = L
    counts["g3_head_shapes"] = dict(klm.lm_head.shapes)
    counts["g3_head_routes"] = dict(klm.lm_head.routes)
    counts["g3_by_shape"] = dict(kqm.quant_linear.shapes)
    counts["g3_steps"] = steps
    counts["g3_groups"] = group_names(cfg)
    say(f"launches in the serving run: {got}; {engine.calls['prefill_waves']} prefill "
        f"waves + {steps} decode steps = {forwards} forwards x {2 * L + 1} rmsnorm")
    check_projection_launches(got, counts["g3_by_shape"], L, engine.calls)
    check(got["rmsnorm"] == (2 * L + 1) * forwards,
          f"rmsnorm launches {got['rmsnorm']} != {2 * L + 1} x {forwards}")
    check_attention_launches(got, L, engine.calls)
    check(got["lm_head"] == forwards, f"lm_head launches {got['lm_head']} != {forwards}")
    check(all(v == 0 for k, v in got.items() if k not in LM_KERNELS),
          f"the Gemma3 path launched another kernel: {got}")
    check_graph_steps(engine, dict.fromkeys(engine.calls, 0), 0, "the served run")
    check(all(r.done and len(r.out_tokens) == G3_NEW for r in served),
          "a request did not finish with its tokens")
    say(f"flash_attention launches by (B, H, KV, Sq, Sk, hd, (causal, window, chunk)): "
        f"{counts['g3_flash_shapes']}; flash_attention_decode by (B, H, KV, slots, "
        f"hd, mask, cache dtype): {counts['g3_flash_decode_shapes']}")
    say(f"quant_linear calls by (M, K, (N, ...)): {counts['g3_by_shape']}")
    over = [n for n in lens if n > cfg.window]
    wrap = [n for n in lens if n <= cfg.window < n + G3_NEW]
    say(f"prompts over the {cfg.window}-slot ring at prefill: {over}; wrapping it "
        f"mid-decode: {wrap}; the global caches reach position {max(lens) + G3_NEW - 1}")
    new = sum(len(r.out_tokens) for r in served)
    t_prefill = sum(waves)
    step_ms = (t_run - t_prefill) / max(steps, 1) * 1e3
    say(f"served {len(served)} requests (prompts {lens}, {sum(lens)} tokens) / {new} "
        f"new tokens in {t_run:.3f} s: {new / t_run:.1f} tokens/s; prefill "
        f"{t_prefill:.3f} s in {len(waves)} waves; decode {step_ms:.2f} ms per step "
        f"({steps} steps of {G3_SLOTS} slots); peak device memory {peak:.2f} GB; "
        f"backfills {sched.backfills}")
    report["gemma3"] = {"tokens_per_s": new / t_run, "prefill_s": t_prefill,
                        "decode_ms_per_step": step_ms, "peak_gb": peak,
                        "seconds": t_run, "new_tokens": new}
    wave_cache = _storage_bytes(_cache_tensors(engine.init_shared_cache()))
    S_wave = -(-max(lens) // 8) * 8
    report["gemma3"]["memory"] = memory_account(
        engine, params, steady, peak,
        prefill_scratch_gb(cfg, G3_SLOTS * S_wave, wave_cache))
    wide = fp64_on_card(params, engine.params, engine._caches)
    say(f"fp64 tensors on the card after the served run: {wide} bytes (an fp64 copy "
        f"of the token table would be {cfg.vocab_size * cfg.d_model * 8 / 1e9:.2f} GB)")
    check(wide == 0, f"{wide} bytes of fp64 tensors on the card")

    # every stream equals the slot-at-a-time oracle's
    calls = dict(engine.calls)
    mem_reset()
    t0 = time.perf_counter()
    solo = [engine._run_one(r) for r in gemma3_requests(cfg)]
    t_oracle = time.perf_counter() - t0
    same = sum(a.out_tokens == b.out_tokens for a, b in zip(served, solo))
    say(f"streams equal to the slot-at-a-time _run_one: {same} of {len(served)} "
        f"({t_oracle:.1f} s for the oracle)")
    check(same == len(served), f"{len(served) - same} streams differ from _run_one")
    check_graph_steps(engine, calls, 1, "the oracle")
    mem_peak("the oracle")
    report["gemma3"]["oracle_s"] = t_oracle
    mem_reset()

    # last-token prefill logits through the kernels against the plain
    # versions, at a 2-layer cut; beside it, each kernel alone, a plain
    # attention summed in fp32 (how far rounding alone moves the logits), one
    # whose window is one key wider, and the same weights unquantized
    cut_cfg, tree = gemma3_cut(cfg, engine.params)
    _, tree_bf16 = gemma3_cut(cfg, params)
    model = TransformerLM(cut_cfg, DEVICE)
    sub = sorted(reqs, key=lambda r: len(r.prompt))[-2:]
    plain = dict(rmsnorm=krn.rmsnorm_plain, quant_linear=kqm.quant_linear_plain)
    plain_attn = dict(flash_attention=kfa.flash_attention_plain,
                      flash_attention_decode=kfa.flash_attention_decode_plain)
    variants = {"kernels": (swapped_ops(), tree),
                "flash_attention kernel alone": (swapped_ops(**plain), tree),
                "rmsnorm kernel alone": (swapped_ops(
                    **plain_attn, quant_linear=kqm.quant_linear_plain), tree),
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
    for r in sub:
        toks = torch.as_tensor(r.prompt[None], device=DEVICE)
        check_earlier_composition(
            f"Gemma3 ({len(r.prompt)} tokens)",
            lambda: model.prefill(tree, toks, model.init_cache(1, len(r.prompt)))[0])
    mem_peak("the 2-layer comparisons")
    prof = decode_profile(engine, step_ms, max(lens))
    check_decode_step("Gemma3", prof)
    check_norms_per_step("Gemma3", prof, 2 * L + 1)
    report["gemma3"]["decode_profile"] = prof
    report["gemma3"]["prefill_profile"] = prefill_profile(engine, gemma3_requests(cfg),
                                                          "Gemma3")
    del engine, params, tree, model
    free_device_memory()


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


def _flash_err(a, b, dtype, keys: int = 0):
    """(within the tolerance, max abs error, max error over the tolerance);
    ``keys``, a row's most admitted keys, scales the bf16 floor past
    FLASH_TOL_KEYS."""
    tol = FLASH_TOL[dtype]
    err = (a.float() - b.float()).abs()
    atol = tol["atol"] * (max(1.0, math.sqrt(keys / FLASH_TOL_KEYS)) if dtype == torch.bfloat16
                          else 1.0)
    allowed = atol + tol["rtol"] * b.float().abs()
    return bool((err <= allowed).all()), err.max().item(), (err / allowed).max().item()


def phase_flash_check(gen, counts) -> dict:
    from repro_torch.kernels import flash_attention as kfa

    phase("15. flash_attention against its plain versions")
    say(f"tolerance: fp32 {FP32_TOL} (rtol and atol, tests/test_kernels.py's), bf16 "
        f"one bf16 step of each value (rtol 2^-7) + 1e-6")
    worst = {"flash_attention": 0.0, "flash_attention_decode": 0.0}
    # every served prefill launch (bf16) took the tensor-core route
    for path in ("lm", "g3"):
        routes, n = counts[f"{path}_flash_routes"], counts[path]["flash_attention"]
        check(routes == {kfa.ROUTES[torch.bfloat16]: n} and n > 0,
              f"{path}: served prefill launches by route {routes}, of {n}")
    say(f"served prefill launches by route: Qwen2 {counts['lm_flash_routes']}, Gemma3 "
        f"{counts['g3_flash_routes']} (every one on the tensor cores)")
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
        (2, 4, 1, 513, 513, 256, dict(causal=True, window=512), both),
        (2, 6, 1, 200, 200, 64, dict(causal=True), both),          # 6:1, Sq % 16 != 0
        (1, 4, 2, 50, 300, 64, dict(causal=True, chunk=64), both)]  # Sq < Sk
    kfa.flash_attention.routes.clear()
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
    n_bf16 = sum(torch.bfloat16 in c[-1] for c in cases)
    n_fp32 = sum(torch.float32 in c[-1] for c in cases)
    routes = dict(kfa.flash_attention.routes)
    check(routes == {kfa.ROUTES[torch.bfloat16]: n_bf16, kfa.ROUTES[torch.float32]: n_fp32},
          f"prefill launches by route {routes}: {n_bf16} bf16, {n_fp32} fp32 cases")
    say(f"prefill form at the {len(served)} served shapes (bf16) and {len(cases) - len(served)} "
        f"others in fp32 and bf16 (hd 32, 64, 128, 256; GQA 1:1, 2:1, 4:1, 6:1; causal, "
        f"window, chunk, not causal; Sq < Sk; Sk 33, 100, 200, 300, 513, 600, 777): within "
        f"the tolerance, max abs error {worst['flash_attention']:.3g}; launches by route "
        f"{routes}")
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

    # the precision choice on the card: the tensor-core kernel with p in 1,
    # 2 and 3 bf16 terms (3 is the served kernel, bitwise) against the plain
    # version, at the widest served global shapes of both models
    for label, shapes in (("Gemma3", counts["g3_flash_shapes"]),
                          ("Qwen2", counts["lm_flash_shapes"])):
        B, H, KV, Sq, Sk, hd, key = max((k for k in shapes if k[6][1] is None),
                                        key=lambda k: (k[0], k[4]))
        kw = _mask_kwargs(key)
        q, k, v = _flash_inputs(gen, torch.bfloat16, B, H, KV, Sq, Sk, hd)
        want = kfa.flash_attention_plain(q, k, v, **kw)
        read = {}
        for terms in (1, 2, 3):
            a = kfa.flash_attention_terms(q, k, v, terms, **kw)
            if terms == kfa.P_TERMS:
                check(torch.equal(a, kfa.flash_attention(q, k, v, **kw)),
                      f"{label}: the kernel at {terms} terms is not the served kernel")
            _, _, ratio = _flash_err(a, want, torch.bfloat16)
            tol = FLASH_TOL[torch.bfloat16]
            over = ((a.float() - want.float()).abs()
                    > tol["atol"] + tol["rtol"] * want.float().abs()).float().mean().item()
            read[terms] = (ratio, over)
            del a
        check(read[kfa.P_TERMS][0] <= 1.0, f"{label}: {kfa.P_TERMS} terms read {read}")
        say(f"p in bf16 terms at {label}'s served {(B, H, KV, Sq, Sk, hd)} {kw}, against the "
            f"plain version: " + "; ".join(f"{t} term{'s' * (t > 1)} {r:.3g} x the tolerance "
                                           f"({o:.3g} of the values beyond it)"
                                           for t, (r, o) in read.items()))
        del q, k, v, want
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


def ptxas_usage(stem: str) -> dict:
    """Entry function → (registers, spill store bytes, spill load bytes,
    stack frame bytes) of each CUDA function of ``csrc/<stem>.cu``, from
    phase 2's -Xptxas -v report."""
    import re

    found, name = {}, None
    for line in BUILD_LOGS.get(stem, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            found[name] = [0, 0, 0, 0]
        elif name is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                found[name][1:] = [int(m.group(2)), int(m.group(3)), int(m.group(1))]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                found[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in found.items()}


def check_no_spill(stem: str, wanted: dict) -> None:
    """Each CUDA function of ``csrc/<stem>.cu`` that ``wanted`` names (label
    → a pattern of its mangled name) is in phase 2's -Xptxas -v report, with
    no spill and no stack frame."""
    import re

    usage = ptxas_usage(stem)
    found = {label: next((u for n, u in usage.items() if re.search(pat, n)), None)
             for label, pat in wanted.items()}
    say(f"{stem} (-Xptxas -v; registers, spill store / load bytes, stack frame): "
        + ", ".join(f"{k} " + (f"{u[0]} registers, {u[1]} / {u[2]}, {u[3]}" if u
                               else "missing") for k, u in found.items()))
    check(all(found.values()), f"{stem}: not in the -Xptxas -v report: "
          f"{[k for k, u in found.items() if u is None]}")
    check(all(u[1:] == (0, 0, 0) for u in found.values() if u),
          f"{stem}: a function spills or keeps a stack frame: {found}")


def mma_registers() -> dict:
    """hd → (registers, spill store bytes, spill load bytes) of each
    tensor-core prefill instance."""
    import re

    found = {}
    for name, use in ptxas_usage("flash_attention").items():
        m = re.search(r"flash_mma_kernelILi(\d+)E", name)
        if m:
            found[int(m.group(1))] = use[:3]
    return found


def phase_flash_timing(gen, counts, worst) -> list:
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.flash_attention import _admitted, slot_positions

    phase("16. flash_attention timing at the served shapes")
    say(f"card: {CARD}")
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
    regs = mma_registers()
    say("tensor-core prefill instances (-Xptxas -v): " + ", ".join(
        f"hd {hd}: {r} registers, {st} bytes of spill stores, {ld} of spill loads"
        for hd, (r, st, ld) in sorted(regs.items())))
    check(bool(regs), "no tensor-core prefill instance in the -Xptxas -v report")
    check(all(st == 0 and ld == 0 for _, st, ld in regs.values()),
          f"a tensor-core prefill instance spills: {regs}")
    for label, key in pre_rows:
        B, H, KV, Sq, Sk, hd, mk = key
        kw = _mask_kwargs(mk)
        q, k, v = _flash_inputs(gen, torch.bfloat16, B, H, KV, Sq, Sk, hd)
        ms = cuda_ms(lambda: kfa.flash_attention(q, k, v, **kw), 5)
        plain_ms = cuda_ms(lambda: kfa.flash_attention_plain(q, k, v, **kw), 1)
        # the fp32 kernel (IEEE fp32 on the SIMT pipe) at the same shape, on
        # the same values in fp32: the yardstick of the route it replaced
        qf, kf, vf = q.float(), k.float(), v.float()
        simt_ms = cuda_ms(lambda: kfa.flash_attention(qf, kf, vf, **kw), 3)
        del qf, kf, vf
        pq = torch.arange(Sq, device=DEVICE)[:, None] + (Sk - Sq)
        mask = _admitted(pq, torch.arange(Sk, device=DEVICE)[None, :], **kw)
        if kw["window"] is not None or kw["chunk"] is not None:
            lib, backend = sdpa_yardstick(q, k, v, attn_mask=mask, scale=hd ** -0.5)
        else:
            lib, backend = sdpa_yardstick(q, k, v, is_causal=True, scale=hd ** -0.5)
        lib_ms, backend = library_time(lib, backend, eager=True)
        pairs = _attention_pairs(B, H, Sq, Sk, kw)
        moved = 2 * (2 * B * H * Sq * hd + 2 * B * KV * Sk * hd)
        t_b, by = bound(moved, 4.0 * hd * pairs, BF16_OPS_PER_S)
        t_f, by_f = bound(moved, 4.0 * hd * pairs)
        launched = {**g3, **lm}.get(key, 0)
        say(f"flash_attention {label} (B, H, KV, Sq, Sk, hd) = {(B, H, KV, Sq, Sk, hd)} "
            f"{kw}, bf16, {launched} launches on the path: kernel (tensor cores) {ms:.4f} "
            f"ms, the fp32 kernel on fp32 operands {simt_ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, scaled_dot_product_attention {_ms(lib_ms)} ({backend}); bound over "
            f"{pairs:.4g} admitted pairs x 4 hd operations: {t_b:.4f} ms at the bf16 "
            f"tensor-core rate ({by}; {t_b / ms:.1%} of the kernel's time), {t_f:.4f} ms "
            f"at the fp32 rate ({by_f}; {t_f / simt_ms:.1%} of the fp32 kernel's)")
        timings.append({"label": label, "shape": [B, H, KV, Sq, Sk, hd], "mask": kw,
                        "launches": launched, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "library_note": backend,
                        "bound_ms": t_b, "bound_by": by, "fp32_kernel_ms": simt_ms,
                        "fp32_bound_ms": t_f})
        del q, k, v, mask
    head = timings[0]
    records.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:123",
        "launches": counts["lm"]["flash_attention"] + counts["lmp"]["flash_attention"]
        + counts["g3"]["flash_attention"],
        "launches_by_route": {k: counts["lm_flash_routes"].get(k, 0)
                              + counts["g3_flash_routes"].get(k, 0)
                              for k in kfa.ROUTES.values()},
        "registers": {str(hd): r for hd, r in regs.items()},
        "max_abs_err": worst["flash_attention"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "library_note": head["library_note"], "shape": head["shape"], "shapes": timings,
        "launches_by_path": {"lm_serve": counts["lm"]["flash_attention"],
                             "lm_plain_serve": counts["lmp"]["flash_attention"],
                             "gemma3_serve": counts["g3"]["flash_attention"]},
    })
    timings = []
    for label, key in dec_rows:
        B, H, KV, slots, hd, mk = key[:6]     # the cache's dtype last: bf16 here
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
        + counts["lmp"]["flash_attention_decode"] + counts["g3"]["flash_attention_decode"],
        "max_abs_err": worst["flash_attention_decode"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "library_note": head["library_note"], "shape": head["shape"], "shapes": timings,
        "launches_by_path": {"lm_serve": counts["lm"]["flash_attention_decode"],
                             "lm_plain_serve": counts["lmp"]["flash_attention_decode"],
                             "gemma3_serve": counts["g3"]["flash_attention_decode"]},
    })
    return records


def mm_fp32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One cuBLAS call of lm_head's function: bf16 operands, fp32 sums and
    fp32 logits (torch.mm with out_dtype, ``aten::mm.dtype``)."""
    return torch.mm(x, w.t(), out_dtype=torch.float32)


def phase_head(gen, counts) -> dict:
    from repro_torch.kernels import lm_head as klm

    phase("17. lm_head against its plain version, and its timing")
    served = {**counts["lm_head_shapes"], **counts["mamba_head_shapes"],
              **counts["g3_head_shapes"]}
    routes = {"Qwen2": counts["lm_head_routes"], "Mamba2": counts["mamba_head_routes"],
              "Gemma3": counts["g3_head_routes"]}
    tables = sorted({(D, V, tied) for _, D, V, tied in served}, key=lambda k: -k[1])
    x0 = torch.randn(8, 64, device=DEVICE).bfloat16()
    try:
        mm_fp32_out(x0, x0)
        lib_fn, lib_note = mm_fp32_out, ("torch.mm(x, w.t(), out_dtype=torch.float32): "
                                         "bf16 operands, fp32 sums and logits (cuBLAS)")
    except (TypeError, RuntimeError) as e:
        say(f"torch.mm with out_dtype is not in this torch ({str(e).splitlines()[0]}); "
            f"the yardstick stays F.linear")
        lib_fn, lib_note = None, "torch.nn.functional.linear, bf16 out (cuBLAS)"
    worst = 0.0
    timings = []
    for D, V, tied in tables + [(256, 1048, False)]:
        w = torch.randn((V, D) if tied else (D, V), generator=gen, device=DEVICE).bfloat16()
        x = torch.randn(8, D, generator=gen, device=DEVICE).bfloat16()
        eight = klm.lm_head(x, w, tied=tied)
        want = klm.lm_head_plain(x, w, tied=tied)
        sync()
        err = (eight - want).abs()
        worst = max(worst, err.max().item())
        check(bool((err <= 2e-4 + 2e-4 * want.abs()).all()),
              f"lm_head {(8, D, V, tied)}: max abs error {err.max().item()}")
        for m in range(8):
            one = klm.lm_head(x[m:m + 1], w, tied=tied)
            check(torch.equal(one[0], eight[m]),
                  f"lm_head {(D, V, tied)}: row {m} at M = 1 differs from M = 8")
        del want
        if (D, V, tied) not in tables:
            continue
        for M in (8, 1):
            xm = x[:M]
            ms = graph_ms(lambda: klm.lm_head(xm, w, tied=tied), launches=5)
            plain_ms = cuda_ms(lambda: klm.lm_head_plain(xm, w, tied=tied), 1)
            linear_ms = graph_ms(lambda: torch.nn.functional.linear(xm, w), launches=5)
            lib_ms = (graph_ms(lambda: lib_fn(xm, w), launches=5) if lib_fn
                      else linear_ms)
            t_b, by = bound(V * D * 2 + M * D * 2 + M * V * 4, 2.0 * M * V * D)
            launched = served.get((M, D, V, tied), 0)
            key = (M, D, V)
            first = LM_HEAD_FMA_MS.get(key)
            limit = LM_HEAD_LIMIT_MS.get(key)
            say(f"lm_head (M, D, V) = {key} tied, bf16, {launched} launches on the "
                f"paths: kernel ({klm.route(w.dtype, tied)}) {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, torch.mm out_dtype=fp32 "
                + (f"{lib_ms:.4f} ms" if lib_fn else "not in this torch")
                + f", F.linear (bf16 out) {linear_ms:.4f} ms, bound {t_b:.4f} ms ({by}), "
                f"{t_b / ms:.1%} of it"
                + (f"; the FMA kernel {first:.4f} ms, {first / ms:.2f}x" if first else "")
                + (f"; must {limit[0]} ms, target {limit[1]} ms" if limit else ""))
            if limit:
                check(ms <= limit[0], f"lm_head {key}: {ms:.4f} ms over {limit[0]} ms")
            timings.append({"shape": [M, D, V], "tied": tied, "launches": launched,
                            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                            "linear_ms": linear_ms,
                            "bound_ms": t_b, "bound_by": by})
        del w, x
    say(f"against the plain version at every served (D, V) and an untied (256, 1048): "
        f"within rtol = atol = 2e-4, max abs error {worst:.3g}; row m bitwise the same "
        f"at M = 1 and M = 8")
    mma = klm.route(torch.bfloat16, True)
    say(f"lm_head launches on the served paths by route: {routes} (bf16 tied: "
        f"{mma}; fp32, or untied: {klm.route(torch.float32, True)})")
    check(all(set(r) == {mma} for r in routes.values()),
          f"a served lm_head launch did not take the bf16 tied route: {routes}")
    check_no_spill("lm_head", {"tied_mma_kernel": r"tied_mma_kernel"})
    head = timings[0]
    return {
        "name": "lm_head", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lm_head.cu",
        "replaces": "none: src/repro/models/layers/embedding.py:34 logits_from, "
                    "an einsum left to XLA",
        "launches": counts["lm"]["lm_head"] + counts["lmp"]["lm_head"]
        + counts["mamba"]["lm_head"] + counts["g3"]["lm_head"],
        "max_abs_err": worst, "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "library_note": lib_note,
        "shape": head["shape"], "shapes": timings,
        "launches_by_path": {"lm_serve": counts["lm"]["lm_head"],
                             "lm_plain_serve": counts["lmp"]["lm_head"],
                             "mamba_serve": counts["mamba"]["lm_head"],
                             "gemma3_serve": counts["g3"]["lm_head"]},
    }


# --------------------------------------------------------------------------- #
# phase 19: the decode step's fixed-order products, the SSD decode step and
# the folded norms
# --------------------------------------------------------------------------- #
FIXED_RAGGED = [(3, 64, (1, 17, 100), None), (16, 264, (40,), "norm"),
                (5, 5120, (2560,), "gated"), (1, 8960, (33, 7), None),
                (17, 64, (1, 17, 100), None), (65, 520, (33, 7, 300), None)]


def _fixed_case(gen, M, K, Ns, prologue, dtype=torch.bfloat16):
    """What fixed_linear is handed — x (M, K), the weights (K, N) as the port
    stores them (views of (N, K) rows), its norm= keyword — and what the
    unfused composition hands the product instead: the rmsnorm kernel's row
    (prologue "norm"), or, for Mamba2's gated norm ("gated": x is the fp32
    gate y·silu(z) that ssd_decode writes), the layer's _gated_norm(y, z)."""
    from repro_torch.kernels import rmsnorm as krn
    from repro_torch.models.layers.ssd import _gated_norm

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)

    x = r(M, K).to(dtype)
    ws = [(r(N, K) / K ** 0.5).to(dtype).t() for N in Ns]
    if prologue == "norm":
        scale = (0.1 * r(K)).to(dtype)
        return x, ws, {"norm": (scale, 1e-6, True)}, krn.rmsnorm(x, scale, 1e-6,
                                                                 plus_one=True)
    if prologue == "gated":
        z, scale = r(M, K).to(dtype), (1 + 0.1 * r(K)).to(dtype)
        gate = x.float() * torch.nn.functional.silu(z.float())
        return gate, ws, {"norm": (scale, 1e-5, False)}, _gated_norm(x, z, scale, 1e-5)
    return x, ws, {}, x


def _close_fixed(got, want) -> bool:
    """Within FP32_TOL of max |want| (the kernel sums in fp32 where the
    plain version sums in fp64, and a norm prologue's statistics differ in
    the last fp32 bits, which moves an element of the normed bf16 row by a
    step now and then); bf16 outputs a bf16 step more."""
    g, w = got.float(), want.float()
    lim = FP32_TOL * w.abs().max().clamp(min=1e-30)
    if got.dtype == torch.bfloat16:
        lim = lim + torch.maximum(g.abs(), w.abs()) * 2.0 ** -7
    return bool(((g - w).abs() <= lim).all())


def served_fixed_shapes(counts) -> dict:
    shapes = dict(counts["mamba_fixed_shapes"])
    for k, v in counts["lmp_fixed_shapes"].items():
        shapes[k] = shapes.get(k, 0) + v
    return shapes


def phase_fixed_check(gen, counts) -> dict:
    from repro_torch.kernels import fixed_linear as kfl
    from repro_torch.kernels import ssd_scan as kss

    phase("19. fixed_linear and ssd_decode against their plain versions, and the folded "
          "norms against the unfused compositions")
    worst = {"fixed_linear": 0.0, "ssd_decode": 0.0}
    served = sorted(served_fixed_shapes(counts), key=str)
    d_in = counts["mamba_widths"][1]
    cases = [((M, K, Ns, "gated" if pro and K == d_in else pro), torch.bfloat16)
             for M, K, Ns, pro in served]
    cases += [(k, torch.bfloat16) for k in FIXED_RAGGED]
    cases += [((8, 256, (64, 5), "norm"), torch.float32), ((4, 512, (96,), "gated"),
                                                          torch.float32)]
    for (M, K, Ns, pro), dtype in cases:
        x, ws, kw, normed = _fixed_case(gen, 8 if M == 1 else M, K, Ns, pro, dtype)
        outs = [dtype] + [torch.float32] * (len(Ns) - 1)
        got = kfl.fixed_linear(x, ws, outs, **kw)
        want = kfl.fixed_linear_plain(x, ws, outs, **kw)
        unfused = kfl.fixed_linear(normed, ws, outs)
        sync()
        what = f"fixed_linear {(M, K, Ns, pro)} {dtype}"
        for a, b, c in zip(got, want, unfused):
            worst["fixed_linear"] = max(worst["fixed_linear"],
                                        (a.float() - b.float()).abs().max().item())
            check(a.dtype == b.dtype and a.shape == b.shape and _close_fixed(a, b),
                  f"{what}: against the plain version, max abs err "
                  f"{(a.float() - b.float()).abs().max().item()}")
            check(torch.equal(a, c), f"{what}: the folded prologue differs from the "
                  f"unfused composition (max abs {(a.float() - c.float()).abs().max()})")
        rows = x.shape[0]
        picks = range(8) if rows == 8 else sorted({0, 63, 64, rows // 2, rows - 1}
                                                   & set(range(rows)))
        for m in picks:                # row m alone, bitwise the same
            one = kfl.fixed_linear(x[m:m + 1], ws, outs, **kw)
            check(all(torch.equal(a[0], b[m]) for a, b in zip(one, got)),
                  f"{what}: row {m} at M = 1 differs from M = {rows}")
        for first in (16, 17) if rows > 17 else ():    # either side of the two forms
            part = kfl.fixed_linear(x[:first], ws, outs, **kw)
            check(all(torch.equal(a, b[:first]) for a, b in zip(part, got)),
                  f"{what}: the first {first} rows alone differ from M = {rows}")
    say(f"fixed_linear at the {len(served)} served (M, K, (N, ...), prologue) and "
        f"{len(cases) - len(served)} ragged or fp32 ones: within {FP32_TOL} of max |out| "
        f"of the plain version (a bf16 step more for bf16 outputs), max abs error "
        f"{worst['fixed_linear']:.3g}; every folded prologue bitwise equal to the "
        f"unfused composition; row m at M = 1 bitwise equal to M = 8, and to the "
        f"prefill waves' rows (the tiled form), whose first 16 and 17 rows alone are "
        f"bitwise theirs")

    dec = sorted({k[:5] for k in counts["mamba_decode_shapes"]})
    dcases = dec + [(5, 7, 9, 44, "float32"), (3, 16, 16, 16, "bfloat16")]
    for B, H, P, N, dt in dcases:
        dtype = getattr(torch, dt)

        def r(*shape):
            return torch.randn(*shape, generator=gen, device=DEVICE)

        h0 = 0.5 * r(B, H, P, N)
        args = [r(B, H), r(B, H, P).to(dtype), r(B, N), r(B, N), r(H),
                torch.log(1 + 15 * torch.rand(H, generator=gen, device=DEVICE)),
                torch.ones(H, device=DEVICE)]
        ha, hb = h0.clone(), h0.clone()
        y = kss.ssd_decode(ha, *args)
        yp = kss.ssd_decode_plain(hb, *args)
        sync()
        worst["ssd_decode"] = max(worst["ssd_decode"], (y.float() - yp.float()).abs().max()
                                  .item())
        check(torch.equal(ha, hb), f"ssd_decode {(B, H, P, N, dt)}: the state differs from "
              f"the plain update")
        check(_close_fixed(y, yp), f"ssd_decode {(B, H, P, N, dt)}: y max abs err "
              f"{(y.float() - yp.float()).abs().max().item()}")
        hm = h0[B - 1:].clone()
        ym = kss.ssd_decode(hm, *[a[B - 1:] if a.ndim > 1 else a for a in args])
        check(torch.equal(hm[0], ha[B - 1]) and torch.equal(ym[0], y[B - 1]),
              f"ssd_decode {(B, H, P, N, dt)}: the last slot alone differs")
        z = torch.randn(B, H, P, generator=gen, device=DEVICE).to(dtype)
        gate = kss.ssd_decode(h0.clone(), *args, z=z)
        sync()
        check(torch.equal(gate, y.float() * torch.nn.functional.silu(z.float())),
              f"ssd_decode {(B, H, P, N, dt)}: the gate differs from PyTorch's y * silu(z)")
    say(f"ssd_decode at the served {dec} and 2 ragged shapes: the state bitwise the "
        f"plain update, y within {FP32_TOL} of max |y| (a bf16 step more in bf16), max "
        f"abs error {worst['ssd_decode']:.3g}; the gate y * silu(z) bitwise PyTorch's; "
        f"the last slot alone bitwise equal to it in the batch")

    return worst


def phase_fixed_timing(gen, counts, worst) -> list:
    from repro_torch.kernels import fixed_linear as kfl
    from repro_torch.kernels import ssd_scan as kss

    phase("19b. fixed_linear and ssd_decode timed at the served decode shapes")
    served = served_fixed_shapes(counts)
    d_mb, d_in = counts["mamba_widths"]
    headline = {(8, d_mb): "Mamba2 in-projections", (8, d_in): "Mamba2 out-projection"}
    timings, bars = [], {}
    for (M, K, Ns, pro), n in sorted(served.items(), key=lambda kv: str(kv[0])):
        if M != 8:
            continue
        x, ws, kw, _ = _fixed_case(gen, M, K, Ns, "gated" if pro and K == d_in else pro)
        nbytes = K * sum(Ns) * 2
        copies = max(1, math.ceil(COLD_BYTES / nbytes))
        sets = [ws] + [[w.t().clone().t() for w in ws] for _ in range(copies - 1)]
        cats = [torch.cat([w.t() for w in s]) for s in sets]     # (sum N, K) each
        ms = graph_ms([lambda s=s: kfl.fixed_linear(x, s, **kw) for s in sets])
        xb = x.to(ws[0].dtype)
        bare_ms = (graph_ms([lambda s=s: kfl.fixed_linear(xb, s) for s in sets]) if kw
                   else ms)
        lib_ms = graph_ms([lambda c=c: mm_fp32_out(xb, c) for c in cats])
        plain_ms = cuda_ms(lambda: kfl.fixed_linear_plain(x, ws, **kw), 1)
        del sets, cats
        t_b, by = bound(nbytes + M * K * x.element_size() + M * sum(Ns) * 2,
                        2.0 * M * K * sum(Ns), BF16_OPS_PER_S)
        label = headline.get((M, K), f"Qwen2 plain {(K, Ns)}")
        bar = (M, K) in headline
        norm_us = (ms - bare_ms) * 1e3
        plan = kfl.plan(x.dtype, kw["norm"][0].dtype if kw else None, K, Ns)
        say(f"fixed_linear {label} (M, K, N) = {(M, K, Ns)}, prologue {pro}, {n} launches "
            f"on the paths (decode form: {plan['clusters']} clusters of {plan['cluster']}, "
            f"{plan['pieces']} pieces in flight a warp): kernel {ms:.4f} ms (without the "
            f"prologue {bare_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, torch.mm out_dtype=fp32 {lib_ms:.4f} ms, bound "
            f"{t_b:.4f} ms ({by}), {t_b / ms:.1%} of it; the product alone "
            f"{bare_ms / lib_ms:.2f}x the library call"
            + (f" (bar: <= {FIXED_LIB_RATIO}x, "
               f"{'met' if bare_ms <= FIXED_LIB_RATIO * lib_ms else 'MISSED'})" if bar else "")
            + (f"; the folded norm {norm_us:+.2f} us (bar: <= {FIXED_NORM_US} us, "
               f"{'met' if norm_us <= FIXED_NORM_US else 'MISSED'})" if pro else ""))
        if bar:
            bars[f"{label}: the product alone <= {FIXED_LIB_RATIO}x torch.mm"] = (
                "met" if bare_ms <= FIXED_LIB_RATIO * lib_ms else "MISSED")
        if pro:
            bars[f"{label}: the folded norm <= {FIXED_NORM_US} us"] = (
                "met" if norm_us <= FIXED_NORM_US else "MISSED")
        timings.append({"label": label, "shape": [M, K, list(Ns)], "prologue": pro,
                        "launches": n, "ms": ms, "product_ms": bare_ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": t_b,
                        "bound_by": by, "plan": plan})
    # the tiled form at the plain-weight path's prefill waves: each group at
    # its widest wave, with the launches of all its waves (bf16 out)
    waves = {}
    for (M, K, Ns, pro), n in served.items():
        if M > 16:
            w = waves.setdefault((K, Ns), [0, 0])
            w[0], w[1] = max(w[0], M), w[1] + n
    pre_ms = pre_lib = pre_b = 0.0
    for (K, Ns), (M, n) in sorted(waves.items(), key=str):
        x, ws, _, _ = _fixed_case(gen, M, K, Ns, None)
        cat = torch.cat([w.t() for w in ws])
        ms = graph_ms(lambda: kfl.fixed_linear(x, ws), 5, 4)
        lib_ms = graph_ms(lambda: mm_fp32_out(x, cat), 5, 4)
        plain_ms = cuda_ms(lambda: kfl.fixed_linear_plain(x, ws), 1)
        t_b, by = bound(2 * (M * K + K * sum(Ns) + M * sum(Ns)), 2.0 * M * K * sum(Ns),
                        BF16_OPS_PER_S)
        del x, ws, cat
        pre_ms, pre_lib, pre_b = pre_ms + n * ms, pre_lib + n * lib_ms, pre_b + n * t_b
        met = "met" if ms <= FIXED_TILED_RATIO * lib_ms else "MISSED"
        aim = ms <= FIXED_TILED_AIM[0] * lib_ms and t_b / ms >= FIXED_TILED_AIM[1]
        say(f"fixed_linear (tiled) Qwen2 plain prefill (M, K, N) = {(M, K, Ns)}, {n} launches "
            f"on the path (all its waves): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.mm out_dtype=fp32 {lib_ms:.4f} ms ({ms / lib_ms:.2f}x; bar: <= "
            f"{FIXED_TILED_RATIO}x, {met}), bound {t_b:.4f} ms ({by}), {t_b / ms:.1%} of it "
            f"(aim: <= {FIXED_TILED_AIM[0]}x and >= {FIXED_TILED_AIM[1]:.0%}, "
            f"{'reached' if aim else 'not reached'})")
        bars[f"Qwen2 plain prefill {(K, Ns)}: the tiled form <= {FIXED_TILED_RATIO}x "
             f"torch.mm"] = met
        timings.append({"label": f"Qwen2 plain prefill {(K, Ns)}", "shape": [M, K, list(Ns)],
                        "prologue": None, "route": "mma_bf16_tiled", "launches": n,
                        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": t_b, "bound_by": by})
    check(bool(waves), "the plain-weight path ran no prefill product")
    say(f"fixed_linear (tiled) over the plain-weight path's prefill waves, each launch at its "
        f"group's widest wave: {pre_ms / 1e3:.4f} s; torch.mm {pre_lib / 1e3:.4f} s; bound "
        f"{pre_b / 1e3:.4f} s")
    check_no_spill("fixed_linear", {
        "fixed_mma_kernel<bf16 x>": r"fixed_mma_kernelI13__nv_bfloat16E",
        "fixed_mma_kernel<fp32 x>": r"fixed_mma_kernelIfE",
        "fixed_wgmma_kernel": r"fixed_wgmma_kernel",
        "fixed_fma_kernel": r"fixed_fma_kernel"})
    head = next(t for t in timings if t["label"] == "Mamba2 in-projections")
    launches = sum(counts[p]["fixed_linear"] for p in ("lm", "lmp", "mamba", "g3"))
    records = [{
        "name": "fixed_linear", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fixed_linear.cu",
        "replaces": "none: the reference's projections (src/repro/models/layers/ssd.py:87, "
                    "attention.py, mlp.py), einsums left to XLA",
        "launches": launches, "max_abs_err": worst["fixed_linear"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "library_note": "torch.mm(x, W, out_dtype=torch.float32), same (M, K, sum N)",
        "shape": head["shape"], "shapes": timings,
        "launches_by_path": {"mamba_serve": counts["mamba"]["fixed_linear"],
                             "lm_plain_serve": counts["lmp"]["fixed_linear"]},
    }]

    # ssd_decode at the served shape, h cycled through copies that miss L2
    B, H, P, N, dt, gated = max(counts["mamba_decode_shapes"])
    dtype = getattr(torch, dt)
    hbytes = B * H * P * N * 4
    hs = [torch.randn(B, H, P, N, generator=gen, device=DEVICE) * 0.5
          for _ in range(max(1, math.ceil(COLD_BYTES / hbytes)))]
    args = [torch.randn(B, H, generator=gen, device=DEVICE),
            torch.randn(B, H, P, generator=gen, device=DEVICE).to(dtype),
            torch.randn(B, N, generator=gen, device=DEVICE),
            torch.randn(B, N, generator=gen, device=DEVICE),
            torch.randn(H, generator=gen, device=DEVICE),
            torch.log(1 + 15 * torch.rand(H, generator=gen, device=DEVICE)),
            torch.ones(H, device=DEVICE)]
    z = torch.randn(B, H, P, generator=gen, device=DEVICE).to(dtype) if gated else None
    ms = graph_ms([lambda h=h: kss.ssd_decode(h, *args, z=z) for h in hs])
    plain_ms = cuda_ms(lambda: kss.ssd_decode_plain(hs[0], *args, z=z), 3)
    del hs
    esize = torch.finfo(dtype).bits // 8
    t_b, by = bound(2 * hbytes + (2 if gated else 1) * B * H * P * esize
                    + (4 if gated else esize) * B * H * P + 2 * B * N * 4 + B * H * 4,
                    6.0 * B * H * P * N)
    launched = counts["mamba"]["ssd_decode"]
    ssd_bar = "met" if t_b / ms >= SSD_DECODE_MIN_SHARE else "MISSED"
    say(f"ssd_decode (B, H, P, N) = {(B, H, P, N)}, x {dt}, the gate written: {gated}, "
        f"{launched} launches on the path: kernel {ms:.4f} ms (the state from HBM), plain "
        f"{plain_ms:.4f} ms, library none, bound {t_b:.4f} ms ({by}), {t_b / ms:.1%} of it "
        f"(bar: >= {SSD_DECODE_MIN_SHARE:.0%}, {ssd_bar})")
    check_no_spill("ssd_scan", {f"ssd_decode_kernel<{t}>": rf"ssd_decode_kernelI{m}E"
                                for t, m in (("fp32", "f"), ("bf16", "13__nv_bfloat16"))})
    records.append({
        "name": "ssd_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "none: the reference's decode recurrence "
                    "(src/repro/models/layers/ssd.py:106-112), jnp left to XLA",
        "launches": launched, "max_abs_err": worst["ssd_decode"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": t_b, "bound_by": by, "library_ms": None,
        "shape": [B, H, P, N], "launches_by_path": {"mamba_serve": launched}})

    records[0]["bars"] = bars
    records[1]["bars"] = {f">= {SSD_DECODE_MIN_SHARE:.0%} of the byte bound": ssd_bar}
    say(f"the PR's kernel bars (a kernel that misses one stays in; its times are in the "
        f"kernels line): {records[0]['bars']} {records[1]['bars']}")
    return records


# --------------------------------------------------------------------------- #
# phase 26: the model zoo (Granite-3-8B, RecurrentGemma-9B, Qwen1.5-32B)
# --------------------------------------------------------------------------- #
def zoo_requests(cfg):
    """The zoo phase's requests for ``cfg``: ZOO's count and new tokens,
    prompts drawn from the seed (the hybrid's up to RG_PROMPT_MAX, so that
    its scan runs at a prompt of ≈ 2,000 tokens)."""
    from repro_torch.serve import Request

    n, new = ZOO_REQUESTS[cfg.name]
    rng = np.random.default_rng(SEED)
    hi = RG_PROMPT_MAX if cfg.name == RG_ARCH else ZOO_PROMPT_MAX
    lens = rng.integers(ZOO_PROMPT_MIN, hi + 1, size=n)
    lens[0] = hi                     # the longest prompt is always served
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=int(m)).astype(np.int32),
                    max_new_tokens=new) for m in lens]


def zoo_layers(cfg) -> dict:
    """Layers by kind over the whole depth: attention (A), RG-LRU (R), and
    of the attention layers those with experts in place of the MLP (M)."""
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.num_layers)]
    A = sum(k.value.startswith("attn") for k in kinds)
    return {"A": A, "R": sum(k.value == "rglru" for k in kinds),
            "M": A if cfg.num_experts else 0}


def moe_products(cfg) -> int:
    """fixed_linear launches of one MoE layer a forward: the router, each
    expert's gate/up and down, the shared expert's gate/up and down."""
    return 1 + 2 * cfg.num_experts + (2 if cfg.shared_expert else 0)


def zoo_step_want(cfg) -> dict:
    """Each kernel's launches in one decode step (int8 projections): an
    attention layer's projection groups (q/k/v, o, and gate/up, down for a
    dense MLP), an RG-LRU layer's 2 groups (its MLP) and 3 fixed_linear
    launches, an MoE layer's ``moe_products``; every norm but the
    recurrent blocks' first (folded into their branches' launch)."""
    n = zoo_layers(cfg)
    A, R, M, L = n["A"], n["R"], n["M"], cfg.num_layers
    return {k: v for k, v in (("quant_linear", 4 * A + 2 * R - 2 * M),
                              ("rmsnorm", 2 * L + 1 - R), ("flash_attention_decode", A),
                              ("fixed_linear", 3 * R + M * moe_products(cfg)),
                              ("lm_head", 1)) if v}


def zoo_expected_launches(cfg, calls, steps: int) -> dict:
    """Each kernel's launches over a serving run of ``calls`` (the engine's
    counts) with int8 projections: at a decode step ``zoo_step_want``; at a
    prefill an attention layer's q/k/v and o groups (and gate/up, down for
    a dense MLP) as one quantize_rows launch a group and one product a
    weight, an RG-LRU layer's MLP so and its 3 fixed_linear launches, one
    rglru_scan a recurrent layer (its requests prefill alone), an MoE
    layer's ``moe_products``, every norm; one lm_head a forward."""
    n = zoo_layers(cfg)
    A, R, M, L = n["A"], n["R"], n["M"], cfg.num_layers
    F = calls["prefill_waves"] + calls["prefills"]
    step = zoo_step_want(cfg)
    return {"quant_linear": step.get("quant_linear", 0) * steps + (7 * A + 3 * R - 3 * M) * F,
            "quantize_rows": (4 * A + 2 * R - 2 * M) * F,
            "rmsnorm": (2 * L + 1) * F + step["rmsnorm"] * steps,
            "flash_attention": A * F, "flash_attention_decode": A * steps,
            "fixed_linear": (3 * R + M * moe_products(cfg)) * (F + steps),
            "rglru_scan": R * calls["prefills"], "lm_head": F + steps}


def zoo_step_launches(engine) -> dict:
    """The kernels' launches of one decode step, by name: one more graph
    replay on the engine's cache (whose wrappers' counts the replay adds)."""
    from repro_torch.kernels import launch_counts

    B = engine.batch
    before = launch_counts()
    engine._decode(engine.params, engine._tensor(np.zeros((B, 1), np.int32)),
                   engine._tensor(np.full(B, 64, np.int32)), engine.init_shared_cache())
    sync()
    after = launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def zoo_graph_profile(engine, step_ms: float, steps: int = 3):
    """Device time of the graph-replayed decode step by kernel (torch.profiler,
    CUDA activity) against the served run's step; None where the profiler
    saw no device time."""
    B = engine.batch
    toks = engine._tensor(np.zeros((B, 1), np.int32))
    pos = engine._tensor(np.full(B, 64, np.int32))
    shared = engine.init_shared_cache()
    prof = profile_steps(lambda: engine._decode(engine.params, toks, pos, shared), steps)
    kernels, busy, ours = _kernel_times(prof, steps)
    if busy == 0:
        say("decode step profile (graph): the profiler saw no device time (not measured)")
        return None
    launches = sum(e.count for e in kernels) / steps
    say(f"decode step profile (graph, {steps} steps, {B} slots): device busy {busy:.3f} ms, "
        f"{busy / step_ms:.1%} of the served run's {step_ms:.2f} ms step, {launches:.0f} "
        f"kernel launches a step; " + ", ".join(f"{k} {v:.3f} ms" for k, v in ours.items() if v))
    _print_top(kernels, 8, steps)
    return {"busy_ms": busy, "launches": launches, **ours}


def zoo_serve(arch: str, counts, report, layers: int = 0) -> None:
    """One model of the zoo at its published widths and depth (the first
    ``layers`` layers where given), int8 projections, ZOO_SLOTS slots,
    max_seq ZOO_MAX_SEQ, weights from the seed drawn and quantized a period
    at a time; its requests served with continuous batching, every stream
    held against _run_one."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts
    from repro_torch.models.layers.quant import QTensor
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import ServeEngine, SlotScheduler

    full = get_config(arch)
    cfg = dataclasses.replace(full, quantize="int8", num_layers=layers or full.num_layers)
    n = zoo_layers(cfg)
    experts = (f", {cfg.num_experts} experts top-{cfg.top_k}"
               f"{' and a shared expert' if cfg.shared_expert else ''} in {n['M']} layers "
               f"(bf16: the reference's int8 leaves them)" if cfg.num_experts else "")
    cut = f" of {full.num_layers} (depth cut)" if layers else ""
    say(f"{cfg.name}: {cfg.num_layers} layers{cut} ({n['A']} attention, {n['R']} RG-LRU), "
        f"d_model {cfg.d_model}, {cfg.num_heads} q heads over {cfg.num_kv_heads} kv heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size:,}{experts}, "
        f"{'QKV bias, ' if cfg.qkv_bias else ''}{cfg.dtype}, int8 projections, "
        f"{ZOO_SLOTS} slots, max_seq {ZOO_MAX_SEQ}")
    free_device_memory()
    mem_reset()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    sync()
    t_init = time.perf_counter() - t0
    q = [t for t in _leaves(params, qtensors=True)]
    q_bytes = _storage_bytes([t for x in q for t in (x.qt, x.scale)])
    plain_bytes = _storage_bytes(_leaves(params))
    init_peak = mem_peak(f"{cfg.name}'s weights drawn and quantized a block at a time")
    say(f"weights made on the card from seed {SEED} in {t_init:.2f} s: "
        f"{sum(x.qt.numel() for x in q) / 1e9:.3f} B int8 projection parameters "
        f"({q_bytes / 1e9:.3f} GB with their scales), {plain_bytes / 1e9:.3f} GB of "
        f"{cfg.dtype} leaves (embedding, norms, biases, RG-LRU blocks, experts)")
    check(all(isinstance(x, QTensor) for x in q) and len(q) > 0,
          f"{cfg.name}: no int8 projection in the drawn tree")
    engine = ServeEngine(cfg, params, batch_size=ZOO_SLOTS, max_seq=ZOO_MAX_SEQ,
                         device=DEVICE)
    reqs = zoo_requests(cfg)
    lens = [len(r.prompt) for r in reqs]
    engine.warmup(prompt_lens=[min(lens)])
    sync()
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
    for fn in KERNELS.values():
        if hasattr(fn, "shapes"):
            fn.shapes.clear()
    sched = SlotScheduler(ZOO_SLOTS)
    sync()
    mem_reset()
    reset_launch_counts()            # this model's served run starts here
    t0 = time.perf_counter()
    served = engine.run(reqs, scheduler=sched)
    sync()
    t_run = time.perf_counter() - t0
    got = launch_counts()            # ... and ends here
    peak = mem_peak(f"{cfg.name}'s served run")
    del engine._prefill_into, prefill_into, timed_prefill_into   # no reference to the engine
    shapes = {name: dict(fn.shapes) for name, fn in KERNELS.items()
              if hasattr(fn, "shapes") and fn.shapes}
    steps = engine.calls["decode_steps"]
    want = zoo_expected_launches(cfg, engine.calls, steps)
    say(f"launches in the serving run: {got}; {engine.calls['prefill_waves']} prefill waves, "
        f"{engine.calls['prefills']} per-request prefills, {steps} decode steps")
    check(all(got[k] == v for k, v in want.items())
          and all(v == 0 for k, v in got.items() if k not in want),
          f"{cfg.name}: launches {got} are not the expected {want}")
    check(all(v > 0 for k, v in got.items() if k in want and want[k]),
          f"{cfg.name}: a kernel of the path never launched: {got}")
    check(engine.ragged_ok == (n["R"] == 0 and not cfg.vision_tokens and not cfg.num_experts),
          f"{cfg.name}: ragged prefill {engine.ragged_ok} with {n['R']} RG-LRU layers, "
          f"{cfg.vision_tokens} vision tokens and {cfg.num_experts} experts")
    check_graph_steps(engine, dict.fromkeys(engine.calls, 0), 0, "the served run")
    check(all(r.done and len(r.out_tokens) == r.max_new_tokens for r in served),
          "a request did not finish with its tokens")
    new = sum(len(r.out_tokens) for r in served)
    t_prefill = sum(waves)
    step_ms = (t_run - t_prefill) / max(steps, 1) * 1e3
    say(f"served {len(served)} requests (prompts {lens}, {sum(lens)} tokens) / {new} new "
        f"tokens in {t_run:.3f} s: {new / t_run:.1f} tokens/s; prefill {t_prefill:.3f} s "
        f"in {len(waves)} admissions; decode {step_ms:.2f} ms per step ({steps} steps of "
        f"{ZOO_SLOTS} slots); peak device memory {peak:.2f} GB (weights {init_peak:.2f} GB "
        f"at their peak while drawn); backfills {sched.backfills}")
    cache_gb = _storage_bytes(_cache_tensors(engine.init_shared_cache())) / 1e9
    weights_gb, pools_gb = (q_bytes + plain_bytes) / 1e9, engine.graph_pool_bytes / 1e9
    say(f"what holds the peak: weights {weights_gb:.3f} GB, the {ZOO_SLOTS}-slot cache "
        f"{cache_gb:.3f} GB, the captured steps' graph pools {pools_gb:.3f} GB, the rest "
        f"{peak - weights_gb - cache_gb - pools_gb:.3f} GB (activations, a prefill's batch-1 "
        f"cache, the allocator's blocks)")
    per_step = zoo_step_launches(engine)
    step_want = zoo_step_want(cfg)
    say(f"launches by kernel a decode step (a graph replay): {per_step}")
    check(per_step == step_want, f"{cfg.name}: a decode step's launches {per_step}, "
          f"not {step_want}")
    prof = zoo_graph_profile(engine, step_ms)
    rep = {"tokens_per_s": new / t_run, "prefill_s": t_prefill, "decode_ms_per_step": step_ms,
           "peak_gb": peak, "init_s": t_init, "init_peak_gb": init_peak,
           "int8_gb": q_bytes / 1e9, "plain_gb": plain_bytes / 1e9, "seconds": t_run,
           "new_tokens": new, "steps": steps, "launches": got, "step_launches": per_step,
           "decode_profile": prof, "prompts": lens, "layers": cfg.num_layers,
           "cache_gb": cache_gb}

    # every stream equals the slot-at-a-time oracle's
    calls = dict(engine.calls)
    mem_reset()
    t0 = time.perf_counter()
    solo = [engine._run_one(r) for r in zoo_requests(cfg)]
    rep["oracle_s"] = time.perf_counter() - t0
    same = sum(a.out_tokens == b.out_tokens for a, b in zip(served, solo))
    rep["oracle_peak_gb"] = mem_peak(f"{cfg.name}'s oracle")
    say(f"streams equal to the slot-at-a-time _run_one: {same} of {len(served)} "
        f"({rep['oracle_s']:.1f} s for the oracle)")
    check(same == len(served), f"{cfg.name}: {len(served) - same} streams differ from _run_one")
    check_graph_steps(engine, calls, 1, "the oracle")
    counts.setdefault("zoo", {})[cfg.name] = {"launches": got, "shapes": shapes}
    report.setdefault("zoo", {})[cfg.name] = rep
    del engine, q, served, solo, params
    free_device_memory()
    say(f"{cfg.name} freed: {torch.cuda.memory_allocated() / 1e9:.3f} GB still allocated")


def phase_zoo(counts, report) -> None:
    phase("26. the model zoo: " + ", ".join(ZOO) + " at their published widths and depths")
    for arch in ZOO:
        zoo_serve(arch, counts, report)


def _zoo_shapes(counts, kernel: str) -> dict:
    """A kernel's launches by shape over the zoo's served runs."""
    out = collections.Counter()
    for model in counts["zoo"].values():
        out.update(model["shapes"].get(kernel, {}))
    return dict(out)


def flash_plain_rows(q, k, v, kw: dict, block: int = 1024):
    """kernel 6's plain prefill version of (q, k, v) with the mask ``kw``;
    above 2^30 scores a call, causal, in blocks of ``block`` queries, each
    against the keys up to its last query (the plain version puts the
    queries at the last positions of its keys), so no block holds more than
    ``block`` x Sk fp64 scores a head: the same function, in pieces."""
    from repro_torch.kernels import flash_attention as kfa

    B, H, Sq, _ = q.shape
    Sk = k.shape[2]
    if B * H * Sq * Sk <= 2 ** 30 or not kw["causal"]:
        return kfa.flash_attention_plain(q, k, v, **kw)
    off = Sk - Sq
    return torch.cat([kfa.flash_attention_plain(q[:, :, a:a + block], k[:, :, :off + a + block],
                                                v[:, :, :off + a + block], **kw)
                      for a in range(0, Sq, block)], dim=2)


def zoo_flash_rows(gen, counts) -> list:
    """Kernel 6 at the zoo's served shapes (phases 26-28), every one held
    against the plain versions (FLASH_TOL): each decode shape at its own
    batch and slot count (cross-attention's with every row at Se - 1, where
    all Se slots are admitted), every decode head bitwise the same as the
    head alone in a group of 1, timed beside the plain version, one SDPA
    call and the bound; every prefill shape, each model's widest of each
    kind (by mask, and self or cross) timed so."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.flash_attention import _admitted, slot_positions

    rows = []
    dec = _zoo_shapes(counts, "flash_attention_decode")
    for key, launched in sorted(dec.items(), key=str):
        B, H, KV, slots, hd, mk = key[:6]     # the cache's dtype last: bf16 here
        kw = _mask_kwargs(mk)
        q, kc, vc, pos = _decode_inputs(gen, torch.bfloat16, B, H, KV, slots, hd, 2 * slots)
        cross = not kw["causal"]     # a cross cache: every row at Se - 1
        if cross:
            pos = torch.full((B,), slots - 1, dtype=torch.long, device=DEVICE)
        got = kfa.flash_attention_decode(q, kc, vc, pos, **kw)
        want = kfa.flash_attention_decode_plain(q, kc, vc, pos, **kw)
        sync()
        ok, err, ratio = _flash_err(got, want, torch.bfloat16,
                                    min(slots, kw["window"] or slots, kw["chunk"] or slots))
        check(ok, f"flash_attention_decode {key}: max abs err {err} ({ratio:.3g} x)")
        G = H // KV
        for h in range(0, H, max(1, G // 4)):
            kvh = h // G
            one = kfa.flash_attention_decode(q[:, h:h + 1], kc[:, :, kvh:kvh + 1],
                                             vc[:, :, kvh:kvh + 1], pos, **kw)
            check(torch.equal(one[:, 0], got[:, h]),
                  f"flash_attention_decode {key}: head {h} differs alone")
        # time the end of a stream that fills its cache: every row near its
        # last slot
        if not cross:
            pos = torch.clamp(pos + slots // 2, max=slots - 1)
        ms = graph_ms(lambda: kfa.flash_attention_decode(q, kc, vc, pos, **kw))
        plain_ms = cuda_ms(lambda: kfa.flash_attention_decode_plain(q, kc, vc, pos, **kw), 3)
        sp = slot_positions(pos, slots)
        valid = (sp >= 0) & _admitted(pos[:, None], sp, **kw)
        lib, backend = sdpa_yardstick(q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                                      scale=hd ** -0.5, attn_mask=valid[:, None, None, :])
        lib_ms, backend = library_time(lib, backend, eager=False)
        pairs = _attention_pairs(B, H, 1, slots, kw, pos=pos, slots=slots)
        n_valid = float(valid.sum().item())
        t_b, by = bound(2 * (2 * n_valid * KV * hd + 2 * B * H * hd), 4.0 * hd * pairs)
        say(f"flash_attention_decode zoo (B, H, KV, slots, hd) = {(B, H, KV, slots, hd)} {kw}"
            f" (group {G}), bf16, {launched} launches on the path: within the tolerance "
            f"(max abs err {err:.3g}), heads bitwise alone; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, scaled_dot_product_attention {_ms(lib_ms)} ({backend}), "
            f"bound {t_b:.4f} ms ({by}), {t_b / ms:.1%} of it")
        rows.append({"label": f"zoo decode, group {G}, {B} x {slots} slots"
                              f"{', cross' if cross else ''}",
                     "kernel": "flash_attention_decode",
                     "shape": [B, H, KV, slots, hd], "mask": kw, "launches": launched,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "library_note": backend, "bound_ms": t_b, "bound_by": by})
        del q, kc, vc
    pre = _zoo_shapes(counts, "flash_attention")
    widest = {}                      # its widest launch -> (model, self or cross)
    for model in counts["zoo"]:
        best = {}
        for key in counts["zoo"][model]["shapes"].get("flash_attention", {}):
            kind = (key[6], key[3] == key[4])
            if kind not in best or (key[0] * key[3], key[3]) > (best[kind][0] * best[kind][3],
                                                                best[kind][3]):
                best[kind] = key
        for (_, self_attn), key in best.items():
            widest.setdefault(key, (model, self_attn))
    held, held_err = 0, 0.0
    for key in sorted(pre, key=str):
        B, H, KV, Sq, Sk, hd, mk = key
        kw = _mask_kwargs(mk)
        q, k, v = _flash_inputs(gen, torch.bfloat16, B, H, KV, Sq, Sk, hd)
        a, b = kfa.flash_attention(q, k, v, **kw), flash_plain_rows(q, k, v, kw)
        sync()
        keys = min(Sk, kw["window"] or Sk, kw["chunk"] or Sk)
        ok, err, ratio = _flash_err(a, b, torch.bfloat16, keys)
        check(ok, f"flash_attention zoo {(B, H, KV, Sq, Sk, hd)} {kw}: max abs err {err} "
              f"({ratio:.3g} x the tolerance at rows of up to {keys} keys)")
        del a, b
        held, held_err = held + 1, max(held_err, err)
        if key not in widest:
            del q, k, v
            continue
        model, self_attn = widest[key]
        ms = cuda_ms(lambda: kfa.flash_attention(q, k, v, **kw), 5)
        plain_ms = cuda_ms(lambda: flash_plain_rows(q, k, v, kw), 1)
        mask = _admitted(torch.arange(Sq, device=DEVICE)[:, None] + (Sk - Sq),
                         torch.arange(Sk, device=DEVICE)[None, :], **kw)
        if kw["window"] is not None or kw["chunk"] is not None:
            lib, backend = sdpa_yardstick(q, k, v, attn_mask=mask, scale=hd ** -0.5)
        else:
            lib, backend = sdpa_yardstick(q, k, v, is_causal=kw["causal"], scale=hd ** -0.5)
        lib_ms, backend = library_time(lib, backend, eager=True)
        pairs = _attention_pairs(B, H, Sq, Sk, kw)
        t_b, by = bound(2 * (2 * B * H * Sq * hd + 2 * B * KV * Sk * hd), 4.0 * hd * pairs,
                        BF16_OPS_PER_S)
        launched = pre[key]
        say(f"flash_attention zoo prefill {model} (B, H, KV, Sq, Sk, hd) = "
            f"{(B, H, KV, Sq, Sk, hd)} {kw}, bf16, {launched} launches of this shape: within "
            f"the tolerance (max abs err {err:.3g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, scaled_dot_product_attention {_ms(lib_ms)} ({backend}), bound {t_b:.4f} ms "
            f"({by}, bf16 tensor cores), {t_b / ms:.1%} of it")
        rows.append({"label": f"zoo prefill, {model}{'' if self_attn else ', cross'}",
                     "kernel": "flash_attention",
                     "shape": [B, H, KV, Sq, Sk, hd], "mask": kw, "launches": launched,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "library_note": backend, "bound_ms": t_b, "bound_by": by})
        del q, k, v, mask
        free_device_memory()
    say(f"flash_attention zoo prefill: all {held} served shapes ({sum(pre.values())} launches) "
        f"within the tolerance of the plain version, max abs err {held_err:.3g}")
    return rows, held_err


def zoo_scan_record(gen, counts) -> dict:
    """rglru_scan at the served run's longest prompt (1, S, r) and a decode
    wave's batch, bitwise its plain version, a row bitwise alone, timed
    beside the plain version and the bound (no PyTorch call computes the
    recurrence: library none)."""
    from repro_torch.kernels import rglru_scan as krs

    served = _zoo_shapes(counts, "rglru_scan")
    B, S, r, with_h0 = max(served, key=lambda k: k[1])
    a = torch.rand(B, S, r, generator=gen, device=DEVICE) * 0.2 + 0.8
    b = torch.randn(B, S, r, generator=gen, device=DEVICE)
    h0 = torch.randn(B, r, generator=gen, device=DEVICE) if with_h0 else None
    hs, last = krs.rglru_scan(a, b, h0)
    want, want_last = krs.rglru_scan_plain(a, b, h0)
    sync()
    check(torch.equal(hs, want) and torch.equal(last, want_last),
          f"rglru_scan {(B, S, r)}: not bitwise its plain version")
    three = torch.cat([a, a.flip(0) * 0.99, a], 0), torch.cat([b, -b, b], 0)
    hs3, _ = krs.rglru_scan(*three, None if h0 is None else h0.repeat(3, 1))
    check(torch.equal(hs3[0], hs[0]) and torch.equal(hs3[2], hs[0]),
          "rglru_scan: a row differs in a batch of 3")
    ms = graph_ms(lambda: krs.rglru_scan(a, b, h0), launches=5)
    plain_ms = cuda_ms(lambda: krs.rglru_scan_plain(a, b, h0), 1)
    t_b, by = bound(4 * (3 * B * S * r + 2 * B * r), 2.0 * B * S * r)
    usage = ptxas_usage("rglru_scan")
    launched = sum(served.values())
    say(f"rglru_scan (B, S, r) = {(B, S, r)}, h0 given: {with_h0}, {launched} launches on "
        f"the path (prompts of {sorted({k[1] for k in served})} tokens): bitwise its plain "
        f"version, a row bitwise the same in a batch of 3; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library none, bound {t_b:.4f} ms ({by}), {t_b / ms:.1%} of it; "
        f"-Xptxas -v {usage}")
    check_no_spill("rglru_scan", {"rglru_scan_kernel": r"rglru_scan_kernel"})
    del a, b, hs, want, hs3
    free_device_memory()
    return {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "none: the reference's RG-LRU recurrence "
                    "(src/repro/models/layers/rglru.py:122-131), "
                    "jax.lax.associative_scan left to XLA",
        "launches": launched, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": t_b, "bound_by": by, "library_ms": None, "shape": [B, S, r],
        "launches_by_path": {"zoo_serve": launched}}


def zoo_head_rows(gen, counts) -> list:
    """lm_head at the zoo's (D, V) tables, at every served M (and M = 8 and
    1): against the plain version (rtol = atol = 2e-4), rows bitwise at
    M = 1, timed beside one torch.mm(out_dtype=float32) and the bound."""
    from repro_torch.kernels import lm_head as klm

    served = _zoo_shapes(counts, "lm_head")
    rows = []
    for D, V in sorted({(D, V) for _, D, V, _ in served}):
        Ms = sorted({M for M, d, v, _ in served if (d, v) == (D, V)} | {ZOO_SLOTS, 1},
                    reverse=True)
        w = torch.randn(V, D, generator=gen, device=DEVICE).bfloat16() * D ** -0.5
        x = torch.randn(Ms[0], D, generator=gen, device=DEVICE).bfloat16()
        whole = klm.lm_head(x, w, tied=True)
        for m in range(Ms[0]):
            check(torch.equal(klm.lm_head(x[m:m + 1], w, tied=True)[0], whole[m]),
                  f"lm_head {(D, V)}: row {m} differs at M = 1")
        for M in Ms:
            xm = x[:M]
            got, want = klm.lm_head(xm, w, tied=True), klm.lm_head_plain(xm, w, tied=True)
            sync()
            err = (got - want).abs()
            check(bool((err <= 2e-4 + 2e-4 * want.abs()).all()),
                  f"lm_head {(M, D, V)}: max abs error {err.max().item()}")
            ms = graph_ms(lambda: klm.lm_head(xm, w, tied=True), launches=5)
            plain_ms = cuda_ms(lambda: klm.lm_head_plain(xm, w, tied=True), 1)
            lib_ms = graph_ms(lambda: mm_fp32_out(xm, w), launches=5)
            t_b, by = bound(V * D * 2 + M * D * 2 + M * V * 4, 2.0 * M * V * D)
            launched = served.get((M, D, V, True), 0)
            say(f"lm_head zoo (M, D, V) = {(M, D, V)} tied, bf16, {launched} launches on the "
                f"path: within the tolerance (max abs err {err.max().item():.3g}), rows "
                f"bitwise at M = 1; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.mm "
                f"out_dtype=fp32 {lib_ms:.4f} ms, bound {t_b:.4f} ms ({by}), {t_b / ms:.1%}")
            rows.append({"label": f"zoo, V = {V:,}", "shape": [M, D, V], "tied": True,
                         "launches": launched, "max_abs_err": err.max().item(), "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": t_b,
                         "bound_by": by})
            del got, want
        del w, x, whole
    return rows


def zoo_qmm_rows(gen, counts) -> tuple:
    """quant_linear at every served shape of the zoo's runs, bitwise the
    plain version: each decode group (M up to qmm_group's SKINNY_M, weights
    from HBM) timed beside it and the bound (int8 tensor-core rate; library
    none for the grouped function), each model's widest prefill product
    timed so beside torch._int_mm; quantize_rows at every served shape,
    bitwise, each model's widest timed against its byte bound."""
    from repro_torch.kernels import quant_matmul as kqm

    rows, qrows = [], []
    for model, data in counts["zoo"].items():
        by_shape = data["shapes"].get("quant_linear", {})
        if not by_shape:             # a plain-weight run
            continue
        for (M, K, Ns), calls in sorted(by_shape.items()):
            x, group = _group_operands(gen, M, K, Ns)
            check(all(torch.equal(a, b) for a, b in zip(kqm.quant_linear(x, group),
                                                        kqm.quant_linear_plain(x, group))),
                  f"quant_linear {model} {(M, K, Ns)}: not bitwise its plain version")
            if M > kqm.SKINNY_M:     # a prefill group: held; its widest product timed below
                del x, group
                continue
            nsum = sum(Ns)
            sets = _cold_sets(group, K * nsum)
            t_b, by = bound(2 * M * K + K * nsum + 4 * nsum + 2 * M * nsum,
                            2.0 * M * K * nsum, INT8_OPS_PER_S)
            ms = graph_ms([lambda g=g: kqm.quant_linear(x, g) for g in sets])
            plain_ms = cuda_ms(lambda: kqm.quant_linear_plain(x, group), 3)
            say(f"quant_linear zoo {model} decode (M, K, N) = {(M, K, Ns)}, {calls} launches: "
                f"bitwise; kernel {ms:.4f} ms (weights from HBM), plain {plain_ms:.4f} ms, "
                f"library none, bound {t_b:.4f} ms ({by}), {t_b / ms:.1%} of it")
            rows.append({"label": f"{model} decode", "shape": [M, K, list(Ns)],
                         "launches": calls, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                         "bound_ms": t_b, "bound_by": by})
            del x, group, sets
            free_device_memory()
        say(f"quant_linear zoo {model}: all {len(by_shape)} served groups "
            f"({sum(by_shape.values())} launches) bitwise their plain version")
        prefill = [(M, K, N) for (M, K, Ns) in by_shape if M > kqm.SKINNY_M for N in Ns]
        M, K, N = max(prefill, key=lambda s: s[0] * s[1] * s[2])
        xq, xs, wq, ws = _qmm_operands(gen, M, K, N)
        check(torch.equal(kqm.quant_matmul(xq, xs, wq, ws), kqm.quant_matmul_plain(xq, xs, wq, ws)),
              f"quant_matmul {model} {(M, K, N)}: not bitwise its plain version")
        wt, out = wq.t(), torch.empty((M, N), dtype=torch.bfloat16, device=DEVICE)
        bn = kqm.tile_n(M, N, torch.cuda.get_device_properties(0).multi_processor_count)
        ms = graph_ms(lambda: kqm._launch_product(xq, xs, wt, ws, out, M, N, K, bn), 5, 4)
        plain_ms = cuda_ms(lambda: kqm.quant_matmul_plain(xq, xs, wq, ws).to(torch.bfloat16), 1)
        wk = wq.contiguous()
        lib_ms = graph_ms(lambda: torch._int_mm(xq, wk), 5, 4)
        t_b, by = bound(M * K + K * N + 4 * (M + N) + 2 * M * N, 2.0 * M * K * N,
                        INT8_OPS_PER_S)
        launched = sum(c for (Mx, Kx, Ns), c in by_shape.items() if (Mx, Kx) == (M, K)
                       and N in Ns)
        say(f"qmm_wgmma zoo {model} prefill (M, K, N) = {(M, K, N)}, {launched} launches: "
            f"bitwise; bf16 out {ms:.4f} ms, plain {plain_ms:.4f} ms, torch._int_mm "
            f"{lib_ms:.4f} ms, bound {t_b:.4f} ms ({by}), {t_b / ms:.1%} of it")
        rows.append({"label": f"{model} prefill", "shape": [M, K, N], "launches": launched,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": t_b,
                     "bound_by": by})
        del xq, xs, wq, ws, wt, wk, out
        free_device_memory()
        rq = data["shapes"].get("quantize_rows", {})
        for (M, K, dt) in rq:
            x, _ = _group_operands(gen, M, K, ())
            got, want = kqm.quantize_rows(x), kqm.quantize_rows_plain(x)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"quantize_rows {model} {(M, K)}: not bitwise its plain version")
            del x, got, want
        (M, K, dt), launched = max(rq.items(), key=lambda kv: kv[0][0] * kv[0][1])
        x, _ = _group_operands(gen, M, K, ())
        ms = graph_ms(lambda: kqm.quantize_rows(x), 5, 4)
        plain_ms = cuda_ms(lambda: kqm.quantize_rows_plain(x), 3)
        t_b, by = bound(3 * M * K + 4 * M, 0.0)
        say(f"quantize_rows zoo {model} (M, K) = {(M, K)} bf16, {launched} launches of this "
            f"shape: all {len(rq)} served shapes bitwise; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {t_b:.4f} ms ({by}), {t_b / ms:.1%} of it")
        qrows.append({"label": f"{model} prefill", "shape": [M, K], "launches": launched,
                      "ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": t_b,
                      "bound_by": by})
        del x
    return rows, qrows


def zoo_norm_rows(gen, counts) -> list:
    """rmsnorm at every served (rows, d) of the zoo's runs: within one bf16
    step of the plain version, rows bitwise alone; the decode rows (up to
    ZOO_SLOTS) and the widest prefill rows of each d timed beside
    F.rms_norm and the bound."""
    from repro_torch.kernels import rmsnorm as krn

    served = _zoo_shapes(counts, "rmsnorm")
    rows = []
    for (n, d, dt) in sorted(served, key=lambda k: (k[1], k[0])):
        x = torch.randn(n, d, generator=gen, device=DEVICE).bfloat16()
        w = (0.1 * torch.randn(d, generator=gen, device=DEVICE)).bfloat16()
        got = krn.rmsnorm(x, w, plus_one=True)
        want = krn.rmsnorm_plain(x, w, plus_one=True)
        sync()
        g, t = got.float(), want.float()
        check(bool(((g - t).abs() <= RMS_BF16_TOL * t.abs() + 1e-6).all()),
              f"rmsnorm {(n, d)}: beyond one bf16 step of the plain version")
        check(torch.equal(krn.rmsnorm(x[n - 1:].clone(), w, plus_one=True)[0], got[n - 1]),
              f"rmsnorm {(n, d)}: row {n - 1} differs alone")
        if n > ZOO_SLOTS and n < max(m for m, dd, _ in served if dd == d):
            del x, got, want
            continue
        ms = graph_ms(lambda: krn.rmsnorm(x, w, plus_one=True), launches=10)
        plain_ms = cuda_ms(lambda: krn.rmsnorm_plain(x, w, plus_one=True), 3)
        wl = (1 + w.float()).bfloat16()
        lib_ms = graph_ms(lambda: torch.nn.functional.rms_norm(x, (d,), wl, 1e-6),
                          launches=10)
        t_b, by = bound(2 * n * d * 2 + 2 * d, 3.0 * n * d)
        launched = served[(n, d, dt)]
        say(f"rmsnorm zoo ({n}, {d}) bf16, {launched} launches of this shape: within one "
            f"bf16 step, rows bitwise alone; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"F.rms_norm {lib_ms:.4f} ms, bound {t_b:.4f} ms ({by}), {t_b / ms:.1%} of it")
        rows.append({"label": f"zoo ({n}, {d})", "shape": [n, d, "bfloat16"],
                     "launches": launched, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": t_b, "bound_by": by})
        del x, got, want
    say(f"rmsnorm zoo: all {len(served)} served shapes ({sum(served.values())} launches) "
        f"within one bf16 step of the plain version, their last rows bitwise alone")
    return rows


def zoo_fixed_rows(gen, counts) -> list:
    """fixed_linear at every served shape of the zoo's runs (the hybrid's
    three a recurrent layer: the branches with the block's norm folded in,
    the gates, fp32 out, the out-projection; Whisper's plain-weight groups,
    x's dtype out; the MoE models' router on fp32 rows and weights, their
    experts' and shared expert's gate/up and down, all fp32 out): against
    the plain version (_close_fixed), the folded norm bitwise the rmsnorm
    kernel's row.  Timed in CUDA graphs with
    weights from HBM, beside one torch.mm of the same (M, K, sum N) and
    output dtype: each decode shape (up to ZOO_DECODE_ROWS rows) and each
    model's widest product at its most and fewest prefill rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fixed_linear as kfl

    rows = []
    for model, data in counts["zoo"].items():
        served = data["shapes"].get("fixed_linear", {})
        if not served:
            continue
        arch = model.split("+")[0]
        experts = get_config(arch).num_experts if arch in MOE else 0
        prefill = [k for k in served if k[0] > ZOO_DECODE_ROWS]
        timed = set()
        for M in {min(k[0] for k in prefill), max(k[0] for k in prefill)} if prefill else ():
            timed.add(max((k for k in prefill if k[0] == M), key=lambda k: (k[1] * sum(k[2]), k)))
        for key, launched in sorted(served.items(), key=str):
            M, K, Ns, pro = key
            # an MoE router's weights and rows are fp32
            router = bool(experts) and Ns == (experts,)
            wdt = torch.float32 if router else torch.bfloat16
            x, ws, kw, xin = _fixed_case(gen, M, K, Ns, pro, dtype=wdt)
            # the hybrid's branches and gates write fp32, and so does every
            # MoE product (as the dense MLP's, then cast); the hybrid's
            # out-projection and Whisper's groups x's dtype
            fp32 = (len(Ns) > 1 and model == RG_ARCH) or bool(experts)
            outs = [torch.float32 if fp32 else torch.bfloat16] * len(Ns)
            got = kfl.fixed_linear(x, ws, outs, **kw)
            sync()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want = kfl.fixed_linear_plain(x, ws, outs, **kw)
            end.record()
            unfused = kfl.fixed_linear(xin, ws, outs)
            sync()
            held_plain_ms = start.elapsed_time(end)
            check(all(_close_fixed(a, b) for a, b in zip(got, want)),
                  f"fixed_linear {model} {(M, K, Ns, pro)}: beyond the tolerance")
            check(all(torch.equal(a, b) for a, b in zip(got, unfused)),
                  f"fixed_linear {model} {(M, K, Ns, pro)}: the folded norm differs from the "
                  f"unfused row")
            del got, want, unfused
            if M > ZOO_DECODE_ROWS and key not in timed:
                del x, ws, xin
                continue
            nsum, wsize = sum(Ns), ws[0].element_size()
            wcat = torch.cat([w for w in ws], 1).t().contiguous()
            copies = max(1, math.ceil(COLD_BYTES / (wsize * K * nsum)))
            sets = [ws] + [[w.t().contiguous().t() for w in ws] for _ in range(copies - 1)]
            ms = graph_ms([lambda s=s: kfl.fixed_linear(x, s, outs, **kw) for s in sets])
            lib = ((lambda: mm_fp32_out(xin, wcat)) if fp32 and not router
                   else (lambda: xin @ wcat.t()))
            lib_ms = graph_ms(lib, launches=10)
            where = "decode" if M <= ZOO_DECODE_ROWS else "prefill"
            lib_name = ("torch.mm fp32" if router else
                        f"torch.mm {'out_dtype=fp32' if fp32 else 'bf16'}")
            del sets
            # the plain version reads the weights once a row, in fp64: at the
            # widest shapes its one call above, timed as it ran
            plain_ms = (cuda_ms(lambda: kfl.fixed_linear_plain(x, ws, outs, **kw), 3)
                        if M * K * nsum <= 2 ** 32 else held_plain_ms)
            t_b, by = bound(x.element_size() * M * K + wsize * K * nsum
                            + outs[0].itemsize * M * nsum, 2.0 * M * K * nsum,
                            FP32_OPS_PER_S if router else BF16_OPS_PER_S)
            say(f"fixed_linear zoo {model} {where} (M, K, N, prologue) = {(M, K, Ns, pro)}, "
                f"route {kfl.route(wdt, x.dtype, pro is not None, M)}, {launched} "
                f"launches: within the tolerance, the folded norm bitwise the unfused row; "
                f"kernel {ms:.4f} ms (weights from HBM), plain {plain_ms:.4f} ms, {lib_name} "
                f"{lib_ms:.4f} ms (weights from L2), bound {t_b:.4f} ms ({by}), "
                f"{t_b / ms:.1%} of it")
            rows.append({"label": f"zoo {model} {where} {Ns} {pro}", "shape": [M, K, list(Ns)],
                         "prologue": pro, "launches": launched, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "bound_ms": t_b, "bound_by": by})
            del x, ws, xin, wcat
            free_device_memory()
        say(f"fixed_linear zoo {model}: all {len(served)} served shapes "
            f"({sum(served.values())} launches) within the tolerance of the plain version")
    return rows


# --------------------------------------------------------------------------- #
# phases 27 and 28: the two stubbed frontends (Whisper-small, LLaVA-NeXT-34B)
# --------------------------------------------------------------------------- #
def whisper_expected_launches(cfg, steps: int, int8: bool) -> dict:
    """Each kernel's launches over ``prefill(encoder_frames=)`` of
    WH_BATCH x WH_PROMPT tokens (rows past qmm_group's 16: the prefill
    forms) and ``steps`` decode steps.  The encoder's layer: 2 LayerNorms,
    4 projection groups (q/k/v, o, up, down: 6 weights), one non-causal
    prefill; a decoder layer at the prefill: 3 LayerNorms, 7 groups (q/k/v,
    o, cross q, cross k/v over the encoder's rows, cross o, up, down: 10
    weights), a causal and a cross prefill; at a decode step: 3 LayerNorms,
    6 groups (the cross K/V come from the cache), two decode launches; the
    final norms; one lm_head a forward.  int8 groups launch quantize_rows
    once and qmm_wgmma once a weight at a prefill (``quant_linear`` counts
    the latter) and qmm_group once at a decode step; plain weights one
    fixed_linear a group."""
    E, L = cfg.encoder_layers, cfg.num_layers
    out = {"layernorm": (2 * E + 1) + (3 * L + 1) * (1 + steps),
           "flash_attention": E + 2 * L, "flash_attention_decode": 2 * L * steps,
           "lm_head": 1 + steps}
    if int8:
        out.update(quant_linear=6 * E + 10 * L + 6 * L * steps, quantize_rows=4 * E + 7 * L)
    else:
        out.update(fixed_linear=4 * E + 7 * L + 6 * L * steps)
    return out


def whisper_decode(model, params, tokens, frames, new: int, max_seq: int):
    """``prefill(encoder_frames=)`` then ``new - 1`` greedy decode steps,
    every row at one position: (the greedy tokens (B, new) on the host, the
    prefill's logits, the last step's, the cache, prefill s, decode s)."""
    B, S = tokens.shape
    cache = model.init_cache(B, max_seq)
    sync()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, tokens, cache, encoder_frames=frames)
    sync()
    t_pre = time.perf_counter() - t0
    first = logits
    out = [logits[:, -1].argmax(-1)]
    t0 = time.perf_counter()
    for i in range(new - 1):
        logits, cache = model.decode_step(params, out[-1][:, None], S + i, cache)
        out.append(logits[:, -1].argmax(-1))
    sync()
    return (torch.stack(out, 1).cpu(), first, logits, cache, t_pre,
            time.perf_counter() - t0)


def whisper_run(cfg, frames, tokens, counts, report, label: str) -> None:
    """One Whisper-small configuration at its published widths and depths:
    weights from the seed (quantized a block at a time as drawn), the
    encoder timed, a warm-up prefill and decode step, then the main path
    (counted): prefill(encoder_frames=)
    of WH_BATCH rows and WH_NEW greedy tokens; then each row alone at batch
    1, bitwise: its stream, its prefill and last logits and its cross
    caches."""
    from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts
    from repro_torch.models.transformer import TransformerLM, init_model

    int8 = cfg.quantize == "int8"
    free_device_memory()
    mem_reset()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    sync()
    say(f"{label}: weights made on the card from seed {SEED} in "
        f"{time.perf_counter() - t0:.2f} s, {_storage_bytes(_leaves_any(params)) / 1e9:.3f} GB")
    model = TransformerLM(cfg, device=DEVICE)
    enc_ms = cuda_ms(lambda: model.encode(params, frames), 3)
    whisper_decode(model, params, tokens, frames, 2, WH_MAX_SEQ)    # a warm-up, not counted
    for fn in KERNELS.values():
        if hasattr(fn, "shapes"):
            fn.shapes.clear()
    sync()
    mem_reset()
    reset_launch_counts()            # the main path's run starts here
    stream, first, last, cache, t_pre, t_dec = whisper_decode(
        model, params, tokens, frames, WH_NEW, WH_MAX_SEQ)
    got = launch_counts()            # ... and ends here
    peak = mem_peak(f"{label}'s run")
    shapes = {name: dict(fn.shapes) for name, fn in KERNELS.items()
              if hasattr(fn, "shapes") and fn.shapes}
    want = whisper_expected_launches(cfg, WH_NEW - 1, int8)
    say(f"{label}: launches {got}")
    check(all(got[k] == v for k, v in want.items())
          and all(v == 0 for k, v in got.items() if k not in want),
          f"{label}: launches {got} are not the expected {want}")
    check(bool(torch.isfinite(first).all() and torch.isfinite(last).all())
          and tuple(first.shape) == (WH_BATCH, 1, cfg.vocab_size),
          f"{label}: logits {tuple(first.shape)} not finite or not (B, 1, V)")
    new = stream.numel()
    step_ms = t_dec / (WH_NEW - 1) * 1e3
    say(f"{label}: encoder {enc_ms:.3f} ms ({WH_BATCH} x {cfg.encoder_seq} frames, CUDA "
        f"events); prefill {t_pre:.4f} s (encoder, cross K/V and a {tokens.shape[1]}-token "
        f"prompt); decode {step_ms:.3f} ms a step ({WH_NEW - 1} eager steps of {WH_BATCH} "
        f"rows); {new / (t_pre + t_dec):.1f} tokens/s; peak {peak:.3f} GB")
    # every row alone at batch 1: its stream, logits and cross caches bitwise
    same = 0
    for i in range(WH_BATCH):
        s1, f1, l1, c1, _, _ = whisper_decode(model, params, tokens[i:i + 1],
                                              frames[i:i + 1], WH_NEW, WH_MAX_SEQ)
        cross = all(torch.equal(c1["b0"]["cross"][kv][:, 0], cache["b0"]["cross"][kv][:, i])
                    for kv in ("k", "v"))
        ok = (torch.equal(s1[0], stream[i]) and torch.equal(f1[0], first[i])
              and torch.equal(l1[0], last[i]) and cross)
        same += ok
        check(ok, f"{label}: row {i} alone differs from the batch (stream "
                  f"{torch.equal(s1[0], stream[i])}, cross caches {cross})")
        del c1
    say(f"{label}: {same} of {WH_BATCH} rows alone at batch 1 bitwise the batch's: stream, "
        f"prefill and last logits, cross caches of all {cfg.num_layers} layers; row 0's "
        f"stream {stream[0, :12].tolist()}...")
    counts.setdefault("zoo", {})[label] = {"launches": got, "shapes": shapes}
    report.setdefault("zoo", {})[label] = {
        "encoder_ms": enc_ms, "prefill_s": t_pre, "decode_ms_per_step": step_ms,
        "tokens_per_s": new / (t_pre + t_dec), "peak_gb": peak, "launches": got}
    del params, model, cache
    free_device_memory()


def phase_whisper(counts, report) -> None:
    """Whisper-small's encoder-decoder at its published widths, int8 as the
    zoo runs it at its published depths, and plain bf16 through
    fixed_linear at WH_PLAIN_LAYERS of them."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(WH_ARCH)
    phase(f"27. {WH_ARCH}: {cfg.encoder_layers} + {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.resolved_head_dim}, vocab "
          f"{cfg.vocab_size:,}, {cfg.encoder_seq} frames, cross-attention, LayerNorm")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 27)
    frames = torch.randn(WH_BATCH, cfg.encoder_seq, cfg.d_model, generator=gen,
                         device=DEVICE).to(torch.bfloat16)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 27).integers(
        0, cfg.vocab_size, size=(WH_BATCH, WH_PROMPT))).to(DEVICE)
    whisper_run(dataclasses.replace(cfg, quantize="int8"), frames, tokens, counts, report,
                WH_ARCH)
    whisper_run(dataclasses.replace(cfg, num_layers=WH_PLAIN_LAYERS,
                                    encoder_layers=WH_PLAIN_LAYERS),
                frames, tokens, counts, report, f"{WH_ARCH} plain")


def llava_vision_prefix(cfg, counts, report) -> None:
    """Phase 28 (b): the weights drawn again from the seed, quantized a
    block at a time; LLAVA_ROWS rows of the published 2,880 patch
    embeddings (drawn from the seed at the token rows' scale) before a
    LLAVA_TEXT-token prompt, prefilled in one call, then LLAVA_NEW greedy
    decode steps (counted); each row alone at batch 1 bitwise: stream,
    prefill and last logits."""
    from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts
    from repro_torch.models.transformer import TransformerLM, init_model

    free_device_memory()
    params = init_model(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    model = TransformerLM(cfg, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 28)
    vision = (torch.randn(LLAVA_ROWS, cfg.vision_tokens, cfg.d_model, generator=gen,
                          device=DEVICE) * cfg.d_model ** -0.5).to(torch.bfloat16)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 28).integers(
        0, cfg.vocab_size, size=(LLAVA_ROWS, LLAVA_TEXT))).to(DEVICE)
    S = cfg.vision_tokens + LLAVA_TEXT

    def run(rows):
        cache = model.init_cache(len(range(*rows.indices(LLAVA_ROWS))), LLAVA_VISION_SEQ)
        sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, tokens[rows], cache, vision_embeds=vision[rows])
        sync()
        t_pre = time.perf_counter() - t0
        first, out = logits, [logits[:, -1].argmax(-1)]
        t0 = time.perf_counter()
        for i in range(LLAVA_NEW):
            logits, cache = model.decode_step(params, out[-1][:, None], S + i, cache)
            out.append(logits[:, -1].argmax(-1))
        sync()
        return torch.stack(out, 1).cpu(), first, logits, cache, t_pre, time.perf_counter() - t0

    for fn in KERNELS.values():
        if hasattr(fn, "shapes"):
            fn.shapes.clear()
    free_device_memory()
    sync()
    mem_reset()
    reset_launch_counts()            # (b)'s run starts here
    stream, first, last, cache, t_pre, t_dec = run(slice(0, LLAVA_ROWS))
    got = launch_counts()            # ... and ends here
    peak = mem_peak(f"{cfg.name} (b), the vision prefix")
    shapes = {name: dict(fn.shapes) for name, fn in KERNELS.items()
              if hasattr(fn, "shapes") and fn.shapes}
    L, F = cfg.num_layers, 1 + LLAVA_NEW
    want = {"quant_linear": 7 * L + 4 * L * LLAVA_NEW, "quantize_rows": 4 * L,
            "rmsnorm": (2 * L + 1) * F, "flash_attention": L,
            "flash_attention_decode": L * LLAVA_NEW, "lm_head": F}
    say(f"{cfg.name} (b): launches {got}")
    check(all(got[k] == v for k, v in want.items())
          and all(v == 0 for k, v in got.items() if k not in want),
          f"{cfg.name} (b): launches {got} are not the expected {want}")
    check(bool(torch.isfinite(first).all() and torch.isfinite(last).all()),
          f"{cfg.name} (b): logits not finite")
    w_gb = _storage_bytes(_leaves_any(params)) / 1e9
    c_gb = _storage_bytes(_leaves_any(cache)) / 1e9
    step_ms = t_dec / LLAVA_NEW * 1e3
    say(f"{cfg.name} (b): prefill of {LLAVA_ROWS} x {S} tokens ({cfg.vision_tokens} patches "
        f"+ {LLAVA_TEXT} text) {t_pre:.4f} s; decode {step_ms:.3f} ms a step ({LLAVA_NEW} "
        f"eager steps of {LLAVA_ROWS} rows); peak {peak:.3f} GB = weights {w_gb:.3f} GB + "
        f"cache {c_gb:.3f} GB ({LLAVA_ROWS} x {LLAVA_VISION_SEQ} slots) + "
        f"{peak - w_gb - c_gb:.3f} GB of the prefill's activations")
    del cache
    same = 0
    for i in range(LLAVA_ROWS):
        s1, f1, l1, c1, _, _ = run(slice(i, i + 1))
        ok = (torch.equal(s1[0], stream[i]) and torch.equal(f1[0], first[i])
              and torch.equal(l1[0], last[i]))
        same += ok
        check(ok, f"{cfg.name} (b): row {i} alone differs from the batch")
        del c1
    say(f"{cfg.name} (b): {same} of {LLAVA_ROWS} rows alone at batch 1 bitwise the batch's "
        f"(stream, prefill and last logits); row 0's stream {stream[0, :8].tolist()}...")
    counts["zoo"][f"{cfg.name}+vision"] = {"launches": got, "shapes": shapes}
    report["zoo"][f"{cfg.name}+vision"] = {
        "prefill_s": t_pre, "decode_ms_per_step": step_ms, "peak_gb": peak,
        "weights_gb": w_gb, "cache_gb": c_gb, "launches": got}
    del model, vision, params
    free_device_memory()


def phase_llava(counts, report) -> None:
    """LLaVA-NeXT-34B at its published widths and depth, int8 drawn a
    block at a time: (a) the engine's text-only path, served as the zoo's
    models are; (b) the vision prefix through the model's prefill."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(LLAVA_ARCH)
    phase(f"28. {LLAVA_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} q heads over {cfg.num_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size:,}, {cfg.vision_tokens} vision tokens; int8")
    zoo_serve(LLAVA_ARCH, counts, report)
    llava_vision_prefix(dataclasses.replace(cfg, quantize="int8"), counts, report)


# --------------------------------------------------------------------------- #
# phase 29: the MoE models (Mixtral-8x22B, Llama-4-Scout-17B-16E)
# --------------------------------------------------------------------------- #
def moe_layer_check(cfg, bp, x) -> dict:
    """moe_apply at one layer's input against its plain composition
    (fixed_linear_plain in place of the kernel, on the card): the router's
    gates within ROUTER_TOL and its choices equal wherever the plain gates'
    k-th and (k+1)-th lie more than 2 ROUTER_TOL apart; on the kernel's
    routing, every expert product within fixed_linear's tolerance of its
    plain version on the same rows (gate and up on the expert's buffer
    rows, down on its rounded hidden rows), each expert row the layer keeps
    bitwise the kernel's down rounded, and moe_apply's output bitwise the
    composition of its parts (with the shared expert's MLP); the aux loss.
    Each product is held on the kernel path's own rows: run end to end in
    plain versions, a hidden value that rounds to its other bf16 neighbour
    moves a down row by a step times a weight, and a row sums ≈ 16,000 of
    them (0.004 at Mixtral's first layer, more than a bf16 step of small
    rows).  moe_apply's device time (kernels) printed."""
    from repro_torch.kernels import fixed_linear as kfl
    from repro_torch.models.layers import moe as lmoe
    from repro_torch.models.layers.mlp import mlp_apply

    t0 = time.perf_counter()
    E, k, D, f32 = cfg.num_experts, cfg.top_k, x.shape[-1], torch.float32
    rk = lmoe.moe_route(bp, x, cfg)
    out, aux = lmoe.moe_apply(bp, x, cfg)
    buf = lmoe._dispatch(x, rk, E)
    y = lmoe._experts(bp, buf, E)
    with swapped_ops(fixed_linear=kfl.fixed_linear_plain):
        rp = lmoe.moe_route(bp, x, cfg)
    sync()
    gate_err = (rk.gates - rp.gates).abs().max().item()
    srt = rp.gates.sort(dim=-1, descending=True).values
    gap = srt[:, k - 1] - srt[:, k]
    differ = (rk.top_idx != rp.top_idx).any(-1)
    n_differ, drops = int(differ.sum()), int((rk.dest == rk.drop).sum())
    check(gate_err <= ROUTER_TOL, f"moe_apply {cfg.name}: gates {gate_err:.3g} from the plain "
          f"composition's, over {ROUTER_TOL}")
    check(bool((gap[differ] <= 2 * ROUTER_TOL).all()),
          f"moe_apply {cfg.name}: {n_differ} tokens routed apart, some with a top-k gap over "
          f"2 x {ROUTER_TOL}")
    GC, prod_err = rk.groups * rk.capacity, 0.0
    for e in range(E):
        xe, wd = buf[e * GC:(e + 1) * GC], bp["w_down"][e]
        ws = [bp["w_gate"][e], bp["w_up"][e]]
        gu = kfl.fixed_linear(xe, ws, [f32, f32])
        h = (torch.nn.functional.silu(gu[0]) * gu[1]).to(x.dtype)
        down = kfl.fixed_linear(h, [wd], [f32])
        for got, want in zip(gu + down, kfl.fixed_linear_plain(xe, ws, [f32, f32])
                             + kfl.fixed_linear_plain(h, [wd], [f32])):
            prod_err = max(prod_err, (got - want).abs().max().item())
            check(_close_fixed(got, want), f"moe_apply {cfg.name}: expert {e}'s product "
                  f"{tuple(got.shape)} beyond fixed_linear's tolerance of its plain version")
        check(torch.equal(y[e * GC:(e + 1) * GC], down[0].to(x.dtype)),
              f"moe_apply {cfg.name}: expert {e}'s rows are not its down product rounded")
    whole = lmoe._combine(y, rk, cfg.moe_dispatch).view(x.shape)
    if "shared" in bp:
        whole = whole + mlp_apply(bp["shared"], x)
    check(torch.equal(out, whole), f"moe_apply {cfg.name}: not bitwise the composition of "
          f"its parts")
    aux_p = lmoe._aux(rp, cfg).item()
    check(abs(aux.item() - aux_p) <= 1e-4 * abs(aux_p),
          f"moe_apply {cfg.name}: aux {aux.item()} against {aux_p}")
    check_s = time.perf_counter() - t0
    ms = cuda_ms(lambda: lmoe.moe_apply(bp, x, cfg, aux=False), 3)
    T = x.shape[0] * x.shape[1]
    say(f"moe_apply {cfg.name} at (b)'s first layer input {tuple(x.shape)} ({rk.groups} groups of "
        f"{rk.group}, capacity {rk.capacity}, {drops} of {T * k} choices dropped) against its "
        f"plain composition (fixed_linear_plain): gates within {gate_err:.3g}, {n_differ} tokens "
        f"routed apart (top-k gap <= {2 * ROUTER_TOL} there), every expert product within "
        f"fixed_linear's tolerance of its plain version on the same rows (max abs err "
        f"{prod_err:.3g}), the output bitwise its parts' composition; aux "
        f"{aux.item():.6f} / {aux_p:.6f}; {check_s:.1f} s with the plain versions; "
        f"moe_apply with the kernels {ms:.3f} ms")
    return {"shape": list(x.shape), "groups": rk.groups, "capacity": rk.capacity,
            "drops": drops, "gate_err": gate_err, "routed_apart": n_differ,
            "max_abs_err": prod_err,
            "aux": [aux.item(), aux_p], "ms": ms, "check_s": check_s}


def moe_long(arch: str, layers: int, counts, report) -> None:
    """(b): one request of MOE_LONG[arch] prompt tokens (dispatch groups of
    2,048) and MOE_LONG_NEW greedy tokens through ServeEngine at one slot,
    past the window or the chunk; the rings' sizes, every launch count, the
    decode steps as graph replays, finite logits; the first MoE layer's
    input kept for moe_layer_check.  Its launches join the kernels line as
    "zoo_<model>+long", and 26b holds and times kernel 6 at its shapes."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts
    from repro_torch.models import transformer as tmod
    from repro_torch.models.config import BlockKind
    from repro_torch.models.transformer import init_model, layer_slice
    from repro_torch.serve import Request, ServeEngine

    cfg = dataclasses.replace(get_config(arch), quantize="int8", num_layers=layers)
    S, new = MOE_LONG[arch], MOE_LONG_NEW
    edge = (f"window {cfg.window}" if BlockKind.ATTN_LOCAL in cfg.pattern
            else f"chunk {cfg.attn_chunk}")
    say(f"(b) {cfg.name}, {layers} layers: one request of {S:,} prompt tokens ({S // 2048} "
        f"dispatch groups of 2,048), {new} greedy tokens, past its {edge}")
    free_device_memory()
    mem_reset()
    params = init_model(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    engine = ServeEngine(cfg, params, batch_size=1, max_seq=S + new, device=DEVICE)
    cache = engine.init_shared_cache()
    sync()
    mem_reset()                          # the run's peak, not the drawing's
    want_slots = {BlockKind.ATTN_LOCAL: min(cfg.window, S + new),
                  BlockKind.ATTN_CHUNKED: min(cfg.attn_chunk, S + new),
                  BlockKind.ATTN_NOPE: S + new}
    rings = {kind.value: int(cache[f"b{i}"]["attn"]["k"].shape[2])
             for i, kind in enumerate(cfg.pattern)}
    check(all(rings[k.value] == want_slots[k] for k in cfg.pattern),
          f"{cfg.name}: cache slots {rings}, not {want_slots}")
    rng = np.random.default_rng(SEED + 29)
    req = Request(prompt=rng.integers(0, cfg.vocab_size, size=S).astype(np.int32),
                  max_new_tokens=new)
    seen = {}
    apply = tmod.moe_apply

    def first_input(p, x, c, **kw):
        if "x" not in seen and x.shape[1] == S:
            seen["x"] = x.clone()
        return apply(p, x, c, **kw)

    prefill_s = []
    prefill_into = engine._prefill_into

    def timed_prefill_into(*a, **kw):
        t = time.perf_counter()
        out = prefill_into(*a, **kw)
        sync()
        prefill_s.append(time.perf_counter() - t)
        return out

    last, step_s = {}, []
    decode = engine._decode

    def kept_decode(*a, **kw):
        t = time.perf_counter()
        out = decode(*a, **kw)
        sync()
        step_s.append(time.perf_counter() - t)
        last["logits"] = out[0]
        return out

    engine._prefill_into, engine._decode = timed_prefill_into, kept_decode
    tmod.moe_apply = first_input
    for fn in KERNELS.values():
        if hasattr(fn, "shapes"):
            fn.shapes.clear()
    sync()
    try:
        reset_launch_counts()            # (b)'s run starts here
        t0 = time.perf_counter()
        served = engine.run([req])
        sync()
        t_run = time.perf_counter() - t0
        got = launch_counts()            # ... and ends here
    finally:
        tmod.moe_apply = apply
        del engine._prefill_into, engine._decode
    peak = mem_peak(f"{cfg.name} (b)")
    shapes = {name: dict(fn.shapes) for name, fn in KERNELS.items()
              if hasattr(fn, "shapes") and fn.shapes}
    steps = engine.calls["decode_steps"]
    want = zoo_expected_launches(cfg, engine.calls, steps)
    say(f"launches in (b): {got}; {engine.calls['prefills']} prefill, {steps} decode steps")
    check(all(got[k] == v for k, v in want.items())
          and all(v == 0 for k, v in got.items() if k not in want),
          f"{cfg.name} (b): launches {got} are not the expected {want}")
    check_graph_steps(engine, dict.fromkeys(engine.calls, 0), 1, f"{cfg.name} (b)")
    logits = last.pop("logits")
    check(tuple(logits.shape) == (1, 1, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"{cfg.name} (b): the last step's logits {tuple(logits.shape)} not finite")
    r = served[0]
    check(r.done and len(r.out_tokens) == new, f"{cfg.name} (b): the request did not finish")
    # the replays' steps (the first step runs eagerly and captures the graph)
    step_ms = sum(step_s[1:]) / max(len(step_s) - 1, 1) * 1e3
    say(f"(b) {cfg.name}: prefill of {S:,} tokens {prefill_s[0]:.3f} s, decode {step_ms:.2f} ms a "
        f"replayed step past the {edge} ({steps} steps, one slot; the first, with its capture, "
        f"{step_s[0] * 1e3:.1f} ms), {r.out_tokens[:8]}...; {t_run:.3f} s in all; cache slots "
        f"{rings}; peak device memory {peak:.2f} GB (weights, cache and the prefill's "
        f"activations)")
    counts["zoo"][f"{cfg.name}+long"] = {"launches": got, "shapes": shapes}
    layer = moe_layer_check(cfg, layer_slice(params["blocks"], 0)["b0"]["moe"], seen["x"])
    report["zoo"][f"{cfg.name}+long"] = {
        "prompt": S, "new_tokens": new, "prefill_s": prefill_s[0], "decode_ms_per_step": step_ms,
        "peak_gb": peak, "launches": got, "rings": rings, "moe_layer": layer, "layers": layers}
    del engine, params, served, logits, seen, cache
    free_device_memory()


def phase_moe(counts, report) -> None:
    """Phase 29: each MoE model at its published widths and a depth cut, int8
    attention (the experts bf16, as in the reference): (a) served as phase
    26 serves a model; (b) one long request past its window or chunk."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fixed_linear as kfl

    phase("29. the MoE models at their published widths, int8 attention and bf16 experts: "
          + ", ".join(f"{a} ({n} of {get_config(a).num_layers} layers)" for a, n in MOE.items()))
    say(f"card: {CARD}")
    widest = {"bf16 decode form": (kfl.max_k(torch.bfloat16, torch.bfloat16, False), 16384),
              "fp32 SIMT route": (kfl.max_k(torch.float32, torch.float32, False), 6144)}
    say("fixed_linear.max_k on this card against the widest K phase 29 gives it: "
        + ", ".join(f"{k} {v[0]:,} (needs {v[1]:,})" for k, v in widest.items()))
    check(all(v[0] >= v[1] for v in widest.values()),
          f"fixed_linear cannot take phase 29's K: {widest}")
    for arch, layers in MOE.items():
        zoo_serve(arch, counts, report, layers=layers)
        prof = report["zoo"][arch]["decode_profile"]
        if prof:
            say(f"{arch} (a): fixed_linear {prof.get('fixed_linear', 0.0):.3f} ms of the "
                f"replayed step's {prof['busy_ms']:.3f} busy ms "
                f"({prof.get('fixed_linear', 0.0) / prof['busy_ms']:.1%}), "
                f"{prof['launches']:.0f} launches")
        moe_long(arch, layers, counts, report)


def zoo_layernorm_record(gen, counts) -> dict:
    """layernorm at Whisper's served (rows, 768) shapes: against its plain
    version (LN_TOL; bitwise printed), every row bitwise alone, timed in a
    CUDA graph beside the plain version, one F.layer_norm and the bound."""
    from repro_torch.kernels import layernorm as kln

    served = _zoo_shapes(counts, "layernorm")
    rows, worst = [], 0.0
    for (n, d, dt), launched in sorted(served.items(), key=lambda kv: -kv[0][0]):
        dtype = getattr(torch, dt)
        x = (torch.randn(n, d, generator=gen, device=DEVICE) * 3 + 1).to(dtype)
        s = (1 + 0.1 * torch.randn(d, generator=gen, device=DEVICE)).to(torch.bfloat16)
        b = (0.1 * torch.randn(d, generator=gen, device=DEVICE)).to(torch.bfloat16)
        got, want = kln.layernorm(x, s, b), kln.layernorm_plain(x, s, b)
        sync()
        tol = LN_TOL[dtype]
        err = (got.float() - want.float()).abs()
        check(bool((err <= tol["atol"] + tol["rtol"] * want.float().abs()).all()),
              f"layernorm {(n, d)}: beyond the tolerance of the plain version")
        bitwise = torch.equal(got, want)
        for r in sorted({0, n // 2, n - 1}):
            check(torch.equal(kln.layernorm(x[r:r + 1].clone(), s, b)[0], got[r]),
                  f"layernorm {(n, d)}: row {r} differs alone")
        worst = max(worst, err.max().item())
        ms = graph_ms(lambda: kln.layernorm(x, s, b), launches=10)
        plain_ms = cuda_ms(lambda: kln.layernorm_plain(x, s, b), 3)
        lib_ms = graph_ms(lambda: torch.nn.functional.layer_norm(x, (d,), s.to(dtype),
                                                                 b.to(dtype), 1e-5),
                          launches=10)
        esize = x.element_size()
        t_b, by = bound(2 * n * d * esize + 2 * d * 2, 9.0 * n * d)
        say(f"layernorm ({n}, {d}) {dt}, {launched} launches of this shape: within the "
            f"tolerance (max abs err {err.max().item():.3g}), bitwise the plain version: "
            f"{bitwise}, rows bitwise alone; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"F.layer_norm {lib_ms:.4f} ms, bound {t_b:.5f} ms ({by}), {t_b / ms:.1%} of it")
        rows.append({"label": f"Whisper ({n}, {d})", "shape": [n, d, dt], "launches": launched,
                     "max_abs_err": err.max().item(), "bitwise_plain": bitwise, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": t_b,
                     "bound_by": by})
        del x, got, want
    check_no_spill("layernorm", {f"layernorm_kernel<{t}>": rf"layernorm_kernelI{m}"
                                 for t, m in (("fp32", "f"), ("bf16", "13__nv_bfloat16"))})
    head = rows[0]
    return {
        "name": "layernorm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/layernorm.cu",
        "replaces": "none: the reference's layernorm (src/repro/models/layers/norms.py:32-39), "
                    "jnp left to XLA",
        "launches": 0, "max_abs_err": worst, "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": head["shape"], "zoo_shapes": rows,
        "launches_by_path": {}}


# the records of the kernels line each zoo launch counts under, by wrapper
ZOO_RECORD_OF = {"quant_linear": "quant_matmul", "quantize_rows": "quantize_rows",
                 "rmsnorm": "rmsnorm", "flash_attention": "flash_attention",
                 "flash_attention_decode": "flash_attention_decode", "lm_head": "lm_head",
                 "fixed_linear": "fixed_linear", "rglru_scan": "rglru_scan",
                 "layernorm": "layernorm"}


def phase_zoo_kernels(gen, counts, records) -> None:
    """The zoo path's kernels held against their plain versions and timed at
    its shapes; their launches on the path added to the kernels line."""
    phase("26b. the zoo's kernels held and timed at its served shapes (phases 26-29)")
    say(f"card: {CARD}")
    records.append(zoo_scan_record(gen, counts))
    records.append(zoo_layernorm_record(gen, counts))
    by_name = {r["name"]: r for r in records}
    flash, flash_held_err = zoo_flash_rows(gen, counts)
    zoo_rows = {"flash": flash, "lm_head": zoo_head_rows(gen, counts),
                "rmsnorm": zoo_norm_rows(gen, counts), "fixed_linear": zoo_fixed_rows(gen, counts)}
    zoo_rows["quant_matmul"], zoo_rows["quantize_rows"] = zoo_qmm_rows(gen, counts)
    for rec, rows in (("lm_head", zoo_rows["lm_head"]), ("rmsnorm", zoo_rows["rmsnorm"]),
                      ("fixed_linear", zoo_rows["fixed_linear"]),
                      ("quant_matmul", zoo_rows["quant_matmul"]),
                      ("quantize_rows", zoo_rows["quantize_rows"])):
        by_name[rec]["zoo_shapes"] = rows
    for kernel in ("flash_attention", "flash_attention_decode"):
        by_name[kernel]["zoo_shapes"] = [r for r in zoo_rows["flash"] if r["kernel"] == kernel]
        by_name[kernel]["max_abs_err"] = max(
            [by_name[kernel]["max_abs_err"]] + [r["max_abs_err"] for r in zoo_rows["flash"]
                                                if r["kernel"] == kernel])
    by_name["flash_attention"]["max_abs_err"] = max(by_name["flash_attention"]["max_abs_err"],
                                                    flash_held_err)
    for model, data in counts["zoo"].items():
        for wrapper, n in data["launches"].items():
            if n and wrapper != "rglru_scan":
                rec = by_name[ZOO_RECORD_OF[wrapper]]
                rec["launches"] += n
                rec["launches_by_path"][f"zoo_{model}"] = n


# --------------------------------------------------------------------------- #
# phase 30: the serving stack's last single-card features
# --------------------------------------------------------------------------- #
# (b) and (c): every request opens with one shared prefix of PREFIX_LEN
# tokens and a tail of PREFIX_TAIL_MIN..PREFIX_TAIL_MAX; the radix cache's
# blocks and capacity (the reference launcher's flags)
PREFIX_LEN, PREFIX_TAIL_MIN, PREFIX_TAIL_MAX = 512, 64, 512
PREFIX_BLOCK, PREFIX_CAPACITY = 32, 512
# Gemma3-1B's cut for (b): one period's first 6 layers (5 local, 1 global)
# under a 768-token prefix, past its 512-slot ring
G3_PREFIX_LAYERS, G3_PREFIX_LEN = 6, 768
# (c): 4 replicas of 4 slots, 32 requests in a burst (half at 0, half at
# 1 / FLEET_RATE s)
FLEET_REPLICAS, FLEET_SLOTS, FLEET_REQUESTS, FLEET_RATE = 4, 4, 32, 20.0
# the tail form's bitwise check: prefix lengths that are not multiples of
# the key tile (32 or 64), one straddling the 512-slot ring
TAIL_STARTS = (37, 100, 300, 513)


def prefix_requests(cfg, prefix_len: int, n: int, seed: int, lead: bool = False):
    """``n`` requests of one shared ``prefix_len``-token prefix and tails
    of PREFIX_TAIL_MIN..PREFIX_TAIL_MAX tokens, LM_NEW new tokens each,
    drawn with numpy from ``seed`` (the prefix from SEED, so that requests
    of two seeds share it).  With ``lead`` the first is the bare prefix:
    a ring layer can restore a block only where the prompt that wrote it
    left its positions in the ring (the reference's ``valid_end``), and
    only the bare prefix leaves a prefix longer than the ring so."""
    from repro_torch.serve import Request

    prefix = np.random.default_rng(SEED).integers(0, cfg.vocab_size, size=prefix_len)
    rng = np.random.default_rng(seed)
    tails = rng.integers(PREFIX_TAIL_MIN, PREFIX_TAIL_MAX + 1, size=n - lead)
    out = [Request(prompt=prefix.astype(np.int32), max_new_tokens=LM_NEW)] if lead else []
    return out + [Request(prompt=np.concatenate(
        [prefix, rng.integers(0, cfg.vocab_size, size=int(t))]).astype(np.int32),
        max_new_tokens=LM_NEW) for t in tails]


def timed_prefill(engine, waves: list) -> None:
    """Time each of the engine's prefill waves into ``waves`` (host clock;
    each wave ends in a device-to-host copy of its first tokens)."""
    prefill_into = type(engine)._prefill_into

    def timed(*a, **kw):
        t = time.perf_counter()
        out = prefill_into(engine, *a, **kw)
        waves.append(time.perf_counter() - t)
        return out

    engine._prefill_into = timed


def serve_counted(engine, reqs, **kw):
    """``engine.run(reqs)`` (or a router's) with every launch count, route
    and shape set to 0 just before and read just after: (served, launches,
    decode routes, flash shapes by form, engine calls, seconds, prefill
    seconds)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.quant_matmul import quant_linear

    eng = getattr(engine, "engine", engine)
    waves = []
    timed_prefill(eng, waves)
    for k in eng.calls:
        eng.calls[k] = 0
    for fn in (kfa.flash_attention, kfa.flash_attention_decode, kfa.flash_attention_tail,
               quant_linear):
        fn.shapes.clear()
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    served = engine.run(reqs, **kw)
    sync()
    secs = time.perf_counter() - t0
    got = launch_counts()
    del eng._prefill_into
    shapes = {"flash_attention": dict(kfa.flash_attention.shapes),
              "flash_attention_decode": dict(kfa.flash_attention_decode.shapes),
              "flash_attention_tail": dict(kfa.flash_attention_tail.shapes),
              "quant_linear": dict(quant_linear.shapes)}
    return (served, got, dict(kfa.flash_attention_decode.routes), shapes, dict(eng.calls),
            secs, sum(waves))


def check_stack_launches(what: str, got, calls, layers: int, cache: str,
                         decode_routes, groups) -> None:
    """Kernel 6 and the int8 projections on a served run of an attention
    stack: a full-prefill launch a layer a miss wave, a tail-form launch a
    layer a hit wave, a decode launch a layer a step on the cache's route;
    4 quant_linear groups a layer a forward (``groups``: its calls by (M,
    K, (N, ...))), each of more than SKINNY_M rows after one quantize_rows
    launch, and with an int8 KV cache 2 more quantize_rows a layer a
    forward (K and V written)."""
    from repro_torch.kernels.quant_matmul import SKINNY_M

    waves, tails, steps = calls["prefill_waves"], calls["tail_waves"], calls["decode_steps"]
    kv = 2 if cache == "int8" else 0
    wide = sum(n for (M, *_), n in groups.items() if M > SKINNY_M)
    check(sum(groups.values()) == 4 * layers * (waves + steps),
          f"{what}: quant_linear calls {groups} are not 4 a layer a forward")
    say(f"{what}: launches {dict((k, v) for k, v in got.items() if v)}; {waves} prefill "
        f"waves ({tails} tail waves), {steps} decode steps, decode by route {decode_routes}")
    check(got["flash_attention"] == layers * (waves - tails)
          and got["flash_attention_tail"] == layers * tails
          and got["flash_attention_decode"] == layers * steps > 0,
          f"{what}: kernel 6 launches {got} != {layers} a layer a wave / hit wave / step")
    check(decode_routes == {cache: layers * steps},
          f"{what}: decode launches by route {decode_routes}, every one on {cache}")
    check(got["quantize_rows"] == wide + kv * layers * (waves + steps),
          f"{what}: quantize_rows launches {got['quantize_rows']} != {wide} wide groups + "
          f"{kv} x {layers} x ({waves} waves + {steps} steps)")
    check(got["quant_matmul"] == 0 and got["lm_head"] == waves + steps
          and all(v == 0 for k, v in got.items()
                  if k not in LM_KERNELS + ("flash_attention_tail",)),
          f"{what}: another kernel launched, or lm_head not once a forward: {got}")


def phase_kv8(params, counts, report) -> None:
    """(a) the int8 KV cache: Qwen2-1.5B at full width and depth."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config(LM_ARCH), quantize="int8", cache_dtype="int8")
    phase(f"30a. the int8 KV cache: {cfg.name} at full width and depth ({cfg.num_layers} "
          f"layers), int8 projections and cache_dtype='int8', {LM_SLOTS} slots, max_seq "
          f"{LM_MAX_SEQ}")
    mem_reset()
    engine = ServeEngine(cfg, params, batch_size=LM_SLOTS, max_seq=LM_MAX_SEQ, device=DEVICE)
    engine.warmup(prompt_lens=[LM_PROMPT_MIN])
    cache = engine.init_shared_cache()
    int8_bytes = _storage_bytes(_cache_tensors(cache))
    bf16_bytes = sum(2 * t.numel() for t in _cache_tensors(cache) if t.dtype == torch.int8)
    say(f"the shared cache ({LM_SLOTS} slots x {LM_MAX_SEQ}): {int8_bytes / 1e9:.4f} GB as "
        f"int8 codes and fp32 scales, against {bf16_bytes / 1e9:.4f} GB in bf16 "
        f"({int8_bytes / bf16_bytes:.4f} of it)")
    served, got, routes, shapes, calls, secs, pre = serve_counted(engine, lm_requests(cfg))
    check_stack_launches("(a) the served run", got, calls, cfg.num_layers, "int8", routes,
                         shapes["quant_linear"])
    check_graph_steps(engine, dict.fromkeys(calls, 0), 0, "(a) the served run")
    check(all(r.done and len(r.out_tokens) == LM_NEW for r in served),
          "(a) a request did not finish with its tokens")
    t0 = time.perf_counter()
    solo = [engine._run_one(r) for r in lm_requests(cfg)]
    same = sum(a.out_tokens == b.out_tokens for a, b in zip(served, solo))
    new = sum(len(r.out_tokens) for r in served)
    steps = calls["decode_steps"]
    say(f"(a) served {len(served)} requests / {new} new tokens in {secs:.3f} s "
        f"({new / secs:.1f} tokens/s), prefill {pre:.3f} s in {calls['prefill_waves']} "
        f"waves, decode {(secs - pre) / steps * 1e3:.2f} ms a step; streams equal to "
        f"_run_one's: {same} of {len(served)} ({time.perf_counter() - t0:.1f} s for the "
        f"oracle)")
    check(same == len(served), f"(a) {len(served) - same} streams differ from _run_one")
    report["kv8"] = {"tokens_per_s": new / secs, "prefill_s": pre,
                     "decode_ms_per_step": (secs - pre) / steps * 1e3,
                     "cache_gb": int8_bytes / 1e9, "bf16_cache_gb": bf16_bytes / 1e9,
                     "peak_gb": mem_peak("(a) the served run and the oracle")}
    counts["kv8"] = got
    counts["kv8_decode_shapes"] = shapes["flash_attention_decode"]
    del engine, cache
    free_device_memory()


def prefix_runs(what: str, cfg, params, reqs_fn, counts, key: str,
                profile: bool = False) -> dict:
    """(b)'s three runs of ``reqs_fn()``'s requests: prefix cache off, on
    (cold), on (warm, the same engine and trie), each stream and first
    token held against the others and _run_one's; the hit statistics, the
    prefill seconds and the launches of each; with ``profile``, where the
    time of one wave of the first requests goes, off and warm (a full
    wave, a tail wave)."""
    from repro_torch.serve import RadixPrefixCache, ServeEngine

    off = ServeEngine(cfg, params, batch_size=LM_SLOTS, max_seq=LM_MAX_SEQ, device=DEVICE)
    pc = RadixPrefixCache(block_size=PREFIX_BLOCK, capacity_blocks=PREFIX_CAPACITY)
    on = ServeEngine(cfg, params, batch_size=LM_SLOTS, max_seq=LM_MAX_SEQ, prefix_cache=pc,
                     device=DEVICE)
    for eng in (off, on):
        eng.warmup(prompt_lens=[LM_PROMPT_MIN])
    check(pc.blocks == 0, f"{what}: the warm-up's probe blocks stayed in the trie")
    runs = {}
    for label, eng in (("off", off), ("cold", on), ("warm", on)):
        before = dict(pc.stats())
        served, got, routes, shapes, calls, secs, pre = serve_counted(eng, reqs_fn())
        check_stack_launches(f"{what} cache {label}", got, calls, cfg.num_layers, "bf16",
                             routes, shapes["quant_linear"])
        check_graph_steps(eng, dict.fromkeys(calls, 0), 0, f"{what} cache {label}")
        stats = {k: pc.stats()[k] - before[k] for k in ("requests", "hits", "misses",
                                                         "cached_tokens", "prompt_tokens",
                                                         "evictions", "inserted_blocks")}
        stats["hit_rate"] = stats["cached_tokens"] / max(stats["prompt_tokens"], 1)
        hit = label != "off"
        check(not hit or (stats["hits"] > 0 and calls["tail_waves"] > 0),
              f"{what} cache {label}: no hit ({stats})")
        say(f"{what} cache {label}: {secs:.3f} s, prefill {pre:.4f} s in "
            f"{calls['prefill_waves']} waves ({calls['tail_waves']} tail waves), "
            + (f"hits {stats}" if hit else "no prefix cache"))
        runs[label] = {"served": served, "seconds": secs, "prefill_s": pre, "calls": calls,
                       "launches": got, "stats": stats if hit else None,
                       "tail_shapes": shapes["flash_attention_tail"],
                       "cached": [r.cached_prefill for r in served]}
    if profile:
        runs["off"]["wave_profile"] = prefill_profile(off, reqs_fn(), f"{what} cache off")
        runs["warm"]["wave_profile"] = prefill_profile(on, reqs_fn(),
                                                       f"{what} cache on (warm)")
    t0 = time.perf_counter()
    solo = [off._run_one(r) for r in reqs_fn()]
    for label, run in runs.items():
        same = sum(a.out_tokens == b.out_tokens for a, b in zip(run["served"], solo))
        firsts = sum(a.out_tokens[:1] == b.out_tokens[:1]
                     for a, b in zip(run["served"], solo))
        check(same == len(solo) and firsts == len(solo),
              f"{what} cache {label}: {len(solo) - same} streams and {len(solo) - firsts} "
              f"first tokens differ from _run_one's")
    say(f"{what}: every stream and first token of the three runs equal to _run_one's "
        f"({len(solo)} requests, {time.perf_counter() - t0:.1f} s for the oracle); cached "
        f"prefill tokens a request (warm): {runs['warm']['cached']}")
    counts.setdefault("prefix_tail_shapes", collections.Counter()).update(
        collections.Counter(runs["cold"]["tail_shapes"])
        + collections.Counter(runs["warm"]["tail_shapes"]))
    counts[key] = {label: run["launches"] for label, run in runs.items()}
    out = {label: {k: v for k, v in run.items() if k not in ("served", "launches")}
           for label, run in runs.items()}
    out["oracle"] = solo
    del off, on
    return out


def phase_prefix(params, counts, report) -> list:
    """(b) the radix prefix cache and the tail prefill; returns Qwen2's
    _run_one streams (phase 30c reuses them)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model

    cfg = dataclasses.replace(get_config(LM_ARCH), quantize="int8")
    phase(f"30b. the prefix cache: {cfg.name} at full width and depth, int8 projections, "
          f"bf16 cache, {LM_REQUESTS} requests of a shared {PREFIX_LEN}-token prefix and "
          f"tails of {PREFIX_TAIL_MIN}..{PREFIX_TAIL_MAX}, blocks of {PREFIX_BLOCK}")
    mem_reset()
    qwen = prefix_runs("(b) Qwen2", cfg, params,
                       lambda: prefix_requests(cfg, PREFIX_LEN, LM_REQUESTS, SEED + 1),
                       counts, "prefix_qwen", profile=True)
    full = get_config(G3_ARCH)
    g3 = dataclasses.replace(full, quantize="int8", num_layers=G3_PREFIX_LAYERS,
                             pattern=full.pattern[:G3_PREFIX_LAYERS])
    say(f"Gemma3-1B at full width, {G3_PREFIX_LAYERS} layers "
        f"({', '.join(k.value for k in g3.pattern)}), window {g3.window}, a shared "
        f"{G3_PREFIX_LEN}-token prefix, the first request the bare prefix")
    g3_params = init_model(torch.Generator(device=DEVICE).manual_seed(SEED), g3)
    gemma = prefix_runs("(b) Gemma3", g3, g3_params,
                        lambda: prefix_requests(g3, G3_PREFIX_LEN, LM_REQUESTS, SEED + 2,
                                                lead=True),
                        counts, "prefix_gemma3")
    report["prefix"] = {"qwen2": {k: v for k, v in qwen.items() if k != "oracle"},
                        "gemma3": {k: v for k, v in gemma.items() if k != "oracle"},
                        "peak_gb": mem_peak("(b) the six runs and their oracles")}
    del g3_params
    free_device_memory()
    return qwen["oracle"]


def phase_fleet(params, km_model, oracle, counts, report) -> None:
    """(c) the replica router, its autoscaler, and the predictor fleet."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import arrival_trace
    from repro_torch.serve import (PredictorFleet, QueueAutoscaler, RadixPrefixCache,
                                   ReplicaRouter)
    from repro_torch.serve.predictor import ModelPredictor, PredictRequest

    cfg = dataclasses.replace(get_config(LM_ARCH), quantize="int8")
    phase(f"30c. the replica router: {cfg.name} at full width, int8 projections, "
          f"{FLEET_REPLICAS} replicas x {FLEET_SLOTS} slots, QueueAutoscaler(min_replicas=1), "
          f"prefix cache on, {FLEET_REQUESTS} requests in a burst on the host clock")
    mem_reset()
    auto = QueueAutoscaler(slots_per_replica=FLEET_SLOTS, min_replicas=1,
                           max_replicas=FLEET_REPLICAS)
    router = ReplicaRouter(cfg, params, slots_per_replica=FLEET_SLOTS,
                           max_replicas=FLEET_REPLICAS, min_replicas=1, max_seq=LM_MAX_SEQ,
                           autoscaler=auto, device=DEVICE,
                           prefix_cache=RadixPrefixCache(block_size=PREFIX_BLOCK,
                                                         capacity_blocks=PREFIX_CAPACITY))
    # every span's graph captured before the run
    router.warmup(prompt_lens=[LM_PROMPT_MIN], spans=range(1, FLEET_REPLICAS + 1))
    check(router.engine.prefix_cache.blocks == 0, "(c) the warm-up's blocks stayed")
    check(set(router.engine._graphs) == {("span", n * FLEET_SLOTS)
                                         for n in range(1, FLEET_REPLICAS + 1)}
          | {FLEET_REPLICAS * FLEET_SLOTS},
          f"(c) the warm-up captured {sorted(router.engine._graphs, key=str)}")

    def reqs():
        half = FLEET_REQUESTS // 2
        out = (prefix_requests(cfg, PREFIX_LEN, half, SEED + 1)
               + prefix_requests(cfg, PREFIX_LEN, FLEET_REQUESTS - half, SEED + 3))
        for r, a in zip(out, arrival_trace("burst", len(out), FLEET_RATE, SEED)):
            r.arrival = float(a)
        return out

    start = time.perf_counter()
    served, got, routes, shapes, calls, secs, pre = serve_counted(
        router, reqs(), now_fn=lambda: time.perf_counter() - start)
    check_stack_launches("(c) the fleet's run", got, calls, cfg.num_layers, "bf16", routes,
                         shapes["quant_linear"])
    check_graph_steps(router.engine, dict.fromkeys(calls, 0), 0, "(c) the fleet's run")
    rep = router.report()
    events = rep["autoscaler_events"]
    kinds = {k for _, k, _ in events}
    say(f"(c) served {rep['finished']} of {len(served)} in {secs:.3f} s (prefill {pre:.3f} "
        f"s); latency p50 {rep['latency_p50'] * 1e3:.1f} ms, p99 "
        f"{rep['latency_p99'] * 1e3:.1f} ms; backfills {rep['backfills']}; autoscaler "
        f"{events}; prefix cache {rep['prefix_cache']}; requests a replica "
        f"{[r['finished'] for r in rep['per_replica']]}")
    check("up" in kinds and "down" in kinds, f"(c) the autoscaler's events {events}")
    check(all(r.done for r in served) and rep["rejected"] == 0, "(c) a request not served")
    t0 = time.perf_counter()
    # the first half are (b)'s requests, whose _run_one streams (b) holds
    rest = [router.engine._run_one(r) for r in reqs()[len(oracle):]]
    same = sum(a.out_tokens == b.out_tokens for a, b in zip(served, list(oracle) + rest))
    say(f"(c) streams equal to _run_one's: {same} of {len(served)} ({len(rest)} oracles "
        f"here, {time.perf_counter() - t0:.1f} s)")
    check(same == len(served), f"(c) {len(served) - same} streams differ from _run_one")
    counts["fleet"] = got
    report["fleet"] = {"seconds": secs, "prefill_s": pre, "events": events,
                       "latency_p50": rep["latency_p50"], "latency_p99": rep["latency_p99"],
                       "prefix_cache": rep["prefix_cache"], "calls": calls}
    del router
    free_device_memory()

    # PredictorFleet: two replicas of phase 6's k-means predictor against
    # the single predictor, pick for pick
    rng = np.random.default_rng(SEED + 4)
    sizes = rng.integers(1, 2 * KMEANS_SERVE_ROWS, size=16)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    blocks = [torch.randn(int(n), KMEANS_FEATURES, generator=gen, device=DEVICE).cpu().numpy()
              for n in sizes]
    single = ModelPredictor(km_model, max_batch=KMEANS_SERVE_ROWS, device=DEVICE)
    want = [single.submit(PredictRequest(features=b)) for b in blocks]
    single.flush()
    fleet = PredictorFleet([ModelPredictor(km_model, max_batch=KMEANS_SERVE_ROWS,
                                           device=DEVICE) for _ in range(2)])
    reset_launch_counts()
    picks = []
    for b in blocks:
        req = PredictRequest(features=b)
        picks.append((fleet.submit(req), req))
    fleet.flush_all()
    sync()
    launched = launch_counts()
    frep = fleet.report()
    same = sum(np.array_equal(r.result, w.result) for (_, r), w in zip(picks, want))
    say(f"(c) PredictorFleet of 2 k-means predictors: {len(blocks)} requests of "
        f"{min(sizes)}..{max(sizes)} rows, by replica {[i for i, _ in picks]}, "
        f"{frep['batches']} microbatches, {launched['kmeans_assign']} kmeans_assign "
        f"launches; picks bitwise the single predictor's: {same} of {len(blocks)}")
    check(same == len(blocks), "(c) the fleet's picks differ from the single predictor's")
    check(launched["kmeans_assign"] == frep["batches"] > 0
          and sum(v for k, v in launched.items() if k != "kmeans_assign") == 0,
          f"(c) the fleet's launches {launched} for {frep['batches']} microbatches")
    check(set(i for i, _ in picks) == {0, 1}, "(c) the fleet dispatched to one replica")
    counts["predictor_fleet"] = launched["kmeans_assign"]


def kv8_record(gen, counts) -> dict:
    """Kernel 6's decode form on its int8 route: bitwise the bf16 (fp32)
    route over caches dequantized as _cache_read does, at Qwen2's and
    Gemma3's shapes; within FLASH_TOL of the plain version; timed at (a)'s
    shape beside the plain version, the bf16 route on the dequantized
    caches, one dequantize + SDPA and its bound."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.flash_attention import _admitted, slot_positions

    qw, g3 = get_config(LM_ARCH), get_config(G3_ARCH)
    cases = [((LM_SLOTS, qw.num_heads, qw.num_kv_heads, LM_MAX_SEQ, qw.resolved_head_dim),
              dict(causal=True)),
             ((LM_SLOTS, g3.num_heads, g3.num_kv_heads, G3_MAX_SEQ, g3.resolved_head_dim),
              dict(causal=True)),
             ((LM_SLOTS, g3.num_heads, g3.num_kv_heads, g3.window, g3.resolved_head_dim),
              dict(causal=True, window=g3.window))]
    worst = 0.0

    def inputs(dtype, B, H, KV, slots, hd):
        q = torch.randn(B, H, hd, generator=gen, device=DEVICE).to(dtype)
        codes = [torch.randint(-127, 128, (B, slots, KV, hd), generator=gen, device=DEVICE,
                               dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand(B, slots, KV, generator=gen, device=DEVICE) * 0.05 + 1e-8
                  for _ in range(2)]
        return q, codes, scales

    for (B, H, KV, slots, hd), kw in cases:
        # ragged positions, some past the ring's end (its slots stale) and
        # some short of it (the slots above them stale)
        pos = torch.tensor([0, 1, slots // 2 - 1, slots - 1, slots, 2 * slots - 1, 3 * slots + 7,
                            slots // 3][:B], device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            q, (kc, vc), (ks, vs) = inputs(dtype, B, H, KV, slots, hd)
            got = kfa.flash_attention_decode(q, kc, vc, pos, k_scale=ks, v_scale=vs, **kw)
            kd, vd = (kfa.cache_read(c, s).to(dtype) for c, s in ((kc, ks), (vc, vs)))
            want = kfa.flash_attention_decode(q, kd, vd, pos, **kw)
            plain = kfa.flash_attention_decode_plain(q, kc, vc, pos, k_scale=ks, v_scale=vs,
                                                     **kw)
            sync()
            check(torch.equal(got, want), f"int8 route {(B, H, KV, slots, hd)} {kw} {dtype}: "
                  f"not bitwise the route over the dequantized caches")
            ok, err, ratio = _flash_err(got, plain, dtype, min(slots, kw.get("window") or slots))
            check(ok, f"int8 route {(B, H, KV, slots, hd)} {kw} {dtype}: max abs err {err} "
                  f"({ratio:.3g} x the tolerance)")
            worst = max(worst, err)
    say(f"flash_attention_decode, int8 route: bitwise the bf16 / fp32 route over caches "
        f"dequantized by _cache_read at {[c[0] for c in cases]} (masks "
        f"{[c[1] for c in cases]}), fp32 and bf16 q, positions ragged and past the ring; "
        f"max abs err against the plain version {worst:.3g}")
    served = counts["kv8_decode_shapes"]
    key = max(served, key=lambda k: served[k])
    B, H, KV, slots, hd, mk = key[:6]
    kw = _mask_kwargs(mk)
    q, (kc, vc), (ks, vs) = inputs(torch.bfloat16, B, H, KV, slots, hd)
    # every row at the end of a stream: (a)'s last positions
    pos = torch.linspace(LM_PROMPT_MIN, LM_PROMPT_MAX + LM_NEW - 1, B,
                         device=DEVICE).long()
    ms = graph_ms(lambda: kfa.flash_attention_decode(q, kc, vc, pos, k_scale=ks, v_scale=vs,
                                                     **kw))
    plain_ms = cuda_ms(lambda: kfa.flash_attention_decode_plain(
        q, kc, vc, pos, k_scale=ks, v_scale=vs, **kw), 3)
    kd, vd = kfa.cache_read(kc, ks), kfa.cache_read(vc, vs)
    bf16_ms = graph_ms(lambda: kfa.flash_attention_decode(q, kd, vd, pos, **kw))
    sp = slot_positions(pos, slots)
    valid = (sp >= 0) & _admitted(pos[:, None], sp, **kw)

    def lib():
        k = kfa.cache_read(kc, ks).transpose(1, 2)
        v = kfa.cache_read(vc, vs).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=valid[:, None, None, :], scale=hd ** -0.5,
            enable_gqa=True)

    lib_ms, backend = library_time(lib, "dequantize (cache_read) + scaled_dot_product_"
                                   "attention", eager=False)
    pairs = _attention_pairs(B, H, 1, slots, kw, pos=pos, slots=slots)
    n_valid = float(valid.sum().item())
    # each admitted (slot, kv head) read once for K and once for V: hd
    # codes and a 4-byte scale, where the bf16 route reads 2 hd bytes
    t_b, by = bound(2 * n_valid * KV * (hd + 4) + 2 * 2 * B * H * hd, 4.0 * hd * pairs)
    t_16, _ = bound(2 * 2 * n_valid * KV * hd + 2 * 2 * B * H * hd, 4.0 * hd * pairs)
    launched = counts["kv8"]["flash_attention_decode"]
    say(f"flash_attention_decode int8 route (B, H, KV, slots, hd) = {(B, H, KV, slots, hd)} "
        f"{kw}, bf16 q, positions {pos.tolist()}, {launched} launches on (a)'s path: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, the bf16 route on the dequantized caches "
        f"{bf16_ms:.4f} ms, {_ms(lib_ms)} ({backend}); bound {t_b:.4f} ms ({by}; "
        f"{n_valid:.0f} valid slots; the bf16 route's {t_16:.4f} ms), {t_b / ms:.1%} of it")
    return {"name": "flash_attention_decode_int8", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode_int8.cu",
            "replaces": "src/repro/kernels/flash_attention.py:123",
            "launches": launched, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": t_b, "bound_by": by, "library_ms": lib_ms, "library_note": backend,
            "bf16_route_ms": bf16_ms, "bf16_bound_ms": t_16,
            "shape": [B, H, KV, slots, hd], "mask": kw, "positions": pos.tolist(),
            "launches_by_path": {"kv8_serve": launched}}


def tail_record(gen, counts) -> dict:
    """Kernel 6's tail form: each row bitwise the full prefill's row at the
    same position and within FLASH_TOL of its plain version, first at
    global, window and chunk masks with prefixes that are not multiples of
    the key tile, then at every (B, H, KV, Sq, ring, hd, mask) that the
    served runs of (b) and (c) launched, with ragged starts as a hit wave
    has them; timed at (b)'s widest hit wave beside the plain version (its
    output held too), the full prefill of the same rows, SDPA with the
    explicit mask and its bound."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.flash_attention import _admitted

    qw, g3 = get_config(LM_ARCH), get_config(G3_ARCH)
    S, B = 700, len(TAIL_STARTS)
    cases = [((qw.num_heads, qw.num_kv_heads, qw.resolved_head_dim), dict(causal=True), S),
             ((g3.num_heads, g3.num_kv_heads, g3.resolved_head_dim), dict(causal=True), S),
             ((g3.num_heads, g3.num_kv_heads, g3.resolved_head_dim),
              dict(causal=True, window=g3.window), g3.window),
             ((4, 2, 64), dict(causal=True, chunk=128), 128)]
    worst = 0.0
    for (H, KV, hd), kw, ring in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(gen, dtype, B, H, KV, S, S, hd)
            full = kfa.flash_attention(q, k, v, **kw)
            tq, tk, tv, kc, vc, st, n = tail_operands(q, k, v, TAIL_STARTS, ring)
            got = kfa.flash_attention_tail(tq, tk, tv, kc, vc, st, n, **kw)
            plain = kfa.flash_attention_tail_plain(tq, tk, tv, kc, vc, st, n, **kw)
            sync()
            for b, s in enumerate(TAIL_STARTS):
                check(torch.equal(got[b, :, :S - s], full[b, :, s:]),
                      f"tail form {(H, KV, hd)} {kw} {dtype} start {s}: not bitwise the "
                      f"full prefill's rows")
                ok, err, ratio = _flash_err(got[b, :, :S - s], plain[b, :, :S - s], dtype, S)
                check(ok, f"tail form {(H, KV, hd)} {kw} {dtype} start {s}: max abs err "
                      f"{err} ({ratio:.3g} x)")
                worst = max(worst, err)
    say(f"flash_attention_tail: every row bitwise the full prefill's at its position, "
        f"{[(c[0], c[1]) for c in cases]}, prefixes {TAIL_STARTS}, fp32 and bf16; max abs "
        f"err against the plain version {worst:.3g}")
    served = counts["prefix_tail_shapes"]
    for key in sorted(served, key=str):
        Bs, H, KV, Sq, ring, hd, mk = key
        kw = _mask_kwargs(mk)
        start = served_tail_starts(Bs, Sq, ring, kw)
        S = min(start) + Sq
        q, k, v = _flash_inputs(gen, torch.bfloat16, Bs, H, KV, S, S, hd)
        full = kfa.flash_attention(q, k, v, **kw)
        ops = tail_operands(q, k, v, start, ring)
        check(tuple(ops[0].shape) == (Bs, H, Sq, hd) and tuple(ops[3].shape) == (Bs, ring, KV, hd),
              f"tail form at the served {key}: operands {[tuple(t.shape) for t in ops]}")
        got = kfa.flash_attention_tail(*ops, **kw)
        plain = kfa.flash_attention_tail_plain(*ops, **kw)
        sync()
        keys = min(S, kw.get("window") or S, kw.get("chunk") or S)
        for b, s in enumerate(start):
            check(torch.equal(got[b, :, :S - s], full[b, :, s:]),
                  f"tail form at the served {key}, start {s}: not bitwise the full prefill's rows")
            ok, err, ratio = _flash_err(got[b, :, :S - s], plain[b, :, :S - s], torch.bfloat16,
                                        keys)
            check(ok, f"tail form at the served {key}, start {s}: max abs err {err} "
                  f"({ratio:.3g} x)")
            worst = max(worst, err)
        say(f"flash_attention_tail at the served (B, H, KV, Sq, ring, hd) = "
            f"{(Bs, H, KV, Sq, ring, hd)} {kw} ({served[key]} launches), bf16, starts {start}: "
            f"every row bitwise the full prefill's, within FLASH_TOL of the plain version")
        del q, k, v, full, ops, got, plain
    say(f"flash_attention_tail: {len(served)} served shapes held; max abs err against the plain "
        f"version over every case {worst:.3g}")
    # Qwen2's widest hit wave (a global layer: the sub-cache's T slots)
    key = max((k for k in served if k[1] == qw.num_heads),
              key=lambda k: (k[0] * k[3], k[4]))
    Bs, H, KV, Sq, T, hd, mk = key
    kw = _mask_kwargs(mk)
    start = [PREFIX_LEN] * Bs
    Sk = PREFIX_LEN + Sq
    q, k, v = _flash_inputs(gen, torch.bfloat16, Bs, H, KV, Sk, Sk, hd)
    tq, tk, tv, kc, vc, st, n = tail_operands(q, k, v, start, T)
    out = {}

    def tail():
        out["kernel"] = kfa.flash_attention_tail(tq, tk, tv, kc, vc, st, n, **kw)

    def tail_plain():
        out["plain"] = kfa.flash_attention_tail_plain(tq, tk, tv, kc, vc, st, n, **kw)

    ms = cuda_ms(tail, 5)
    plain_ms = cuda_ms(tail_plain, 1)
    full = kfa.flash_attention(q, k, v, **kw)
    sync()
    check(torch.equal(out["kernel"], full[:, :, PREFIX_LEN:]),
          f"tail form at the timed {key}: not bitwise the full prefill's rows")
    ok, err, ratio = _flash_err(out["kernel"], out["plain"], torch.bfloat16, Sk)
    check(ok, f"tail form at the timed {key}: max abs err {err} ({ratio:.3g} x)")
    worst = max(worst, err)
    del out, full
    # the same rows through the full prefill: queries at the last Sq of Sk
    full_ms = cuda_ms(lambda: kfa.flash_attention(tq, k, v, **kw), 5)
    pq = torch.arange(Sq, device=DEVICE)[:, None] + PREFIX_LEN
    mask = _admitted(pq, torch.arange(Sk, device=DEVICE)[None, :], **kw)
    lib, backend = sdpa_yardstick(tq, k, v, attn_mask=mask, scale=hd ** -0.5)
    lib_ms, backend = library_time(lib, backend + ", the explicit mask", eager=True)
    pairs = _attention_pairs(Bs, H, Sq, Sk, kw)
    moved = 2 * (2 * Bs * H * Sq * hd + 2 * Bs * KV * Sk * hd)
    t_b, by = bound(moved, 4.0 * hd * pairs, BF16_OPS_PER_S)
    launched = sum(counts[p][label]["flash_attention_tail"]
                   for p in ("prefix_qwen", "prefix_gemma3") for label in ("cold", "warm"))
    launched += counts["fleet"]["flash_attention_tail"]
    say(f"flash_attention_tail (B, H, KV, Sq, ring, hd) = {(Bs, H, KV, Sq, T, hd)} {kw}, "
        f"bf16, every row after a {PREFIX_LEN}-token prefix, {served[key]} launches at this "
        f"shape, {launched} on the paths: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, the "
        f"full prefill of the same rows {full_ms:.4f} ms, scaled_dot_product_attention "
        f"{_ms(lib_ms)} ({backend}); bound {t_b:.4f} ms ({by}, {pairs:.4g} admitted pairs at "
        f"the bf16 tensor-core rate), {t_b / ms:.1%} of it; its rows bitwise the full "
        f"prefill's and within FLASH_TOL of the plain version's")
    regs = {name: use for name, use in ptxas_usage("flash_tail").items()}
    say("tail-form instances (-Xptxas -v: registers, spill store and load bytes, stack "
        "frame): " + "; ".join(f"{_short(name)} {use}" for name, use in sorted(regs.items())))
    return {"name": "flash_attention_tail", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_tail.cu",
            "replaces": "src/repro/kernels/flash_attention.py:123",
            "launches": launched, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": t_b, "bound_by": by, "library_ms": lib_ms, "library_note": backend,
            "full_prefill_ms": full_ms, "shape": [Bs, H, KV, Sq, T, hd], "mask": kw,
            "start": PREFIX_LEN,
            "launches_by_path": {
                **{f"{p}_{label}": counts[p][label]["flash_attention_tail"]
                   for p in ("prefix_qwen", "prefix_gemma3") for label in ("cold", "warm")},
                "fleet": counts["fleet"]["flash_attention_tail"]}}


def _short(name: str) -> str:
    import re

    m = re.search(r"(flash_\w+?kernel)I(.*?)EE", name)
    return f"{m.group(1)}<{m.group(2)}>" if m else name[:60]


def served_tail_starts(B: int, Sq: int, ring: int, kw: dict) -> list:
    """Ragged prefix lengths for a served tail shape, as a hit wave has
    them: spread over Sq positions, the first row's tail the longest (Sq),
    even rows on a block boundary and odd rows on no key tile's.  On a
    layer whose ring holds every position (global, or a window or chunk
    wider than the ring), every prefix lies within the ring's slots, as the
    wave's T slots hold it; on a window or chunk ring every prefix passes
    the ring's end, so the prefix wraps."""
    span = kw.get("window") or kw.get("chunk")
    hi = ring + Sq if span and ring >= span else ring - 1
    lo = max(1, hi - Sq + 1)
    out = []
    for b in range(B):
        s = lo + (hi - lo) * b // max(B - 1, 1)
        s = s - s % PREFIX_BLOCK if b % 2 == 0 else s | 1
        out.append(min(max(s, lo), hi))
    out[0] = lo
    return out


def tail_operands(q, k, v, start, ring):
    """The tail form's operands cut from a full prefill's: each row's
    queries and K/V from ``start[b]`` on (padded to the longest tail), and
    ring caches of ``ring`` slots holding what a full prefill leaves at the
    positions below ``start[b]`` (slot p mod ring, the last ring of them)."""
    B, KV, S, hd = k.shape
    L = [S - s for s in start]
    Sq = max(L)

    def cut(t):
        out = torch.zeros(t.shape[0], t.shape[1], Sq, hd, dtype=t.dtype, device=t.device)
        for b, s in enumerate(start):
            out[b, :, :S - s] = t[b, :, s:]
        return out

    caches = []
    for t in (k, v):
        c = torch.zeros(B, ring, KV, hd, dtype=t.dtype, device=t.device)
        for b, s in enumerate(start):
            p = torch.arange(max(0, s - ring), s, device=t.device)
            c[b, p % ring] = t[b, :, p].transpose(0, 1)
        caches.append(c)
    return (cut(q), cut(k), cut(v), *caches, torch.tensor(start, device=q.device),
            torch.tensor(L, device=q.device))


def phase_serving_stack(gen, km_model, counts, report, records) -> None:
    """Phase 30: (a) the int8 KV cache, (b) the prefix cache, (c) the
    router and the predictor fleet, then (d) the new route and form held
    and timed; their launches join the kernels line."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model

    # Qwen2-1.5B's int8 weights, drawn once and quantized a block at a
    # time, serve (a), (b) and (c)
    cfg = dataclasses.replace(get_config(LM_ARCH), quantize="int8")
    params = init_model(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    phase_kv8(params, counts, report)
    oracle = phase_prefix(params, counts, report)
    phase_fleet(params, km_model, oracle, counts, report)
    del params
    free_device_memory()
    phase("30d. kernel 6's int8 decode route and tail form held and timed at (a)'s and "
          "(b)'s shapes")
    say(f"card: {CARD}")
    records.append(kv8_record(gen, counts))
    records.append(tail_record(gen, counts))
    by_name = {r["name"]: r for r in records}
    paths = {"kv8_serve": counts["kv8"],
             **{f"{p}_{label}": counts[p][label] for p in ("prefix_qwen", "prefix_gemma3")
                for label in ("off", "cold", "warm")},
             "fleet": counts["fleet"]}
    for path, got in paths.items():
        for wrapper, n in got.items():
            if not n or wrapper == "flash_attention_tail":
                continue
            if path == "kv8_serve" and wrapper == "flash_attention_decode":
                continue                 # the int8 route's own record
            rec = by_name[ZOO_RECORD_OF[wrapper]]
            rec["launches"] += n
            rec["launches_by_path"][path] = n
    km = by_name["kmeans_assign"]
    km["launches"] += counts["predictor_fleet"]
    km.setdefault("launches_by_path", {})["predictor_fleet"] = counts["predictor_fleet"]


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
    first_path = ("logreg_grad", "logreg_margin", "kmeans_assign")
    reset_launch_counts()            # the first path's run starts here
    phase_logreg(gen, counts, report)
    phase4_w = report["logreg"]["sgd"].weights.clone()   # phase 24 (a) holds it
    phase_kmeans(gen, counts, report)
    phase_serving(gen, counts, report)
    totals = launch_counts()         # ... and ends here
    km_model = report["kmeans"]["model"]   # phase 30 (c) serves it again
    say(f"launches on the first path: {totals}")
    check(all(totals[k] > 0 for k in first_path)
          and all(v == 0 for k, v in totals.items() if k not in first_path)
          and set(logreg_grad_routes()) == {"one_pass"},
          f"a kernel of the first path never launched, or another did: {totals}; "
          f"logreg_grad by route {dict(logreg_grad_routes())}")

    records = phase_timing(gen, counts, report)
    for r in records:
        check(r["launches"] == totals[r["name"]], f"{r['name']} launch bookkeeping")
    # phase 21 fits the GLMs on phase 4's table, then frees the first
    # path's tables (free_tables) before its ALS and PCA parts
    phase_estimators(gen, report)
    free_device_memory()
    # the child processes of phases 22 (d), 23 (f) and 24 start here, once
    # the first path's tables are freed: each spends ≈ 8-15 s reaching the
    # card, so they run beside phases 20-23 (whose times are read beside
    # them) instead of in series with the phase that reads them
    children = [FitCLI(), TuneCLI(), MeshChildren()]
    fit_cli, tune_cli, mesh_children = children
    try:
        fig = phase_fig_a2()             # counts its own launches
        free_device_memory()
        say(f"after phase 20: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated "
            f"(its tables kept for phase 25)")
        stream = phase_stream(fit_cli)   # counts its own launches, frees its pools
        phase_search(gen, tune_cli)      # launches no kernel (checked)
        mesh = phase_mesh(mesh_children, phase4_w, fig)  # counts the mesh path's launches
    finally:
        for child in children:
            child.close()
    phase("25. kernels 1-3 held and timed at the shapes of phases 20, 22 and 24, once no "
          "child process shares the card")
    for part in (fig, stream, mesh):
        for name, times in part.pop("times")().items():
            # a kernel held and timed at a path's shapes that the path did
            # not launch (logreg_xt_z since the one-pass gradient) counts 0
            part["kernels"].setdefault(name, {"launches": 0}).update(times)
    fig.pop("tables")                # phase 20's tables, kept for phases 24 and 25
    free_device_memory()
    for r in records:
        for key, part in (("fig_a2", fig), ("stream", stream), ("mesh", mesh)):
            if r["name"] in part["kernels"]:
                r[key] = part["kernels"][r["name"]]
                r["launches"] += r[key]["launches"]
                r["launches_by_path"][key] = r[key]["launches"]

    phase_lm(counts, report)
    phase_mamba(counts)
    worst = phase_new_kernels_check(gen, counts)
    records.extend(phase_new_kernels_timing(gen, counts, worst))
    phase_gemma3(counts, report)
    # quant_matmul's phases read the shapes both int8 models launched
    worst = phase_qmm_check(gen, counts)
    records.extend(phase_qmm_timing(gen, counts, worst))
    # the plain-weight path runs before the flash_attention and lm_head
    # phases, whose records count its launches too
    phase_lm_plain(counts, report)
    rms = next(r for r in records if r["name"] == "rmsnorm")
    rms["launches"] += counts["lmp"]["rmsnorm"]
    rms["launches_by_path"]["lm_plain_serve"] = counts["lmp"]["rmsnorm"]
    worst = phase_flash_check(gen, counts)
    records.extend(phase_flash_timing(gen, counts, worst))
    records.append(phase_head(gen, counts))
    worst = phase_fixed_check(gen, counts)
    records.extend(phase_fixed_timing(gen, counts, worst))
    # the serving stack's int8 KV cache, prefix cache and router on
    # Qwen2-1.5B and Gemma3-1B, then kernel 6's new route and form
    phase_serving_stack(gen, km_model, counts, report, records)
    del km_model
    # the model zoo last, on an otherwise empty card (Qwen1.5-32B's int8
    # weights and caches take ≈ 70 GB), then its kernels at its shapes
    phase_zoo(counts, report)
    # the two stubbed frontends (Whisper-small ≈ 1 GB, LLaVA-NeXT-34B ≈ 40
    # GB), each freed before the next; their runs join the zoo's records
    phase_whisper(counts, report)
    phase_llava(counts, report)
    # the MoE models (≈ 40 and 37 GB at 8 layers), each freed before the
    # next; their runs join the zoo's records and 26b's shapes
    phase_moe(counts, report)
    phase_zoo_kernels(gen, counts, records)
    end_phase()
    # logreg_xt_z is on no path since the fits take logreg_grad: the checks
    # and a width no cluster holds launch it
    check(len(records) == 17
          and all((r["launches"] == 0) == (r["name"] == "logreg_xt_z") for r in records),
          f"a kernel was never launched on its path, or logreg_xt_z was: "
          f"{[(r['name'], r['launches']) for r in records]}")
    say(f"smoke run {time.perf_counter() - t_start:.1f} s; seconds by phase: "
        f"{PHASE_SECONDS}")
    print(CARD)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--stream-child"]:
        sys.exit(stream_child(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-host"]:
        sys.exit(mesh_host(sys.argv[2]))
    if sys.argv[1:2] == ["--fit"]:
        fit_main(sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
