#!/usr/bin/env python3
"""Drive the repro_torch main paths once on one CUDA card, and check them.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; the kernels are built from
``src/repro_torch/csrc`` at first use.  Phases, in order (any failure
raises and the script exits non-zero):

1. card and precision: the card, its power limit, the TF32 switches (off);
2. build: the four CUDA sources (one nvcc each, in parallel), with the
   build seconds and ptxas' report, per kernel for the Hopper redesign
   (``wgmma_kernel``, ``attn_wgmma_kernel``, ``simt_kernel``,
   ``ssd_mma_kernel``, ``kmeans_mma_kernel``), which must show no spills
   and no stack frame (no local memory);
3. kernel vs plain on the card, each call checked to take the route its
   layout implies (the wrappers count launches by route):
   ``stacked_matmul`` on the SIMT route in f32/bf16/f16 (ragged blocks,
   18- and 140-byte rows, split-K) and on the wgmma route in bf16/f16 (at
   the tile, ragged, below one tile, ``transpose_a``, K-major B, split-K),
   each run twice for the same bits, a strided ``DsArray.T`` view on both
   routes, the 2-D entry and an int32 operand that must raise;
   ``kmeans_assign`` with ragged n,
   gm > 1, k not a multiple of 8, k·d past one block's shared memory
   (centers staged in chunks, the partial in global scratch), rows of 2,560
   and 4,096 features (the D-tiled layout), k = 2000 (the sums pass with
   its partial in global memory), k = 128 and d = 128 (rows at a pitch
   of 136) in one block column and in two, each on the route the rule
   gives it (mma: 3xTF32 tensor cores, resident or streamed, one block
   column only) and forced onto simt, an mma call run twice for the same
   bits; uncentred blobs (features near 100) on the mma route, which the
   same expansion with single-TF32 products must fail; 131,072 centred
   random rows on the mma route, which the plain version fed TF32-rounded
   x and centers must fail; the simt D-tiled layout forced on
   narrow rows, whose labels must equal the whole-row layout's bit for
   bit, and the mma route's streamed form, whose labels and counts must
   equal its resident form's;
   ``flash_attention`` on the cases of ``tests/test_kernels.py``, D of
   80, 112 and 256 and the encoder-decoder's non-causal forms at D = 64
   (16 heads, Tq < Tk, Tq > Tk, one query over every slot) in f32 (SIMT
   tile), bf16 and f16 (wgmma), at the LM
   path's prefill shape (B = 2, H = 32, T = 4096, D = 80, causal, bf16),
   D = 80 with q_offset and kv_len, and the decode shape (Tq = 1,
   kv_len < Tk, the rows kernel); ``ssd_chunk`` alone at the LM path's
   shape (B·H = 160, T = 4096, L = 128, P = S = 64) on the mma route (3xTF32
   tensor cores) and forced onto the simt route, fast and slow decay, every
   output within the card test's tolerance of the plain chunk, which the
   plain chunk fed TF32-rounded x, B and C must fail; ``ssd_chunk`` +
   ``ssd_scan`` at that shape with fast and slow decay and ``h0`` and at
   two small shapes, all on the mma route; each against a limit from its
   output's precision and reduction depth that a zeroed output, attention
   without its causal mask (non-causal attention: made causal) and an SSD
   without its inter-chunk term must fail;
4. the ds-array main path at a size K-means users run: 8,000,000 x 100 fp32
   samples in 64 Gaussian blobs, blocks (262,144 x 100): ``from_array`` ->
   ``mean(axis=0)`` -> ``matmul_ta(x, x)``; 8192² ``A @ B`` and
   ``matmul_ta(A, B)`` in f32 and bf16 with blocks (2048, 2048);
   ``KMeans(64, max_iter=20, tol=1e-4, seed=0)`` fit, predict and score.
   The launch counts are zeroed just before and read just after (the two
   bf16 products must take the wgmma route, the f32 ones and the Gram the
   SIMT route, every ``kmeans_assign`` the mma route), and every result is
   checked against a plain or float64
   version; a zeroed product and products of bf16- or TF32-rounded inputs
   must fail the GEMM check;
5. times at that path's shapes (median of 7 CUDA-event timed runs after a
   warm-up, each queued behind a ~1 ms device-side spin so that the host's
   launch latency is not counted) beside the bound the card's data sheet
   gives, and its wall times; the bf16 products also on the SIMT route
   (forced, as before the tensor-core kernel), in the same run;
   ``kmeans_assign`` at the fit's shape on the mma route (resident) and
   forced onto simt, each against its own bound;
6. the lazy plan layer on the main path's arrays, each step's launch
   counts zeroed before and read after: a fused chain at 8192² f32
   (``sqrt(abs((A + B)·2))`` into sum(0), max(1) and a duplicate sum(0)),
   its optimizer stats those of the reference's, the duplicate collapsed,
   its bits the eager chain's, its kernel launches (``torch.profiler``, in
   a child process: a profiler session here would cost phase 8's profiles
   their kernels) beside the eager chain's; the transpose fold ``(X.lazy().T @ X)`` at
   8 M x 100, bits equal to ``matmul_ta``, one ``stacked_matmul`` launch on
   the route ``plan`` gives it, added peak memory below X's; the PCA
   power-iteration body ``xl.T @ (xl @ Q)`` recorded 20 times (Q 100 x 8,
   re-orthonormalised between), optimised and built once, 40 GEMM
   launches, its last Q within the GEMM limit of the eager loop's; K-means
   predict and two scores with ``‖x‖²`` as one plan, optimised once, the
   score that of the eager ``‖x‖²``; ``pseudo_shuffle`` and
   ``exact_shuffle`` of X, eager and lazy from one generator state (equal
   bits), the sorted float64 row checksums ``x·w`` equal to X's, pad ZERO;
   ``concat_rows`` of X split at 15 · 262,144 rows (grid stack) and at
   4,000,000 (gather), both equal to X; ``norm(axis=1)`` and
   ``norm(axis=0)`` within 1e-4 relative of float64; each step timed;
7. the LM path: zamba2-2.7b at its published widths (54 Mamba-2 layers, the
   shared attention block after every 6), bf16, random weights from
   ``--seed`` with every norm scale, ``conv_b`` and ``dt_bias`` redrawn (the
   package's init, like the reference's, zeroes the norms, which makes every
   Mamba layer the identity).  Each step below zeroes the launch counts
   before and checks them after (9 attention and 54 SSD launches per
   forward, all 9 attention launches of a bf16 forward on the wgmma route,
   every SSD launch on the mma route, 9 attention launches per decoded
   token on the rows kernel):
   ``forward`` on B = 2, T = 4096, its logits against the same forward with
   the plain attention and SSD swapped in, then timed (median of 3 warm
   runs); the float32 model at T = 64, ``decode_step`` teacher-forced
   against ``forward``; ``serve.generate`` in float32 and with the bf16
   weights, its tokens held to the argmax of a teacher-forced forward;
   ``serve.main`` with four requests of 256 prompt and 64 new tokens (its
   times: it draws its own weights, whose zero norms make every logit 0);
   the composition: the
   ``forward_hidden`` states of 16 batches of (2, 4096) tokens (131,072 x
   2,560 fp32) as a ds-array with blocks (8192, 2560), clustered by
   ``KMeans(64, max_iter=20, tol=1e-4, seed=0)``, every ``kmeans_assign``
   on the mma route (streamed);
8. times of ``flash_attention`` (prefill on the wgmma route and, forced,
   on the SIMT tile kernel; decode), ``ssd_chunk`` (the mma route and,
   forced, the simt route) and ``kmeans_assign`` (the mma route and,
   forced, the simt route's D-tiled layout) at the LM path's shapes (the
   SSD chunk's bounds count the causal half of its L x L
   products: three TF32 products per fp32 one for the mma route, fp32 for
   the simt route), the check that
   the main paths launched ``ssd_chunk`` 972 times on the mma route and
   never on the simt route (and ``kmeans_assign`` only on the mma route),
   the LM path's wall times, and a ``torch.profiler`` breakdown (device
   time by kernel group, the device's busy share) of one forward, 8 decode
   steps and one assign at the composition's shape (its labels kernel and
   its sums pass apart);
9. the sparse path at the Netflix Prize shape (paper §5.3): 480,189 x
   17,770 with 100,480,507 distinct uniform positions drawn from
   ``--seed``, ratings 1..5, through ``from_scipy`` with blocks (32,768 x
   4,096): ``check_invariants``, the three sums, ``(R·0.5).sqrt()``,
   ``R·R``, ``R + R`` and ``canonicalize``, ``S·D`` for the one-block-row
   slice S and a dense D, ``astype(bfloat16)``; ``R @ V``,
   ``matmul_ta(R, U)``, ``R.T @ U`` and one ALS half-step (f = 16, its
   dense product on ``stacked_matmul``); the lazy fold, a sparse chain
   recorded twice and a lazy slice; ``KMeans(64)`` fit, predict and score
   on R.  Each step against float64 (scipy, or the COO triplets on the
   card) with a zeroed control that must fail; the products and K-means
   run with the package's densify patched to raise; the added peak memory
   of ``R @ V``, ``matmul_ta`` and one assignment below half of R's stored
   bytes; their times beside the bytes bound and ``torch.sparse.mm``.

10. the estimators through their entry points, each fit, predict,
    transform and score timed (CUDA-synchronised) with its ``stacked_matmul``
    launches by route and added peak memory: on phase 4's samples (rebuilt
    from ``--seed``; y linear in x plus noise; the blob ids as classes)
    ``PCA(8)`` and ``frobenius``, ``tsqr``, ``LinearRegression()`` (which
    must pick the normal equations), ``LinearRegression(solver="tsqr")`` and
    ``Ridge(alpha=1)``, ``RandomForestClassifier()`` on the 64 blob ids, and
    an RBF ``CascadeSVM`` (sv_cap 64, 3 iterations) on X's first block row
    re-blocked into 64 chunks of 4,096 rows (a cascade node's dual is
    rows x rows); on phase 9's R ``ALS(16)`` (10 iterations, no convergence
    check: the reference's dense ``u @ vᵀ`` is 34 GB there), fitted twice
    for the same bits and scored on ``R[:32768]``, and ``PCA(16,
    center=False)``.  Checks against float64 on the card: PCA against the
    same power iteration from the same start and each variance against
    the data's along its component; ``‖QR − X‖`` and ``‖QᵀQ − I‖``; the
    normal equations' backward error and ``predict == X @ coef_ +
    intercept_``; the forest's arrays equal to a CPU fit of the first
    65,536 rows and its predictions to a Python walk of the trees; the
    CSVM's decision values from ``sv_``, ``dual_coef_`` and
    ``intercept_``; both ALS half-steps; each with a wrong answer that must
    fail.  The PCA and CSVM plans are optimised once; no GEMM takes the
    plain version.
11. the durable path (at most 60 s), on phase 4's and phase 10's arrays and
    fitted estimators, each step's launch counts zeroed before and read
    after, in a scratch directory whose free space is checked first:
    ingestion — X written with ``np.save`` and read back by
    ``load_npy_rows`` (its bits; host tracemalloc peak at most 3 block rows;
    GB/s and the added device peak, X twice while the block rows stack),
    an ``io_load`` fault at block row 3 (``IOLoadError``,
    ``memory_allocated`` back to its value), X's first 262,144 + 4,096 rows
    as ``%.4e`` text (``np.savetxt``'s bytes, the digits formed on the card)
    through ``load_txt_file`` (the bits of ``from_array(np.loadtxt)``), R's
    first 33,768 users as 1-based svmlight through ``load_svmlight_file``
    (``from_scipy``'s stacked COO, invariants) and all of R as an
    uncompressed ``.npz`` through ``load_npz_sparse`` (R's stacked COO);
    model files — ``save_model`` / ``load_model(device="cuda")`` of
    ``KMeans(64)``, ``PCA(8)``, the linear models, the forest, the CSVM,
    ``ALS(16)`` and sparse ``PCA(16)``, each save, load and output (fitted
    and loaded) a step of its own, each output bit-equal to the fitted
    object's, the loaded ``KMeans``' assigns all on the mma route, every
    leaf from the card 32-bit (host NumPy leaves keep the reference's
    dtypes); crash and resume — ``KMeans(64)`` on X's first
    2,097,152 rows (cut from 8 M: three k-means++ inits fit the budget;
    tol=0, max_iter=6 if it converges in < 3 iterations), with
    ``checkpoint_dir``, crashed halfway and resumed to the plain fit's
    ``n_iter_`` and center bits, every assign on the mma route; phase
    10's ``ALS(16)`` crashed at iteration 5 and its CSVM at iteration 2,
    both resumed to phase 10's bits; guarded execution on phase 4's 8192²
    f32 ``A @ B``:
    ``run_resilient`` clean (only ``executions`` counted, ``compute()``'s
    bits and launches, its added time from timed runs that are steps too),
    one transient (one retry), ``oom`` on the fused and eager rungs (two
    degradations; the einsum rung launches ``compute()``'s ``stacked_matmul``
    calls, within the GEMM limit of the kernel's, and runs Xᵀ X on the
    2,097,152 rows with its split-K workspace within the 4 MiB low-memory
    cap where the fused run's passes it, both within the GEMM limit of
    float64; no GEMM on the card takes the plain version), a real ``torch.cuda.OutOfMemoryError`` classified
    ``oom`` with the next allocation fine, NaN poisoned into block (1, 2)
    under ``guard="finite"`` (``NumericalDivergence`` naming it), and the
    clean result's ``finite_report``.
12. the predict server and the plan profiler (at most 45 s), each step's
    launch counts zeroed before and read after: ``Ridge(alpha=0.1)`` fitted
    on 131,072 x 4,096 f32 rows from ``--seed`` (blocks 16,384 x 4,096;
    ``benchmarks/bench_serve.py``'s width), saved with ``save_model`` and
    loaded back as version 2 by ``ModelRegistry(device="cuda").load``, and
    phase 4's ``KMeans(64)`` registered eagerly; buckets (1, 8, 32, 128),
    block rows 128, dense and stacked COO at density 0.01 (``nse`` 20,971).
    The first request of a cold registry (``warm=False``, plan cache
    cleared) against a warm one; streams of 64 requests per model, format
    and bucket, each submitted, pumped and awaited in turn (p50/p99 µs,
    requests/s, launches per request); 4 client threads x 32 requests of
    1-8 rows against the started server.  Checks, each with a wrong answer
    that must fail: every served result is the bits of ``predict`` on its
    padded bucket batch, a lone row the bits of a direct predict, every
    Ridge result within the GEMM limit of float64, K-means labels the
    float64 argmin up to near-ties; the steady state (``opt_runs``,
    ``misses`` and ``aot_compiles`` frozen, ``cache_hits`` the plan
    requests, no shed, fallback, retry or failure); every dense request one
    ``stacked_matmul`` on the card (no plain GEMM), every K-means request
    one ``kmeans_assign`` on the mma route; an injected ``serve_dispatch``
    transient bumps exactly ``dispatch_retries`` and a crash of every
    batched dispatch exactly ``batch_sheds``, its requests served with the
    bits of a direct predict.  The device's busy share over the 128-row
    dense stream (``torch.profiler``); the served product alone beside its
    bound, its plain version and ``torch.matmul``; ``obs.profile`` of phase
    6's fused chain at 8192² f32, of the served 128-row Ridge plan and of
    an elementwise chain on a 128-row stacked COO batch, every node's
    measured bytes the cost model's (a law off by 2x must drift), the
    per-node sum against the fused run and the run's memory; and, in child
    processes (``--serve-first``), the seconds from ``import repro_torch``
    to the first response, registered cold and warm.
13. distribution: a one-rank NCCL group (its store a file under
    ``build/``) and a 1 x 1 ``("data", "model")`` mesh, at the main path's
    sizes (phase 4's A and B, the 8 M x 100 samples redrawn from
    ``--seed``, phase 9's R): ``summa_matmul`` and ``cannon_matmul`` of the
    8192² products in f32 (SIMT route) and bf16 (wgmma route), each call's
    launches counted by route, within the GEMM limit of the plain product
    (Cannon's d - 1 partial sums in the operands' type added to it), the
    same bits twice; ``summa_matmul(A + 1, B - 2)`` whole and cut to 8000²
    (the product of the FILL-pad blocks must fail); ``transpose_pp`` of the
    samples equal to ``X.T`` (of ``X + 1``: FILL(1) in the pad region);
    ``colsum_psum`` within 1e-5 of sum|x| of float64 (one block row
    dropped must fail); ``slice_sharded``, ``rechunk_sharded``,
    ``concat_rows_sharded`` and the plain slice, row gather, ``rechunk``,
    ``concat_rows`` and elementwise ops of a distributed A, each equal to
    the undistributed op with its placement kept; ``distribute_sparse`` of
    R (stored entries and the first block row equal); a DTensor handed to
    ``local_matmul`` raises.  Then CUDA-event times of each schedule whole,
    its collectives alone and its local GEMMs alone beside the
    undistributed ``A @ B``, ``transpose_pp`` and ``colsum_psum`` beside
    their undistributed forms and bytes bounds, and the added peak memory.
    With four cards it also runs the same in four child processes
    (``--dist-rank``), one NCCL rank per card, on a 2 x 2 mesh.
14. plan analysis, its launch counts zeroed before and read after:
    ``analysis.check`` (every rule, ``WAIVERS`` of ``python -m
    repro_torch.analysis`` suppressed) over the plans captured with
    ``plan.capture_plans()`` from phase 4's ``KMeans(64)`` fit (a dense fit
    records none) and its predict and score on the 8 M x 100 samples, phase
    6's fold and power iteration on them and its fused chain on the 8192²
    A and B (into ``sum(0)``, ``max(1)``, ``sum(0)``), phase 4's 8192²
    ``A @ B`` in f32 and bf16 recorded lazily, phase 9's sparse plans on R (the sparse
    ``‖x‖²`` and ``Rᵀ @ U``), phase 10's ``PCA(8)`` and ``Ridge(alpha=1)``
    fits, and one warmed bucket (128 rows) of phase 12's served Ridge: per
    plan the findings by rule and severity, the naive and minimised peaks,
    and each plane's seconds (the graph plane's added peak memory too); any
    finding at or above ``warn`` that ``WAIVERS`` does not name fails.  The
    graph of phase 4's pipeline at 64 x 48 (the six-op chain, one ``@``, one
    folded ``matmul_ta``) recorded on the card and on the CPU must be equal
    node for node, kernel nodes included.  ``python -m repro_torch.analysis``
    in a child process on the card must exit 0 and print exactly the
    waivers ``WAIVERS`` lists.  Both GEMM routes and the assign's mma route
    must have launched.
15. training (zamba2-2.7b at its published widths, 54 layers, bf16 weights
    from ``--seed`` with the norms redrawn as in phase 7, fp32 AdamW
    moments, remat on; the batch B = 2 x T = 4096 from
    ``pipeline_for_model``): first the autograd Functions' gradients
    against autograd of the plain versions at small shapes on the
    ``wgmma``, ``tile`` and SSD ``mma`` routes (the backward launches no
    kernel); then one step's loss and gradients through the kernels against
    the same step with the plain versions swapped in (``plain_kernels``):
    the loss within 2·E, E = |loss(plain bf16) − loss(float32 twin)| (the
    twin forward only, under ``no_grad``), the flattened gradients' cosine
    at least 0.99 and norm ratio within 1 ± 0.05; six ``make_train_step``
    steps, each launching exactly 18 ``flash_attention`` (all ``wgmma``)
    and 108 ``ssd_chunk`` (all ``mma``): remat recomputes each group's
    forward, the backward launches nothing; losses, grad norms and
    parameters finite, every parameter leaf moved, ``count`` 6; s/step,
    tokens/s and the peak memory; one more loss-and-gradients call with
    each plain backward fenced and timed (its share of the call); greedy
    decode of 16 tokens from the trained weights through ``serve.generate``
    (tokens the teacher-forced argmax at a share of at least 0.5); and
    ``launch/train.main`` at the smoke size on the card, crashed at step 12
    and resumed from step 9's checkpoint to ``latest_step == 24``, its
    launches counted (27 steps run).  The kernels line adds each LM
    kernel's ``train`` launches.
16. the dense and SSM families at their published widths, bf16 weights
    from ``--seed`` with the norms redrawn (``redraw_family_norms``), each
    step's launch counts zeroed before and read after.  gemma2-2b (26
    layers, d_model 2,304, 8 query heads of 256 over 4 KV heads, vocab
    256,000, window 4,096 on the local layers, soft-caps 50 and 30):
    ``forward`` on B 1 x T 8,192 (the window cuts), exactly 26
    ``flash_attention`` launches, all ``wgmma``, its logits within 2·E of
    the same forward with the plain attention (E: the plain bf16 forward
    against its float32 twin; the forward without its windows must fail),
    then timed (median of 3 warm runs) and profiled with 2 decode steps;
    one layer's attention at that shape, windowed (against its plain
    version; the same attention without its window must fail the limit)
    and global, timed beside their bounds over the pairs each sees, the
    plain version and SDPA (causal, no window or soft-cap); decode
    attention against a full 4,096-slot rolling cache (rows); float32
    ``decode_step`` teacher-forced over 48 tokens, and a check config with
    ``attn_window=32`` whose rolling buffers wrap (its 16 steps after the
    wrap against the windowed forward; the forward without that window must
    fail); ``launch.serve --arch gemma2-2b`` with 4 requests of 256 + 64
    tokens.  mamba2-370m (48 layers, d_model 1,024, 32 heads of 64, state
    128, chunk 128, vocab 50,280): ``forward`` on B 8 x T 2,048, exactly 48
    ``ssd_chunk`` launches, all ``mma``, against the plain-SSD forward (the
    forward without the inter-chunk term must fail), timed and profiled;
    ``ssd_chunk`` alone at its shape (BH 256, BG 8, S 128) against its
    plain version (TF32-rounded x, B, C must fail) and timed; float32
    decode teacher-forced; ``launch.serve --arch mamba2-370m`` as above.
    The kernels line adds the phase's launches (``families``) and the new
    shapes as ``cases``.
17. the encoder-decoder family: seamless-m4t-medium at its published width
    (12 encoder + 12 decoder layers, d_model 1,024, 16 heads of 64, d_ff
    4,096, vocab 256,206), bf16 weights from ``--seed`` with every norm
    redrawn around 1, each step's launch counts zeroed before and read
    after.  First ``AttentionFunction``'s gradients at the family's forms
    (non-causal, Tq != Tk, D 64) on ``wgmma`` and ``tile`` against plain
    autograd.  ``forward`` on B 8 x 1,536 frames (~30 s of speech) x 256
    tokens, exactly 36 ``flash_attention`` launches (12 encoder, 12
    decoder, 12 cross), all ``wgmma``, its logits within 2·E of the plain
    forward (the forward with a causal encoder must fail), timed and
    profiled with 2 decode steps; the encoder's self-attention and the
    cross-attention at those shapes and decode cross-attention (4 x 1
    query over 256 encoder slots, ``rows``) against their plain versions
    (made causal must fail), timed beside their bounds, the plain version
    and SDPA (``is_causal=False``: the same function); float32
    ``decode_step`` with ``enc_out`` in the cache, teacher-forced over 48
    tokens; one loss-and-gradients call against the plain one (loss within
    2·E, cosine at least 0.99) and 3 ``make_train_step`` steps at B 4 x
    T_dec 256 over 1,536 frames (losses finite, every leaf moved, s/step,
    peak); ``launch.serve --arch seamless-m4t-medium`` with 4 requests of
    256 frames and prompt tokens + 64 new tokens.  The kernels line adds
    the phase's launches (``encdec``) and the new shapes as ``cases``.
18. the MoE family: mixtral-8x7b at its published width (d_model 4,096,
    32 query heads of 128 over 8 KV heads, d_ff 14,336, 8 experts top-2,
    capacity factor 1.25, vocab 32,000, window 4,096 on every layer) with
    its depth cut to fit one card (93 GB in bf16 at 32 layers), bf16
    weights from ``--seed`` with the norms redrawn, each step's launch
    counts zeroed before and read after.  At 4 layers: the slots dropped
    by each layer; ``forward`` on B 1 x T 8,192 (the window cuts), exactly
    4 ``flash_attention`` launches, all ``wgmma`` (D = 128, GQA 32:8), its
    logits within 2·E of the plain-attention forward (the forward without
    its window must fail); float32 ``decode_step`` teacher-forced over 48
    tokens on a check config with ``capacity_factor = n_experts``
    (dropless, as the reference's SMOKE configs: at 1.25 the forward drops
    slots that a one-token step never drops).  One layer's attention at
    that shape against its plain version (without its window must fail),
    timed beside its bound over the pairs the window leaves, the plain
    version and SDPA (causal, no window: not the same function); decode
    attention on ``rows`` at D = 128.  At 16 layers (47 GB): the forward
    timed (median of 3 warm runs) and profiled by group (expert products,
    the dispatch's torch ops, attention, the fp32 logits), 2 decode steps
    profiled, and ``serve.generate`` with 4 requests of 256 + 64 tokens.
    The kernels line adds the phase's launches (``moe``) and the new
    shapes as ``cases``.
19. training over a device mesh: a one-rank NCCL group and a 1 x 1
    ``("data", "model")`` mesh; zamba2-2.7b at its full width and phase
    15's shape (B 2 x T 4,096) from ``--seed``: the unmeshed
    ``loss_and_grads`` (its gradients kept on the host), then the meshed
    one (parameters placed by ``param_shardings``, the batch by the
    pipeline's mesh) with exactly phase 15's attention and SSD launches,
    all ``wgmma`` / ``mma``, on local shards: the loss within phase 15's
    2·E, the gradients' cosine and norm ratio within phase 15's limits;
    one profiled call each, meshed and unmeshed (device time by group);
    three meshed AdamW steps timed beside phase 15's and beside two
    unmeshed steps on the same state's shards, with the peak, the host
    thread's time a step, and the collectives and redistributions of a
    fourth (``CommDebugMode``); ``compressed_psum`` on the NCCL group (5 trials on
    a (4, 64) tensor within the reference test's bounds, one call timed at
    64 MB); ``torchrun --nproc_per_node 1 -m repro_torch.launch.train
    --smoke --mesh data=1,model=1`` through a crash and a resume, whose
    losses equal phase 15's unmeshed driver's.  With four cards, four
    NCCL ranks take yi-9b at its published width (4 layers) on a 2 x 2
    mesh, the loss within 1e-2 of one card's.
20. MoE training and the multi-node dry run: mixtral-8x7b at its
    published width cut to 4 of 32 layers (6.07 B parameters), bf16
    weights from ``--seed`` with the norms redrawn, AdamW with bf16 moments
    (``launch.dryrun.pick_optimizer``'s choice at that size), remat on, B 1
    x T 8,192 from ``pipeline_for_model``, accumulation 1 (``pick_accum``
    asks 2 for the family, which B = 1 cannot split), no mesh.  One
    loss-and-gradients call against the plain one (the loss within 2·E of
    the float32 twin's gap, the gradients' cosine at least 0.99), exactly
    8 ``wgmma`` attention launches a step (forward and remat recompute);
    4 AdamW steps (s/step the median of steps 2-4, tokens/s,
    ``max_memory_allocated``) and a fifth profiled by group (the expert
    MLPs and their ``bmm`` backward, the dispatch's scatter/gather and
    backward, attention forward and backward, the rest).  Then
    ``launch.dryrun.estimate`` of exactly that step, and of phase 15's
    zamba2-2.7b step, on ``meta`` tensors: each estimated peak (plus the
    bytes live on the card outside the step) within 10 % of the card's
    ``max_memory_allocated``, the arguments' bytes equal, the estimate's
    flops over the measured s/step in TFLOP/s and as a share of 989 bf16.
    Meanwhile ``python -m repro_torch.launch.dryrun`` runs in niced child
    processes, six at a time, with the card hidden: every arch at
    ``train_4k`` on one pod
    (256 ranks), one ``prefill_32k``, one ``decode_32k``, one
    ``long_500k`` and one two-pod cell; no cell may err, and each prints
    its mode, accumulation, rank 0's peak against the card's memory, flops
    and collective bytes by kind.  The kernels line adds the phase's
    launches (``dryrun``).

The line before the last is ``{"kernels": [...]}`` with one object per
kernel and route; the last is ``{"ok": true, "device": {...}}``.  Without a
CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import statistics
import subprocess
import sys
import time

# NVIDIA H100 SXM data sheet (dense): fp32 on CUDA cores, tf32/bf16/f16 on
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "f16": 989e12}
PEAK_BYTES = 3.35e12

N_ROWS, N_FEATURES, N_CLUSTERS = 8_000_000, 100, 64
X_BLOCK = (262_144, 100)
SQUARE, SQUARE_BLOCK = 8192, (2048, 2048)
SAMPLE_ROWS = 1_000_000
TIMED_RUNS = 7
SPIN_CYCLES = 2_000_000    # ~1 ms of the card's clock before each timed run
# GEMM limit: GEMM_ERRS x the fp32 error of a depth-K sum, eps·√K·rms(ref),
# plus one unit in the last place of the output type
GEMM_ERRS = 8
# a label may differ from its reference only at a near-tie: the float64 gap
# between the row's two nearest centers is below GAP_ERRS x the largest fp32
# error of a distance measured on these rows; and at most NEAR_TIE_SHARE of
# the rows may be such near-ties
GAP_ERRS = 4
NEAR_TIE_SHARE = 1e-4

# the LM path
LM_ARCH = "zamba2-2.7b"
LM_BATCH, LM_SEQ = 2, 4096
DECODE_SEQ = 64
DECODE_TOL = 5e-3          # decode vs teacher forcing (tests/test_models.py)
SERVE_ARGV = ["--arch", LM_ARCH, "--batch", "4", "--prompt-len", "256",
              "--gen", "64"]
FORWARD_RUNS = 3           # warm forwards timed after the checked one
GEN32_PROMPT, GEN32_NEW = 16, 32               # serve.generate, float32 check
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 32, 64     # serve.generate, bf16 weights
BF16_AGREE = 0.5           # least share of bf16 tokens equal to the forward's argmax
TOP_ERRS = 16              # bf16 token's logit: at most this x E below the best
HIDDEN_BATCHES = 16
HIDDEN_BLOCK = (8192, 2560)
LM_CLUSTERS = 64
ATTN_PER_FORWARD, SSD_PER_FORWARD = 9, 54

# the training path (phase 15): zamba2-2.7b at full width, B = 2 x T = 4096
TRAIN_STEPS = 6
TRAIN_LR = 3e-3            # AdamW peak (the driver's default), warm-up 1 step
GRAD_COS = 0.99            # kernel step's gradients vs the plain step's
GRAD_NORM_RATIO = 0.05     # |‖g_kernel‖ / ‖g_plain‖ − 1| at most this
TRAIN_PEAK_GB = 75.0       # above this, T = 2048 (PERF.md)
TRAIN_DECODE = (2, 32, 16)                     # greedy decode: batch, prompt, new
DRIVER_ARGV = ["--arch", LM_ARCH, "--smoke", "--steps", "25", "--crash-at", "12",
               "--ckpt-every", "10", "--log-every", "100"]
# the driver's steps: 0-11, the crash at 12, the resume from step 9's
# checkpoint, 10-24; per step 4 attention and 8 SSD launches (SMOKE: 4
# layers, the shared block after every 2: 2 and 4 a forward, twice with
# remat)
DRIVER_STEPS = 12 + 15


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gemm_bad(out, ref, depth: int, extra=0.0) -> int:
    """Elements beyond |out - ref| <= GEMM_ERRS·eps32·√depth·rms(ref) +
    eps_out·|ref| (+ ``extra``): the fp32 accumulation error of a
    depth-long reduction summed in another order, plus one unit in the last
    place of the output type, which both sides round their fp32 sums to."""
    import torch
    ref = ref.double()
    rms = float(ref.pow(2).mean().sqrt()) if ref.numel() else 0.0
    atol = GEMM_ERRS * torch.finfo(torch.float32).eps * depth ** 0.5 * rms
    rtol = torch.finfo(out.dtype).eps
    diff = (out.double() - ref).abs()
    return int((diff > atol + rtol * ref.abs() + extra).sum())


def gemm_close(out, ref, depth: int) -> float:
    """Max abs error; raises if any element is beyond ``gemm_bad``'s limit."""
    bad = gemm_bad(out, ref, depth)
    check(bad == 0, f"{bad} GEMM elements beyond tolerance (depth {depth})")
    diff = (out.double() - ref.double()).abs()
    return float(diff.max()) if diff.numel() else 0.0


def tf32(t):
    """``t`` with its mantissa rounded to TF32's 10 bits (nearest)."""
    import torch
    bits = (t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def timed(fn, runs: int = TIMED_RUNS) -> float:
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call.  Each
    run is queued behind a device-side spin of SPIN_CYCLES, so the host has
    enqueued ``fn``'s launches before the card reaches them and the time is
    the card's, not the host's launch latency (which dominates a call of a
    few µs, such as decode attention)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound(flops: float, nbytes: float, kind: str):
    """(bound_ms, bound_by): the larger of operations over peak and bytes
    over bandwidth."""
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sq_dists(rows, centers):
    """‖x‖² − 2x·c + ‖c‖² in the dtype of the inputs, as the kernel forms it."""
    return ((rows * rows).sum(1, keepdim=True) - 2 * rows @ centers.T
            + (centers * centers).sum(1)[None])


def label_faults(rows, centers, got, want):
    """(near_ties, others, cap, err) of ``got`` against ``want``.

    ``err`` is the largest |fp32 − float64| of the distances of the first
    SAMPLE_ROWS rows to every center: the measured rounding of the fp32
    expansion, which grows with the norms, not with the distance.  A row
    whose label differs is a near-tie when the float64 gap between its two
    nearest centers is below GAP_ERRS·err, else one of ``others``; ``cap``
    is NEAR_TIE_SHARE of the rows."""
    import math
    import torch
    probe = rows[:SAMPLE_ROWS].float()
    c32 = centers.float()
    err = float((sq_dists(probe, c32).double()
                 - sq_dists(probe.double(), c32.double())).abs().max())
    diff = got.long() != want.long()
    near = other = 0
    if bool(diff.any()):
        d = sq_dists(rows[diff].double(), c32.double())
        two = torch.topk(d, min(2, c32.shape[0]), dim=1, largest=False).values
        is_near = (two[:, -1] - two[:, 0]) < GAP_ERRS * err
        near, other = int(is_near.sum()), int((~is_near).sum())
    return near, other, math.ceil(NEAR_TIE_SHARE * rows.shape[0]), err


def check_labels(rows, centers, got, want, what: str):
    """Holds ``got`` to ``want`` up to near-ties (``label_faults``): any
    other disagreement, or more near-ties than NEAR_TIE_SHARE of the rows,
    fails.  Returns (near_ties, err)."""
    near, other, cap, err = label_faults(rows, centers, got, want)
    check(other == 0, f"{what}: {other} labels differ beyond near-ties "
                      f"(gap >= {GAP_ERRS} x {err:.3e})")
    check(near <= cap, f"{what}: {near} near-ties, more than {cap}")
    return near, err


def stats_of(blocks, labels, k: int):
    """Per-cluster sums ``(k, gm*bm)`` and counts ``(k,)`` of the rows of
    ``blocks`` under ``labels`` (-1: no cluster), as a float64 einsum."""
    import torch
    gn, gm, bn, bm = blocks.shape
    valid = (labels >= 0).double()[:, None]
    onehot = torch.nn.functional.one_hot(labels.clamp(min=0).long(), k) * valid
    sums = torch.einsum("iak,ijab->kjb", onehot.reshape(gn, bn, k), blocks.double())
    return sums.reshape(k, gm * bm), onehot.sum(0)


def check_stats(blocks, labels, sums, counts, what: str) -> float:
    """The kernel's sums and counts against ``stats_of`` its own labels:
    counts exact, sums within 1e-4 of their largest (the fp32 rounding of
    sums over ~1e5 rows); returns the max abs error of the sums."""
    want_s, want_c = stats_of(blocks, labels, sums.shape[0])
    check(bool((counts == want_c).all()), f"{what}: counts differ")
    serr = float((sums - want_s).abs().max())
    check(serr <= 1e-4 * max(1.0, float(want_s.abs().max())),
          f"{what}: sums max abs err {serr}")
    return serr


def stacked_rows(blocks, n):
    """The (n, d) sample rows of a stacked (gn, gm, bn, bm) tensor."""
    gn, gm, bn, bm = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(gn * bn, gm * bm)[:n]


def bad_count(out, ref, limit) -> int:
    return int(((out.double() - ref.double()).abs() > limit).sum())


def attn_limit(q, k, v, kw, ref):
    """Per element of an attention output: (u_v + GEMM_ERRS·eps32·√(Tk + D))
    · A + eps_out·|ref|, where A = Σ p|v| / Σ p is the same attention of |v|:
    P rounded to V's dtype before P·V (unit roundoff u_v of each term), the
    fp32 error of the depth-D scores and depth-Tk sums taken in another
    order, and one unit in the last place of the output type."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    mag = attention_ref(q.float(), k.float(), v.float().abs(), **kw).double()
    eps32 = torch.finfo(torch.float32).eps
    u_v = torch.finfo(v.dtype).eps / 2
    depth = k.shape[2] + q.shape[3]
    return ((u_v + GEMM_ERRS * eps32 * depth ** 0.5) * mag
            + torch.finfo(q.dtype).eps * ref.double().abs())


def attn_check(out, q, k, v, kw, what: str, causal_control: bool = False,
               causal_added: bool = False):
    """``out`` against the plain attention within ``attn_limit``; a zeroed
    output (and, for causal attention, the same attention without its
    causal mask; for non-causal attention, the same attention made causal)
    must fail that limit.  Returns the max abs error."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    ref = attention_ref(q, k, v, **kw)
    limit = attn_limit(q, k, v, kw, ref)
    bad = bad_count(out, ref, limit)
    check(bad == 0, f"{what}: {bad} elements beyond the attention limit")
    err = float((out.double() - ref.double()).abs().max())
    controls = {"zeroed output": bad_count(0 * ref, ref, limit)}
    if causal_control:
        open_kw = dict(kw, causal=False)
        controls["no causal mask"] = bad_count(attention_ref(q, k, v, **open_kw),
                                               ref, limit)
    if causal_added:
        controls["made causal"] = bad_count(
            attention_ref(q, k, v, **dict(kw, causal=True)), ref, limit)
    for name, n in controls.items():
        check(n > 0, f"{what}: control '{name}' passed the attention limit")
    print(f"[3] {what}: max abs err {err:.3e}; controls fail at "
          f"{controls} of {ref.numel()} elements")
    return err


class plain_kernels:
    """Within the block, the models and ``ssd_scan`` run the plain attention
    and the plain SSD chunk instead of the CUDA kernels, inside the same
    autograd Functions, so a backward is the one the kernels' forward gets
    (the package has no such switch: the script patches the two entries it
    calls)."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.ssd import ops as sops
        from repro_torch.models import common as cm
        self.saved = (cm.flash_attention, sops.ssd_chunk)

        def attention(q, k, v, **kw):
            return fops.AttentionFunction.apply(q, k, v, fops.attention_ref, kw)

        def ssd_chunk(x, dt, a, b, c, *, chunk):
            return sops.SSDChunkFunction.apply(x, dt, a, b, c, sops.ssd_chunk_ref,
                                               chunk)

        cm.flash_attention, sops.ssd_chunk = attention, ssd_chunk
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.ssd import ops as sops
        from repro_torch.models import common as cm
        cm.flash_attention, sops.ssd_chunk = self.saved
        return False


@contextlib.contextmanager
def patched(obj, name: str, value):
    """Within the block, ``obj.name`` is ``value`` (the script patches the
    kernel wrappers' layout and route choices; the package has no such
    options)."""
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


class forced_route:
    """Within the block, every GEMM takes the SIMT route (the script patches
    ``tma_operand``, so ``plan`` finds no TMA-readable operand), every
    attention of more than 8 queries the SIMT tile kernel, every SSD chunk
    and every K-means assignment the simt kernel (it patches the ``route``
    functions): the routes the main path took before the tensor-core
    kernels, timed beside them in one run.  The package has no such
    option."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import kernel as fk
        from repro_torch.kernels.kmeans import kernel as kk
        from repro_torch.kernels.matmul import kernel as mk
        from repro_torch.kernels.ssd import kernel as sk
        self.saved = (mk.tma_operand, fk.route, sk.route, kk.route)
        mk.tma_operand = lambda *args: None
        fk.route = lambda q, k, v: "rows" if q.shape[2] <= fk.ROW_QUERIES else "tile"
        sk.route = lambda *args: "simt"
        kk.route = lambda *args: "simt"
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.flash_attention import kernel as fk
        from repro_torch.kernels.kmeans import kernel as kk
        from repro_torch.kernels.matmul import kernel as mk
        from repro_torch.kernels.ssd import kernel as sk
        mk.tma_operand, fk.route, sk.route, kk.route = self.saved
        return False


def routed_as(route: str):
    """The natural route, or ``forced_route`` for "simt" where the rule
    gives a tensor-core route."""
    return forced_route() if route == "simt" else contextlib.nullcontext()


def routed(fn, kernel_fn, route: str, what: str):
    """``fn()`` after a check that it launched ``kernel_fn`` once, by
    ``route`` (its per-route count rose by one and no other did)."""
    import torch
    before = dict(kernel_fn.route_launches)
    out = fn()
    torch.cuda.synchronize()
    diff = {r: n - before[r] for r, n in kernel_fn.route_launches.items()}
    check(diff == {r: int(r == route) for r in diff},
          f"{what}: launches by route {diff}, expected one by {route}")
    return out


def ssd_without_inter(x, dt, a, b, c, h0=None, *, chunk):
    """``ssd_scan`` with its inter-chunk term dropped (a control): y_intra
    of the plain chunk, and the last chunk's own state."""
    import torch
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref
    t = x.shape[1]
    pad = -t % chunk
    x, b, c = (torch.nn.functional.pad(m, (0, 0, 0, pad)) for m in (x, b, c))
    y, states, _, _ = ssd_chunk_ref(x, torch.nn.functional.pad(dt, (0, pad)), a,
                                    b, c, chunk=chunk)
    return y[:, :t], states[:, -1]


def ssd_check(args, chunk: int, what: str):
    """``ssd_scan`` through the kernel against the same scan with the plain
    chunk, per element within (GEMM_ERRS + 2·L·Λ)·eps32·A + eps32·|ref|.  A
    is the same scan of |x|, |B|, |C|, |h0|: the sum of the magnitudes of
    the terms.  Λ is the largest |ℓ| of a chunk: ℓ is a cumsum of L terms of
    one sign, so a sum in any order is within (L-1)·u·Λ of it, and each gate
    exp(ℓ_t − ℓ_s) or exp(ℓ_t), on either side, within a relative L·eps·Λ
    (the kernel adds in sequence, torch.cumsum on the card in another
    order).  A zeroed output and the scan without its inter-chunk term must
    fail.  The scan launches ``ssd_chunk`` once, by the mma route.  Returns
    (max abs err of y, of h_final)."""
    import torch
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd.ops import ssd_scan
    x, dt, a, b, c, h0 = args
    y, h = routed(lambda: ssd_scan(*args, chunk=chunk), sk.ssd_chunk, "mma", what)
    with plain_kernels():
        y_ref, h_ref = ssd_scan(*args, chunk=chunk)
        mag_y, mag_h = ssd_scan(x.abs(), dt, a, b.abs(), c.abs(), h0.abs(),
                                chunk=chunk)
    eps32 = torch.finfo(torch.float32).eps
    bh, t = dt.shape
    lam = float((-a[:, None] * torch.nn.functional.pad(dt, (0, -t % chunk))
                 .reshape(bh, -1, chunk).sum(-1)).max())
    rel = (GEMM_ERRS + 2 * chunk * lam) * eps32
    lim_y = rel * mag_y.double() + eps32 * y_ref.double().abs()
    lim_h = rel * mag_h.double() + eps32 * h_ref.double().abs()
    bad = bad_count(y, y_ref, lim_y) + bad_count(h, h_ref, lim_h)
    check(bad == 0, f"{what}: {bad} elements beyond the SSD limit")
    y_intra, _ = ssd_without_inter(x, dt, a, b, c, h0, chunk=chunk)
    controls = {"zeroed output": bad_count(0 * y_ref, y_ref, lim_y),
                "no inter-chunk term": bad_count(y_intra, y_ref, lim_y)}
    for name, n in controls.items():
        check(n > 0, f"{what}: control '{name}' passed the SSD limit")
    errs = (float((y - y_ref).abs().max()), float((h - h_ref).abs().max()))
    print(f"[3] {what}: Λ = {lam:.1f}; max abs err y {errs[0]:.3e}, h "
          f"{errs[1]:.3e}; controls fail at {controls} of {y_ref.numel()}")
    return errs


def ssd_chunk_check(args, chunk: int, route: str, what: str, phase: int = 3) -> float:
    """``ssd_chunk`` by ``route`` against ``ssd_chunk_ref``: every output
    within the card test's tolerance (``test_ssd_chunk_matches_plain``:
    atol 2e-5·max(1, max|ref|), rtol 1e-5).  Control that must fail: the
    plain chunk fed TF32-rounded x, B and C, the error of single-pass TF32
    products.  Returns the max abs error over the outputs."""
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref
    x, dt, a, b, c = args
    got = routed(lambda: sk.ssd_chunk(*args, chunk=chunk), sk.ssd_chunk, route, what)
    want = ssd_chunk_ref(*args, chunk=chunk)
    control = ssd_chunk_ref(tf32(x), dt, a, tf32(b), tf32(c), chunk=chunk)
    bad, ctrl, errs = {}, {}, []
    for name, g, w, k in zip(("y_intra", "states", "c_dec", "decay"), got, want,
                             control):
        limit = 2e-5 * max(1.0, float(w.abs().max())) + 1e-5 * w.double().abs()
        bad[name], ctrl[name] = bad_count(g, w, limit), bad_count(k, w, limit)
        errs.append(float((g - w).abs().max()))
    check(not any(bad.values()), f"{what}: elements beyond the card test's "
                                 f"tolerance {bad}")
    check(ctrl["y_intra"] > 0 and ctrl["states"] > 0,
          f"{what}: control 'TF32-rounded x, B, C' passed: {ctrl}")
    print(f"[{phase}] {what}: max abs err {dict(zip(bad, errs))}; the TF32 control "
          f"fails at {ctrl}", flush=True)
    return max(errs)


def ssd_inputs(torch, gen, bh, bg, t, p, s, slow: bool):
    """Random SSD inputs: slow decay (dt in [0.001, 0.1], a in [-2, -0.5]) or
    the fast decay of zamba2's init (dt in [0.5, 1], a in [-16, -1])."""
    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device="cuda")
    x = torch.randn((bh, t, p), generator=gen, device="cuda")
    dt = u(0.001, 0.1, bh, t) if slow else u(0.5, 1.0, bh, t)
    a = -(u(0.5, 2.0, bh) if slow else u(1.0, 16.0, bh))
    b = torch.randn((bg, t, s), generator=gen, device="cuda")
    c = torch.randn((bg, t, s), generator=gen, device="cuda")
    h0 = torch.randn((bh, s, p), generator=gen, device="cuda")
    return x, dt, a, b, c, h0


def redraw_norms(params, gen) -> None:
    """In place: norm scales around 1 (``norm``, ``gate_norm``,
    ``final_norm``) and 0 (the ``plus_one`` norms ``ln1``, ``ln2``),
    ``conv_b`` around 0 and ``dt_bias`` as Mamba-2 draws it
    (softplus(dt_bias) log-uniform in [1e-3, 1e-1])."""
    import math
    import torch

    def around(t, centre):
        t.copy_(centre + 0.1 * torch.randn(t.shape, generator=gen, device=t.device))

    layers, shared = params["layers"], params["shared"]
    for t, centre in ((layers["norm"], 1.0), (layers["gate_norm"], 1.0),
                      (layers["conv_b"], 0.0), (params["final_norm"], 1.0),
                      (shared["ln1"], 0.0), (shared["ln2"], 0.0)):
        around(t, centre)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand(layers["dt_bias"].shape,
                                               generator=gen, device="cuda"))
    layers["dt_bias"].copy_(torch.log(torch.expm1(dt)))


def teacher_forced(model, params, prompt, got):
    """float32 logits of a forward over the prompt and all but the last of
    the generated tokens ``got``, at the positions that chose ``got``."""
    import torch
    logits, _ = model.forward(params, torch.cat([prompt, got[:, :-1]], dim=1))
    return logits[:, prompt.shape[1] - 1:].float()


def rms(torch, a, b=None) -> float:
    """Root mean square of ``a`` (or ``a - b``) in float64, 256 rows at a
    time (gemma2's logits at 8,192 tokens are 2.1 G elements)."""
    a2 = a.reshape(-1, a.shape[-1])
    b2 = None if b is None else b.reshape(-1, b.shape[-1])
    total = 0.0
    for lo in range(0, a2.shape[0], 256):
        d = a2[lo:lo + 256].double()
        if b2 is not None:
            d = d - b2[lo:lo + 256].double()
        total += float(d.pow(2).sum())
    return (total / a.numel()) ** 0.5


def without_inter_chunk(model, params, tokens):
    """The logits of ``model``'s forward with ``ssd_scan``'s inter-chunk
    term dropped (a control)."""
    from repro_torch.models import ssm as ssm_mod
    with patched(ssm_mod, "ssd_scan", ssd_without_inter):
        return model.forward(params, tokens)[0]


def family_forward(torch, model, params, tokens, per_fwd, tag: str, control,
                   patches=None):
    """``forward`` (over ``patches`` too: an encoder-decoder's frames)
    through the kernels (its launches exactly ``per_fwd``) against the same
    forward with the plain versions.  Limit: a bf16
    forward lies about E = rms(plain bf16 - float32 twin) from the float32
    model, and two such forwards at most 2E from each other (a rounding
    difference anywhere is amplified over the layers, so the kernels' own
    error is not the scale: the bf16 model's is).  The zeroed logits and
    ``control`` = (name, fn), a plain forward of another function, must
    fail.  Then the median of FORWARD_RUNS warm runs.  Returns (record, the
    float32 twin's params, launches)."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from repro_torch.models.model import build_model
    rec = {}
    zero_counts()
    t0 = time.perf_counter()
    logits, _ = model.forward(params, tokens, patches)
    torch.cuda.synchronize()
    rec["forward_first_s"] = time.perf_counter() - t0
    launches = read_counts()
    expect_counts(launches, per_fwd, f"{model.cfg.name} forward {tuple(tokens.shape)}", tag)
    check(bool(torch.isfinite(logits).all()), f"{model.cfg.name}: logits not finite")
    params32 = pytree.tree_map(lambda t: t.float(), params)
    model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    with plain_kernels():      # one logits tensor at a time beside these two
        plain, _ = model.forward(params, tokens, patches)
        err = rms(torch, logits, plain)
        agree = float((logits.argmax(-1) == plain.argmax(-1)).double().mean())
        exact, _ = model32.forward(params32, tokens, patches)
        own, to_exact = rms(torch, plain, exact), rms(torch, logits, exact)
        del exact, logits
        name, fn = control
        controls = {"zeroed logits": rms(torch, plain), name: rms(torch, fn(), plain)}
        del plain
    check(err <= 2 * own, f"{model.cfg.name}: logits rms err {err} vs the plain forward, "
                          f"beyond 2 x the bf16 model's own {own}")
    for key, val in controls.items():
        check(val > 2 * own, f"{model.cfg.name}: control '{key}' ({val}) passed the "
                             f"logits limit {2 * own}")
    print(f"{tag} {model.cfg.name} forward {tuple(tokens.shape)} vs plain: logits rms err "
          f"{err:.4e} (limit 2 x {own:.4e}, the plain bf16 forward vs the float32 model; "
          f"the kernels' forward vs the float32 model {to_exact:.4e}); argmax agrees at "
          f"{agree:.6f} of positions; controls fail at {controls}", flush=True)
    runs = []
    for _ in range(FORWARD_RUNS):
        t0 = time.perf_counter()
        model.forward(params, tokens, patches)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    rec.update(forward_runs_s=runs, forward_s=statistics.median(runs),
               forward_tok_per_s=tokens.numel() / statistics.median(runs),
               logits_rms_err=err, logits_limit=2 * own, to_float32=to_exact,
               argmax_agree=agree, controls=controls)
    return rec, params32, launches


def family_decode(torch, model32, params32, tokens, want_counts, what: str, tag: str,
                  frames=None):
    """float32 ``decode_step`` teacher-forced over ``tokens`` against the
    forward of the same model: the max abs error, and the launches of the
    forward and the steps, exactly ``want_counts``.  An encoder-decoder's
    ``frames`` go through the forward, and are encoded once into the
    cache's ``enc_out``.  Returns (max abs err, the decoded logits, the
    forward's, launches)."""
    zero_counts()
    full, _ = model32.forward(params32, tokens, frames)
    kw = {} if frames is None else {"enc_len": frames.shape[1]}
    cache = model32.init_cache(tokens.shape[0], tokens.shape[1], device="cuda", **kw)
    if frames is not None:
        cache["enc_out"] = model32.module.encode(params32, model32.cfg, frames)
    steps = []
    for i in range(tokens.shape[1]):
        lg, cache = model32.decode_step(params32, cache, tokens[:, i:i + 1])
        steps.append(lg[:, 0])
    got = torch.stack(steps, dim=1)
    launches = read_counts()
    expect_counts(launches, want_counts, f"{what}: forward + {tokens.shape[1]} decode "
                                         f"steps", tag)
    err = float((got - full).abs().max())
    print(f"{tag} {what}: decode vs teacher forcing over {tokens.shape[1]} tokens, max abs "
          f"err {err:.3e} (limit {DECODE_TOL})", flush=True)
    return err, got, full, launches


def lm_kernels():
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.kernels.ssd import kernel as sk
    return {"flash_attention": fk.flash_attention, "ssd_chunk": sk.ssd_chunk,
            "kmeans_assign": kk.kmeans_assign_stacked}


ROUTED = ("flash_attention", "ssd_chunk", "kmeans_assign")


def zero_counts() -> None:
    for fn in lm_kernels().values():
        fn.launches = 0
    for name in ROUTED:
        fn = lm_kernels()[name]
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def read_counts():
    counts = {name: fn.launches for name, fn in lm_kernels().items()}
    for name in ROUTED:
        counts.update({f"{name}/{r}": n
                       for r, n in lm_kernels()[name].route_launches.items()})
    return counts


def expect_counts(got, want, what: str, tag: str = "[7]") -> None:
    for name, n in want.items():
        check(got[name] == n, f"{what}: {name} launched {got[name]} times, "
                              f"the path implies {n}")
    print(f"{tag} {what}: launches {got}", flush=True)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(f"[1] card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi[0])
    print(f"[1] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    return name, smi[0]


#: kernels of the Hopper redesign, whose ptxas report must show no spills
NEW_KERNELS = ("wgmma_kernel", "attn_wgmma_kernel", "simt_kernel", "ssd_mma_kernel",
               "kmeans_mma_kernel")


def ptxas_entries(log: str):
    """``[(entry, properties, usage)]`` from one source's ``-Xptxas -v``
    report: each entry function's spill line and register line."""
    entries, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = [line.split("'")[1], "", ""]
            entries.append(cur)
        elif cur is not None and "spill" in line:
            cur[1] = line.strip()
        elif cur is not None and "Used" in line:
            cur[2] = line.split(":", 1)[1].strip()
    return entries


def ptxas_losses(log: str):
    """ptxas' "Potential Performance Loss" notes (e.g. wgmma serialized)."""
    return [line.split(":", 1)[1].strip() for line in log.splitlines()
            if "Performance Loss" in line]


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[2] build: {time.perf_counter() - t0:.3f} s", flush=True)
    spilled = []
    for name, log in sorted(_build.BUILD_LOGS.items()):
        entries = ptxas_entries(log)
        used = sorted({usage for _, _, usage in entries})
        print(f"[2] {name}: {len(entries)} kernels; {'; '.join(used)}")
        for entry, props, usage in entries:
            if any(k in entry for k in NEW_KERNELS):
                print(f"[2]   {entry[:90]}: {usage}; {props}")
                if "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" not in props:
                    spilled.append(entry)
        for note in ptxas_losses(log):
            print(f"[2]   ptxas: {note[:200]}")
    check(not spilled, f"ptxas spills (or a stack frame) in the new kernels: {spilled}")


def phase_kernels(torch, gen):
    from repro_torch.core import dsarray as dsa
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.kernels.kmeans.ref import kmeans_assign_stacked_ref
    from repro_torch.kernels.matmul import kernel as mk
    from repro_torch.kernels.matmul import ops as mops
    from repro_torch.kernels.matmul.ref import matmul_ref, stacked_matmul_ref

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    f32, f16, bf16 = torch.float32, torch.float16, torch.bfloat16
    mn, kb = False, True   # B stored row-major (N innermost) or as a K-major view
    cases = [  # gi, gk, gj, bn, bk, bm, dtype, transpose_a, B K-major, route
        (2, 2, 2, 128, 128, 128, f32, False, mn, "simt"),
        (2, 3, 2, 50, 70, 30, f32, False, mn, "simt"),        # ragged blocks
        (1, 2, 1, 300, 9, 257, f16, False, mn, "simt"),       # 18-byte rows
        (2, 3, 2, 50, 70, 30, bf16, True, mn, "simt"),        # 140-byte rows
        (3, 2, 1, 33, 17, 5, f32, True, mn, "simt"),
        (1, 31, 1, 100, 2000, 100, f32, True, mn, "simt"),    # split-K
        (2, 2, 2, 128, 128, 128, bf16, False, mn, "wgmma"),   # multiples of the tile
        (2, 2, 2, 256, 192, 384, f16, False, mn, "wgmma"),
        (2, 3, 2, 200, 72, 136, bf16, False, mn, "wgmma"),    # ragged blocks
        (2, 3, 2, 200, 72, 136, f16, True, mn, "wgmma"),
        (1, 2, 1, 40, 24, 56, bf16, True, mn, "wgmma"),       # below one tile
        (1, 2, 1, 40, 24, 56, bf16, False, kb, "wgmma"),      # K-major B
        (2, 3, 2, 200, 72, 136, bf16, True, kb, "wgmma"),     # both transposed
        (1, 16, 1, 128, 2048, 128, bf16, True, mn, "wgmma"),  # split-K
        (1, 16, 1, 96, 2048, 80, f16, False, kb, "wgmma"),    # split-K, K-major B
    ]
    for gi, gk, gj, bn, bk, bm, dt, ta, bkm, route in cases:
        a = rnd(gk, gi, bk, bn, dtype=dt) if ta else rnd(gi, gk, bn, bk, dtype=dt)
        b = rnd(gk, gj, bm, bk, dtype=dt).transpose(2, 3) if bkm else \
            rnd(gk, gj, bk, bm, dtype=dt)
        out = routed(lambda: mk.stacked_matmul(a, b, out_dtype=dt, transpose_a=ta),
                     mk.stacked_matmul, route, f"stacked_matmul {(gi, gk, gj, bn, bk, bm)}")
        ref = stacked_matmul_ref(a, b, out_dtype=dt, transpose_a=ta)
        err = gemm_close(out, ref, gk * bk)
        # the same bits again: split-K sums its workspace in a fixed order
        check(torch.equal(out, mk.stacked_matmul(a, b, out_dtype=dt, transpose_a=ta)),
              "stacked_matmul is not deterministic")
        print(f"[3] stacked_matmul {(gi, gk, gj, bn, bk, bm)} {dt} transpose_a={ta} "
              f"B {'K' if bkm else 'N'}-major, {route}: max abs err {err:.3e}, "
              f"bit-identical on a second run")
    # a permuted view (DsArray.transpose) read through its strides
    for dt, route in ((f32, "simt"), (bf16, "wgmma")):
        base = dsa.from_array(rnd(300, 200, dtype=dt), (64, 48), device="cuda")
        other = dsa.from_array(rnd(300, 90, dtype=dt), (64, 40), device="cuda")
        at = base.T
        check(not at.blocks.is_contiguous(), "transpose should be a view")
        got = routed(lambda: (at @ other).collect(), mk.stacked_matmul, route,
                     "strided Aᵀ view")
        want = (base.collect().float().T @ other.collect().float()).to(dt)
        err = gemm_close(got, want, 300)
        print(f"[3] stacked_matmul strided Aᵀ view {dt}, {route}: max abs err {err:.3e}")
    # the 2-D entry (matmul_padded's counterpart)
    a2, b2 = rnd(300, 200), rnd(200, 130)
    before = mk.stacked_matmul.launches
    err = gemm_close(mops.matmul(a2, b2), matmul_ref(a2, b2), 200)
    check(mk.stacked_matmul.launches == before + 1, "2-D matmul did not launch")
    print(f"[3] matmul 2-D (300x200 @ 200x130): max abs err {err:.3e}")
    ints = torch.ones((1, 1, 4, 4), dtype=torch.int32, device="cuda")
    try:
        mops.local_matmul(ints, ints)
    except TypeError as exc:
        print(f"[3] int32 on the card raises: {exc}")
    else:
        raise RuntimeError("chip_smoke check failed: int32 GEMM did not raise")

    lib = kk._lib()

    def form(x, c):
        """What the call of these tensors launches: the route, and its
        layout (the simt plan, or the mma route's form and sums)."""
        d = c.shape[1]
        if kk.route(x, c) == "simt":
            return "simt", kk.launch_plan(lib, c.shape[0], d, 0)
        if kk.resident(lib, c.shape[0], d, 0):
            return "mma", "resident"
        return "mma", "streamed + sums pass"

    def assign_check(x, c, n, what):
        """One call on the route ``form`` gives, against the plain version;
        an mma call again, for the same bits.  Returns the labels."""
        route, layout = form(x, c)
        what = f"{what} {route} ({layout})"
        l1, s1, c1 = routed(lambda: kk.kmeans_assign_stacked(x, c, n),
                            kk.kmeans_assign_stacked, route, what)
        l2, _, _ = kmeans_assign_stacked_ref(x, c, n)
        check(bool((l1[n:] == -1).all()), f"{what}: rows >= n must get label -1")
        near, _ = check_labels(stacked_rows(x, n), c, l1[:n], l2[:n], what)
        serr = check_stats(x, l1, s1, c1, what)
        again = ""
        if route == "mma":
            second = kk.kmeans_assign_stacked(x, c, n)
            check(all(torch.equal(a, b) for a, b in zip((l1, s1, c1), second)),
                  f"{what}: a second run gave other bits")
            again = ", the same bits on a second run"
        print(f"[3] kmeans_assign {what}: labels differ at {near} near-ties, sums max "
              f"abs err {serr:.3e}{again}")
        return l1, c1

    for gn, gm, bn, bm, n, k in [(3, 2, 100, 60, 250, 17), (1, 1, 600, 130, 600, 5),
                                 (4, 1, 128, 16, 500, 64), (2, 3, 97, 11, 150, 12),
                                 (4, 2, 512, 392, 2000, 10),      # 32-row tiles
                                 (3, 1, 700, 1000, 1900, 16),     # 8-center chunks
                                 (3, 7, 1000, 112, 2500, 64),     # global partial
                                 (4, 1, 1024, 64, 4000, 1000),    # many clusters
                                 (4, 1, 1024, 2560, 4000, 64),    # D-tiled
                                 (3, 4, 700, 1024, 2000, 17),     # D-tiled, 4096
                                 (3, 1, 1000, 40, 3000, 2000),    # global sums pass
                                 (2, 1, 3000, 100, 5000, 128),    # K_MMA centers
                                 (4, 1, 512, 128, 2000, 64),      # pitch 136, resident
                                 (4, 2, 512, 64, 2000, 64)]:      # the same rows, gm = 2
        x = rnd(gn, gm, bn, bm)
        valid = torch.arange(gn * bn, device="cuda").reshape(gn, 1, bn, 1) < n
        x = (x * valid).contiguous()
        c = rnd(k, gm * bm) * 0.5
        for route in dict.fromkeys((kk.route(x, c), "simt")):
            with routed_as(route):
                assign_check(x, c, n, f"{(gn, gm, bn, bm)} n={n} k={k}")
    # uncentred features (blobs far from the origin, as unstandardised data
    # is): the mma route meets the near-tie rule.  Control that must fail:
    # the kernel's expansion with single-TF32 products, (||x||² - 2
    # tf32(x)·tf32(c)) + ||c||² with the norms in fp32.  (The plain version
    # fed TF32-rounded x and centers gives the exact distance between rounded
    # points, which moves no argmin between such separated blobs: its control
    # is the next case.)
    gn, bm, n, k = 8, 100, 8 * 4096, 64
    blob = 100 + torch.randn(k, bm, generator=gen, device="cuda")
    pick = torch.randint(0, k, (n,), generator=gen, device="cuda")
    x = (blob[pick] + rnd(n, bm)).reshape(gn, 1, n // gn, bm).contiguous()
    c = (blob + 0.1 * rnd(k, bm)).contiguous()
    assign_check(x, c, n, f"uncentred (blobs at 100) {tuple(x.shape)} k={k}")
    rows, want = stacked_rows(x, n), kmeans_assign_stacked_ref(x, c, n)[0]
    one_tf32 = ((rows * rows).sum(1, keepdim=True) - 2 * tf32(rows) @ tf32(c).T
                + (c * c).sum(1)[None]).argmin(1)
    ctrl = label_faults(rows, c, one_tf32, want)
    check(ctrl[1] > 0 or ctrl[0] > ctrl[2],
          f"control 'single-TF32 products' passed the near-tie rule: {ctrl}")
    print(f"[3] kmeans_assign uncentred: the single-TF32 control differs at {ctrl[1]} "
          f"labels beyond near-ties and {ctrl[0]} near-ties (cap {ctrl[2]})")
    # centred random rows (no blobs: gaps near 0 are common, and fp32's own
    # distance error is small): the mma route meets the near-tie rule, and
    # the plain version fed TF32-rounded x and centers, which moves a gap by
    # about 2^-11 of |x|·|c2 - c1|, must fail it
    gn, bm, n, k = 32, 100, 32 * 4096, 64
    x = rnd(gn, 1, n // gn, bm)
    c = rnd(k, bm) * 0.5
    assign_check(x, c, n, f"centred random rows {tuple(x.shape)} k={k}")
    rows, want = stacked_rows(x, n), kmeans_assign_stacked_ref(x, c, n)[0]
    ctrl = label_faults(rows, c, kmeans_assign_stacked_ref(tf32(x), tf32(c), n)[0], want)
    check(ctrl[1] > 0 or ctrl[0] > ctrl[2],
          f"control 'plain version of TF32-rounded x and centers' passed the near-tie "
          f"rule: {ctrl}")
    print(f"[3] kmeans_assign centred random rows: the plain version of TF32-rounded x "
          f"and centers differs at {ctrl[1]} labels beyond near-ties and {ctrl[0]} "
          f"near-ties (cap {ctrl[2]})")
    # the D-tiled simt layout sums each distance in the whole-row layout's
    # order; the mma route's streamed form in the resident form's order
    for gn, gm, bn, bm, n, k in [(4, 1, 1024, 100, 4000, 64), (3, 2, 512, 392, 1500, 10)]:
        x = rnd(gn, gm, bn, bm)
        c = rnd(k, gm * bm) * 0.5
        whole = kk.launch_plan(lib, k, gm * bm, 0)
        with forced_route():
            l1, _, c1 = kk.kmeans_assign_stacked(x, c, n)
            for ds in (256, 32):
                tiled = kk.Plan(kk.DTILED_ROWS, min(whole.chunk, kk.DTILED_CHUNK), False, ds)
                with patched(kk, "launch_plan", lambda *args, p=tiled: p):
                    l2, _, c2 = kk.kmeans_assign_stacked(x, c, n)
                same = bool((l1 == l2).all()) and bool((c1 == c2).all())
                check(same, f"kmeans_assign {tiled} labels differ from {whole}")
        print(f"[3] kmeans_assign d={gm * bm} k={k}: the D-tiled layout (slices of "
              f"256 and 32) gives {whole}'s labels and counts bit for bit")
    for gn, gm, bn, bm, n, k in [(4, 1, 1024, 100, 4000, 64), (3, 1, 100, 120, 250, 17),
                                 (4, 1, 512, 128, 2000, 64)]:
        x = rnd(gn, gm, bn, bm)
        c = rnd(k, gm * bm) * 0.5
        check(form(x, c)[1].startswith("resident"), f"{(gn, gm, bn, bm)} is not resident")
        l1, c1 = assign_check(x, c, n, f"{(gn, gm, bn, bm)} n={n} k={k}")
        with patched(kk, "resident", lambda *args: False):
            l2, c2 = assign_check(x, c, n, f"{(gn, gm, bn, bm)} n={n} k={k}")
        check(torch.equal(l1, l2) and torch.equal(c1, c2),
              f"kmeans_assign d={gm * bm} k={k}: streamed labels differ from resident")
        print(f"[3] kmeans_assign d={gm * bm} k={k}: the mma route's streamed form gives "
              f"the resident form's labels and counts bit for bit")
    sys.stdout.flush()


FLASH_CASES = [  # tq, tk, hq, hkv, d, causal, window, cap, qoff (tests/test_kernels.py)
    (128, 128, 4, 2, 64, True, 0, 0.0, 0),
    (100, 100, 4, 4, 48, True, 0, 0.0, 0),
    (64, 256, 2, 1, 64, True, 0, 0.0, 192),
    (128, 128, 8, 2, 64, True, 64, 0.0, 0),
    (128, 128, 4, 2, 64, True, 0, 30.0, 0),
    (96, 160, 4, 2, 64, False, 0, 0.0, 0),
    (1, 300, 4, 2, 64, True, 0, 0.0, 299),
    (256, 512, 2, 2, 128, True, 128, 50.0, 0),
    (300, 300, 4, 4, 80, True, 0, 0.0, 0),     # zamba2's head dim
    (150, 150, 2, 1, 112, True, 48, 0.0, 0),   # D = 112: a zeroed padding chunk
    (70, 90, 2, 2, 256, False, 0, 0.0, 0),     # D = 256
    # the encoder-decoder (seamless-m4t-medium: 16 heads of 64)
    (200, 200, 16, 16, 64, False, 0, 0.0, 0),  # bidirectional encoder
    (96, 600, 16, 16, 64, False, 0, 0.0, 0),   # cross-attention, Tq < Tk
    (500, 70, 4, 4, 64, False, 0, 0.0, 0),     # Tq > Tk, a ragged last key tile
    (1, 256, 16, 16, 64, False, 0, 0.0, 0),    # decode cross-attention: rows, every slot
]


def phase_lm_kernels(torch, gen):
    """Phase 3 (continued): the LM path's kernels against their plain
    versions, at the test cases and at the path's shapes."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def attn(q, k, v, what, **kw):
        kw = dict(dict(causal=True, window=0, softcap=0.0, q_offset=0), **kw,
                  sm_scale=q.shape[-1] ** -0.5)
        # the route the rule gives: rows for Tq <= 8, tensor cores for 16-bit
        # types with D a multiple of 16 (all these tensors are TMA-readable)
        route = ("rows" if q.shape[2] <= fk.ROW_QUERIES else
                 "wgmma" if q.dtype != torch.float32 and q.shape[3] % 16 == 0
                 else "tile")
        what = f"{what}, {route}"
        out = routed(lambda: fk.flash_attention(q, k, v, **kw), fk.flash_attention,
                     route, what)
        # the causal mask hides a key from the first query (at q_offset)
        hides = kw["causal"] and kw["q_offset"] < k.shape[2] - 1
        added = (not kw["causal"] and q.shape[2] > 1 and kw.get("kv_len") is None
                 and kw["window"] == 0)
        return attn_check(out, q, k, v, kw, what, causal_control=hides,
                          causal_added=added)

    for tq, tk, hq, hkv, d, causal, window, cap, qoff in FLASH_CASES:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            attn(rnd(2, hq, tq, d, dtype=dt), rnd(2, hkv, tk, d, dtype=dt),
                 rnd(2, hkv, tk, d, dtype=dt),
                 f"flash_attention {(tq, tk, hq, hkv, d)} causal={causal} "
                 f"window={window} cap={cap} qoff={qoff} {dt}",
                 causal=causal, window=window, softcap=cap, q_offset=qoff)
    # the prefill shape, as the model passes it: (B, T, H, D) -> (B, H, T, D) views
    bf16 = torch.bfloat16
    qkv = rnd(3, LM_BATCH, LM_SEQ, 32, 80, dtype=bf16)
    q, k, v = (qkv[i].transpose(1, 2) for i in range(3))
    attn(q, k, v, f"flash_attention prefill {tuple(q.shape)} bf16, strided views")
    del qkv, q, k, v
    # D = 80, causal with q_offset, kv_len cutting the keys, strided views
    qkv = rnd(3, 2, 700, 8, 80, dtype=bf16)
    q, k, v = (qkv[i].transpose(1, 2) for i in range(3))
    attn(q[:, :, :500], k, v, "flash_attention (2, 8, 500, 80) vs 700 keys, q_offset "
         "150, kv_len 620, bf16", q_offset=150, kv_len=620)
    del qkv, q, k, v
    # the decode shape: one query against a cache of 320 slots, 300 written
    q, k, v = rnd(4, 32, 1, 80, dtype=bf16), rnd(4, 32, 320, 80, dtype=bf16), \
        rnd(4, 32, 320, 80, dtype=bf16)
    attn(q, k, v, "flash_attention decode (4, 32, 1, 80) kv_len=300 of 320 bf16",
         causal=False, kv_len=300)
    # int inputs raise on the card, never fall back
    ints = torch.ones((1, 1, 4, 8), dtype=torch.int32, device="cuda")
    try:
        fk.flash_attention(ints, ints, ints, causal=True, window=0, softcap=0.0,
                           sm_scale=1.0)
    except TypeError as exc:
        print(f"[3] int32 attention on the card raises: {exc}")
    else:
        raise RuntimeError("chip_smoke check failed: int32 attention did not raise")

    # the chunk alone at the LM path's shape, on both routes
    for slow in (False, True):
        args = ssd_inputs(torch, gen, 160, 2, LM_SEQ, 64, 64, slow)[:5]
        for route in sk.ROUTES:
            with routed_as(route):
                ssd_chunk_check(args, 128, route, f"ssd_chunk BH=160 (B, C per 80 heads) "
                                f"T={LM_SEQ} L=128 P=S=64 {'slow' if slow else 'fast'} "
                                f"decay, {route}")
        del args
    for bh, bg, t, chunk, slow, with_h0 in [(160, 2, LM_SEQ, 128, False, True),
                                            (160, 2, LM_SEQ, 128, True, True),
                                            (6, 2, 300, 64, True, False),
                                            (4, 4, 256, 64, True, True)]:
        x, dt, a, b, c, h0 = ssd_inputs(torch, gen, bh, bg, t, 64 if bh > 8 else 32,
                                        64 if bh > 8 else 16, slow)
        ssd_check((x, dt, a, b, c, h0 if with_h0 else torch.zeros_like(h0)), chunk,
                  f"ssd_scan BH={bh} (B, C per {bh // bg} heads) T={t} L={chunk} "
                  f"P={x.shape[2]} S={b.shape[2]} {'slow' if slow else 'fast'} "
                  f"decay, h0 {'drawn' if with_h0 else 'zero'}")
    try:
        sk.ssd_chunk(x.bfloat16(), dt, a, b, c, chunk=64)
    except TypeError as exc:
        print(f"[3] bf16 ssd_chunk on the card raises: {exc}")
    else:
        raise RuntimeError("chip_smoke check failed: bf16 ssd_chunk did not raise")
    sys.stdout.flush()


def blob_data(torch, gen):
    """(blob ids, samples): N_ROWS x N_FEATURES fp32 in N_CLUSTERS Gaussian
    blobs of unit variance, centers uniform in [-10, 10), drawn from ``gen``."""
    n, m, k = N_ROWS, N_FEATURES, N_CLUSTERS
    true_centers = torch.rand(k, m, generator=gen, device="cuda") * 20 - 10
    truth = torch.randint(0, k, (n,), generator=gen, device="cuda")
    data = true_centers[truth] + torch.randn(n, m, generator=gen, device="cuda")
    return truth, data


def main_path(torch, gen):
    """Phase 4: the main path through the public entry points."""
    import repro_torch as rt
    from repro_torch.algorithms import KMeans
    from repro_torch.core import plan
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.kernels.matmul import kernel as mk
    from repro_torch.kernels.matmul.ref import stacked_matmul_ref
    from repro_torch.obs import registry, tracing

    n, m, k = N_ROWS, N_FEATURES, N_CLUSTERS
    _, data = blob_data(torch, gen)
    sq = torch.rand(SQUARE, SQUARE, generator=gen, device="cuda") - 0.5
    sq2 = torch.rand(SQUARE, SQUARE, generator=gen, device="cuda") - 0.5
    torch.cuda.synchronize()

    ds_counts(zero=True)
    wall = {}
    t0 = time.perf_counter()
    x = rt.from_array(data, X_BLOCK, device="cuda")
    mean = x.mean(axis=0).collect()
    gram = rt.matmul_ta(x, x).collect()
    A = rt.from_array(sq, SQUARE_BLOCK, device="cuda")
    B = rt.from_array(sq2, SQUARE_BLOCK, device="cuda")
    prods = {"ab_f32": A @ B, "atb_f32": rt.matmul_ta(A, B)}
    Ab, Bb = A.astype(torch.bfloat16), B.astype(torch.bfloat16)
    prods["ab_bf16"] = Ab @ Bb
    prods["atb_bf16"] = rt.matmul_ta(Ab, Bb)
    torch.cuda.synchronize()
    wall["algebra_s"] = time.perf_counter() - t0
    km = KMeans(n_clusters=k, max_iter=20, tol=1e-4, seed=0)
    with tracing.recording() as events, plan.capture_plans() as fit_plans:
        t0 = time.perf_counter()
        km.fit(x)           # phase 14 lints the plans it records
        torch.cuda.synchronize()
        wall["fit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = km.predict(x)
    torch.cuda.synchronize()
    wall["predict_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    score = km.score(x)
    wall["score_s"] = time.perf_counter() - t0
    launches = ds_counts()
    loop = [e["dur"] for e in events if e["name"] == "fit.loop"]
    iters = [e["dur"] for e in events if e["name"] == "fit.iteration"]
    wall["lloyd_s"] = loop[0] / 1e6
    wall["init_s"] = wall["fit_s"] - wall["lloyd_s"]
    wall["s_per_iteration"] = statistics.median(iters) / 1e6 if iters else None
    wall["n_iter"] = km.n_iter_
    print(f"[4] launches on the main path: {launches}; GEMM dispatches "
          f"{registry.snapshot('gemm')}")
    for name in ("stacked_matmul", "kmeans_assign"):
        check(launches[name] > 0, f"{name} was not launched on the main path")
    # the two bf16 8192² products on the tensor cores; the Gram and the two
    # f32 products on the SIMT route; every assignment on the mma route
    check(launches["stacked_matmul/wgmma"] == 2 and launches["stacked_matmul/simt"] == 3,
          f"main-path GEMM routes {mk.stacked_matmul.route_launches}: want wgmma 2, simt 3")
    check(launches["kmeans_assign/mma"] == launches["kmeans_assign"]
          and launches["kmeans_assign/simt"] == 0,
          f"main-path kmeans_assign routes {kk.kmeans_assign_stacked.route_launches}: "
          f"want all {launches['kmeans_assign']} on mma")

    # checks
    x64 = data.double()
    err = float((mean.double().reshape(-1) - x64.mean(0)).abs().max())
    check(err <= 1e-4 * float(x64.mean(0).abs().max()), f"mean err {err}")
    g64 = x64.T @ x64
    rel = float((gram.double() - g64).abs().max() / g64.abs().max())
    check(rel <= 1e-4, f"Gram relative err {rel}")
    del x64, g64
    print(f"[4] mean max abs err {err:.3e}; Gram (100x100 over K={n}) "
          f"relative err {rel:.3e} vs float64")
    for key, c in prods.items():
        a, b = (A, B) if key.endswith("f32") else (Ab, Bb)
        ref = stacked_matmul_ref(a.blocks, b.blocks, out_dtype=c.dtype,
                                 transpose_a=key.startswith("atb"))
        perr = gemm_close(c.blocks, ref, SQUARE)
        print(f"[4] {key} {SQUARE}²: max abs err {perr:.3e} vs plain")
    # controls: outputs a wrong GEMM could give must fail that check
    f32 = torch.float32
    ref = stacked_matmul_ref(A.blocks, B.blocks, out_dtype=f32)
    ref_bf16 = stacked_matmul_ref(Ab.blocks, Bb.blocks, out_dtype=torch.bfloat16)
    controls = {
        "zero f32 output": gemm_bad(torch.zeros_like(ref), ref, SQUARE),
        "f32 product of bf16-rounded inputs": gemm_bad(
            stacked_matmul_ref(Ab.blocks, Bb.blocks, out_dtype=f32), ref, SQUARE),
        "f32 product of TF32-rounded inputs": gemm_bad(
            stacked_matmul_ref(tf32(A.blocks), tf32(B.blocks), out_dtype=f32),
            ref, SQUARE),
        "zero bf16 output": gemm_bad(torch.zeros_like(ref_bf16), ref_bf16, SQUARE),
    }
    del ref, ref_bf16
    for what, bad in controls.items():
        check(bad > 0, f"control '{what}' passed the GEMM check")
        print(f"[4] control {what}: fails at {bad} of {SQUARE * SQUARE} elements")
    check(km.n_iter_ >= 1, "KMeans ran no iteration")
    check(score == score and abs(score) != float("inf"), f"score {score}")
    idx = torch.randperm(n, generator=gen, device="cuda")[:SAMPLE_ROWS]
    rows = data[idx]
    c = km.centers_.double()
    plain_labels = sq_dists(rows.double(), c).argmin(1)
    got = pred.collect().reshape(-1)[idx]
    near, lerr = check_labels(rows, km.centers_, got, plain_labels, "predict")
    plain_score = 0.0
    for lo in range(0, n, SAMPLE_ROWS):
        dd = sq_dists(data[lo:lo + SAMPLE_ROWS].double(), c)
        plain_score -= float(dd.min(1).values.clamp(min=0).sum())
    srel = abs(score - plain_score) / abs(plain_score)
    check(srel <= 1e-4, f"score {score} vs float64 {plain_score}")
    print(f"[4] KMeans: n_iter {km.n_iter_}, score {score:.6e} (float64 "
          f"{plain_score:.6e}, rel {srel:.2e}); predict on {SAMPLE_ROWS} rows "
          f"differs from the float64 argmin at {near} near-ties (gap < "
          f"{GAP_ERRS} x {lerr:.3e}), 0 others")
    print(f"[4] wall: {json.dumps(wall)}", flush=True)
    return x, A, B, Ab, Bb, km, launches, wall, fit_plans


def assign_times(torch, blocks, centers, n: int, label: str, phase: int):
    """``kmeans_assign`` on the mma route (the main path's) and forced onto
    the simt route, each checked against the plain version and timed; each
    route's bound from the units it runs on (3xTF32: three TF32 products
    per fp32 one).  Returns the row."""
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.kernels.kmeans.ref import kmeans_assign_stacked_ref
    gn, gm, bn, bm = blocks.shape
    k, d, n_pad = centers.shape[0], gm * bm, gn * bn
    resident = kk.resident(kk._lib(), k, d, 0)
    rows = stacked_rows(blocks, n)
    want, _, _ = kmeans_assign_stacked_ref(blocks, centers, n)

    def run(route, what):
        got = routed(lambda: kk.kmeans_assign_stacked(blocks, centers, n),
                     kk.kmeans_assign_stacked, route, what)
        near, lerr = check_labels(rows, centers, got[0][:n], want[:n], what)
        serr = check_stats(blocks, *got, what)
        ms = timed(lambda: kk.kmeans_assign_stacked(blocks, centers, n))
        print(f"[{phase}] {what}: {ms:.3f} ms; labels differ from the plain version at "
              f"{near} near-ties (gap < {GAP_ERRS} x {lerr:.3e}), 0 others; sums max abs "
              f"err {serr:.3e} vs float64", flush=True)
        return ms, near, serr

    form = "resident" if resident else "streamed + sums pass"
    ms, near, serr = run("mma", f"{label}, mma ({form})")
    row = {"case": label, "kernel": "mma", "form": form, "ms": ms}
    with forced_route():
        row["simt_ms"] = run("simt", f"{label}, simt (forced)")[0]
    # the n valid rows: distances, argmin, ‖x‖², sums; n_pad labels written
    flops = 2.0 * n * k * d + 3.0 * n * k + 2.0 * n * d + n * d
    nbytes = 4.0 * (n * d + k * d + n_pad + k * d + k)
    row["bound_ms"], row["bound_by"] = bound(3 * flops, nbytes, "tf32")
    row["simt_bound_ms"], row["simt_bound_by"] = bound(flops, nbytes, "fp32")
    row.update(plain_ms=timed(lambda: kmeans_assign_stacked_ref(blocks, centers, n)),
               library_ms=None, flops=flops, bytes=nbytes, max_abs_err=serr,
               label_near_ties=near, tflops=flops / ms / 1e9)
    print(f"[{phase}] {label}: mma {ms:.3f} ms (bound {row['bound_ms']:.3f} by "
          f"{row['bound_by']}), simt {row['simt_ms']:.3f} ms (bound "
          f"{row['simt_bound_ms']:.3f} by {row['simt_bound_by']}), plain "
          f"{row['plain_ms']:.3f} ms", flush=True)
    return row


def phase_times(torch, x, A, B, Ab, Bb, km, launches):
    """Phase 5: kernel, plain and library times at the main path's shapes."""
    from repro_torch.kernels.matmul import kernel as mk
    from repro_torch.kernels.matmul import ops as mops
    from repro_torch.kernels.matmul.ref import matmul_ref, stacked_matmul_ref

    def report(row):
        row["tflops"] = row["flops"] / row["ms"] / 1e9
        lib = row["library_ms"]
        print(f"[5] {row['case']}: {row['ms']:.3f} ms (plain {row['plain_ms']:.3f}, "
              f"library {'-' if lib is None else f'{lib:.3f}'}, bound "
              f"{row['bound_ms']:.3f} by {row['bound_by']})", flush=True)
        return row

    def gemm_case(label, a, b, ta, kind, route, depth=None):
        """``depth`` is the reduction length the product needs (the valid
        rows of a Gram), where it is less than the padded gk·bk.  A
        ``route`` of "simt" on bf16 operands forces the SIMT route (the
        route these products took before the tensor-core kernel)."""
        forced = forced_route() if route == "simt" and a.dtype != torch.float32 \
            else contextlib.nullcontext()
        with forced:
            return _gemm_case(f"{label}, {route}", a, b, ta, kind, route, depth)

    def _gemm_case(label, a, b, ta, kind, route, depth):
        out_dtype = a.dtype
        av = a.permute(1, 0, 3, 2) if ta else a
        gi, gk, bn, bk = av.shape
        gj, bm = b.shape[1], b.shape[3]
        m, k, n = gi * bn, depth or gk * bk, gj * bm
        flops = 2.0 * m * n * k
        # each input read once (a Gram's one operand once), the output written once
        nbytes = a.element_size() * (m * k + (0 if b is a else k * n) + m * n)
        spec = "kiba,kjbc->ijac" if ta else "ikab,kjbc->ijac"
        out = routed(lambda: mk.stacked_matmul(a, b, out_dtype=out_dtype, transpose_a=ta),
                     mk.stacked_matmul, route, label)
        ref = stacked_matmul_ref(a, b, out_dtype=out_dtype, transpose_a=ta)
        err = gemm_close(out, ref, k)
        del out, ref
        ms = timed(lambda: mk.stacked_matmul(a, b, out_dtype=out_dtype,
                                             transpose_a=ta))
        plain = timed(lambda: stacked_matmul_ref(a, b, out_dtype=out_dtype,
                                                 transpose_a=ta))
        lib = timed(lambda: torch.einsum(spec, a, b))
        b_ms, b_by = bound(flops, nbytes, kind)
        return report({"case": label, "ms": ms, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
                       "bytes": nbytes, "max_abs_err": err})

    tc_cases = [  # the tensor-core route, each beside the SIMT route it replaced
        gemm_case(f"A@B {SQUARE}² bf16, blocks {SQUARE_BLOCK}", Ab.blocks, Bb.blocks,
                  False, "bf16", "wgmma"),
        gemm_case(f"A@B {SQUARE}² bf16", Ab.blocks, Bb.blocks, False, "bf16", "simt"),
        gemm_case(f"matmul_ta(A,B) {SQUARE}² bf16", Ab.blocks, Bb.blocks, True, "bf16",
                  "wgmma"),
        gemm_case(f"matmul_ta(A,B) {SQUARE}² bf16", Ab.blocks, Bb.blocks, True, "bf16",
                  "simt"),
    ]
    cases = [
        gemm_case(f"A@B {SQUARE}² f32, blocks {SQUARE_BLOCK}", A.blocks, B.blocks,
                  False, "fp32", "simt"),
        gemm_case(f"matmul_ta(A,B) {SQUARE}² f32", A.blocks, B.blocks, True, "fp32",
                  "simt"),
        gemm_case(f"matmul_ta(x,x) Gram {N_ROWS}x{N_FEATURES}, blocks {X_BLOCK} "
                  f"(split-K)", x.blocks, x.blocks, True, "fp32", "simt",
                  depth=x.shape[0]),
    ]
    # the 2-D entry (the counterpart of matmul_padded), same kernel
    a2d, b2d = A.collect(), B.collect()
    flops = 2.0 * SQUARE ** 3
    nbytes = 3 * 4.0 * SQUARE * SQUARE
    b_ms, b_by = bound(flops, nbytes, "fp32")
    err = gemm_close(mops.matmul(a2d, b2d), a2d @ b2d, SQUARE)
    ms = timed(lambda: mops.matmul(a2d, b2d))
    cases.append(report({
        "case": f"2-D matmul {SQUARE}² f32 (matmul_padded's entry), simt", "ms": ms,
        "plain_ms": timed(lambda: matmul_ref(a2d, b2d)),
        "library_ms": timed(lambda: torch.matmul(a2d, b2d)),
        "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes,
        "max_abs_err": err}))
    cases += tc_cases[1::2]   # the bf16 products on the SIMT route

    # kmeans_assign at the fit's shape, against the fitted centers
    blocks = x.blocks
    gm, bm = blocks.shape[1], blocks.shape[3]
    centers = torch.nn.functional.pad(km.centers_, (0, gm * bm - km.centers_.shape[1]))
    km_row = assign_times(torch, blocks, centers.contiguous(), x.shape[0],
                          f"assign {x.shape[0]}x{gm * bm}, k={centers.shape[0]}, "
                          f"blocks {X_BLOCK}", phase=5)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    gemm = {"route": "cuda", "source": "src/repro_torch/csrc/stacked_matmul.cu",
            "replaces": "src/repro/kernels/matmul/kernel.py:75"}
    return [
        {"name": "stacked_matmul.wgmma", **gemm,
         "launches": launches["stacked_matmul/wgmma"], "shape": tc_cases[0]["case"],
         **{key: tc_cases[0][key] for key in keys}, "cases": tc_cases[0::2]},
        {"name": "stacked_matmul.simt", **gemm,
         "launches": launches["stacked_matmul/simt"], "shape": cases[0]["case"],
         **{key: cases[0][key] for key in keys}, "cases": cases},
    ], km_row


PCA_COLS, PCA_ITERS = 8, 20   # the power iteration's Q and its recordings
SPLIT_ALIGNED, SPLIT_RAGGED = 15 * X_BLOCK[0], 4_000_000   # concat_rows splits
# the fused chain's optimizer stats, as the reference's optimizer reports
# them for the same recording (tests/test_torch_lazy.py holds the two equal)
CHAIN_STATS = {"nodes_before": 9, "nodes_after": 5, "fused_elementwise": 3}


def ds_counts(zero: bool = False):
    """The ds-array kernels' launch counts by kernel and route (set to 0
    first with ``zero``)."""
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.kernels.matmul import kernel as mk
    counts = {}
    for name, fn in (("stacked_matmul", mk.stacked_matmul),
                     ("kmeans_assign", kk.kmeans_assign_stacked)):
        if zero:
            fn.launches = 0
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        counts[name] = fn.launches
        counts.update({f"{name}/{r}": n for r, n in fn.route_launches.items()})
    return counts


def kernel_launches(torch, fn):
    """Kernels ``fn`` launches on the card, by ``torch.profiler``; None when
    the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def traced(body):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)     # the trace is live first
            torch.cuda.synchronize()
            body()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0)

    base, n = traced(lambda: None), traced(fn)
    return n - base if base else None


def fused_chain(torch, A, B):
    """Phase 6's fused chain: the three lazy roots and the eager chain."""
    s = ((A.lazy() + B) * 2.0).abs().sqrt()

    def eager_chain():
        e = ((A + B) * 2.0).abs().sqrt()
        return e.sum(axis=0), e.max(axis=1), e.sum(axis=0)

    return (s.sum(axis=0), s.max(axis=1), s.sum(axis=0)), eager_chain


def chain_launches(seed: int) -> dict:
    """The fused chain's kernel launches, lazy and eager, on new 8192² f32
    arrays (launches depend on shapes and pad states, not values).  Runs in
    a process of its own (``--chain-launches``): a ``torch.profiler``
    session in the main process made phase 8's later profiles miss some or
    all of their kernels."""
    import torch
    import repro_torch as rt
    from repro_torch.core import plan
    gen = torch.Generator(device="cuda").manual_seed(seed)
    A, B = (rt.from_array(torch.rand(SQUARE, SQUARE, generator=gen, device="cuda"),
                          SQUARE_BLOCK, device="cuda") for _ in range(2))
    roots, eager_chain = fused_chain(torch, A, B)
    fns = {"lazy": lambda: plan.compute_multi(*roots), "eager": eager_chain}
    for fn in fns.values():          # warm: plan built, meta kernels imported
        fn()
    return {name: kernel_launches(torch, fn) for name, fn in fns.items()}


def row_checksums(torch, a, w):
    """Sorted float64 ``x·w`` of ``a``'s rows, one contiguous block-row at a
    time (one reduction order for every row)."""
    gn, gm, bn, bm = a.blocks.shape
    wb = torch.nn.functional.pad(w, (0, gm * bm - w.shape[0])).reshape(gm, 1, bm)
    sums = [(a.blocks[i].contiguous().double() * wb).sum((0, 2)) for i in range(gn)]
    return torch.cat(sums)[: a.shape[0]].sort().values


def phase_lazy(torch, gen, seed, x, A, B, km, smi):
    """Phase 6: the lazy plan layer (record, optimize, fuse, cache) on the
    main path's arrays; returns the launch counts of its six steps."""
    import repro_torch as rt
    from repro_torch.algorithms import kmeans as kmod
    from repro_torch.core import plan
    from repro_torch.kernels.matmul import kernel as mk
    from repro_torch.obs import tracing

    total = dict.fromkeys(ds_counts(), 0)
    times = {}

    def counted(what, fn):
        """``fn()`` with the launch counts zeroed before and read after."""
        ds_counts(zero=True)
        out = fn()
        torch.cuda.synchronize()
        got = ds_counts()
        for k, v in got.items():
            total[k] += v
        print(f"[6] {what}: launches {got}", flush=True)
        return out, got

    def bits_equal(got, want, what):
        check(got.shape == want.shape and got.pad_state == want.pad_state
              and torch.equal(got.blocks, want.blocks),
              f"{what}: not the eager result's bits")

    # 1. a fused elementwise chain into three reductions, one a duplicate
    plan.clear_cache()
    roots, eager_chain = fused_chain(torch, A, B)
    with tracing.recording() as events:
        p = plan.plan_for(*roots)
    times["optimize_ms"] = next(e["dur"] for e in events
                                if e["name"] == "plan.optimize") / 1e3
    stats = {k: p.stats[k] for k in CHAIN_STATS}
    check(stats == CHAIN_STATS, f"fused chain stats {stats}, want {CHAIN_STATS}")
    check(p.roots[0] is p.roots[2], "the duplicate reduction did not collapse")
    got, _ = counted("fused chain", lambda: plan.compute_multi(*roots))
    want = eager_chain()
    for g, w, what in zip(got, want, ("sum(axis=0)", "max(axis=1)", "sum(axis=0)")):
        bits_equal(g, w, f"fused chain {what}")
    del got, want
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--chain-launches",
         "--seed", str(seed)], capture_output=True, text=True, timeout=300)
    check(child.returncode == 0, f"the launch-count process failed: {child.stderr[-2000:]}")
    launches = json.loads(child.stdout.strip().splitlines()[-1])
    times["chain_ms"] = timed(lambda: plan.compute_multi(*roots))
    times["chain_eager_ms"] = timed(eager_chain)
    print(f"[6] fused chain {SQUARE}² f32 -> sum(0), max(1), sum(0): stats {stats} "
          f"(optimizer {times['optimize_ms']:.3f} ms on the host); kernel launches "
          f"(torch.profiler) lazy {launches['lazy']}, eager {launches['eager']}; "
          f"{times['chain_ms']:.3f} ms (eager {times['chain_eager_ms']:.3f} ms); "
          f"{smi}", flush=True)
    times["chain_launches"] = launches
    del roots, p

    # 2. the transpose fold at full size: one GEMM reads X transposed
    want = rt.matmul_ta(x, x)
    gc.collect()               # no garbage freed inside the measured window
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got, n = counted("fold", lambda: (x.lazy().T @ x).compute())
    added = torch.cuda.max_memory_allocated() - base
    bits_equal(got, want, "(X.lazy().T @ X).compute()")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    route = mk.plan(x.blocks.permute(1, 0, 3, 2), x.blocks, sms).route
    check(n["stacked_matmul"] == 1 and n[f"stacked_matmul/{route}"] == 1,
          f"fold launches {n}: want one stacked_matmul on {route}")
    x_bytes = x.blocks.numel() * x.blocks.element_size()
    check(added < x_bytes, f"the fold added {added} bytes, X holds {x_bytes}")
    times["fold_ms"] = timed(lambda: (x.lazy().T @ x).compute())
    times["fold_eager_ms"] = timed(lambda: rt.matmul_ta(x, x))
    times["fold_added_bytes"] = added
    print(f"[6] fold (X.lazy().T @ X) {N_ROWS}x{N_FEATURES}: bits equal matmul_ta, "
          f"1 stacked_matmul on {route}, peak added {added / 1e6:.3f} MB (X "
          f"{x_bytes / 1e9:.3f} GB); {times['fold_ms']:.3f} ms (eager "
          f"{times['fold_eager_ms']:.3f} ms); {smi}", flush=True)
    del got, want

    # 3. the PCA power-iteration body recorded PCA_ITERS times
    q0 = torch.linalg.qr(torch.randn((N_FEATURES, PCA_COLS), generator=gen,
                                     device="cuda"))[0]

    def power(step):
        q = q0
        for _ in range(PCA_ITERS):
            y = step(rt.from_array(q, (N_FEATURES, PCA_COLS), device="cuda"))
            q = torch.linalg.qr(y.collect())[0]
        torch.cuda.synchronize()
        return q

    plan.clear_cache()
    xl = x.lazy()
    t0 = time.perf_counter()
    q_lazy, n = counted(f"power iteration x{PCA_ITERS}",
                        lambda: power(lambda qd: (xl.T @ (xl @ qd)).compute()))
    times["pca_ms_per_iter"] = (time.perf_counter() - t0) * 1e3 / PCA_ITERS
    st = plan.cache_stats()
    want_st = {"opt_runs": 1, "opt_skips": PCA_ITERS - 1, "misses": 1,
               "hits": PCA_ITERS - 1}
    check({k: st[k] for k in want_st} == want_st, f"hot-loop plan counters {st}")
    check(n["stacked_matmul"] == 2 * PCA_ITERS,
          f"hot loop: {n['stacked_matmul']} stacked_matmul launches, want "
          f"{2 * PCA_ITERS}")
    t0 = time.perf_counter()
    q_eager = power(lambda qd: rt.matmul_ta(x, x @ qd))
    times["pca_eager_ms_per_iter"] = (time.perf_counter() - t0) * 1e3 / PCA_ITERS
    err = gemm_close(q_lazy, q_eager, N_ROWS)
    print(f"[6] power iteration (xl.T @ (xl @ Q)), Q {N_FEATURES}x{PCA_COLS}, "
          f"{PCA_ITERS} recordings: plan counters {st}; last Q max abs err {err:.3e} "
          f"vs the eager loop; {times['pca_ms_per_iter']:.3f} ms an iteration "
          f"(eager {times['pca_eager_ms_per_iter']:.3f}); {smi}", flush=True)

    # 4. K-means: score's ‖x‖² is a plan, optimised once across the calls
    def eager_row_sq_norms(a):
        s_ = (a * a).sum(axis=1)
        return s_.blocks.reshape(a.blocks.shape[0], a.blocks.shape[2]).to(torch.float32)

    plan.clear_cache()
    (pred, score, score2), n = counted(
        "KMeans predict, score, score",
        lambda: (km.predict(x), km.score(x), km.score(x)))
    st = plan.cache_stats()
    check((st["opt_runs"], st["opt_skips"], st["misses"], st["hits"]) == (1, 1, 1, 1),
          f"‖x‖² plan counters over predict and two scores: {st}")
    check(n["kmeans_assign"] == 1, f"predict launched kmeans_assign {n}")
    t0 = time.perf_counter()
    km.score(x)
    times["score_warm_s"] = time.perf_counter() - t0
    with patched(kmod, "_row_sq_norms", eager_row_sq_norms):
        t0 = time.perf_counter()
        score_eager = km.score(x)
        times["score_eager_s"] = time.perf_counter() - t0
    rel = abs(score - score_eager) / abs(score_eager)
    check(score == score2 and rel <= 1e-6,
          f"score {score} / {score2} vs eager ‖x‖² {score_eager} (rel {rel:.2e})")
    print(f"[6] KMeans score with the ‖x‖² plan {score:.9e}, eager ‖x‖² "
          f"{score_eager:.9e} (rel {rel:.2e}); plan counters {st}; score "
          f"{times['score_warm_s']:.4f} s (eager ‖x‖² {times['score_eager_s']:.4f} s; "
          f"phase 4's first score pays the one-time import of torch's meta "
          f"kernels)", flush=True)
    del pred

    # 5. shuffles: rows move unchanged, lazy equals eager for one state
    w = torch.randn(N_FEATURES, generator=gen, device="cuda", dtype=torch.float64)
    ref_sums = row_checksums(torch, x, w)
    for name, fn in (("pseudo_shuffle", rt.pseudo_shuffle),
                     ("exact_shuffle", rt.exact_shuffle)):
        state = gen.get_state()
        eager = fn(gen, x)
        gen.set_state(state)
        lazy_out = fn(gen, x.lazy()).compute()
        bits_equal(lazy_out, eager, f"lazy {name}")
        del lazy_out
        check(eager.pad_state == rt.PAD_ZERO and eager.shape == x.shape,
              f"{name}: pad {eager.pad_state}, shape {eager.shape}")
        check(torch.equal(row_checksums(torch, eager, w), ref_sums),
              f"{name}: the rows' checksums differ from X's")
        moved = float((eager.blocks != x.blocks).any(-1).float().mean())
        del eager
        times[f"{name}_ms"] = timed(lambda: fn(gen, x))
        times[f"{name}_lazy_ms"] = timed(lambda: fn(gen, x.lazy()).compute())
        print(f"[6] {name} {N_ROWS}x{N_FEATURES}: rows' float64 checksums equal X's, "
              f"pad ZERO, lazy == eager; {moved:.4f} of row slots changed; "
              f"{times[f'{name}_ms']:.3f} ms (lazy {times[f'{name}_lazy_ms']:.3f} ms); "
              f"{smi}", flush=True)
    del ref_sums

    # 6. structural: concat_rows of two splits of X, norms along each axis
    for k, path in ((SPLIT_ALIGNED, "grid stack"), (SPLIT_RAGGED, "gather")):
        parts = (x[:k], x[k:])
        check((path == "grid stack") == (k % X_BLOCK[0] == 0), f"split {k}")
        out = rt.concat_rows(parts)
        bits_equal(out, x, f"concat_rows at {k}")
        del out
        times[f"concat_{k}_ms"] = timed(lambda: rt.concat_rows(parts))
        print(f"[6] concat_rows split at {k} ({path}): equals X; "
              f"{times[f'concat_{k}_ms']:.3f} ms; {smi}", flush=True)
        del parts
    rows = x.collect()
    for axis in (1, 0):
        got = x.norm(axis=axis).collect().reshape(-1).double()
        if axis == 1:
            ref = torch.cat([rows[lo:lo + SAMPLE_ROWS].double().pow(2).sum(1).sqrt()
                             for lo in range(0, N_ROWS, SAMPLE_ROWS)])
        else:
            ref = sum(rows[lo:lo + SAMPLE_ROWS].double().pow(2).sum(0)
                      for lo in range(0, N_ROWS, SAMPLE_ROWS)).sqrt()
        rel = float(((got - ref).abs() / ref).max())
        check(rel <= 1e-4, f"norm(axis={axis}) relative err {rel}")
        del got, ref
        times[f"norm_axis{axis}_ms"] = timed(lambda: x.norm(axis=axis))
        print(f"[6] norm(axis={axis}): max relative err {rel:.3e} vs float64; "
              f"{times[f'norm_axis{axis}_ms']:.3f} ms; {smi}", flush=True)
    print(f"[6] card: {smi}; lazy-plan phase: {json.dumps(times)}; launches "
          f"{total}", flush=True)
    return total


KERNEL_GROUPS = (("flash_attention", ("attn_tile_kernel", "attn_rows_kernel",
                                      "attn_wgmma_kernel")),
                 ("stacked_matmul", ("wgmma_kernel", "simt_kernel", "splitk_reduce")),
                 ("ssd_chunk", ("ssd_chunk_kernel", "ssd_mma_kernel")),
                 ("kmeans_assign labels", ("kmeans_mma_kernel", "kmeans_assign_kernel",
                                           "kmeans_assign_dtiled")),
                 ("kmeans_assign sums pass", ("kmeans_sums_kernel",)),
                 ("kmeans_assign split/reduce", ("kmeans_split_centers", "kmeans_reduce")),
                 ("cuBLAS GEMM", ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "sm80_")))


def device_profile(torch, fn, what: str, tag: str = "[8]", ranges=None,
                   host_ops: bool = True):
    """Runs ``fn`` once under ``torch.profiler`` and prints the device time
    of its kernels by group (the port's kernels, cuBLAS, the rest of the
    torch ops), the top kernels, and the device's busy share of the
    window's host-clock time; returns the summary.  ``ranges`` {name:
    (module, attribute)}: each function is wrapped in a ``record_function``
    range of that name for the run (the package has no ranges), and the
    summary's ``ranges`` holds the device time of the kernels launched
    under each.  ``host_ops=False`` traces the device alone (no range
    spans): a trace of some 40,000 host ops takes a minute to process.  A
    trace without device time prints 'not measured'."""
    import importlib
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    ranges = ranges or {}

    def ranged(name, real):
        def wrapper(*args, **kw):
            with record_function(name):
                return real(*args, **kw)
        return wrapper

    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for name, (mod, attr) in ranges.items():
            obj = importlib.import_module(mod)
            stack.enter_context(patched(obj, attr, ranged(name, getattr(obj, attr))))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                     if host_ops else [ProfilerActivity.CUDA]) as prof:
            # a first kernel and a sync, so the trace is live before the window
            # (kernels launched right after the profiler starts can go unseen)
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # a range's own device-side span is not a kernel
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key not in ranges]
    busy = sum(ms for _, _, ms in kernels)
    if not kernels:
        print(f"{tag} profile {what}: the profiler recorded no device time: not measured")
        return {"what": what, "wall_ms": wall_ms, "busy_ms": None}
    groups = {}
    for name, count, ms in kernels:
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(key in name for key in keys)), "other torch ops")
        n, t = groups.get(group, (0, 0.0))
        groups[group] = (n + count, t + ms)
    spans = {name: sum(e.device_time_total for e in prof.events()
                       if e.name == name and e.device_type == DeviceType.CPU) / 1e3
             for name in ranges}
    top = sorted(kernels, key=lambda k: -k[2])[:6]
    print(f"{tag} profile {what}: window {wall_ms:.3f} ms (host clock, profiler on), "
          f"device busy {busy:.3f} ms ({busy / wall_ms:.3f} of it); by group: "
          + "; ".join(f"{g} {t:.3f} ms in {n} launches" for g, (n, t) in
                      sorted(groups.items(), key=lambda kv: -kv[1][1]))
          + (f"; under the ranges: {json.dumps(spans)} ms" if ranges else ""), flush=True)
    for name, count, ms in top:
        print(f"{tag}   {ms:10.3f} ms  x{count:<5d} {name[:110]}")
    return {"what": what, "wall_ms": wall_ms, "busy_ms": busy, "ranges": spans,
            "groups": {g: {"launches": n, "ms": t} for g, (n, t) in groups.items()}}


def lm_path(torch, gen):
    """Phase 7: the LM path at zamba2-2.7b's published widths, each step
    with its launch counts zeroed before and checked after."""
    import dataclasses
    import repro_torch as rt
    from repro_torch.algorithms import KMeans
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import hybrid
    from repro_torch.models.model import build_model
    from repro_torch.obs import tracing

    cfg = get_config(LM_ARCH)
    model = build_model(cfg)
    wall, launches = {}, {}
    # a bf16 forward's 9 attention launches all take the tensor-core route
    per_fwd = {"flash_attention": ATTN_PER_FORWARD, "ssd_chunk": SSD_PER_FORWARD,
               "flash_attention/wgmma": ATTN_PER_FORWARD, "flash_attention/tile": 0,
               "flash_attention/rows": 0, "ssd_chunk/mma": SSD_PER_FORWARD,
               "ssd_chunk/simt": 0}
    with torch.inference_mode():
        params = model.init(gen, "cuda")
        redraw_norms(params, gen)
        n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(params))
        tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ), generator=gen,
                               device="cuda")
        torch.cuda.synchronize()
        print(f"[7] {cfg.name}: {n_params} parameters, bf16, {cfg.n_layers} Mamba-2 "
              f"layers, d_model {cfg.d_model}", flush=True)

        # forward through the kernels, against the plain versions, then timed
        fwd, params32, launches["forward"] = family_forward(
            torch, model, params, tokens, per_fwd, "[7]",
            ("no inter-chunk term", lambda: without_inter_chunk(model, params, tokens)))
        wall.update((key, fwd[key]) for key in ("forward_first_s", "forward_runs_s",
                                                "forward_s", "forward_tok_per_s"))
        model32 = build_model(dataclasses.replace(cfg, dtype="float32"))

        # float32 at the same widths: decode teacher-forced against forward
        derr, _, _, launches["decode_f32"] = family_decode(
            torch, model32, params32, tokens[:, :DECODE_SEQ],
            {"flash_attention": ATTN_PER_FORWARD * (1 + DECODE_SEQ),
             "ssd_chunk": SSD_PER_FORWARD, "ssd_chunk/mma": SSD_PER_FORWARD,
             "flash_attention/tile": ATTN_PER_FORWARD,     # float32
             "flash_attention/rows": ATTN_PER_FORWARD * DECODE_SEQ}, "float32", "[7]")
        check(derr < DECODE_TOL, f"decode vs teacher forcing: {derr}")

        # serve.generate on the card, float32: every token the argmax of the
        # teacher-forced forward, except where that forward's top two logits
        # lie within 2 x DECODE_TOL (decode may then pick either)
        zero_counts()
        prompt = tokens[:, :GEN32_PROMPT]
        got, _ = serve.generate(model32, params32, prompt, GEN32_NEW)
        launches["generate_f32"] = read_counts()
        expect_counts(launches["generate_f32"],
                      {"flash_attention": ATTN_PER_FORWARD * (GEN32_PROMPT + GEN32_NEW - 1),
                       "flash_attention/rows": ATTN_PER_FORWARD * (GEN32_PROMPT + GEN32_NEW - 1),
                       "ssd_chunk": 0}, f"float32 serve.generate {tuple(prompt.shape)} "
                                        f"+ {GEN32_NEW}")
        want = teacher_forced(model32, params32, prompt, got)
        top2 = want.topk(2, dim=-1).values
        clear = top2[..., 0] - top2[..., 1] >= 2 * DECODE_TOL
        best = want.argmax(-1)
        wrong = int(((got != best) & clear).sum())
        zeros = int(((best != 0) & clear).sum())
        check(wrong == 0, f"float32 serve.generate: {wrong} tokens are not the argmax")
        check(float(clear.float().mean()) >= 0.5, "float32 serve.generate: too many "
                                                   "near-ties to check")
        check(zeros > 0, "control 'all tokens 0' passed the float32 generate check")
        print(f"[7] float32 serve.generate {tuple(prompt.shape)} + {GEN32_NEW}: tokens "
              f"equal the teacher-forced argmax at all {int(clear.sum())} of "
              f"{clear.numel()} positions without a near-tie (top-2 gap < "
              f"{2 * DECODE_TOL}); control 'all tokens 0' fails at {zeros}", flush=True)

        # serve.generate with the bf16 weights: bf16 rounding alone flips the
        # argmax at about 1 in 9 positions (the kernels' forward against the
        # plain one, above), so the tokens are held to a share of the bf16
        # teacher-forced argmax, and each to lie within TOP_ERRS x the bf16
        # forward's rms distance from the float32 model below that model's
        # best logit (a token drawn at random lies ~4 logit rms below it)
        zero_counts()
        prompt = torch.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT),
                               generator=gen, device="cuda")
        got, _ = serve.generate(model, params, prompt, GEN_NEW)
        launches["generate_bf16"] = read_counts()
        expect_counts(launches["generate_bf16"],
                      {"flash_attention": ATTN_PER_FORWARD * (GEN_PROMPT + GEN_NEW - 1),
                       "flash_attention/rows": ATTN_PER_FORWARD * (GEN_PROMPT + GEN_NEW - 1),
                       "ssd_chunk": 0}, f"bf16 serve.generate {tuple(prompt.shape)} "
                                        f"+ {GEN_NEW}")
        fwd = teacher_forced(model, params, prompt, got)
        exact = teacher_forced(model32, params32, prompt, got)
        tau = TOP_ERRS * rms(torch, fwd, exact)
        below = exact.max(-1).values - exact.gather(-1, got[..., None])[..., 0]
        agree = float((got == fwd.argmax(-1)).double().mean())
        zeros = float((fwd.argmax(-1) == 0).double().mean())
        far = int((below > tau).sum())
        check(far == 0, f"bf16 serve.generate: {far} tokens lie more than {tau} below "
                        f"the float32 model's best logit")
        check(agree >= BF16_AGREE, f"bf16 serve.generate agrees with the teacher-forced "
                                   f"argmax at {agree} of positions")
        check(zeros < BF16_AGREE, "control 'all tokens 0' passed the bf16 generate check")
        print(f"[7] bf16 serve.generate {tuple(prompt.shape)} + {GEN_NEW}: tokens equal "
              f"the bf16 teacher-forced argmax at {agree:.4f} of positions (limit "
              f"{BF16_AGREE}); each within {float(below.max()):.4f} of the float32 "
              f"model's best logit (limit {tau:.4f}); control 'all tokens 0' agrees "
              f"at {zeros:.4f}", flush=True)
        del params32, model32, fwd, exact, want

    # the server, as a user runs it (times only: serve.main draws its own
    # weights with the reference init, whose zero norms make every logit 0)
    zero_counts()
    served, times = serve.main(SERVE_ARGV)
    launches["serve"] = read_counts()
    n_req, n_prompt, n_gen = (int(SERVE_ARGV[i]) for i in (3, 5, 7))
    expect_counts(launches["serve"],
                  {"flash_attention": ATTN_PER_FORWARD * (n_prompt + n_gen - 1),
                   "ssd_chunk": 0}, f"serve.main {' '.join(SERVE_ARGV)}")
    check(tuple(served.shape) == (n_req, n_gen), f"served {tuple(served.shape)}")
    check(bool(((served >= 0) & (served < cfg.vocab_size)).all()), "bad tokens")
    wall["serve_prefill_s"] = times["prefill_s"]
    wall["serve_decode_s"] = times["decode_s"]
    wall["serve_decode_tok_per_s"] = n_req * (n_gen - 1) / times["decode_s"]

    # the composition: hidden states -> ds-array -> KMeans
    zero_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        states = []
        for _ in range(HIDDEN_BATCHES):
            toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ), generator=gen,
                                 device="cuda")
            h, _ = hybrid.forward_hidden(params, cfg, toks)
            states.append(h.float().reshape(-1, cfg.d_model))
    data = torch.cat(states)          # bf16 hidden states cast to float32
    del states
    torch.cuda.synchronize()
    wall["hidden_s"] = time.perf_counter() - t0
    n = data.shape[0]
    x = rt.from_array(data, HIDDEN_BLOCK, device="cuda")
    km = KMeans(n_clusters=LM_CLUSTERS, max_iter=20, tol=1e-4, seed=0)
    with tracing.recording() as events:
        t0 = time.perf_counter()
        km.fit(x)
        torch.cuda.synchronize()
        wall["kmeans_fit_s"] = time.perf_counter() - t0
    pred = km.predict(x)
    score = km.score(x)
    launches["composition"] = read_counts()
    expect_counts(launches["composition"],
                  {"flash_attention": ATTN_PER_FORWARD * HIDDEN_BATCHES,
                   "flash_attention/wgmma": ATTN_PER_FORWARD * HIDDEN_BATCHES,
                   "ssd_chunk": SSD_PER_FORWARD * HIDDEN_BATCHES,
                   "ssd_chunk/mma": SSD_PER_FORWARD * HIDDEN_BATCHES,
                   "kmeans_assign": km.n_iter_ + 1,
                   "kmeans_assign/mma": km.n_iter_ + 1, "kmeans_assign/simt": 0},
                  f"{HIDDEN_BATCHES} forward_hidden + KMeans fit/predict/score")
    iters = [e["dur"] for e in events if e["name"] == "fit.iteration"]
    wall["kmeans_n_iter"] = km.n_iter_
    wall["kmeans_s_per_iteration"] = statistics.median(iters) / 1e6
    wall["kmeans_lloyd_s"] = [e["dur"] for e in events if e["name"] == "fit.loop"][0] / 1e6
    check(km.n_iter_ >= 1, "KMeans on hidden states ran no iteration")
    check(score == score and abs(score) != float("inf"), f"score {score}")
    c64 = km.centers_.double()
    want = torch.cat([sq_dists(data[lo:lo + 16384].double(), c64).argmin(1)
                      for lo in range(0, n, 16384)])
    near, lerr = check_labels(data, km.centers_, pred.collect().reshape(-1), want,
                              "predict on hidden states")
    plain_score = -sum(float(sq_dists(data[lo:lo + 16384].double(), c64)
                             .min(1).values.clamp(min=0).sum())
                       for lo in range(0, n, 16384))
    srel = abs(score - plain_score) / abs(plain_score)
    check(srel <= 1e-4, f"hidden-state score {score} vs float64 {plain_score}")
    print(f"[7] KMeans on {n} x {cfg.d_model} hidden states, blocks {HIDDEN_BLOCK}: "
          f"n_iter {km.n_iter_}, score {score:.6e} (float64 {plain_score:.6e}, rel "
          f"{srel:.2e}); predict differs from the float64 argmin at {near} "
          f"near-ties (gap < {GAP_ERRS} x {lerr:.3e}), 0 others", flush=True)
    print(f"[7] wall: {json.dumps(wall)}", flush=True)

    # where the device time goes (counts of these runs are not the path's)
    with torch.inference_mode():
        profiles = [device_profile(torch, lambda: model.forward(params, tokens),
                                   f"forward {tuple(tokens.shape)}")]
        cache = model.init_cache(4, 16, device="cuda")
        step = tokens[:1, :1].repeat(4, 1)

        def decode_window():
            for _ in range(8):
                model.decode_step(params, cache, step)

        decode_window()   # warm
        profiles.append(device_profile(torch, decode_window, "8 decode steps, batch 4"))
        del cache
    return params, x, km, launches, wall, profiles


def lm_times(torch, gen, x, km, launches):
    """Phase 8: times of the LM path's kernels at its shapes."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref

    def report(row):
        row["tflops"] = row["flops"] / row["ms"] / 1e9
        lib = row["library_ms"]
        print(f"[8] {row['case']}: {row['ms']:.3f} ms (plain {row['plain_ms']:.3f}, "
              f"library {'-' if lib is None else f'{lib:.3f}'}, bound "
              f"{row['bound_ms']:.3f} by {row['bound_by']})", flush=True)
        return row

    def total(name):
        return sum(counts[name] for counts in launches.values())

    bf16 = torch.bfloat16
    rows = {}
    # attention: prefill (the model's (B, T, H, D) views) on the tensor cores
    # and, forced, on the SIMT tile kernel it replaced; decode
    flash = []
    for b, tq, tk, kv_len, causal, route in [
            (LM_BATCH, LM_SEQ, LM_SEQ, LM_SEQ, True, "wgmma"),
            (LM_BATCH, LM_SEQ, LM_SEQ, LM_SEQ, True, "tile"),
            (4, 1, 320, 300, False, "rows")]:
        h, d = 32, 80
        if tq > 1:
            qkv = torch.randn((3, b, tq, h, d), generator=gen, device="cuda").to(bf16)
            q, k, v = (qkv[i].transpose(1, 2) for i in range(3))
        else:
            q = torch.randn((b, h, tq, d), generator=gen, device="cuda").to(bf16)
            k, v = (torch.randn((b, h, tk, d), generator=gen, device="cuda").to(bf16)
                    for _ in range(2))
        kw = dict(causal=causal, window=0, softcap=0.0, sm_scale=d ** -0.5,
                  kv_len=kv_len)
        label = (f"{'prefill' if causal else 'decode'} B={b} H={h} Tq={tq} Tk={tk} "
                 f"kv_len={kv_len} D={d} bf16{' causal' if causal else ''}, {route}")
        with forced_route() if route == "tile" else contextlib.nullcontext():
            out = routed(lambda: fk.flash_attention(q, k, v, **kw), fk.flash_attention,
                         route, label)
            ms = timed(lambda: fk.flash_attention(q, k, v, **kw))
        ref = attention_ref(q, k, v, **kw)
        check(bad_count(out, ref, attn_limit(q, k, v, kw, ref)) == 0,
              "attention beyond its limit in phase 8")
        err = float((out.double() - ref.double()).abs().max())
        del out, ref
        if causal:   # q·k over the causal half, then p·v: 4·B·H·T²·D/2
            flops = 4.0 * b * h * tq * tk * d / 2
            lib = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=d ** -0.5))
        else:
            flops = 4.0 * b * h * tq * kv_len * d
            lib = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k[:, :, :kv_len], v[:, :, :kv_len], scale=d ** -0.5))
        nbytes = 2.0 * b * h * d * (2 * tq + 2 * kv_len)   # q, o; k, v read once
        b_ms, b_by = bound(flops, nbytes, "bf16")
        flash.append(report({
            "case": label, "kernel": route, "ms": ms,
            "plain_ms": timed(lambda: attention_ref(q, k, v, **kw)),
            "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
            "flops": flops, "bytes": nbytes, "max_abs_err": err}))
        del q, k, v

    # SSD chunk at the model's shape: B·H = 160 rows, B and C per group (B·G =
    # 2), on the mma route and, forced, on the simt route it replaced
    bh, bg, t, L, p, s = LM_BATCH * 80, LM_BATCH, LM_SEQ, 128, 64, 64
    args = ssd_inputs(torch, gen, bh, bg, t, p, s, slow=False)[:5]
    label = f"ssd_chunk BH={bh} (B, C per 80 heads) T={t} L={L} P={p} S={s} f32"
    err = ssd_chunk_check(args, L, "mma", f"{label}, mma", phase=8)
    ms = timed(lambda: sk.ssd_chunk(*args, chunk=L))
    with forced_route():
        ssd_chunk_check(args, L, "simt", f"{label}, simt (forced)", phase=8)
        simt_ms = timed(lambda: sk.ssd_chunk(*args, chunk=L))
    nc = t // L
    # C·Bᵀ and W·X over the causal half (the L(L+1)/2 pairs s <= t), then
    # the chunk state (B ⊙ decay)ᵀ·X
    flops = bh * nc * (L * (L + 1) / 2 * (2.0 * s + 2.0 * p) + 2.0 * L * s * p)
    # inputs x, dt, a, B and C once per group; outputs y, states, C·exp(ℓ), decay
    nbytes = 4.0 * (bh * t * p + bh * t + bh + 2 * bg * t * s
                    + bh * t * p + bh * nc * s * p + bh * t * s + bh * nc)
    # each route at the rate of the units it runs on: the mma route issues
    # three TF32 products (3xTF32) per fp32 one, the simt route fp32 FMAs
    b_ms, b_by = bound(3 * flops, nbytes, "tf32")
    simt_b_ms, simt_b_by = bound(flops, nbytes, "fp32")
    ssd = report({
        "case": label, "kernel": "mma", "ms": ms, "simt_ms": simt_ms,
        "plain_ms": timed(lambda: ssd_chunk_ref(*args, chunk=L)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "simt_bound_ms": simt_b_ms, "simt_bound_by": simt_b_by, "flops": flops,
        "bytes": nbytes, "max_abs_err": err})
    print(f"[8] ssd_chunk forced onto simt: {simt_ms:.3f} ms, bound "
          f"{simt_b_ms:.3f} ms by {simt_b_by} (fp32)", flush=True)
    del args
    routes = {r: total(f"ssd_chunk/{r}") for r in sk.ROUTES}
    check(routes == {"mma": SSD_PER_FORWARD * (2 + HIDDEN_BATCHES), "simt": 0},
          f"main paths launched ssd_chunk by route {routes}")

    # kmeans_assign on the hidden states and their fitted centers: the mma
    # route's streamed form, simt's D-tiled layout forced
    blocks, centers, n = x.blocks, km.centers_.contiguous(), x.shape[0]
    wide = assign_times(torch, blocks, centers, n,
                        f"assign {n}x{centers.shape[1]}, k={centers.shape[0]}, blocks "
                        f"{HIDDEN_BLOCK}", phase=8)
    device_profile(torch, lambda: kk.kmeans_assign_stacked(blocks, centers, n),
                   "kmeans_assign, mma route, streamed (labels kernel, sums pass, reduce)")
    assign_routes = {r: total(f"kmeans_assign/{r}") for r in kk.ROUTES}
    check(assign_routes == {"mma": total("kmeans_assign"), "simt": 0},
          f"the LM path launched kmeans_assign by route {assign_routes}")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    by_path = {name: {path: counts[name] for path, counts in launches.items()}
               for name in ("flash_attention/wgmma", "flash_attention/tile",
                            "flash_attention/rows", "ssd_chunk/mma")}
    attn = {"route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:91"}
    return wide, [
        {"name": f"flash_attention.{row['kernel']}", **attn,
         "launches": total(f"flash_attention/{row['kernel']}"),
         "launches_by_path": by_path[f"flash_attention/{row['kernel']}"],
         "shape": row["case"], **{key: row[key] for key in keys}}
        for row in flash
    ] + [
        {"name": "ssd_chunk.mma", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_chunk.cu",
         "replaces": "src/repro/kernels/ssd/kernel.py:77",
         "launches": total("ssd_chunk"), "launches_by_route": routes,
         "launches_by_path": by_path["ssd_chunk/mma"], "shape": ssd["case"],
         **{key: ssd[key] for key in keys + ("kernel", "simt_ms", "simt_bound_ms", "simt_bound_by")}},
    ]


# ---------------------------------------------------------------------------
# phase 9: sparse blocks at the Netflix Prize shape
# ---------------------------------------------------------------------------

# the Netflix Prize ratings (paper §5.3): users x movies, ratings stored;
# drawn from --seed at that shape and nnz (the file is not in the checkout)
NETFLIX_USERS, NETFLIX_MOVIES, NETFLIX_RATINGS = 480_189, 17_770, 100_480_507
NETFLIX_BLOCK = (32_768, 4_096)
ALS_FACTORS, ALS_REG = 16, 0.1      # the reference ALS's defaults
ENTRY_CHUNK = 4_000_000             # triplets per float64 reference pass


def netflix_ratings(torch, gen):
    """(csr, rows, cols, vals): NETFLIX_RATINGS distinct (user, movie)
    positions drawn uniformly, ratings uniform in 1..5 (float32), as a scipy
    CSR matrix and as int64/float64 COO triplets on the card."""
    import numpy as np
    import scipy.sparse as ssp
    total = NETFLIX_USERS * NETFLIX_MOVIES
    pos = torch.unique(torch.randint(0, total, (NETFLIX_RATINGS + 2_000_000,),
                                     generator=gen, device="cuda"))
    while pos.numel() < NETFLIX_RATINGS:
        more = torch.randint(0, total, (NETFLIX_RATINGS - pos.numel() + 100_000,),
                             generator=gen, device="cuda")
        pos = torch.unique(torch.cat([pos, more]))
    keep = torch.randperm(pos.numel(), generator=gen, device="cuda")[:NETFLIX_RATINGS]
    pos = pos[keep].sort().values
    del keep
    rows, cols = pos // NETFLIX_MOVIES, pos % NETFLIX_MOVIES
    del pos
    vals = torch.randint(1, 6, (NETFLIX_RATINGS,), generator=gen,
                         device="cuda").to(torch.float32)
    indptr = torch.zeros(NETFLIX_USERS + 1, dtype=torch.int64, device="cuda")
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=NETFLIX_USERS), 0)
    csr = ssp.csr_matrix((vals.cpu().numpy(), cols.to(torch.int32).cpu().numpy(),
                          indptr.cpu().numpy()),
                         shape=(NETFLIX_USERS, NETFLIX_MOVIES))
    return csr, rows, cols, vals.double()


def triplet_dots(torch, trip, c64):
    """float64 ``x·cᵀ`` (n, k) of the COO triplets against ``c64`` (k, m):
    each stored value times its column of the centers, summed per row by a
    float64 ``index_add_``, ENTRY_CHUNK triplets at a time."""
    rows, cols, vals = trip
    out = torch.zeros((NETFLIX_USERS, c64.shape[0]), dtype=torch.float64,
                      device="cuda")
    ct = c64.T.contiguous()
    for lo in range(0, rows.numel(), ENTRY_CHUNK):
        sl = slice(lo, lo + ENTRY_CHUNK)
        out.index_add_(0, rows[sl], ct[cols[sl]] * vals[sl, None])
    return out


def triplet_dist(torch, trip, c64):
    """float64 ‖x‖² − 2x·c + ‖c‖² (n, k) from the triplets."""
    rows, cols, vals = trip
    x_sq = torch.zeros(NETFLIX_USERS, dtype=torch.float64, device="cuda")
    x_sq.index_add_(0, rows, vals * vals)
    return x_sq[:, None] - 2 * triplet_dots(torch, trip, c64) \
        + (c64 * c64).sum(1)[None]


def triplet_means(torch, trip, labels, k: int):
    """float64 per-cluster means (k, m) and counts (k,) of the rows under
    ``labels`` (n,), from the triplets."""
    rows, cols, vals = trip
    lab = labels.long()
    sums = torch.zeros(k * NETFLIX_MOVIES, dtype=torch.float64, device="cuda")
    for lo in range(0, rows.numel(), ENTRY_CHUNK):
        sl = slice(lo, lo + ENTRY_CHUNK)
        sums.index_add_(0, lab[rows[sl]] * NETFLIX_MOVIES + cols[sl], vals[sl])
    counts = torch.bincount(lab, minlength=k).double()
    return sums.reshape(k, NETFLIX_MOVIES) / counts.clamp(min=1)[:, None], counts


def sparse_label_check(torch, dist32, dist64, got, what: str):
    """``got`` (n,) against the float64 argmin of ``dist64`` (n, k): a row
    may differ only at a near-tie, its float64 gap between the two nearest
    centers below GAP_ERRS x the largest |fp32 − float64| distance of these
    rows; and at most NEAR_TIE_SHARE of the rows.  Returns (near, err)."""
    import math
    err = float((dist32.double() - dist64).abs().max())
    diff = got.long() != dist64.argmin(1)
    near = 0
    if bool(diff.any()):
        two = torch.topk(dist64[diff], 2, dim=1, largest=False).values
        is_near = (two[:, 1] - two[:, 0]) < GAP_ERRS * err
        check(bool(is_near.all()), f"{what}: {int((~is_near).sum())} labels "
                                   f"differ beyond near-ties (gap >= {GAP_ERRS} x {err:.3e})")
        near = int(is_near.sum())
    cap = math.ceil(NEAR_TIE_SHARE * got.numel())
    check(near <= cap, f"{what}: {near} near-ties, more than {cap}")
    return near, err


@contextlib.contextmanager
def never_densified():
    """Within the block, any densify of a sparse array raises (the
    package's ``todense`` and the two names its block densify is bound
    to)."""
    from repro_torch.core import sparse as smod
    from repro_torch.kernels.matmul import ops as mops

    def refuse(*args, **kwargs):
        raise RuntimeError("chip_smoke check failed: a sparse array was densified")

    with patched(smod, "todense", refuse), \
            patched(smod, "_to_dense_blocks", refuse), \
            patched(mops, "_to_dense_blocks", refuse):
        yield


def added_peak(torch, fn):
    """(result, bytes): ``fn()`` and the device memory it added at its peak
    over what was allocated before."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def phase_sparse(torch, gen, smi):
    """Phase 9: the sparse path at the Netflix Prize shape; returns its
    kernel launches and the sparse-ops rows."""
    import numpy as np
    import repro_torch as rt
    from repro_torch.algorithms import KMeans
    from repro_torch.algorithms import kmeans as kmod
    from repro_torch.core import plan
    from repro_torch.core import sparse as smod
    from repro_torch.obs import tracing

    t_phase = time.perf_counter()
    wall = {}
    csr, *trip = netflix_ratings(torch, gen)
    trip = tuple(trip)
    csr64 = csr.astype(np.float64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    R = rt.from_scipy(csr, NETFLIX_BLOCK, device="cuda")
    torch.cuda.synchronize()
    wall["from_scipy_s"] = time.perf_counter() - t0
    gn, gm, bn, bm = R.blocks.shape
    nse = R.blocks.nse
    stored = R.blocks.data.numel() * 4 + R.blocks.indices.numel() * 4
    dense_bytes = 4.0 * gn * gm * bn * bm
    mean_nnz = NETFLIX_RATINGS / (gn * gm)
    row_nnz = np.diff(csr.indptr)
    col_nnz = np.bincount(csr.indices, minlength=NETFLIX_MOVIES)
    print(f"[9] R {NETFLIX_USERS}x{NETFLIX_MOVIES}, {NETFLIX_RATINGS} ratings "
          f"({NETFLIX_RATINGS / (NETFLIX_USERS * NETFLIX_MOVIES):.4%} dense, uniform "
          f"positions from --seed: real ratings are skewed, so real blocks pad more); "
          f"from_scipy {wall['from_scipy_s']:.3f} s (triplets to the card, bucketed "
          f"there); grid {gn}x{gm} of {NETFLIX_BLOCK}, nse {nse}, nse / mean block "
          f"nnz {nse / mean_nnz:.4f}; stored {stored / 1e9:.3f} GB (dense "
          f"{dense_bytes / 1e9:.1f} GB)", flush=True)
    check(R.block_format == "bcoo" and nse == int(
        smod.max_block_nnz(csr, NETFLIX_BLOCK)), f"R: format {R.block_format}, nse {nse}")

    def close(out, ref, depth, what, control=True):
        """GEMM-style limit for a reduction of ``depth`` terms; the zeroed
        result must fail it."""
        err = gemm_close(out, ref, depth)
        if control:
            check(gemm_bad(torch.zeros_like(out), ref, depth) > 0,
                  f"{what}: the zeroed control passed")
        print(f"[9] {what}: max abs err {err:.3e} vs float64 (depth {depth}); "
              f"zeroed control fails", flush=True)
        return err

    def entries_close(out_data, ref64, what, ulps=2):
        """Per stored entry: |out − ref| <= ulps·eps32·|ref|; zeroed fails."""
        lim = ulps * torch.finfo(torch.float32).eps * ref64.abs()
        bad = int(((out_data.double() - ref64).abs() > lim).sum())
        check(bad == 0, f"{what}: {bad} entries beyond {ulps} ulps")
        check(int(((0 * ref64 - ref64).abs() > lim).sum()) > 0,
              f"{what}: the zeroed control passed")
        print(f"[9] {what}: every stored entry within {ulps} ulps of float64; "
              f"zeroed control fails", flush=True)

    # 1. invariants, sums, data maps, pair ops, the gather, astype
    t0 = time.perf_counter()
    R.check_invariants()
    wall["check_invariants_s"] = time.perf_counter() - t0
    data64 = R.blocks.data.double()
    total = R.sum()
    close(total.reshape(1), torch.tensor([csr64.sum()], device="cuda"),
          NETFLIX_RATINGS, "R.sum()")
    close(R.sum(axis=0).collect().reshape(-1),
          torch.from_numpy(np.asarray(csr64.sum(axis=0)).ravel()).cuda(),
          int(col_nnz.max()), "R.sum(axis=0)")
    close(R.sum(axis=1).collect().reshape(-1),
          torch.from_numpy(np.asarray(csr64.sum(axis=1)).ravel()).cuda(),
          int(row_nnz.max()), "R.sum(axis=1)")
    out = (R * 0.5).sqrt()
    check(out.block_format == "bcoo" and out.blocks.nse == nse,
          f"(R*0.5).sqrt(): {out.block_format}, nse {out.blocks.nse}")
    entries_close(out.blocks.data, (0.5 * data64).sqrt(), "(R * 0.5).sqrt()")
    out = R * R
    check(out.block_format == "bcoo" and out.blocks.nse == nse,
          f"R * R: {out.block_format}, nse {out.blocks.nse}")
    entries_close(out.blocks.data, data64 * data64, "R * R")
    out = R + R
    check(out.block_format == "bcoo" and out.blocks.nse == 2 * nse, "R + R")
    out = smod.canonicalize(out)
    check(out.blocks.nse == nse and torch.equal(out.blocks.indices, R.blocks.indices)
          and torch.equal(out.blocks.data, 2 * R.blocks.data),
          "canonicalize(R + R): not R's positions with twice its values")
    print(f"[9] R + R: nse {2 * nse}; canonicalize: nse {nse}, R's indices, "
          f"2·R's data bit for bit", flush=True)
    S = R[:NETFLIX_BLOCK[0]]
    check(S.block_format == "bcoo", "R[:32768] densified")
    D = rt.random_array(gen, S.shape, NETFLIX_BLOCK, device="cuda")
    out = S * D
    check(out.block_format == "bcoo", "S * D densified")
    sidx = S.blocks.indices.long()
    grow = sidx[..., 0]
    gcol = torch.arange(gm, device="cuda")[None, :, None] * bm + sidx[..., 1]
    ok = (sidx[..., 0] < bn) & (sidx[..., 1] < bm)
    dense_d = D.collect()
    dv = torch.zeros_like(S.blocks.data, dtype=torch.float64)
    dv[ok] = dense_d[grow[ok], gcol[ok]].double()
    entries_close(out.blocks.data, S.blocks.data.double() * dv,
                  f"S * D (S = R[:{NETFLIX_BLOCK[0]}], D {S.shape[0]}x{S.shape[1]} dense)",
                  ulps=1)
    del D, dense_d, dv, sidx, grow, gcol, ok, out
    out = R.astype(torch.bfloat16)
    check(out.block_format == "bcoo" and out.dtype == torch.bfloat16
          and torch.equal(out.blocks.data.float(), R.blocks.data),
          "R.astype(bfloat16): not R's ratings (exact in bf16)")
    del out, data64
    print("[9] R.astype(bfloat16): bcoo, every rating exact", flush=True)

    # 2. the ALS products and one ALS half-step (f = 16), never densified
    V = rt.from_array(torch.randn(NETFLIX_MOVIES, ALS_FACTORS, generator=gen,
                                  device="cuda") * 0.1, (bm, ALS_FACTORS), device="cuda")
    U = rt.from_array(torch.randn(NETFLIX_USERS, ALS_FACTORS, generator=gen,
                                  device="cuda") * 0.1, (bn, ALS_FACTORS), device="cuda")
    v64, u64 = V.collect().double().cpu().numpy(), U.collect().double().cpu().numpy()
    ds_counts(zero=True)
    with never_densified():
        rv, rv_added = added_peak(torch, lambda: R @ V)
        rv2 = R @ V
        rtu, rtu_added = added_peak(torch, lambda: rt.matmul_ta(R, U))
        rtu2 = rt.matmul_ta(R, U)
        rtu_eager = R.T @ U
        g = torch.linalg.inv(rt.gram(V).double() + ALS_REG * torch.eye(
            ALS_FACTORS, dtype=torch.float64, device="cuda")).float()
        u_new = (R @ V) @ rt.from_array(g, (ALS_FACTORS, ALS_FACTORS), device="cuda")
    torch.cuda.synchronize()
    als_launches = ds_counts()
    check(als_launches["stacked_matmul/simt"] == 1 and als_launches["stacked_matmul"] == 1
          and als_launches["kmeans_assign"] == 0,
          f"ALS products: launches {als_launches}, want one stacked_matmul on simt")
    check(torch.equal(rv.blocks, rv2.blocks) and torch.equal(rtu.blocks, rtu2.blocks),
          "a repeated sparse product gave other bits")
    close(rv.collect(), torch.from_numpy(csr64 @ v64).cuda(), int(row_nnz.max()),
          f"R @ V (V {NETFLIX_MOVIES}x{ALS_FACTORS})")
    ref_tu = torch.from_numpy(np.asarray(csr64.T @ u64)).cuda()
    close(rtu.collect(), ref_tu, int(col_nnz.max()),
          f"matmul_ta(R, U) (U {NETFLIX_USERS}x{ALS_FACTORS})")
    rt_bits = torch.equal(rtu_eager.blocks, rtu.blocks)
    if not rt_bits:
        close(rtu_eager.collect(), ref_tu, int(col_nnz.max()), "R.T @ U")
    print(f"[9] R.T @ U: {'bits equal matmul_ta' if rt_bits else 'within the limit, bits differ from matmul_ta'}",
          flush=True)
    g64 = np.linalg.inv(v64.T @ v64 + ALS_REG * np.eye(ALS_FACTORS))
    close(u_new.collect(), torch.from_numpy((csr64 @ v64) @ g64).cuda(),
          int(row_nnz.max()) * ALS_FACTORS, "ALS half-step (R @ V) @ inv(gram(V) + 0.1 I)")
    slots = gn * gm * nse      # stored slots, the pad slots included
    per_entry = {"R @ V": 4.0 * slots * ALS_FACTORS,
                 "matmul_ta(R, U)": 4.0 * slots * ALS_FACTORS}
    for what, added in (("R @ V", rv_added), ("matmul_ta(R, U)", rtu_added)):
        check(added < stored / 2, f"{what} added {added} bytes, half of R's "
                                  f"stored {stored} is the limit")
        print(f"[9] {what}: added peak {added / 1e6:.3f} MB (limit {stored / 2e6:.1f} MB; "
              f"a gather of one value per stored entry per output column "
              f"{per_entry[what] / 1e9:.2f} GB)", flush=True)
    del rv2, rtu2, rtu_eager, u_new, ref_tu

    # 3. lazy: the fold, a sparse chain recorded twice, a lazy slice
    with never_densified():
        folded = (R.lazy().T @ U).compute()
    check(torch.equal(folded.blocks, rtu.blocks), "(R.lazy().T @ U) is not matmul_ta's bits")
    plan.clear_cache()
    for _ in range(2):
        chain = ((R.lazy() * 2.0) * R).sum(axis=1)
        got = chain.compute()
    st = plan.cache_stats()
    check((st["opt_runs"], st["opt_skips"], st["misses"], st["hits"]) == (1, 1, 1, 1),
          f"sparse chain plan counters {st}")
    fused = plan.plan_for(chain).stats["fused_elementwise"]
    check(fused == 0, f"the sparse nodes fused ({fused})")
    close(got.collect().reshape(-1),
          torch.from_numpy(2 * np.asarray(csr64.multiply(csr64).sum(axis=1)).ravel()).cuda(),
          int(row_nnz.max()), "((R.lazy() * 2) * R).sum(axis=1)")
    a = R.lazy()[:NETFLIX_BLOCK[0]].todense().compute()
    b = R[:NETFLIX_BLOCK[0]].todense()
    check(a.block_format == "dense" and torch.equal(a.blocks, b.blocks),
          "R.lazy()[:32768].todense() differs from R[:32768].todense()")
    del a, b, folded, got
    print(f"[9] lazy: (R.lazy().T @ U) bits equal matmul_ta; the sparse chain "
          f"recorded twice: counters {st}, fused_elementwise {fused}; the lazy "
          f"slice's todense equals the eager one", flush=True)

    # 4. K-means on the users' rating rows, never densified
    k = N_CLUSTERS
    km = KMeans(n_clusters=k, max_iter=20, tol=1e-4, seed=0)
    last = {}
    stats_fn = kmod._sparse_center_stats

    def recorded_stats(x, row_valid, centers, x_sq):
        out = stats_fn(x, row_valid, centers, x_sq)
        last["centers"], last["labels"] = centers, out[0]
        return out

    ds_counts(zero=True)
    with never_densified(), patched(kmod, "_sparse_center_stats", recorded_stats):
        with tracing.recording() as events:
            t0 = time.perf_counter()
            km.fit(R)
            torch.cuda.synchronize()
            wall["fit_s"] = time.perf_counter() - t0
        fit_last = dict(last)
        t0 = time.perf_counter()
        pred = km.predict(R)
        torch.cuda.synchronize()
        wall["predict_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        score = km.score(R)
        wall["score_s"] = time.perf_counter() - t0
    km_launches = ds_counts()
    check(sum(km_launches.values()) == 0, f"sparse K-means launched {km_launches}")
    loop = [e["dur"] for e in events if e["name"] == "fit.loop"]
    iters = [e["dur"] for e in events if e["name"] == "fit.iteration"]
    wall["init_s"] = wall["fit_s"] - loop[0] / 1e6
    wall["s_per_iteration"] = statistics.median(iters) / 1e6
    wall["n_iter"] = km.n_iter_
    n = NETFLIX_USERS
    c64 = km.centers_.double()
    dist64 = triplet_dist(torch, trip, c64)
    x_sq = kmod._row_sq_norms(R)
    cpad = torch.nn.functional.pad(km.centers_, (0, gm * bm - NETFLIX_MOVIES))
    dist32 = (x_sq[..., None] - 2.0 * kmod._dots(R, cpad)
              + (cpad * cpad).sum(1)).reshape(-1, k)[:n]
    near, lerr = sparse_label_check(torch, dist32, dist64,
                                    pred.collect().reshape(-1), "predict")
    plain_score = -float(dist64.min(1).values.clamp(min=0).sum())
    srel = abs(score - plain_score) / abs(plain_score)
    check(srel <= 1e-4, f"score {score} vs float64 {plain_score}")
    # the last Lloyd step: its labels against its centers, and the returned
    # centers the float64 means of those labels' members
    prev64 = fit_last["centers"][:, :NETFLIX_MOVIES].double()
    lab = fit_last["labels"].reshape(-1)[:n]
    pdist64 = triplet_dist(torch, trip, prev64)
    pcs = fit_last["centers"]
    pdist32 = (x_sq[..., None] - 2.0 * kmod._dots(R, pcs)
               + (pcs * pcs).sum(1)).reshape(-1, k)[:n]
    lnear, _ = sparse_label_check(torch, pdist32, pdist64, lab, "the last Lloyd step")
    means, counts = triplet_means(torch, trip, lab, k)
    means = torch.where(counts[:, None] > 0, means, prev64)
    close(km.centers_, means, int(counts.max()), "centers vs float64 member means")
    print(f"[9] KMeans({k}) on R: n_iter {km.n_iter_}, score {score:.6e} (float64 "
          f"{plain_score:.6e}, rel {srel:.2e}); predict differs from the float64 "
          f"argmin at {near} near-ties (gap < {GAP_ERRS} x {lerr:.3e}); the last "
          f"step's labels at {lnear}; no kernel launched, R never densified; "
          f"wall {json.dumps(wall)}", flush=True)
    del dist64, dist32, pdist64, pdist32, means, pred

    # 5. one assignment's added memory, and 6. times beside the bound and cuSPARSE
    row_valid = kmod._Rows(R).valid
    with never_densified():
        _, assign_added = added_peak(
            torch, lambda: kmod._sparse_center_stats(R, row_valid, cpad, x_sq))
    check(assign_added < stored / 2, f"one K-means assignment added {assign_added} "
                                     f"bytes, half of R's stored {stored} is the limit")
    print(f"[9] one K-means assignment (k={k}): added peak {assign_added / 1e6:.3f} MB "
          f"(limit {stored / 2e6:.1f} MB; a gather of one value per stored slot "
          f"per center {4.0 * slots * k / 1e9:.1f} GB)", flush=True)
    crow = torch.from_numpy(csr.indptr.astype(np.int64)).cuda()
    lib_r = torch.sparse_csr_tensor(crow, torch.from_numpy(csr.indices.astype(np.int64)).cuda(),
                                    torch.from_numpy(csr.data).cuda(),
                                    size=(NETFLIX_USERS, NETFLIX_MOVIES))
    cst = csr.T.tocsr()
    lib_rt = torch.sparse_csr_tensor(torch.from_numpy(cst.indptr.astype(np.int64)).cuda(),
                                     torch.from_numpy(cst.indices.astype(np.int64)).cuda(),
                                     torch.from_numpy(cst.data).cuda(),
                                     size=(NETFLIX_MOVIES, NETFLIX_USERS))
    del cst
    vd, ud = V.collect().contiguous(), U.collect().contiguous()
    cdense = km.centers_.contiguous()
    xs = x_sq.reshape(-1)[:n]

    def library_assign():
        dist = xs[:, None] - 2.0 * torch.sparse.mm(lib_r, cdense.T.contiguous()) \
            + (cdense * cdense).sum(1)
        onehot = torch.nn.functional.one_hot(dist.argmin(1), k).float()
        return torch.sparse.mm(lib_rt, onehot), onehot.sum(0)

    check(gemm_bad(torch.sparse.mm(lib_r, vd), rv.collect(), int(row_nnz.max())) == 0,
          "torch.sparse.mm disagrees with R @ V")
    out_bytes = {"R @ V": 4.0 * NETFLIX_USERS * ALS_FACTORS,
                 "matmul_ta(R, U)": 4.0 * NETFLIX_MOVIES * ALS_FACTORS}
    rows = []
    for name, fn, lib, operand, flops in (
            ("R @ V", lambda: R @ V, lambda: torch.sparse.mm(lib_r, vd),
             4.0 * NETFLIX_MOVIES * ALS_FACTORS + out_bytes["R @ V"],
             2.0 * NETFLIX_RATINGS * ALS_FACTORS),
            ("matmul_ta(R, U)", lambda: rt.matmul_ta(R, U),
             lambda: torch.sparse.mm(lib_rt, ud),
             4.0 * NETFLIX_USERS * ALS_FACTORS + out_bytes["matmul_ta(R, U)"],
             2.0 * NETFLIX_RATINGS * ALS_FACTORS),
            (f"K-means assignment, k={k}",
             lambda: kmod._sparse_center_stats(R, row_valid, cpad, x_sq), library_assign,
             4.0 * (cpad.numel() + xs.numel() * 2 + cpad.numel() + k),
             4.0 * NETFLIX_RATINGS * k)):
        ms = timed(fn)
        lib_ms = timed(lib)
        b_ms, b_by = bound(flops, stored + operand, "fp32")
        rows.append({"case": name, "ms": ms, "library_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": b_by})
        print(f"[9] {name}: {ms:.3f} ms (bound {b_ms:.3f} by {b_by}: R's stored "
              f"bytes once plus the operands; torch.sparse.mm {lib_ms:.3f} ms); "
              f"{smi}", flush=True)
    del lib_r, lib_rt, vd, ud
    wall["phase_s"] = time.perf_counter() - t_phase
    print(f"[9] card: {smi}; sparse phase wall: {json.dumps(wall)}", flush=True)
    return als_launches, rows, (R, csr, trip)

# ---------------------------------------------------------------------------
# phase 10: the estimators
# ---------------------------------------------------------------------------

PCA_K, SPARSE_PCA_K = 8, 16         # components: the dense and the Netflix PCA
PCA_ITERS_DEFAULT = 30              # PCA's n_iter default (the reference's)
Y_NOISE = 0.1                       # y = x·w + 0.5 + Y_NOISE·N(0, 1)
RIDGE_ALPHA = 1.0
CSVM_ROWS = X_BLOCK[0]              # the CSVM's cut: X's first block row ...
CSVM_BLOCK = (X_BLOCK[0] // 64, N_FEATURES)   # ... re-blocked into 64 chunks
CSVM_CAP, CSVM_ITERS = 64, 3
FOREST_SLICE = X_BLOCK[0] // 4      # rows fitted on the card and on the CPU
EST_SAMPLE = 4_096                  # rows whose outputs are recomputed in float64
WALK_ROWS = 1_024                   # rows walked through the trees in Python
ALS_ITERS = 10
# float64 limits, each from the fp32 error of the computation it checks:
# LIN_ERRS x eps32 of backward error for the normal equations (the Gram is
# a long fp32 sum); TSQR_ERRS·m·eps32 for Householder QR; PCA_ANGLE_ERRS x
# eps32 x iterations x λ1/λk for a power-iteration column; a variance to 1e-4
LIN_ERRS, TSQR_ERRS, PCA_ANGLE_ERRS, ALS_ERRS = 64, 8, 100, 8
VAR_RTOL = 1e-4


class Checks:
    """Phases 10 and 12's checks: each result beside its limit, failures
    gathered and raised together at the end of the phase (so one run prints
    every number)."""

    def __init__(self, tag: str = "[10]"):
        self.failed = []
        self.tag = tag

    def __call__(self, cond, msg: str) -> None:
        if not cond:
            self.failed.append(msg)
            print(f"{self.tag} FAILED: {msg}", flush=True)

    def control(self, fails, what: str) -> None:
        self(fails, f"control '{what}' passed its check")

    def raise_any(self) -> None:
        check(not self.failed, "; ".join(self.failed))


def est_step(torch, rec, name, fn, collect: bool = True):
    """``fn()`` with its CUDA-synchronised wall seconds, ``stacked_matmul``
    launches by route and added peak device memory kept in ``rec``; with
    ``collect``, garbage is collected first."""
    before = ds_counts()
    if collect:
        gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    rec["wall_s"][name] = time.perf_counter() - t0
    rec["added_mb"][name] = (torch.cuda.max_memory_allocated() - base) / 1e6
    after = ds_counts()
    rec["launches"][name] = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}
    return out


def chunked_gram64(torch, data, y):
    """float64 XᵀX, column sums, Xᵀy and Σy of the samples, a million rows
    at a time."""
    m = data.shape[1]
    g = torch.zeros((m, m), dtype=torch.float64, device="cuda")
    cs = torch.zeros(m, dtype=torch.float64, device="cuda")
    xty = torch.zeros(m, dtype=torch.float64, device="cuda")
    for lo in range(0, data.shape[0], SAMPLE_ROWS):
        c = data[lo:lo + SAMPLE_ROWS].double()
        yc = y[lo:lo + SAMPLE_ROWS].double()
        g += c.T @ c
        cs += c.sum(0)
        xty += c.T @ yc
    return g, cs, xty, float(y.double().sum())


def power64(torch, apply, q0, iters: int):
    """The power iteration of ``pca`` in float64: ``q <- qr(apply(q))``."""
    q = torch.linalg.qr(q0.double())[0]
    for _ in range(iters):
        q = torch.linalg.qr(apply(q))[0]
    return q


def pca_checks(torch, ck, what, comps, var, q64, rayleigh, lam_ratio, iters):
    """``comps`` (k, m) against the float64 iteration ``q64`` (m, k) from the
    same start (each component one of its columns up to sign, within
    PCA_ANGLE_ERRS·eps32·iters·λ1/λk), and each explained variance against
    the float64 variance of the data along that component; the components
    rotated by one index must fail the variance check."""
    eps = torch.finfo(torch.float32).eps
    comps = comps.double()
    dots = (comps @ q64).abs()
    match = dots.argmax(1)
    ck(sorted(match.tolist()) == list(range(comps.shape[0])),
       f"{what}: components match float64 columns {match.tolist()}")
    sin = float((1 - dots.max(1).values.clamp(max=1) ** 2).clamp(min=0).sqrt().max())
    lim = PCA_ANGLE_ERRS * eps * iters * lam_ratio
    ck(sin <= lim, f"{what}: sin(angle) {sin:.3e} to the float64 iteration, limit {lim:.3e}")
    rq = rayleigh(comps)
    vrel = float(((var.double() - rq).abs() / rq).max())
    ck(vrel <= VAR_RTOL, f"{what}: explained variance rel err {vrel:.3e}, limit {VAR_RTOL}")
    rot = rayleigh(comps.roll(1, 0))
    ck.control(float(((var.double() - rot).abs() / rot).max()) > VAR_RTOL,
               f"{what}: components rotated by one index")
    ck(bool((var[1:] <= var[:-1]).all()), f"{what}: variances not in descending order")
    print(f"[10] {what}: each component a float64-iteration column up to sign "
          f"(max sin {sin:.3e}, limit {lim:.3e}; λ1/λk {lam_ratio:.2f}); "
          f"explained variance rel err {vrel:.3e} (limit {VAR_RTOL}); rotated "
          f"components fail", flush=True)
    return sin, vrel


def phase_estimators(torch, seed, smi, sparse):
    """Phase 10: every estimator through its entry points, dense at phase
    4's shape and sparse at phase 9's; returns the ``stacked_matmul``
    launches of the estimator calls by route, and the fitted estimators
    with X and the CSVM's cut (phase 11 saves, reloads and resumes them)."""
    import numpy as np
    import repro_torch as rt
    from repro_torch.algorithms import ALS, PCA, frobenius, tsqr
    from repro_torch.algorithms import linalg as plin
    from repro_torch.core import plan
    from repro_torch.estimators import (CascadeSVM, LinearRegression,
                                        RandomForestClassifier, Ridge)
    from repro_torch.obs import registry

    t_phase = time.perf_counter()
    ck = Checks()
    eps = torch.finfo(torch.float32).eps
    rec = {"wall_s": {}, "launches": {}, "added_mb": {}}
    plain0 = registry.snapshot("gemm")["gemm.dispatch_plain"]
    ds_counts(zero=True)

    def step(name, fn):
        return est_step(torch, rec, name, fn)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    truth, data = blob_data(torch, gen)          # phase 4's samples
    n, m = data.shape
    w_true = torch.randn(m, generator=gen, device="cuda")
    y = data @ w_true + 0.5 + Y_NOISE * torch.randn(n, generator=gen, device="cuda")
    idx = torch.randperm(n, generator=gen, device="cuda")[:EST_SAMPLE]
    cidx = torch.randperm(CSVM_ROWS, generator=gen, device="cuda")[:EST_SAMPLE]
    g64, cs64, xty64, ysum = chunked_gram64(torch, data, y)
    mu64 = cs64 / n
    cov64 = (g64 - n * torch.outer(mu64, mu64)) / (n - 1)
    x = rt.from_array(data, X_BLOCK, device="cuda")
    torch.cuda.synchronize()

    # 1. PCA (the reference's defaults) and frobenius
    plan.clear_cache()
    pca_est = step("pca_fit", lambda: PCA(n_components=PCA_K).fit(x))
    st = plan.cache_stats()
    want_st = {"opt_runs": 1, "opt_skips": PCA_ITERS_DEFAULT - 1, "misses": 1,
               "hits": PCA_ITERS_DEFAULT - 1}
    ck({k: st[k] for k in want_st} == want_st, f"PCA plan counters {st}")
    proj = step("pca_transform", lambda: pca_est.transform(x))
    pca_score = pca_est.score(x)
    ev64, evec64 = torch.linalg.eigh(cov64)
    ev64, evec64 = ev64.flip(0), evec64.flip(1)
    q64 = power64(torch, lambda q: cov64 @ q,
                  plin._initial_q(m, PCA_K, 0, "cuda"), PCA_ITERS_DEFAULT)
    rq64 = ((q64.T @ cov64) * q64.T).sum(1)
    pca_checks(torch, ck, f"PCA({PCA_K}) {n}x{m}", pca_est.components_,
               pca_est.explained_variance_, q64,
               lambda c: ((c @ cov64) * c).sum(1),
               float(rq64.max() / rq64.min()), PCA_ITERS_DEFAULT)
    # the overlap with the covariance's top eigenvectors, checked where the
    # eigen-gap makes PCA_ITERS_DEFAULT iterations converge
    comps64 = pca_est.components_.double()
    gaps = []
    for j in range(1, PCA_K + 1):
        rho = float((ev64[j] / ev64[j - 1]) ** PCA_ITERS_DEFAULT)
        sig = float(torch.linalg.svdvals(evec64[:, :j].T @ comps64[:j].T).min())
        gaps.append({"j": j, "gap_ratio": float(ev64[j] / ev64[j - 1]),
                     "ratio_pow_iters": rho, "overlap": sig})
        if 100 * rho <= 0.1:
            ck(1 - sig <= 100 * rho, f"PCA top-{j} subspace overlap {sig} (bound {100 * rho})")
    print(f"[10] PCA: covariance eigenvalues {[round(float(v), 3) for v in ev64[:PCA_K + 1]]}; "
          f"the leading-j subspace's overlap with the top-j eigenvectors (checked "
          f"where 100·(λ_(j+1)/λ_j)^{PCA_ITERS_DEFAULT} <= 0.1): {json.dumps(gaps)}; "
          f"explained variance {pca_est.explained_variance_.tolist()}; score {pca_score:.6f}",
          flush=True)
    ref = (data[idx].double() - mu64) @ comps64.T
    got = proj.collect()[idx]
    ck(gemm_bad(got, ref, m) == 0, "PCA transform beyond the GEMM limit")
    ck.control(gemm_bad(torch.zeros_like(got), ref, m) > 0, "zeroed transform")
    fro = step("frobenius", lambda: frobenius(x))
    fro64 = float(torch.trace(g64).sqrt())
    frel = abs(fro - fro64) / fro64
    ck(frel <= 1e-5, f"frobenius rel err {frel:.3e}, limit 1e-5")
    ck.control(abs(fro * (1 - 1e-4) - fro64) / fro64 > 1e-5, "frobenius off by 1e-4")
    print(f"[10] PCA transform on {EST_SAMPLE} rows within the GEMM limit of float64 "
          f"(zeroed fails); frobenius(X) rel err {frel:.3e} (limit 1e-5)", flush=True)
    del proj, ref, got

    # 2. TSQR
    q, r = step("tsqr", lambda: tsqr(x))
    r64 = r.double()
    lim = TSQR_ERRS * m * eps

    def tsqr_errors(qq):
        res, qtq = 0.0, torch.zeros((m, m), dtype=torch.float64, device="cuda")
        for lo in range(0, n, SAMPLE_ROWS):
            c = qq[lo:lo + SAMPLE_ROWS].double()
            res += float(((c @ r64 - data[lo:lo + SAMPLE_ROWS].double()) ** 2).sum())
            qtq += c.T @ c
        eye = torch.eye(m, dtype=torch.float64, device="cuda")
        return (res / float(torch.trace(g64))) ** 0.5, float((qtq - eye).abs().max())

    rel_qr, orth = tsqr_errors(q)
    ck(rel_qr <= lim and orth <= lim,
       f"tsqr: ‖QR − X‖/‖X‖ {rel_qr:.3e}, ‖QᵀQ − I‖max {orth:.3e}, limit {lim:.3e}")
    q[:, 0] = 0
    c_rel, c_orth = tsqr_errors(q)
    ck.control(c_rel > lim and c_orth > lim, "Q with a zeroed column")
    print(f"[10] tsqr {n}x{m}: ‖QR − X‖/‖X‖ {rel_qr:.3e}, ‖QᵀQ − I‖max {orth:.3e} "
          f"(limit {TSQR_ERRS}·m·eps32 = {lim:.3e}); a zeroed column of Q fails "
          f"({c_rel:.3e}, {c_orth:.3e})", flush=True)
    del q, r

    # 3. LinearRegression (auto: must pick normal), tsqr, Ridge
    a64 = torch.zeros((m + 1, m + 1), dtype=torch.float64, device="cuda")
    a64[:m, :m], a64[:m, m], a64[m, :m], a64[m, m] = g64, cs64, cs64, n
    b64 = torch.cat([xty64, torch.tensor([ysum], dtype=torch.float64, device="cuda")])
    yd = y.double()
    ss_tot = float(((yd - yd.mean()) ** 2).sum())
    lin, models = {}, {}
    for name, make, alpha in (("linreg", lambda: LinearRegression(), 0.0),
                              ("linreg_tsqr", lambda: LinearRegression(solver="tsqr"), 0.0),
                              ("ridge", lambda: Ridge(alpha=RIDGE_ALPHA), RIDGE_ALPHA)):
        est = step(f"{name}_fit", lambda: make().fit(x, y))
        pred = step(f"{name}_predict", lambda: est.predict(x))
        score = step(f"{name}_score", lambda: est.score(x, y))
        reg = alpha * torch.eye(m + 1, dtype=torch.float64, device="cuda")
        reg[m, m] = 0
        a = a64 + reg
        theta64 = torch.linalg.solve(a, b64)

        def backward(coef, icpt):
            th = torch.cat([torch.as_tensor(coef, dtype=torch.float64, device="cuda"),
                            torch.tensor([icpt], dtype=torch.float64, device="cuda")])
            return float((a @ th - b64).abs().max()
                         / (a.abs().max() * th.abs().max() + b64.abs().max()))

        bw = backward(est.coef_, est.intercept_)
        fw = float((torch.as_tensor(est.coef_, device="cuda") - theta64[:m]).abs().max()
                   / theta64[:m].abs().max())
        cond = float(torch.linalg.cond(a))
        lim = LIN_ERRS * eps
        ck(bw <= lim, f"{name}: normal-equation backward error {bw:.3e}, limit {lim:.3e}")
        zeroed = np.array(est.coef_, copy=True)
        zeroed[int(np.abs(zeroed).argmax())] = 0
        ck.control(backward(zeroed, est.intercept_) > lim, f"{name}: zeroed coefficient")
        w32 = torch.as_tensor(np.asarray(est.coef_, np.float32), device="cuda").double()
        ref = data[idx].double() @ w32 + est.intercept_
        got = pred.collect().reshape(-1)[idx]
        ck(gemm_bad(got, ref, m) == 0, f"{name}: predict is not X @ coef_ + intercept_")
        w0 = w32.clone()
        w0[int(w0.abs().argmax())] = 0
        ck.control(gemm_bad(got, data[idx].double() @ w0 + est.intercept_, m) > 0,
                   f"{name}: predict against a zeroed coefficient")
        r2_64 = 1 - float(((yd - (data.double() @ theta64[:m] + theta64[m])) ** 2).sum()) \
            / ss_tot
        lin[name] = {"solver_used": est.solver_used_, "backward_err": bw,
                     "coef_rel_err": fw, "cond": cond, "r2": score, "r2_64": r2_64}
        print(f"[10] {name}: solver_used_ {est.solver_used_!r}; coefficients: backward "
              f"error {bw:.3e} of the float64 normal equations (limit {lim:.3e}; a "
              f"zeroed coefficient fails), forward rel err {fw:.3e} (cond {cond:.1f}); "
              f"predict on {EST_SAMPLE} rows equals X @ coef_ + intercept_ within the GEMM "
              f"limit; R² {score:.9f} (the float64 solution's {r2_64:.9f})", flush=True)
        models[name] = est
        del pred
    ck(lin["linreg"]["solver_used"] == "normal",
       f"LinearRegression() chose {lin['linreg']['solver_used']!r} on a well-conditioned X")

    # 4. RandomForestClassifier (the reference's defaults) on the blob ids
    forest = step("forest_fit", lambda: RandomForestClassifier().fit(x, truth))
    fpred = step("forest_predict", lambda: forest.predict(x))
    acc = float((fpred.collect().reshape(-1) == truth).double().mean())
    sl = FOREST_SLICE
    f_card = RandomForestClassifier().fit(x[:sl], truth[:sl])
    t0 = time.perf_counter()
    f_cpu = RandomForestClassifier().fit(
        rt.from_array(data[:sl].cpu(), X_BLOCK, device="cpu"), truth[:sl].cpu())
    cpu_s = time.perf_counter() - t0
    names = ("edges_", "feat_", "bin_", "leaf_class_")
    for name in names:
        ck(np.array_equal(getattr(f_card, name), getattr(f_cpu, name)),
           f"forest: {name} differs between the card and the CPU")
    moved = f_cpu.bin_.copy()
    moved[0, 0] += 1
    ck.control(not np.array_equal(f_card.bin_, moved), "forest: one split bin moved")

    def walk(est, rows, leaf):
        codes = (rows[:, :, None] > est.edges_[None]).sum(-1)
        out = []
        for row in codes:
            votes = np.zeros(len(est.classes_), np.int64)
            for t in range(est.n_estimators):
                nd = 0
                for d in range(est.max_depth):
                    i = (1 << d) - 1 + nd
                    nd = 2 * nd + int(row[est.feat_[t, i]] > est.bin_[t, i])
                votes[leaf[t, nd]] += 1
            out.append(est.classes_[int(votes.argmax())])
        return np.asarray(out)

    widx = idx[:WALK_ROWS]
    wrows = data[widx].cpu().numpy()
    got = fpred.collect().reshape(-1)[widx].cpu().numpy()
    ck(np.array_equal(walk(forest, wrows, forest.leaf_class_), got),
       "forest: predict differs from a Python walk of the fitted trees")
    shifted = (forest.leaf_class_ + 1) % len(forest.classes_)
    ck.control(not np.array_equal(walk(forest, wrows, shifted), got),
               "forest: leaf classes shifted by one")
    print(f"[10] forest (8 trees, depth 6, 16 bins) on the {N_CLUSTERS} blob ids: "
          f"training accuracy {acc:.4f}; fitted on the first {sl} rows on the card "
          f"and on the CPU ({cpu_s:.2f} s): {', '.join(names)} equal (a moved bin "
          f"fails); predict on {WALK_ROWS} rows equals a Python walk of the trees "
          f"(shifted leaf classes fail)", flush=True)
    del fpred, f_card, f_cpu

    # 5. CascadeSVM (RBF, gamma="scale") on X's first block row in 64 chunks
    xc = x[:CSVM_ROWS].rechunk(CSVM_BLOCK)
    yc = (truth[:CSVM_ROWS] < N_CLUSTERS // 2).to(torch.int32)
    plan.clear_cache()
    svm = step("csvm_fit", lambda: CascadeSVM(
        kernel="rbf", gamma="scale", sv_cap=CSVM_CAP, max_iter=CSVM_ITERS).fit(xc, yc))
    st = plan.cache_stats()
    ck(st["opt_runs"] == 1 and st["misses"] == 1 and st["hits"] == svm.n_iter_ - 1,
       f"CSVM plan counters {st} over {svm.n_iter_} iterations")
    dec = step("csvm_decision", lambda: svm.decision_function(xc))
    sacc = step("csvm_score", lambda: svm.score(xc, yc))
    xs64 = data[cidx].double()
    sv64 = svm.sv_.double()
    coef64 = (svm.dual_coef_ * svm.sv_y_).double()
    d2 = torch.cdist(xs64, sv64) ** 2
    k64 = torch.exp(-svm.gamma_ * d2)
    dec64 = k64 @ coef64 + svm.intercept_
    got = dec.collect().reshape(-1)[cidx].double()
    lim = 16 * eps * (svm.gamma_ * (((xs64 ** 2).sum(1)[:, None] + (sv64 ** 2).sum(1)[None])
                                    * k64 * coef64.abs()).sum(1)
                      + (k64 * coef64.abs()).sum(1) + abs(svm.intercept_))
    derr = float((got - dec64).abs().max())
    ck(bool(((got - dec64).abs() <= lim).all()),
       f"CSVM decision: max abs err {derr:.3e}, limit up to {float(lim.max()):.3e}")
    rot = k64 @ coef64.roll(1) + svm.intercept_
    ck.control(bool(((got - rot).abs() > lim).any()), "CSVM dual coefficients rotated")
    print(f"[10] CascadeSVM rbf on {CSVM_ROWS}x{m} in {CSVM_ROWS // CSVM_BLOCK[0]} chunks: "
          f"n_iter {svm.n_iter_}, n_sv {svm.n_sv_}, gamma {svm.gamma_:.4e}, accuracy "
          f"{sacc:.4f}; plan counters {st}; decision on {cidx.numel()} rows vs float64 "
          f"from sv_/dual_coef_/intercept_: max abs err {derr:.3e} (per-row limit "
          f"<= {float(lim.max()):.3e}; rotated dual coefficients fail)", flush=True)
    del dec, data, truth, y, g64

    # 6. ALS and sparse PCA on the Netflix Prize ratings
    R, csr, trip = sparse
    rows, cols, vals = trip
    nu, nm = R.shape
    crow = torch.zeros(nu + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=nu), 0)
    r64 = torch.sparse_csr_tensor(crow, cols, vals, size=(nu, nm))
    order = torch.argsort(cols * nu + rows)
    ccol = torch.zeros(nm + 1, dtype=torch.int64, device="cuda")
    ccol[1:] = torch.cumsum(torch.bincount(cols, minlength=nm), 0)
    rt64 = torch.sparse_csr_tensor(ccol, rows[order], vals[order], size=(nm, nu))
    del order
    row_depth = int(np.diff(csr.indptr).max())
    col_depth = int(torch.bincount(cols, minlength=nm).max())
    f = ALS_FACTORS
    last = {}
    real_step = ALS._step

    def recorded_step(self, r_, rt_, u_, v_):
        last["v"] = v_
        return real_step(self, r_, rt_, u_, v_)

    with never_densified(), patched(ALS, "_step", recorded_step):
        als = step("als_fit", lambda: ALS(n_factors=f, reg=ALS_REG, max_iter=ALS_ITERS,
                                           check_convergence=False).fit(R))
        v_prev = last["v"]
        again = step("als_fit_again", lambda: ALS(
            n_factors=f, reg=ALS_REG, max_iter=ALS_ITERS, check_convergence=False).fit(R))
    same = torch.equal(als.u_.blocks, again.u_.blocks) and torch.equal(
        als.v_.blocks, again.v_.blocks)
    ck(same, "ALS: two fits with the same seed gave other bits")
    del again
    eye = torch.eye(f, dtype=torch.float64, device="cuda")

    def half_step(r, factor, depth, what, out):
        fac = factor.collect().double()
        gm = fac.T @ fac + ALS_REG * eye
        ref = torch.sparse.mm(r, fac) @ torch.linalg.inv(gm)
        got = out.collect().double()
        cond = float(torch.linalg.cond(gm))
        scale = float(ref.abs().max())
        lim = ALS_ERRS * eps * (depth ** 0.5 + cond) * scale
        err = float((got - ref).abs().max())
        ck(err <= lim, f"ALS {what}: max abs err {err:.3e}, limit {lim:.3e}")
        zeroed = got.clone()
        zeroed[:, 0] = 0
        ck.control(float((zeroed - ref).abs().max()) > lim, f"ALS {what}: zeroed factor")
        return {"max_abs_err": err, "limit": lim, "cond": cond, "scale": scale}

    als_u = half_step(r64, v_prev, row_depth, "U = R V (VᵀV + λI)⁻¹", als.u_)
    als_v = half_step(rt64, als.u_, col_depth, "V = Rᵀ U (UᵀU + λI)⁻¹", als.v_)
    bn = NETFLIX_BLOCK[0]
    sub = ALS(n_factors=f, reg=ALS_REG)
    sub.u_, sub.v_ = als.u_[:bn], als.v_
    score = step("als_score", lambda: sub.score(R[:bn]))
    u64, v64 = sub.u_.collect().double(), als.v_.collect().double()
    k = int((rows < bn).sum())
    pr = (u64[rows[:k]] * v64[cols[:k]]).sum(1)
    sse = float(torch.trace((u64.T @ u64) @ (v64.T @ v64))) \
        - 2 * float((pr * vals[:k]).sum()) + float((vals[:k] ** 2).sum())
    rmse64 = (sse / (bn * nm)) ** 0.5
    zero_rmse = (float((vals[:k] ** 2).sum()) / (bn * nm)) ** 0.5
    srel = abs(-score - rmse64) / rmse64
    ck(srel <= VAR_RTOL, f"ALS score {score} vs float64 -{rmse64} (rel {srel:.3e})")
    ck.control(abs(zero_rmse - rmse64) / rmse64 > VAR_RTOL, "ALS score of a zero model")
    print(f"[10] ALS(f={f}, reg={ALS_REG}, {ALS_ITERS} iterations) on R: the last "
          f"half-steps against float64: U {json.dumps(als_u)}, V {json.dumps(als_v)} "
          f"(limit {ALS_ERRS}·eps32·(√depth + cond)·scale; a zeroed factor column "
          f"fails); two fits, same bits: {same}; score on R[:{bn}] {score:.9f} "
          f"(float64 {-rmse64:.9f}, rel {srel:.2e}; a zero model's {-zero_rmse:.6f})",
          flush=True)
    del sub, v_prev

    with never_densified():
        sp = step("sparse_pca_fit", lambda: PCA(n_components=SPARSE_PCA_K,
                                                 center=False).fit(R))
        sproj = step("sparse_pca_transform", lambda: sp.transform(R))
    sq64 = power64(torch, lambda q: torch.sparse.mm(rt64, torch.sparse.mm(r64, q)),
                   plin._initial_q(nm, SPARSE_PCA_K, 0, "cuda"), PCA_ITERS_DEFAULT)

    def sparse_rq(c):
        p = torch.sparse.mm(r64, c.T.contiguous())
        return (p * p).sum(0) / (nu - 1)

    srq = sparse_rq(sq64.T)
    pca_checks(torch, ck, f"PCA({SPARSE_PCA_K}, center=False) on R", sp.components_,
               sp.explained_variance_, sq64, sparse_rq, float(srq.max() / srq.min()),
               PCA_ITERS_DEFAULT)
    ref = torch.sparse.mm(r64, sp.components_.double().T.contiguous())
    got = sproj.collect()
    ck(gemm_bad(got, ref, row_depth) == 0, "sparse PCA transform beyond the limit")
    ck.control(gemm_bad(torch.zeros_like(got), ref, row_depth) > 0,
               "zeroed sparse transform")
    print(f"[10] sparse PCA transform ({nu}x{SPARSE_PCA_K}) within the GEMM limit of "
          f"float64 (depth {row_depth}; zeroed fails); R never densified", flush=True)
    del sproj, r64, rt64, ref, got

    launches = ds_counts()
    total = {k: sum(v.get(k, 0) for v in rec["launches"].values()) for k in launches}
    want = {"pca_fit": 2 * PCA_ITERS_DEFAULT + 1, "pca_transform": 1,
            "linreg_fit": 2, "ridge_fit": 2, "linreg_tsqr_fit": 0, "tsqr": 0,
            "linreg_predict": 1, "ridge_predict": 1, "linreg_tsqr_predict": 1,
            "als_fit": 2 * ALS_ITERS, "sparse_pca_fit": 0, "forest_fit": 0}
    for name, nl in want.items():
        got_n = rec["launches"][name].get("stacked_matmul", 0)
        ck(got_n == nl, f"{name}: {got_n} stacked_matmul launches, the path implies {nl}")
    ck(rec["launches"]["csvm_fit"].get("stacked_matmul", 0) >= 1,
       "the CSVM's kernel block launched no stacked_matmul")
    plain = registry.snapshot("gemm")["gemm.dispatch_plain"] - plain0
    ck(plain == 0, f"{plain} GEMMs took the plain version on the card")
    ck(total["kmeans_assign"] == 0, f"kmeans_assign launched {total['kmeans_assign']}")
    rec["wall_s"]["phase_s"] = time.perf_counter() - t_phase
    print(f"[10] card: {smi}; estimators phase: {json.dumps(rec)}; stacked_matmul "
          f"launches by route {json.dumps(total)}; plain GEMMs {plain}", flush=True)
    ck.raise_any()
    fitted = {"x": x, "xc": xc, "yc": yc, "pca": pca_est, "linreg": models["linreg"],
              "ridge": models["ridge"], "forest": forest, "csvm": svm, "als": als,
              "sparse_pca": sp}
    return total, fitted



# ---------------------------------------------------------------------------
# phase 11: the durable path
# ---------------------------------------------------------------------------

TXT_ROWS = X_BLOCK[0] + 4_096               # one full block row and a ragged tail
SVM_USERS = NETFLIX_BLOCK[0] + 1_000        # one full block row of R and a tail
RESUME_ROWS = 8 * X_BLOCK[0]                # the K-means crash/resume cut
PREDICT_ROWS = X_BLOCK[0]                   # rows the reloaded models predict on
INGEST_PEAK_ROWS = 3                        # host peak limit, in block rows
DISK_NEED = 6e9                             # bytes phase 11 writes at most at once
TXT_CHECK_ROWS = 2_000                      # text rows held to np.savetxt's bytes
OVERHEAD_RUNS = 5                           # runs timed for run_resilient's overhead


def format_e4(rows) -> bytes:
    """``rows`` (a finite float32 tensor, n x m) as ``np.savetxt(...,
    delimiter=",", fmt="%.4e")`` writes them, the digits computed on the
    tensor's device: each value is exactly ``mant / 2**p`` with a 24-bit
    ``mant``, so ``mant·10**(4-e) >> p`` in int64 is the exact decimal
    scaling, rounded half to even as printf rounds.  Values outside
    1e-7 <= |v| < 1e5 (where that product could pass int64) are formatted
    by Python."""
    import numpy as np
    import torch
    check(bool(torch.isfinite(rows).all()), "format_e4 takes finite values")
    dev = rows.device
    n, m = rows.shape
    v = rows.double().reshape(-1)
    a = v.abs()
    frac, k = torch.frexp(a)
    mant = (frac * 2.0 ** 24).long()
    p = 24 - k.long()
    nz = a > 0
    e = torch.floor(torch.log10(torch.where(nz, a, 1.0))).long()
    ok = nz & (e >= -7) & (e <= 4)
    pow10 = torch.tensor([10 ** i for i in range(12)], device=dev)
    pp = p.clamp(1, 61)

    def scaled(e):
        return mant * pow10[(4 - e).clamp(0, 11)]

    for _ in range(2):                 # floor(log10) may be one off
        fl = scaled(e) >> pp
        e = e - (ok & (fl < 10_000)).long() + (ok & (fl >= 100_000)).long()
        ok &= (e >= -7) & (e <= 4)
    num = scaled(e)
    q = num >> pp
    r = num - (q << pp)
    half = torch.ones_like(pp) << (pp - 1)
    q = q + ((r > half) | ((r == half) & (q % 2 == 1))).long()
    carry = q == 100_000
    q = torch.where(carry, 10_000, q)
    e = e + carry.long()
    q = torch.where(ok, q, 0)
    out = torch.zeros((n * m, 13), dtype=torch.uint8, device=dev)
    out[:, 0] = torch.where(torch.signbit(v), ord("-"), 0)
    for j, pos in enumerate((1, 3, 4, 5, 6)):
        out[:, pos] = ord("0") + q // 10 ** (4 - j) % 10
    out[:, 2], out[:, 7] = ord("."), ord("e")
    out[:, 8] = torch.where(e < 0, ord("-"), ord("+"))
    out[:, 9], out[:, 10] = ord("0") + e.abs() // 10, ord("0") + e.abs() % 10
    out[:, 11] = ord(",")
    out.view(n, m, 13)[:, -1, 11] = ord("\n")
    out[~nz, 1:11] = torch.tensor(list(b"0.0000e+00"), dtype=torch.uint8, device=dev)
    host = out.cpu().numpy()
    rest = (nz & ~ok).nonzero().reshape(-1).tolist()
    vals = a[rest].tolist() if rest else []
    for i, x in zip(rest, vals):
        host[i, 1:11] = np.frombuffer(("%.4e" % x).encode(), np.uint8)
    flat = host[:, :12].reshape(-1)
    return flat[flat != 0].tobytes()


def write_svmlight(path: str, csr, label: float = 0.0) -> None:
    """``csr``'s rows as svmlight lines ``label c:v ...``, features 1-based,
    each token ``f"{c + 1}:{v:.4e}"`` as ``tests/test_io.py`` writes them
    (the values of R are 1..5, so tokens come from one table per rating)."""
    import numpy as np
    vals = np.unique(csr.data)
    table = np.array([[f"{c + 1}:{v:.4e}" for v in vals]
                      for c in range(csr.shape[1])], dtype=object)
    tokens = table[csr.indices, np.searchsorted(vals, csr.data)]
    head = f"{label} "
    with open(path, "w") as f:
        for i in range(csr.shape[0]):
            f.write(head + " ".join(tokens[csr.indptr[i]:csr.indptr[i + 1]]) + "\n")


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def phase_durable(torch, smi, fitted, km, A, B, sparse):
    """Phase 11: ingestion, model files, crash and resume, and guarded
    execution on phase 4's and phase 10's arrays and fitted estimators;
    returns the ``stacked_matmul`` / ``kmeans_assign`` launches of its steps
    by route."""
    import gc
    import shutil
    import tempfile
    import tracemalloc
    import numpy as np
    import scipy.sparse as ssp
    import repro_torch as rt
    import repro_torch.resilience as R
    from repro_torch.algorithms import ALS, KMeans
    from repro_torch.checkpoint import latest_step
    from repro_torch.core import io as rio
    from repro_torch.estimators import CascadeSVM, load_model
    from repro_torch.kernels.matmul.ref import stacked_matmul_ref
    from repro_torch.obs import registry

    t_phase = time.perf_counter()
    rec = {"wall_s": {}, "launches": {}, "added_mb": {}, "rates": {}}
    x, xc = fitted["x"], fitted["xc"]
    R_, csr, _ = sparse
    n, m = x.shape
    blockrow_bytes = X_BLOCK[0] * X_BLOCK[1] * 4

    def step(name, fn):
        """``fn()`` with its launches (counts zeroed before, read after),
        CUDA-synchronised wall seconds and added peak device memory.  No
        garbage collection per step: at ~0.2 s each on this phase's heap,
        its 55 steps would spend ~10 s collecting; the phase collects
        where it reads memory."""
        ds_counts(zero=True)
        out = est_step(torch, rec, name, fn, collect=False)
        rec["launches"][name] = {k: v for k, v in ds_counts().items() if v}
        return out

    def say(what):
        print(f"[11] {what} (card: {smi})", flush=True)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    try:
        free = shutil.disk_usage(tmp).free
        check(free >= DISK_NEED, f"{tmp}: {free / 1e9:.1f} GB free, phase 11 "
                                 f"writes up to {DISK_NEED / 1e9:.1f} GB")
        say(f"scratch {tmp}: {free / 1e9:.1f} GB free")

        # 1. ingestion ------------------------------------------------------
        npy = os.path.join(tmp, "x.npy")
        t0 = time.perf_counter()
        host_x = x.collect().cpu().numpy()
        np.save(npy, host_x)
        rec["wall_s"]["npy_write"] = time.perf_counter() - t0
        head = host_x[:TXT_ROWS].copy()
        del host_x
        gc.collect()
        tracemalloc.start()
        loaded = step("load_npy_rows", lambda: rio.load_npy_rows(npy, X_BLOCK,
                                                                 device="cuda"))
        _, host_peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        check(loaded.shape == x.shape and loaded.block_shape == x.block_shape
              and loaded.pad_state == x.pad_state, f"loaded {loaded} vs {x}")
        check(torch.equal(loaded.blocks, x.blocks), "load_npy_rows: not X's bits")
        check(host_peak <= INGEST_PEAK_ROWS * blockrow_bytes,
              f"load_npy_rows host peak {host_peak} > {INGEST_PEAK_ROWS} block rows")
        gbs = n * m * 4 / rec["wall_s"]["load_npy_rows"] / 1e9
        rec["rates"]["load_npy_rows_GBps"] = gbs
        rec["rates"]["load_npy_rows_host_peak_blockrows"] = host_peak / blockrow_bytes
        say(f"load_npy_rows {n}x{m} blocks {X_BLOCK}: X's bits; "
            f"{rec['wall_s']['load_npy_rows']:.3f} s ({gbs:.2f} GB/s); host "
            f"tracemalloc peak {host_peak / 1e6:.1f} MB ({host_peak / blockrow_bytes:.2f} "
            f"block rows, limit {INGEST_PEAK_ROWS}); added device peak "
            f"{rec['added_mb']['load_npy_rows']:.0f} MB (the block rows and their "
            f"stack: X twice)")
        del loaded
        # a fault at block row 3: the load raises, the card holds nothing more
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        raised = None
        with R.inject(R.FaultSpec(kind="io", site="io_load",
                                  where={"source": "load_npy_rows",
                                         "block_row": 3})) as (armed,):
            try:
                rio.load_npy_rows(npy, X_BLOCK, device="cuda")
            except R.IOLoadError as exc:
                raised = str(exc)
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        check(raised is not None and armed.fired == 1,
              "an io_load fault at block row 3 did not raise IOLoadError")
        check(after == before, f"memory_allocated {before} before the failed load, "
                               f"{after} after")
        say(f"io_load fault at block row 3 of the .npy load: IOLoadError ({raised}); "
            f"memory_allocated {before} before and after")
        os.remove(npy)

        txt = os.path.join(tmp, "x.txt")
        t0 = time.perf_counter()
        text = format_e4(x.collect()[:TXT_ROWS])
        with open(txt, "wb") as f:
            f.write(text)
        rec["wall_s"]["txt_write"] = time.perf_counter() - t0
        # the card's digits are np.savetxt's: its own bytes on the first rows
        with io.BytesIO() as b:
            np.savetxt(b, head[:TXT_CHECK_ROWS], delimiter=",", fmt="%.4e")
            check(text.startswith(b.getvalue()),
                  "format_e4 differs from np.savetxt(fmt='%.4e') on X's first rows")
        del text
        txt_mb = os.path.getsize(txt) / 1e6
        t0 = time.perf_counter()
        oracle = rt.from_array(np.loadtxt(txt, delimiter=",", dtype=np.float32,
                                          ndmin=2), X_BLOCK, device="cuda")
        rec["wall_s"]["txt_oracle"] = time.perf_counter() - t0
        got = step("load_txt_file", lambda: rio.load_txt_file(txt, X_BLOCK,
                                                              device="cuda"))
        check(got.shape == (TXT_ROWS, m) and got.stacked_grid == (2, 1),
              f"load_txt_file shape {got.shape}, grid {got.stacked_grid}")
        check(torch.equal(got.blocks, oracle.blocks) and got.pad_state == oracle.pad_state,
              "load_txt_file: not the bits of from_array(np.loadtxt(path))")
        close = float((got.collect() - torch.from_numpy(head).cuda()).abs().max())
        mbs = txt_mb / rec["wall_s"]["load_txt_file"]
        rec["rates"]["load_txt_file_MBps"] = mbs
        say(f"load_txt_file {TXT_ROWS}x{m} (%.4e, {txt_mb:.1f} MB, formatted on the card "
            f"and written in {rec['wall_s']['txt_write']:.2f} s, the first "
            f"{TXT_CHECK_ROWS} rows np.savetxt's bytes): the bits of "
            f"from_array(np.loadtxt) ({rec['wall_s']['txt_oracle']:.2f} s); "
            f"{rec['wall_s']['load_txt_file']:.2f} s ({mbs:.1f} MB/s); max |x - X| "
            f"{close:.2e} (the %.4e rounding)")
        del got, oracle, head
        os.remove(txt)

        svm = os.path.join(tmp, "r.svm")
        sub = csr[:SVM_USERS]
        t0 = time.perf_counter()
        write_svmlight(svm, sub)
        rec["wall_s"]["svm_write"] = time.perf_counter() - t0
        (sx, sy) = step("load_svmlight_file", lambda: rio.load_svmlight_file(
            svm, NETFLIX_BLOCK, n_features=NETFLIX_MOVIES, device="cuda"))
        want = rt.from_scipy(sub, NETFLIX_BLOCK, device="cuda")
        sx.check_invariants()
        check(sx.block_format == "bcoo" and sx.blocks.nse == want.blocks.nse
              and torch.equal(sx.blocks.data, want.blocks.data)
              and torch.equal(sx.blocks.indices, want.blocks.indices),
              "load_svmlight_file: not from_scipy's stacked COO")
        check(sy.shape == (SVM_USERS, 1) and bool((sy.collect() == 0).all()),
              "load_svmlight_file labels")
        svm_s = rec["wall_s"]["svm_write"] + rec["wall_s"]["load_svmlight_file"]
        say(f"load_svmlight_file of R's first {SVM_USERS} users ({sub.nnz} ratings, "
            f"{os.path.getsize(svm) / 1e6:.1f} MB, 1-based): from_scipy's stacked COO "
            f"(nse {sx.blocks.nse}), invariants hold; write "
            f"{rec['wall_s']['svm_write']:.2f} s + parse "
            f"{rec['wall_s']['load_svmlight_file']:.2f} s = {svm_s:.2f} s")
        del sx, sy, want, sub
        os.remove(svm)

        npz = os.path.join(tmp, "r.npz")
        t0 = time.perf_counter()
        ssp.save_npz(npz, csr, compressed=False)
        rec["wall_s"]["npz_write"] = time.perf_counter() - t0
        back = step("load_npz_sparse", lambda: rio.load_npz_sparse(
            npz, NETFLIX_BLOCK, device="cuda"))
        check(back.shape == R_.shape and back.blocks.nse == R_.blocks.nse
              and torch.equal(back.blocks.data, R_.blocks.data)
              and torch.equal(back.blocks.indices, R_.blocks.indices),
              "load_npz_sparse: not R's triplets")
        say(f"load_npz_sparse of R ({csr.nnz} ratings, {os.path.getsize(npz) / 1e9:.2f} "
            f"GB uncompressed): R's stacked COO; write {rec['wall_s']['npz_write']:.2f} s, "
            f"load {rec['wall_s']['load_npz_sparse']:.2f} s")
        del back
        os.remove(npz)

        # 2. model files ----------------------------------------------------
        xs = x[:PREDICT_ROWS]
        rs = R_[:NETFLIX_BLOCK[0]]
        pairs = [(0, 0), (NETFLIX_USERS // 4, NETFLIX_MOVIES // 3),
                 (NETFLIX_USERS - 1, NETFLIX_MOVIES - 1)]

        def outputs(name, est):
            if name == "kmeans":
                return {"predict": est.predict(xs).blocks}
            if name in ("pca", "sparse_pca"):
                return {"transform": est.transform(rs if name == "sparse_pca"
                                                   else xs).blocks}
            if name == "csvm":
                return {"decision": est.decision_function(xc).blocks}
            if name == "als":
                return {"u_": est.u_.blocks, "v_": est.v_.blocks,
                        "predict": torch.tensor([est.predict(i, j) for i, j in pairs])}
            return {"predict": est.predict(xs).blocks}

        models = {"kmeans": km, "pca": fitted["pca"], "linreg": fitted["linreg"],
                  "ridge": fitted["ridge"], "forest": fitted["forest"],
                  "csvm": fitted["csvm"], "als": fitted["als"],
                  "sparse_pca": fitted["sparse_pca"]}
        files = {}
        for name, est in models.items():
            d = os.path.join(tmp, "models", name)
            step(f"save_{name}", lambda: est.save_model(d))
            back = step(f"load_{name}", lambda: load_model(d, device="cuda"))
            check(type(back) is type(est), f"{name}: loaded a {type(back).__name__}")
            want = step(f"outputs_{name}", lambda: outputs(name, est))
            got = step(f"outputs_loaded_{name}", lambda: outputs(name, back))
            for key in want:
                check(torch.equal(got[key], want[key]),
                      f"{name}: the loaded model's {key} differs from the fitted one's")
            with open(os.path.join(d, "step_00000000", "manifest.json")) as f:
                man = json.load(f)
            dtypes = {e["path"]: e["dtype"] for e in man["leaves"]}
            # leaves from the device are 32-bit; host NumPy leaves keep their
            # dtype, as the reference writes them (coef_ float64, classes_)
            host_fields = {k for k, v in est._fitted_state().items()
                           if isinstance(v, np.ndarray)}
            wide = {p: t for p, t in dtypes.items()
                    if p not in host_fields and t not in ("float32", "int32")}
            check(not wide, f"{name}: device leaves saved wider than 32 bits: {wide}")
            files[name] = {"save_s": rec["wall_s"][f"save_{name}"],
                           "load_s": rec["wall_s"][f"load_{name}"],
                           "bytes": dir_bytes(d), "dtypes": dtypes,
                           "outputs_equal": sorted(want)}
        # the reloaded K-means predicts through kmeans_assign on the mma route
        kl = rec["launches"]["outputs_loaded_kmeans"]
        check(kl.get("kmeans_assign", 0) > 0
              and kl.get("kmeans_assign/mma", 0) == kl["kmeans_assign"],
              f"the loaded KMeans predict's assignments by route {kl}: want all on mma")
        rec["model_files"] = files
        say(f"save_model/load_model(device='cuda') of {len(models)} fitted estimators: "
            f"each output bit-equal to the fitted object's; {json.dumps(files)}")

        # 3. crash and resume ----------------------------------------------
        xk = x[:RESUME_ROWS]
        kw = dict(n_clusters=N_CLUSTERS, max_iter=20, tol=1e-4, seed=0)
        plain = step("kmeans_fit", lambda: KMeans(**kw).fit(xk))
        if plain.n_iter_ < 3:
            say(f"K-means converged in {plain.n_iter_} iterations at tol=1e-4: the "
                f"resume check runs with tol=0, max_iter=6")
            kw.update(tol=0.0, max_iter=6)
            plain = step("kmeans_fit", lambda: KMeans(**kw).fit(xk))
        k_crash = max(2, plain.n_iter_ // 2)
        crash = os.path.join(tmp, "kmeans_crash")

        def crashed(fit, at: int) -> int:
            """Run ``fit`` with a crash armed at fit iteration ``at``; the
            number of crashes it took (1, or 0 when it finished)."""
            with R.inject(R.FaultSpec(kind="crash", site="fit_iteration",
                                      where={"iteration": at})) as (a,):
                try:
                    fit()
                except R.CrashError:
                    return a.fired
            return 0

        fired = step("kmeans_crash", lambda: crashed(
            lambda: KMeans(**kw).fit(xk, checkpoint_dir=crash), k_crash))
        check(fired == 1, f"K-means: no crash at iteration {k_crash}")
        res = step("kmeans_resume", lambda: KMeans(**kw).fit(
            xk, checkpoint_dir=crash, resume=crash))
        # every iteration of the crashed and the resumed fit ran with
        # checkpoint_dir: the checkpointed fit is held to the plain one here
        check(res.n_iter_ == plain.n_iter_ and torch.equal(res.centers_, plain.centers_),
              f"K-means resumed at {k_crash}: n_iter {res.n_iter_} vs {plain.n_iter_}, "
              f"or other center bits")
        check(latest_step(crash) == plain.n_iter_,
              f"K-means checkpoints end at {latest_step(crash)}, not {plain.n_iter_}")
        kl = {k: sum(rec["launches"][s].get(k, 0) for s in
                     ("kmeans_fit", "kmeans_crash", "kmeans_resume"))
              for k in ("kmeans_assign", "kmeans_assign/mma")}
        check(kl["kmeans_assign"] > 0 and kl["kmeans_assign/mma"] == kl["kmeans_assign"],
              f"K-means crash/resume assignments by route {kl}: want all on mma")
        say(f"KMeans({kw}) on X's first {RESUME_ROWS} rows: n_iter {plain.n_iter_}; "
            f"checkpointed, crashed at iteration {k_crash} and resumed: the plain fit's "
            f"n_iter and center bits, a checkpoint for every iteration; kmeans_assign {kl}")

        als_ref = fitted["als"]
        als_dir = os.path.join(tmp, "als")
        als_kw = dict(n_factors=ALS_FACTORS, reg=ALS_REG, max_iter=ALS_ITERS,
                      check_convergence=False)
        fired = step("als_crash", lambda: crashed(
            lambda: ALS(**als_kw).fit(R_, checkpoint_dir=als_dir), 5))
        check(fired == 1, "ALS: no crash at iteration 5")
        als_res = step("als_resume", lambda: ALS(**als_kw).fit(
            R_, checkpoint_dir=als_dir, resume=als_dir))
        check(als_res.n_iter_ == als_ref.n_iter_
              and torch.equal(als_res.u_.blocks, als_ref.u_.blocks)
              and torch.equal(als_res.v_.blocks, als_ref.v_.blocks),
              "ALS resumed at iteration 5: u_/v_ bits differ from phase 10's fit")
        say(f"ALS({als_kw}) on R crashed at iteration 5 and resumed: u_ and v_ keep "
            f"phase 10's bits; checkpoints {dir_bytes(als_dir) / 1e6:.1f} MB")
        shutil.rmtree(als_dir)

        svm_ref = fitted["csvm"]
        svm_dir = os.path.join(tmp, "csvm")
        svm_kw = dict(kernel="rbf", gamma="scale", sv_cap=CSVM_CAP, max_iter=CSVM_ITERS)
        yc = fitted["yc"]
        fired = step("csvm_crash", lambda: crashed(
            lambda: CascadeSVM(**svm_kw).fit(xc, yc, checkpoint_dir=svm_dir), 2))
        check(fired == 1, "CSVM: no crash at iteration 2")
        svm_res = step("csvm_resume", lambda: CascadeSVM(**svm_kw).fit(
            xc, yc, checkpoint_dir=svm_dir, resume=svm_dir))
        check(svm_res.n_iter_ == svm_ref.n_iter_ and svm_res.n_sv_ == svm_ref.n_sv_
              and svm_res.intercept_ == svm_ref.intercept_
              and all(torch.equal(getattr(svm_res, f), getattr(svm_ref, f))
                      for f in ("sv_", "sv_y_", "dual_coef_")),
              "CSVM resumed at iteration 2: fitted bits differ from phase 10's fit")
        dec_res = step("csvm_resumed_decision", lambda: svm_res.decision_function(xc))
        dec_ref = step("csvm_fitted_decision", lambda: svm_ref.decision_function(xc))
        check(torch.equal(dec_res.blocks, dec_ref.blocks),
              "CSVM resumed: decision values differ")
        say(f"CascadeSVM({svm_kw}) on phase 10's cut crashed at iteration 2 and "
            f"resumed: sv_, sv_y_, dual_coef_, intercept_ and decision values keep "
            f"phase 10's bits (n_iter {svm_res.n_iter_})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 4. guarded execution -------------------------------------------------
    R.reset_stats()
    chain = A.lazy() @ B
    want = step("compute", lambda: rt.compute(chain))
    got = step("run_resilient", lambda: R.run_resilient(chain))
    st = R.stats()
    check(st == {"executions": 1, "retries": 0, "degradations": 0, "recoveries": 0,
                 "guard_failures": 0}, f"clean path resilience counters {st}")
    check(torch.equal(got.blocks, want.blocks), "run_resilient: not compute()'s bits")
    check(rec["launches"]["run_resilient"] == rec["launches"]["compute"],
          f"run_resilient launched {rec['launches']['run_resilient']}, compute() "
          f"{rec['launches']['compute']}")
    ref = stacked_matmul_ref(A.blocks.double(), B.blocks.double())
    check(gemm_bad(want.blocks, ref, SQUARE) == 0, "A @ B beyond the GEMM limit")

    def clock(fn):
        times = []
        for _ in range(OVERHEAD_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    ms_compute = step("overhead_compute", lambda: clock(lambda: rt.compute(chain)))
    ms_resilient = step("overhead_run_resilient",
                        lambda: clock(lambda: R.run_resilient(chain)))
    check(rec["launches"]["overhead_run_resilient"] == rec["launches"]["overhead_compute"],
          f"timed run_resilient launched {rec['launches']['overhead_run_resilient']}, "
          f"compute() {rec['launches']['overhead_compute']}")
    rec["wall_s"]["guard_overhead_ms"] = ms_resilient - ms_compute
    say(f"run_resilient(A @ B) {SQUARE}² f32, clean: counters {st}; compute()'s bits "
        f"and launches {rec['launches']['compute']}; {ms_resilient:.3f} ms against "
        f"compute()'s {ms_compute:.3f} ms (median of {OVERHEAD_RUNS}): adds "
        f"{ms_resilient - ms_compute:.3f} ms")

    R.reset_stats()
    with R.inject(R.FaultSpec(kind="transient", site="plan_execute", at=1)):
        again = step("transient", lambda: R.run_resilient(chain))
    st = R.stats()
    check(st["retries"] == 1 and st["degradations"] == 0 and
          torch.equal(again.blocks, want.blocks), f"transient retry: {st}")
    say(f"one injected transient: retries {st['retries']}, same bits")

    from repro_torch.kernels.matmul import kernel as mk

    def workspace_of(name, fn):
        """``step(name, fn)`` and the largest split-K workspace (bytes) a
        ``stacked_matmul`` launch of it allocated."""
        mk.stacked_matmul.max_workspace = 0
        return step(name, fn), mk.stacked_matmul.max_workspace

    def einsum_rung(name, lz):
        """``lz`` through ``run_resilient`` with an ``oom`` on the fused and
        eager rungs: its result and largest split-K workspace."""
        R.reset_stats()
        with R.inject(R.FaultSpec(kind="oom", site="plan_execute",
                                  modes=("fused", "eager"), times=None)):
            out, ws = workspace_of(name, lambda: R.run_resilient(lz))
        st = R.stats()
        check(st["degradations"] == 2 and st["recoveries"] == 1,
              f"{name}: oom ladder {st}")
        check(ws <= mk.LOW_MEMORY_WORKSPACE, f"{name}: a {ws}-byte split-K workspace "
                                             f"on the low-memory rung")
        return out, ws

    cap = mk.LOW_MEMORY_WORKSPACE
    plain0 = registry.snapshot("gemm")["gemm.dispatch_plain"]
    low, _ = einsum_rung("einsum_rung", chain)
    check(rec["launches"]["einsum_rung"] == rec["launches"]["compute"],
          f"einsum rung: launches {rec['launches']['einsum_rung']}, compute() "
          f"{rec['launches']['compute']}")
    bad = gemm_bad(low.blocks, want.blocks.double(), SQUARE)
    check(bad == 0, f"einsum rung: {bad} elements beyond the GEMM limit of the kernel's")
    err = float((low.blocks.double() - want.blocks.double()).abs().max())
    # a product whose fused split-K workspace passes the cap: the einsum rung
    # runs it within the cap, in fewer splits
    xk = x[:RESUME_ROWS]
    gram = xk.lazy().T @ xk
    fused, fused_ws = workspace_of("gram_compute", lambda: rt.compute(gram))
    one, one_ws = einsum_rung("gram_einsum_rung", gram)
    check(fused_ws > cap and rec["launches"]["gram_einsum_rung"].get("stacked_matmul", 0) > 0,
          f"Gram: fused workspace {fused_ws} bytes (want > {cap}), einsum rung "
          f"launches {rec['launches']['gram_einsum_rung']}")
    g64 = stacked_matmul_ref(xk.blocks.double(), xk.blocks.double(), transpose_a=True)
    bad = (gemm_bad(fused.blocks, g64, RESUME_ROWS), gemm_bad(one.blocks, g64, RESUME_ROWS))
    check(bad == (0, 0), f"Gram: elements beyond the GEMM limit (fused, einsum rung) {bad}")
    gerr = float((one.blocks.double() - fused.blocks.double()).abs().max())
    plain = registry.snapshot("gemm")["gemm.dispatch_plain"] - plain0
    check(plain == 0, f"{plain} GEMMs took the plain version on the card")
    say(f"oom injected on the fused and eager rungs: degradations 2; the einsum rung "
        f"launched {rec['launches']['einsum_rung']} (compute()'s) in "
        f"{rec['wall_s']['einsum_rung']:.3f} s, within the GEMM limit of the kernel's "
        f"(max abs diff {err:.3e}); Xᵀ X on {RESUME_ROWS} rows: fused split-K workspace "
        f"{fused_ws} bytes in {rec['wall_s']['gram_compute']:.4f} s, einsum rung "
        f"{one_ws} bytes (cap {cap}) in {rec['wall_s']['gram_einsum_rung']:.4f} s, "
        f"both within the GEMM limit of float64, max abs diff {gerr:.3e}; plain GEMMs "
        f"on the card {plain}")
    rec["rates"]["gram_workspace_bytes"] = {"fused": fused_ws, "einsum_rung": one_ws}
    del low, ref, fused, one, g64

    total = torch.cuda.mem_get_info()[1]
    kind = None
    try:
        torch.empty(2 * total, dtype=torch.uint8, device="cuda")
    except torch.cuda.OutOfMemoryError as exc:
        kind = R.classify_error(exc)
    check(kind == R.OOM, f"a {2 * total / 1e9:.0f} GB torch.empty classified {kind}")
    probe = torch.ones(1 << 20, device="cuda")
    check(float(probe.sum()) == float(1 << 20), "the allocation after an OOM failed")
    del probe
    say(f"torch.empty of {2 * total / 1e9:.0f} GB: torch.cuda.OutOfMemoryError, "
        f"classified {kind!r}; the next allocation succeeds")

    R.reset_stats()

    def poisoned():
        with R.inject(R.FaultSpec(kind="poison", site="plan_result", block=(1, 2))):
            try:
                R.run_resilient(chain, guard="finite")
            except R.NumericalDivergence as exc:
                return exc
        return None

    caught = step("poison", poisoned)
    check(caught is not None and "block (1, 2)" in str(caught)
          and [(b.gi, b.gj) for b in caught.report.bad_blocks] == [(1, 2)],
          f"poisoned block (1, 2): {caught!r}")
    check(R.stats()["guard_failures"] == 1, f"guard counters {R.stats()}")
    rep = step("finite_report", want.finite_report)
    check(rep.ok, f"finite_report of the clean result: {rep.describe()}")
    say(f"NaN poisoned into block (1, 2) under guard='finite': "
        f"NumericalDivergence ({caught}); finite_report of the clean result: "
        f"{rep.describe()}")
    del caught, want, got, again

    launches = {}
    for counts in rec["launches"].values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    rec["wall_s"]["phase_s"] = time.perf_counter() - t_phase
    print(f"[11] card: {smi}; durable phase: {json.dumps(rec)}; launches {launches}",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 12: the predict server and the plan profiler
# ---------------------------------------------------------------------------

SERVE_ROWS, SERVE_FEATURES = 131_072, 4_096      # bench_serve.py's width
SERVE_BLOCK = (16_384, SERVE_FEATURES)
SERVE_BATCHES = (1, 8, 32, 128)                  # bench_serve.py:35-38
SERVE_BLOCK_ROWS = 128
SERVE_DENSITY = 0.01
SERVE_NSE = max(64, int(SERVE_BLOCK_ROWS * SERVE_FEATURES * SERVE_DENSITY * 4))
SERVE_STREAM = 64                                # requests per stream
SERVE_CLIENTS, SERVE_CLIENT_REQUESTS = 4, 32
SERVE_SPEC = {"batch_sizes": SERVE_BATCHES, "block_rows": SERVE_BLOCK_ROWS,
              "formats": ("dense", "bcoo"), "nse": SERVE_NSE}


def serve_payload(rng, fmt: str, rows: int, centers=None):
    """One request: ``rows`` x SERVE_FEATURES normal rows, or the same at
    SERVE_DENSITY as a CSR matrix; with ``centers``, K-means rows (a center
    plus unit noise)."""
    import numpy as np
    import scipy.sparse as ssp
    if centers is not None:
        pick = rng.integers(0, centers.shape[0], rows)
        return (centers[pick] + rng.normal(size=(rows, centers.shape[1]))
                ).astype(np.float32)
    if fmt == "dense":
        return rng.normal(size=(rows, SERVE_FEATURES)).astype(np.float32)
    return ssp.random(rows, SERVE_FEATURES, density=SERVE_DENSITY, format="csr",
                      random_state=rng, dtype=np.float32)


def serve_first(mode: str, model_dir: str) -> dict:
    """``--serve-first`` (a child process of phase 12): seconds from
    ``import repro_torch`` to the first served response of the saved Ridge,
    registered with ``warm=True`` or ``warm=False``."""
    import numpy as np
    t0 = time.perf_counter()
    import repro_torch.serve as serve
    t_import = time.perf_counter()
    reg = serve.ModelRegistry(device="cuda")
    reg.load("ridge", model_dir, warm=mode == "warm", **SERVE_SPEC)
    t_load = time.perf_counter()
    srv = serve.PredictServer(reg)
    fut = srv.submit("ridge", np.ones((1, SERVE_FEATURES), np.float32))
    srv.pump()
    fut.result()
    t_first = time.perf_counter()
    return {"mode": mode, "import_s": t_import - t0, "load_s": t_load - t_import,
            "first_request_s": t_first - t_load, "total_s": t_first - t0}


def steady_faults(cs0, cs1, st, n_plan: int, n_eager: int):
    """What breaks the steady state between plan counters ``cs0`` and
    ``cs1`` over a stream whose serve counters are ``st``: a re-optimised
    or rebuilt plan, a cache miss, a plan request that missed the warmed
    run, or any shed, fallback, retry or failure."""
    faults = [f"plan.{k} {cs0[k]} -> {cs1[k]}"
              for k in ("opt_runs", "misses", "aot_compiles") if cs1[k] != cs0[k]]
    want = {"requests": n_plan + n_eager, "responses": n_plan + n_eager,
            "cache_hits": n_plan, "eager_requests": n_eager}
    faults += [f"{k} {st[k]} (want {v})" for k, v in want.items() if st[k] != v]
    faults += [f"{k} {st[k]}" for k in ("cache_misses", "failures", "batch_sheds",
                                        "bucket_fallbacks", "dispatch_retries",
                                        "single_dispatches") if st[k]]
    return faults


def route_faults(counts, gemms: int, assigns: int):
    """Launches of one step against the path's: ``gemms`` stacked_matmul
    launches, all on the card's SIMT route (f32), and ``assigns``
    kmeans_assign launches, all on the mma route."""
    want = {"stacked_matmul": gemms, "stacked_matmul/simt": gemms,
            "kmeans_assign": assigns, "kmeans_assign/mma": assigns}
    return [f"{k} {counts.get(k, 0)} (want {v})" for k, v in want.items()
            if counts.get(k, 0) != v] + \
        [f"{k} {v}" for k, v in counts.items() if k not in want and v]


def serve_gemm_case(torch, a, b):
    """The served product alone, ``(1, 1, 128, 4096) @ (1, 1, 4096, 1)`` f32:
    the kernel (its route checked) against its plain version, times beside
    the bound and ``torch.matmul``."""
    from repro_torch.kernels.matmul import kernel as mk
    from repro_torch.kernels.matmul.ref import stacked_matmul_ref
    rows, k = a.shape[2], a.shape[3]
    label = f"served Ridge product ({rows}x{k}) @ ({k}x1) f32, simt"
    f32 = torch.float32
    out = routed(lambda: mk.stacked_matmul(a, b, out_dtype=f32), mk.stacked_matmul,
                 "simt", label)
    err = gemm_close(out, stacked_matmul_ref(a.double(), b.double()), k)
    flops, nbytes = 2.0 * rows * k, 4.0 * (rows * k + k + rows)
    b_ms, b_by = bound(flops, nbytes, "fp32")
    a2d, b2d = a[0, 0], b[0, 0]
    row = {"case": label, "ms": timed(lambda: mk.stacked_matmul(a, b, out_dtype=f32)),
           "plain_ms": timed(lambda: stacked_matmul_ref(a, b, out_dtype=f32)),
           "library_ms": timed(lambda: torch.matmul(a2d, b2d)),
           "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes,
           "max_abs_err": err}
    print(f"[12] {label}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, library "
          f"{row['library_ms']:.4f}, bound {b_ms:.5f} by {b_by})", flush=True)
    return row


def phase_serve(torch, seed, smi, km, A, B):
    """Phase 12: the predict server over a Ridge at bench_serve.py's width
    and phase 4's K-means, and the plan profiler on the card; returns the
    ``stacked_matmul`` / ``kmeans_assign`` launches of its steps by route."""
    import shutil
    import tempfile
    import threading
    import numpy as np
    import repro_torch.resilience as R
    import repro_torch.serve as serve
    import repro_torch as rt
    from repro_torch import obs
    from repro_torch.core import costmodel, plan
    from repro_torch.estimators import Ridge
    from repro_torch.serve.batching import assemble

    t_phase = time.perf_counter()
    rec = {"wall_s": {}, "launches": {}, "added_mb": {}, "rates": {}}
    ck = Checks("[12]")
    n, m = SERVE_ROWS, SERVE_FEATURES

    def step(name, fn):
        """``fn()`` with its launches (counts zeroed before, read after),
        CUDA-synchronised wall seconds and added peak device memory."""
        ds_counts(zero=True)
        out = est_step(torch, rec, name, fn, collect=False)
        rec["launches"][name] = {k: v for k, v in ds_counts().items() if v}
        return out

    def say(what):
        print(f"[12] {what} (card: {smi})", flush=True)

    def plain_gemms():
        return obs.registry.snapshot("gemm")["gemm.dispatch_plain"]

    def host(t):
        return t.collect().cpu().numpy()

    def counters():
        st = dict(serve.stats())
        st.pop("latency")
        return st

    # 1. the models ----------------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    xs = torch.randn(n, m, generator=gen, device="cuda")
    w_true = torch.randn(m, generator=gen, device="cuda") / m ** 0.5
    y = (xs @ w_true + 0.5 + 0.1 * torch.randn(n, generator=gen, device="cuda"))
    X = rt.from_array(xs, SERVE_BLOCK, device="cuda")
    del xs
    ridge = step("ridge_fit", lambda: Ridge(alpha=0.1).fit(X, y.cpu().numpy()))
    del X, y
    coef_err = float(np.abs(ridge.coef_ - w_true.double().cpu().numpy()).max())
    ck(coef_err < 0.01 and abs(ridge.intercept_ - 0.5) < 0.01,
       f"Ridge fit: max |coef - w| {coef_err:.3e}, intercept {ridge.intercept_}")
    ck.control(float(np.abs(w_true.double().cpu().numpy()).max()) >= 0.01,
               "zero coefficients")
    say(f"Ridge(alpha=0.1) on {n} x {m} f32 (blocks {SERVE_BLOCK}): "
        f"{rec['wall_s']['ridge_fit']:.3f} s, max |coef - w| {coef_err:.3e}; "
        f"launches {rec['launches']['ridge_fit']}")
    w32 = torch.as_tensor(ridge.coef_.astype(np.float32), device="cuda").double()
    b0 = float(ridge.intercept_)
    centers = km.centers_.double()
    c_host = km.centers_.cpu().numpy()
    rng = np.random.default_rng(seed + 12)
    row1 = serve_payload(rng, "dense", 1)

    def first_request(reg):
        srv = serve.PredictServer(reg)
        t0 = time.perf_counter()
        fut = srv.submit("ridge", row1)
        srv.pump()
        fut.result()
        return time.perf_counter() - t0

    # 2. cold and warm registration, the first request of each ---------------
    plan.clear_cache()
    serve.reset_stats()
    cold = serve.ModelRegistry(device="cuda")
    cold_cs0 = plan.cache_stats()
    step("register_cold", lambda: cold.register("ridge", ridge, warm=False,
                                                **SERVE_SPEC))
    cold_s = step("first_request_cold", lambda: first_request(cold))
    cold_faults = steady_faults(cold_cs0, plan.cache_stats(), counters(), 1, 0)
    ck.control(cold_faults, "a cold registry's first request")
    plan.clear_cache()
    serve.reset_stats()
    reg = serve.ModelRegistry(device="cuda")
    step("load_ridge", lambda: reg.register("ridge", ridge, **SERVE_SPEC))
    warm_cs = plan.cache_stats()
    ck(warm_cs["aot_compiles"] == 2 * len(SERVE_BATCHES),
       f"warm-up built {warm_cs['aot_compiles']} runs, want {2 * len(SERVE_BATCHES)}")
    warm_s = step("first_request_warm", lambda: first_request(reg))
    ck(rec["launches"]["load_ridge"].get("stacked_matmul/simt", 0)
       == len(SERVE_BATCHES), f"warm-up launches {rec['launches']['load_ridge']}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        mdir = os.path.join(tmp, "ridge")
        step("save_ridge", lambda: ridge.save_model(mdir, version=2))
        v2 = step("load_ridge_v2", lambda: reg.load("ridge", mdir, version=2,
                                                    **SERVE_SPEC))
        kmm = step("load_kmeans", lambda: reg.register(
            "kmeans", km, n_features=N_FEATURES, batch_sizes=SERVE_BATCHES,
            block_rows=SERVE_BLOCK_ROWS))
        ck(reg.get("ridge") is v2 and reg.versions("ridge") == [0, 2],
           f"ridge versions {reg.versions('ridge')}")
        ck(not route_faults(rec["launches"]["load_kmeans"], 0, len(SERVE_BATCHES)),
           f"K-means warm-up launches {rec['launches']['load_kmeans']}")
        ck(plan.cache_stats()["aot_compiles"] == warm_cs["aot_compiles"],
           "version 2 rebuilt runs its structure shares with version 0")
        say(f"first request: cold registry {cold_s * 1e3:.3f} ms (plan optimised and "
            f"built on the request: {cold_faults}), warm {warm_s * 1e3:.3f} ms; load s: "
            f"ridge {rec['wall_s']['load_ridge']:.3f} (8 buckets warmed), ridge v2 from "
            f"its model file {rec['wall_s']['load_ridge_v2']:.3f}, K-means "
            f"{rec['wall_s']['load_kmeans']:.3f}")

        # 3. the streams: 64 requests each, submitted, pumped, awaited ------
        streams = [("ridge", "dense", b) for b in SERVE_BATCHES] + \
                  [("ridge", "bcoo", b) for b in SERVE_BATCHES] + \
                  [("kmeans", "dense", b) for b in SERVE_BATCHES]
        payloads = {key: [serve_payload(rng, key[1], key[2],
                                        c_host if key[0] == "kmeans" else None)
                          for _ in range(SERVE_STREAM)] for key in streams}
        srv = serve.PredictServer(reg)
        served, stream_rates = {}, {}

        def stream(key):
            outs, lats = [], []
            t0 = time.perf_counter()
            for p in payloads[key]:
                fut = srv.submit(key[0], p)
                srv.pump()
                outs.append(fut.result())
                lats.append(fut.latency)
            wall = time.perf_counter() - t0
            lats.sort()
            return outs, {"p50_us": lats[len(lats) // 2] * 1e6,
                          "p99_us": lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1e6,
                          "requests_per_s": len(lats) / wall,
                          "rows_per_s": len(lats) * key[2] / wall}

        serve.reset_stats()
        cs0, plain0 = plan.cache_stats(), plain_gemms()
        for key in streams:
            name = "stream_%s_%s_%d" % key
            served[key], stream_rates[name] = step(name, lambda key=key: stream(key))
        cs1, st1, plain1 = plan.cache_stats(), counters(), plain_gemms()
        n_plan = 8 * SERVE_STREAM
        faults = steady_faults(cs0, cs1, st1, n_plan, 4 * SERVE_STREAM)
        ck(not faults, f"steady state: {faults}")
        ck(plain1 == plain0, f"{plain1 - plain0} GEMMs took the plain version on the card")
        per_request = {}
        for key in streams:
            name = "stream_%s_%s_%d" % key
            got = rec["launches"][name]
            want = (SERVE_STREAM, 0) if key[:2] == ("ridge", "dense") else \
                (0, SERVE_STREAM) if key[0] == "kmeans" else (0, 0)
            bad = route_faults(got, *want)
            ck(not bad, f"{name}: launches {bad}")
            per_request[name] = {k: v / SERVE_STREAM for k, v in got.items()}
        rec["rates"]["streams"] = stream_rates
        rec["rates"]["launches_per_request"] = per_request
        say(f"streams of {SERVE_STREAM} requests (model, format, rows): "
            + "; ".join(f"{k[len('stream_'):]} p50 {v['p50_us']:.1f} µs, p99 "
                        f"{v['p99_us']:.1f} µs, {v['requests_per_s']:.1f} req/s"
                        for k, v in stream_rates.items()))
        say(f"steady state over {len(streams) * SERVE_STREAM} requests: plan counters "
            f"{cs0} -> {cs1}; serve {st1}; plain GEMMs {plain1 - plain0}; launches per "
            f"request {json.dumps(per_request)}")

        # served rows against predict on the padded bucket batch, the lone
        # row against a direct predict, every result against float64
        mismatch, lone = 0, 0
        for key in streams:
            model = reg.get(key[0])
            for p, out in zip(payloads[key], served[key]):
                bucket = model.spec.bucket_for(key[2], key[1])
                want = host(model.estimator.predict(assemble([p], bucket)))
                mismatch += not np.array_equal(out, want[:key[2]])
                if key[2] == 1:
                    lone += not np.array_equal(out, model.predict_direct(p))
        ck(mismatch == 0, f"{mismatch} served results differ from predict on the "
                          f"padded batch")
        ck(lone == 0, f"{lone} one-row results differ from a direct predict")
        out0 = served[streams[1]][0]
        ck.control(not np.array_equal(np.nextafter(out0, np.inf), out0),
                   "one ulp off the served rows")
        ck.control(not np.array_equal(
            reg.get("ridge").predict_direct(payloads[streams[0]][1]),
            served[streams[0]][0]), "another row's direct predict")
        errs = {}
        for fmt in ("dense", "bcoo"):
            keys = [k for k in streams if k[:2] == ("ridge", fmt)]
            rows = np.concatenate([p if fmt == "dense" else p.toarray()
                                   for k in keys for p in payloads[k]])
            got = torch.as_tensor(np.concatenate([o for k in keys for o in served[k]]),
                                  device="cuda").ravel()
            p64 = torch.as_tensor(rows, device="cuda").double()
            ref = p64 @ w32 + b0
            bad = gemm_bad(got, ref, m)
            ck(bad == 0, f"ridge {fmt}: {bad} results beyond the GEMM limit of float64")
            ck.control(gemm_bad(torch.zeros_like(got), ref, m) > 0, f"{fmt}: zeroed")
            ck.control(gemm_bad((tf32(p64.float()).double() @ tf32(w32.float()).double()
                                 + b0).float(), ref, m) > 0,
                       f"{fmt}: TF32-rounded inputs")
            errs[fmt] = float((got.double() - ref).abs().max())
        keys = [k for k in streams if k[0] == "kmeans"]
        krows = torch.as_tensor(np.concatenate([p for k in keys for p in payloads[k]]),
                                device="cuda")
        klab = torch.as_tensor(np.concatenate([o for k in keys for o in served[k]]),
                               device="cuda").ravel()
        want = torch.argmin(sq_dists(krows.double(), centers), dim=1)
        near, other, cap, kerr = label_faults(krows, centers, klab, want)
        ck(other == 0 and near <= cap, f"K-means served labels: {other} differ beyond "
                                       f"near-ties, {near} near-ties (cap {cap})")
        ck.control(label_faults(krows, centers, (klab + 1) % N_CLUSTERS, want)[1] > 0,
                   "labels shifted by one")
        say(f"every served result is the bits of predict on its padded bucket batch "
            f"({mismatch} differ; a lone row the bits of a direct predict: {lone} "
            f"differ); ridge within the GEMM limit of float64 (max abs err dense "
            f"{errs['dense']:.3e}, bcoo {errs['bcoo']:.3e}); K-means labels the float64 "
            f"argmin on {krows.shape[0]} rows ({near} near-ties)")

        # 4. injected faults: each bumps exactly its own counter -------------
        p5 = serve_payload(rng, "dense", 5)
        bucket8 = reg.get("ridge").spec.bucket_for(5, "dense")
        want5 = host(ridge.predict(assemble([p5], bucket8)))[:5]

        def one(specs, payload_list):
            serve.reset_stats()
            with R.inject(*specs):
                futs = [srv.submit("ridge", p) for p in payload_list]
                srv.pump()
            return [f.result() for f in futs], counters()

        clean = {"requests": 1, "responses": 1, "batches": 1, "batched_requests": 1,
                 "cache_hits": 1, "queue_depth_peak": 1}

        def delta(st):
            return {k: v for k, v in st.items() if v}

        outs, st = step("fault_none", lambda: one([], [p5]))
        ck(delta(st) == clean and np.array_equal(outs[0], want5), f"clean request {st}")
        outs, st_tr = step("fault_transient", lambda: one(
            [R.FaultSpec(kind="transient", site="serve_dispatch", times=1)], [p5]))
        want_t = dict(clean, dispatch_retries=1)
        ck(delta(st_tr) == want_t and np.array_equal(outs[0], want5),
           f"transient at serve_dispatch: {delta(st_tr)}")
        ck.control(clean != want_t, "the clean request's counters")
        p3, p2 = serve_payload(rng, "dense", 3), serve_payload(rng, "dense", 2)
        outs, st = step("fault_shed", lambda: one(
            [R.FaultSpec(kind="crash", site="serve_dispatch", times=None,
                         where={"mode": "batched"})], [p3, p2]))
        want_s = {"requests": 2, "responses": 2, "single_dispatches": 2,
                  "batch_sheds": 1, "queue_depth_peak": 2}
        direct = [reg.get("ridge").predict_direct(p) for p in (p3, p2)]
        ck(delta(st) == want_s and all(np.array_equal(o, d) for o, d in zip(outs, direct)),
           f"batched crash at serve_dispatch: {delta(st)}")
        for name, gemms in (("fault_none", 1), ("fault_transient", 1), ("fault_shed", 2)):
            bad = route_faults(rec["launches"][name], gemms, 0)
            ck(not bad, f"{name}: launches {bad}")
        say(f"faults: a transient at serve_dispatch -> {delta(st_tr)}; a crash of "
            f"every batched dispatch -> {delta(st)}, each request the bits of its direct "
            f"predict (the shed path launched {rec['launches']['fault_shed']})")

        # 5. four client threads against the started server -----------------
        serve.reset_stats()
        cs_t0, plain_t0 = plan.cache_stats(), plain_gemms()
        got_t = [None] * SERVE_CLIENTS
        crng = np.random.default_rng(seed + 100)
        client_payloads = [[serve_payload(crng, "dense", int(crng.integers(1, 9)))
                            for _ in range(SERVE_CLIENT_REQUESTS)]
                           for _ in range(SERVE_CLIENTS)]

        def client(i):
            futs = [(p, srv.submit("ridge", p)) for p in client_payloads[i]]
            got_t[i] = [(p, f.result(timeout=120), f.latency) for p, f in futs]

        def threaded():
            srv.start()
            try:
                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(SERVE_CLIENTS)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                return time.perf_counter() - t0
            finally:
                srv.stop()

        wall = step("threaded", threaded)
        total = SERVE_CLIENTS * SERVE_CLIENT_REQUESTS
        ck(all(g is not None for g in got_t), "a client thread did not finish")
        done = [r for g in got_t if g for r in g]
        st_t = counters()
        faults = steady_faults(cs_t0, plan.cache_stats(), st_t, total, 0)
        ck(not faults and plain_gemms() == plain_t0, f"threaded stream: {faults}")
        ck(len(done) == total, f"{len(done)} of {total} threaded requests answered")
        if done:
            p64 = torch.as_tensor(np.concatenate([p for p, _, _ in done]),
                                  device="cuda").double()
            got = torch.as_tensor(np.concatenate([o for _, o, _ in done]),
                                  device="cuda").ravel()
            bad = gemm_bad(got, p64 @ w32 + b0, m)
            ck(bad == 0, f"threaded stream: {bad} results beyond the GEMM limit")
            lats = sorted(lat for _, _, lat in done)
            stream_rates["threaded_ridge_dense_1_8"] = {
                "p50_us": lats[len(lats) // 2] * 1e6,
                "p99_us": lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1e6,
                "requests_per_s": len(lats) / wall,
                "rows_per_s": p64.shape[0] / wall, "batches": st_t["batches"]}
        say(f"{SERVE_CLIENTS} client threads x {SERVE_CLIENT_REQUESTS} requests of 1-8 "
            f"rows: {json.dumps(stream_rates.get('threaded_ridge_dense_1_8'))}; "
            f"serve {st_t}; launches {rec['launches']['threaded']}")

        # 6. the device's busy share over the 128-row dense stream ----------
        prof = step("profiled_stream", lambda: device_profile(
            torch, lambda: stream(("ridge", "dense", 128)),
            f"{SERVE_STREAM} served 128-row dense Ridge requests", tag="[12]"))
        ck(not route_faults(rec["launches"]["profiled_stream"], SERVE_STREAM, 0),
           f"profiled stream: launches {rec['launches']['profiled_stream']}")
        rec["rates"]["busy_share_128_dense"] = (
            prof["busy_ms"] / prof["wall_ms"] if prof["busy_ms"] is not None else None)

        # the served GEMM alone: a 128-row bucket batch times the weights
        gemv = serve_gemm_case(torch, assemble(
            [serve_payload(rng, "dense", 128)],
            reg.get("ridge").spec.bucket_for(128, "dense")).blocks,
            ridge._weights_ds(m, "cuda").blocks)

        # 7. the profiler: every node's bytes are the cost model's ----------
        roots, _ = fused_chain(torch, A, B)
        spec = reg.get("ridge").spec
        coo = assemble([serve_payload(rng, "bcoo", 128)], spec.bucket_for(128, "bcoo"))
        for name, target in (("profile_chain", list(roots)),
                             ("profile_ridge_128", reg.get("ridge").cache.plans[
                                 spec.bucket_for(128, "dense")]),
                             ("profile_coo_chain_128",
                              plan.plan_for((coo.lazy() * 2.0 + coo) * 0.5))):
            rep = step(name, lambda target=target: obs.profile(target))
            drift = [(r.site, r.measured_bytes, r.predicted_bytes) for r in rep.nodes
                     if r.measured_bytes != r.predicted_bytes]
            ck(rep.nodes and not drift, f"{name}: measured != predicted bytes {drift}")
            ck(set(rep.compiled) == {"argument_bytes", "output_bytes", "temp_bytes"},
               f"{name}: compiled {rep.compiled}")
            rec["rates"][name] = {
                "nodes": [(r.site, r.time_s * 1e3, r.measured_bytes) for r in rep.nodes],
                "per_node_ms": rep.eager_total_s * 1e3, "fused_ms": rep.fused_time_s * 1e3,
                "compiled": rep.compiled}
            say(f"obs.profile {name}: {len(rep.nodes)} nodes, measured bytes = the "
                f"law's on every node; per-node sum {rep.eager_total_s * 1e3:.3f} ms "
                f"against the fused run's {rep.fused_time_s * 1e3:.3f} ms; compiled "
                f"{rep.compiled}")
        real = costmodel.node_live_bytes
        with patched(costmodel, "node_live_bytes", lambda *a, **k: real(*a, **k) / 2):
            ck.control(obs.profile(target, fused=False, compiled=False).drifting(),
                       "a byte law off by 2x")
        del roots, coo, target

        # 8. from `import repro_torch` to the first response, in a process
        # per mode; the two run side by side (each is one host thread's work)
        firsts = {}
        procs = {mode: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve-first", mode,
             "--serve-model", mdir], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for mode in ("cold", "warm")}
        for mode, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            ck(proc.returncode == 0, f"--serve-first {mode}: {err[-2000:]}")
            if proc.returncode == 0:
                firsts[mode] = json.loads(out.strip().splitlines()[-1])
        rec["rates"]["first_response_process"] = firsts
        say(f"a fresh process, `import repro_torch` to the first response: "
            f"{json.dumps(firsts)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    launches = {}
    for counts in rec["launches"].values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    rec["wall_s"]["phase_s"] = time.perf_counter() - t_phase
    print(f"[12] card: {smi}; serve phase: {json.dumps(rec)}; launches {launches}",
          flush=True)
    ck.raise_any()
    return launches, gemv, ridge


# ---------------------------------------------------------------------------
# phase 13: distribution
# ---------------------------------------------------------------------------

DIST_SLICE = (slice(1000, 7000), slice(2048, 8192))   # unaligned rows, aligned cols
DIST_RECHUNK = (1024, 4096)
DIST_RAGGED = 8000            # the FILL-pad case's cut of A and B: pad in each block edge
DIST_RANKS = 4                # the 2 x 2 mesh: one rank per card
COLSUM_RTOL = 1e-5            # |colsum - float64| per column, over sum(|x|) of it


def dist_comm(so, kind, a_loc, b_loc, mesh, axes):
    """The collectives of a schedule alone, on this rank's shards (SUMMA's
    two all-gathers, or Cannon's skew and d - 1 shifts); returns the panels
    its last local GEMM reads."""
    if kind == "summa":
        return so._summa_panels(a_loc, b_loc, mesh, axes)
    for panels in so._cannon_panels(a_loc, b_loc, mesh, axes):
        pass
    return panels


def dist_arrays(torch, seed):
    """A and B (8192² f32, blocks 2048²), the 8 M x 100 samples and R at the
    Netflix Prize shape, drawn from ``seed`` as phases 4 and 9 draw them
    (the 2 x 2 mesh's ranks each draw the same arrays)."""
    import repro_torch as rt
    gen = torch.Generator(device="cuda").manual_seed(seed)
    _, data = blob_data(torch, gen)
    sq = torch.rand(SQUARE, SQUARE, generator=gen, device="cuda") - 0.5
    sq2 = torch.rand(SQUARE, SQUARE, generator=gen, device="cuda") - 0.5
    A = rt.from_array(sq, SQUARE_BLOCK, device="cuda")
    B = rt.from_array(sq2, SQUARE_BLOCK, device="cuda")
    del sq, sq2
    csr, *_ = netflix_ratings(torch, gen)
    R = rt.from_scipy(csr, NETFLIX_BLOCK, device="cuda")
    return A, B, data, R


def mesh_checks(torch, mesh, tag, A, B, data, R):
    """Phase 13's checks and times on one mesh; every rank runs them alike
    (SPMD).  Returns the record: launches of the checked calls by route,
    CUDA-event times, added peak memory, errors."""
    import repro_torch as rt
    from repro_torch.core import placement as pl
    from repro_torch.core import shmap_ops as so
    from repro_torch.core.blocking import round_up
    from repro_torch.kernels.matmul.ops import local_matmul
    from repro_torch.kernels.matmul.ref import stacked_matmul_ref

    ck = Checks(tag)
    axes = ("data", "model")
    d = mesh.size(0)
    want_place = pl.placements(mesh, axes)
    rec = {"mesh": f"{tuple(mesh.shape)} {mesh.mesh_dim_names} on "
                   f"{mesh.device_type}, backend "
                   f"{torch.distributed.get_backend()}",
           "launches": {}, "errors": {}, "ms": {}, "added_mb": {}}

    def say(msg):
        print(f"{tag} {msg}", flush=True)

    def placed(out, what, places=want_place):
        leaf = out._leaf
        ok = (pl.is_dtensor(leaf) and leaf.device_mesh == mesh
              and tuple(leaf.placements) == tuple(places))
        ck(ok, f"{what}: placement {getattr(leaf, 'placements', None)}, "
               f"want {tuple(places)}")

    def counted(what, fn, route, per_call):
        """``fn()`` with a check that it launched ``stacked_matmul``
        ``per_call`` times on ``route`` (on this rank) and on no other."""
        before = ds_counts()
        out = fn()
        torch.cuda.synchronize()
        after = ds_counts()
        got = {r: after[f"stacked_matmul/{r}"] - before[f"stacked_matmul/{r}"]
               for r in ("wgmma", "simt")}
        want = {r: per_call if r == route else 0 for r in got}
        ck(got == want, f"{what}: stacked_matmul launches {got}, want {want}")
        rec["launches"][what] = got
        return out

    def gemm_ok(out, ref, depth, what, extra=0.0):
        bad = gemm_bad(out, ref, depth, extra)
        ck(bad == 0, f"{what}: {bad} elements beyond the GEMM limit")
        err = float((out.double() - ref.double()).abs().max())
        rec["errors"][what] = err
        return err

    ds_counts(zero=True)
    t_checks = time.perf_counter()
    # 1. SUMMA and Cannon, f32 on the SIMT route and bf16 on wgmma
    operands = {"f32": (A, B), "bf16": (A.astype(torch.bfloat16),
                                        B.astype(torch.bfloat16))}
    for dt, route in (("f32", "simt"), ("bf16", "wgmma")):
        a, b = operands[dt]
        ref = stacked_matmul_ref(a.blocks, b.blocks, out_dtype=a.dtype)
        # Cannon adds its d partial products in the operands' type, as the
        # reference's schedule does: d - 1 more roundings, each within
        # eps·(|A| @ |B|)
        steps = (d - 1) * torch.finfo(a.dtype).eps * stacked_matmul_ref(
            a.blocks.abs(), b.blocks.abs(), out_dtype=torch.float32).double()
        for kind, fn, per in (("summa", so.summa_matmul, 1),
                              ("cannon", so.cannon_matmul, d)):
            what = f"{kind}_matmul {SQUARE}² {dt}"
            out = counted(what, lambda: fn(a, b, mesh), route, per)
            placed(out, what)
            ck(out.stacked_grid == tuple(ref.shape[:2]) and out.pad_state.kind == "zero",
               f"{what}: grid {out.stacked_grid}, pad {out.pad_state}")
            full = pl.gather(out.blocks)
            err = gemm_ok(full, ref, SQUARE, what, steps if kind == "cannon" else 0.0)
            again = counted(what + ", again", lambda: fn(a, b, mesh), route, per)
            same = torch.equal(pl.local(again.blocks), pl.local(out.blocks))
            ck(same, f"{what}: two runs differ")
            say(f"{what}: {per} {route} launch(es) per rank, max abs err {err:.3e} "
                f"vs plain, same bits twice: {same}")
            del out, full, again
        ck.control(gemm_bad(torch.zeros_like(ref), ref, SQUARE, steps) > 0,
                   f"zero {dt} output")
        del ref, steps

    # 2. FILL-pad operands: the schedules re-zero the pad before placing
    for label, (a, b) in (("", (A, B)),
                          (f" ragged {DIST_RAGGED}²",
                           (A[:DIST_RAGGED, :DIST_RAGGED], B[:DIST_RAGGED, :DIST_RAGGED]))):
        af, bf = a + 1.0, b - 2.0
        what = f"summa_matmul(A + 1, B - 2){label}"
        out = counted(what, lambda: so.summa_matmul(af, bf, mesh), "simt", 1)
        placed(out, what)
        ref = stacked_matmul_ref(af.ensure_zero_pad().blocks, bf.ensure_zero_pad().blocks,
                                 out_dtype=torch.float32)
        full = pl.gather(out.blocks)[:ref.shape[0], :ref.shape[1]]
        err = gemm_ok(full, ref, a.shape[1], what)
        ck(out.pad_state.kind == "zero", f"{what}: pad {out.pad_state}")
        if label:     # the pad constants would add 1·(-2) per pad column
            ck.control(gemm_bad(stacked_matmul_ref(af.blocks, bf.blocks,
                                                   out_dtype=torch.float32), ref,
                                a.shape[1]) > 0, "the product of FILL-pad blocks")
        say(f"{what}: max abs err {err:.3e} vs the zero-padded plain product")
        del af, bf, out, ref, full

    # 3. transpose_pp and colsum_psum of the 8 M x 100 samples
    X = rt.from_array(data, X_BLOCK, device="cuda")
    T = so.transpose_pp(X, mesh)
    placed(T, "transpose_pp(X)")
    ck(T.pad_state == X.pad_state and T.shape == (N_FEATURES, N_ROWS),
       f"transpose_pp(X): pad {T.pad_state}, shape {T.shape}")
    ck(torch.equal(T.collect(), data.T), "transpose_pp(X) != X.T")
    del T
    Xf = X + 1.0
    Tf = so.transpose_pp(Xf, mesh)
    g = Tf._gathered()
    ck(Tf.pad_state == Xf.pad_state and Tf.pad_state.kind == "fill"
       and torch.equal(g.blocks, g._remask(1.0)),
       f"transpose_pp(X + 1): pad {Tf.pad_state} not carried into the pad region")
    ck(torch.equal(g.collect(), (data + 1.0).T), "transpose_pp(X + 1) != (X + 1).T")
    del Xf, Tf, g
    cs = so.colsum_psum(X, mesh)
    placed(cs, "colsum_psum(X)", pl.reduced(want_place, (0,)))
    got = cs.collect().double().reshape(-1)
    c64 = torch.zeros(N_FEATURES, dtype=torch.float64, device="cuda")
    scale = torch.zeros_like(c64)
    for lo in range(0, N_ROWS, SAMPLE_ROWS):
        part = data[lo:lo + SAMPLE_ROWS].double()
        c64 += part.sum(0)
        scale += part.abs().sum(0)
    rel = float(((got - c64).abs() / scale).max())
    ck(rel <= COLSUM_RTOL, f"colsum_psum(X): {rel:.3e} of sum|x| from float64")
    short = c64 - data[:X_BLOCK[0]].double().sum(0)
    ck.control(float(((short - c64).abs() / scale).max()) > COLSUM_RTOL,
               "column sums without one block row")
    rec["errors"]["colsum_psum(X) rel"] = rel
    say(f"transpose_pp(X) {N_ROWS}x{N_FEATURES}: equal to X.T, pad "
        f"{X.pad_state} carried (X + 1: FILL(1.0) in the pad region); "
        f"colsum_psum(X): {rel:.3e} of sum|x| from float64")

    # 4. the structural ops, explicit and plain, on a distributed A
    Ad = A.distribute(mesh)
    placed(Ad, "A.distribute(mesh)")
    rows = torch.arange(1, SQUARE, 3, device="cuda")
    pairs = {
        "slice_sharded": (lambda: so.slice_sharded(A, DIST_SLICE, mesh),
                          lambda: A[DIST_SLICE]),
        "rechunk_sharded": (lambda: so.rechunk_sharded(A, DIST_RECHUNK, mesh),
                            lambda: A.rechunk(DIST_RECHUNK)),
        "concat_rows_sharded": (lambda: so.concat_rows_sharded([A, A[:4096]], mesh),
                                lambda: rt.concat_rows([A, A[:4096]])),
        "Ad[1000:7000, 2048:]": (lambda: Ad[DIST_SLICE], lambda: A[DIST_SLICE]),
        "Ad[rows]": (lambda: Ad[rows], lambda: A[rows]),
        "Ad.rechunk": (lambda: Ad.rechunk(DIST_RECHUNK), lambda: A.rechunk(DIST_RECHUNK)),
        "concat_rows([Ad, Ad])": (lambda: rt.concat_rows([Ad, Ad]),
                                  lambda: rt.concat_rows([A, A])),
        "Ad * 2 + 1": (lambda: Ad * 2.0 + 1.0, lambda: A * 2.0 + 1.0),
    }
    for what, (got_fn, want_fn) in pairs.items():
        got, want = got_fn(), want_fn()
        placed(got, what)
        grid = tuple(round_up(g, d) for g in want.stacked_grid)
        ck(got.stacked_grid == grid and got.pad_state == want.pad_state
           and torch.equal(got.collect(), want.collect()),
           f"{what}: grid {got.stacked_grid} (want {grid}), pad {got.pad_state}, or "
           f"values differ from the undistributed op")
    say(f"{', '.join(pairs)}: each equal to the undistributed op, placement kept")

    # 5. distribute_sparse of R
    Rd = R.distribute(mesh)
    placed(Rd, "R.distribute(mesh)")
    gn, gm = R.stacked_grid
    ck(Rd.block_format == "bcoo" and Rd.blocks.nse == R.blocks.nse
       and torch.equal(pl.gather(Rd.blocks.data)[:gn, :gm], R.blocks.data)
       and torch.equal(pl.gather(Rd.blocks.indices)[:gn, :gm], R.blocks.indices),
       "R.distribute(mesh): stored entries differ")
    first = slice(0, NETFLIX_BLOCK[0])
    ck(torch.equal(Rd[first].collect(), R[first].collect()),
       "R.distribute(mesh)[:32768] collected differs")
    say(f"R {NETFLIX_USERS}x{NETFLIX_MOVIES}, grid {gn}x{gm} -> {Rd.stacked_grid} on "
        f"the mesh: stored entries equal, first block row collected equal")
    del Rd

    # 6. no DTensor reaches a kernel
    try:
        local_matmul(Ad.blocks, Ad.blocks)
        ck(False, "local_matmul took a DTensor")
    except TypeError:
        pass
    launches = ds_counts()
    rec["checks_s"] = time.perf_counter() - t_checks

    # 7. times: each schedule whole, its collectives alone and its local
    # GEMMs alone, beside the undistributed A @ B on the same route
    for dt, route in (("f32", "simt"), ("bf16", "wgmma")):
        a, b = operands[dt]
        ad, bd = a.distribute(mesh), b.distribute(mesh)
        rec["ms"][f"A @ B {dt}, undistributed"] = timed(lambda: a @ b)
        for kind, fn in (("summa", so.summa_matmul), ("cannon", so.cannon_matmul)):
            rec["ms"][f"{kind} {dt}"] = timed(lambda: fn(ad, bd, mesh))
            comm = lambda: dist_comm(so, kind, pl.local(ad.blocks), pl.local(bd.blocks),
                                     mesh, axes)
            rec["ms"][f"{kind} {dt}, collectives"] = timed(comm)
            sa, sb = comm()
            steps = 1 if kind == "summa" else d

            def gemms():
                acc = so._local_gemm(sa, sb)
                for _ in range(steps - 1):
                    acc = acc + so._local_gemm(sa, sb)
                return acc
            rec["ms"][f"{kind} {dt}, local GEMMs"] = timed(gemms)
            _, peak = added_peak(torch, lambda: fn(ad, bd, mesh))
            rec["added_mb"][f"{kind} {dt}"] = peak / 1e6
            del sa, sb
        del ad, bd
    Xd = X.distribute(mesh)
    rec["ms"]["transpose_pp(X)"] = timed(lambda: so.transpose_pp(Xd, mesh))
    rec["ms"]["X.T materialised, undistributed"] = timed(
        lambda: X.blocks.permute(1, 0, 3, 2).contiguous())
    rec["ms"]["colsum_psum(X)"] = timed(lambda: so.colsum_psum(Xd, mesh))
    rec["ms"]["X.sum(axis=0), undistributed"] = timed(lambda: X.sum(axis=0))
    _, peak = added_peak(torch, lambda: so.transpose_pp(Xd, mesh))
    rec["added_mb"]["transpose_pp(X)"] = peak / 1e6
    xbytes = 4.0 * X.blocks.numel()
    rec["bound_ms"] = {"transpose_pp(X) (bytes)": bound(0, 2 * xbytes, "fp32")[0],
                       "colsum_psum(X) (bytes)": bound(0, xbytes, "fp32")[0],
                       "A @ B f32 (operations)": bound(2.0 * SQUARE ** 3, 0, "fp32")[0],
                       "A @ B bf16 (operations)": bound(2.0 * SQUARE ** 3, 0, "bf16")[0]}
    rec["launches_by_route"] = {r: launches[f"stacked_matmul/{r}"]
                                for r in ("wgmma", "simt")}
    rec["failed"] = list(ck.failed)
    return rec


def dist_rank_main(rank: int, world: int, store: str, seed: int) -> dict:
    """One rank of the 2 x 2 mesh (a child process, one card each)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.compat import make_mesh
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cuda")
        A, B, data, R = dist_arrays(torch, seed)
        rec = mesh_checks(torch, mesh, f"[13 rank {rank}]", A, B, data, R)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    rec["rank"] = rank
    return rec


def phase_distributed(torch, seed, smi, A, B, R):
    """Phase 13: distribution on a one-rank NCCL group and a 1 x 1 mesh at
    the main path's sizes (and on a 2 x 2 mesh of four ranks, one per card,
    where the machine has four); returns the checked calls' launches."""
    import torch.distributed as dist
    from repro_torch.core.compat import make_mesh

    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    store = os.path.join(build, f"phase13_store_{os.getpid()}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    _, data = blob_data(torch, gen)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        rec = mesh_checks(torch, mesh, "[13]", A, B, data, R)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    del data
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[13] card: {smi}; mesh {rec['mesh']}; times (CUDA events, ms): "
          f"{json.dumps(rec['ms'])}; bounds (ms): {json.dumps(rec['bound_ms'])}; "
          f"added peak (MB): {json.dumps(rec['added_mb'])}; errors: "
          f"{json.dumps(rec['errors'])}; checked launches by route "
          f"{rec['launches_by_route']}; checks {rec['checks_s']:.3f} s", flush=True)
    failed = list(rec["failed"])

    cards = torch.cuda.device_count()
    if cards >= DIST_RANKS:
        store4 = os.path.join(build, f"phase13_store4_{os.getpid()}")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--dist-rank", str(r), "--dist-store", store4],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(DIST_RANKS)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                p.kill()
            if os.path.exists(store4):
                os.remove(store4)
        for r, (p, (out, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                failed.append(f"2 x 2 rank {r} exited {p.returncode}: {err[-2000:]}")
                continue
            got = json.loads(out.strip().splitlines()[-1])
            failed += [f"2 x 2 rank {r}: {f}" for f in got["failed"]]
            print(f"[13] 2 x 2 mesh, rank {r}: times (ms) {json.dumps(got['ms'])}; "
                  f"added peak (MB) {json.dumps(got['added_mb'])}; launches by route "
                  f"{got['launches_by_route']}", flush=True)
    else:
        print(f"[13] the 2 x 2 mesh needs {DIST_RANKS} cards (one NCCL rank per "
              f"card); this machine has {cards}: it ran the 1 x 1 mesh only",
              flush=True)
    print(f"[13] distribution phase {time.perf_counter() - t_phase:.3f} s", flush=True)
    check(not failed, "; ".join(failed))
    return {f"stacked_matmul/{r}": n for r, n in rec["launches_by_route"].items()}


# ---------------------------------------------------------------------------
# phase 14: plan analysis
# ---------------------------------------------------------------------------

ANALYSIS_CLI_TIMEOUT = 300          # s for the `python -m repro_torch.analysis` child


def small_pipeline(rt, plan, device: str):
    """Phase 4's pipeline at 64 x 48 in 8 x 8 blocks, as one plan: the
    six-op chain, one ``@`` and one folded ``matmul_ta``, from one NumPy
    seed on ``device``."""
    import numpy as np
    rng = np.random.default_rng(0)
    a = rt.from_array(rng.standard_normal((64, 48), np.float32), (8, 8),
                      device=device)
    w = rt.from_array(rng.standard_normal((48, 32), np.float32), (8, 8),
                      device=device)
    chain = ((a.lazy() + a) * 2.0 - a).abs() * 0.5 + 0.25
    return plan.plan_for(chain, a.lazy() @ w, a.lazy().T @ a)


def phase_analysis(torch, seed, smi, fit_plans, km, A, B, R, ridge):
    """Phase 14: ``analysis.check`` (every rule) over the main path's own
    plans at full width, the graph plane the same on the card and the CPU,
    and the CLI in a child process on the card; returns the phase's
    ``stacked_matmul`` and ``kmeans_assign`` launches by route."""
    import re
    from collections import Counter
    import repro_torch as rt
    from repro_torch import analysis
    from repro_torch.algorithms import PCA
    from repro_torch.algorithms import kmeans as pkmeans
    from repro_torch.analysis.__main__ import WAIVERS, dedup
    from repro_torch.core import plan
    from repro_torch.estimators import Ridge
    from repro_torch.obs import registry
    from repro_torch.serve import ModelRegistry

    t_phase = time.perf_counter()
    ck = Checks("[14]")
    rec = {"plans": {}, "wall_s": {}}

    def say(what):
        print(f"[14] {what} (card: {smi})", flush=True)

    ds_counts(zero=True)
    plain0 = registry.snapshot("gemm")["gemm.dispatch_plain"]

    # 1. the main path's plans, captured from its own entry points ----------
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    _, data = blob_data(torch, gen)              # drawn as phase 10 draws them
    n, m = data.shape
    y = data @ torch.randn(m, generator=gen, device="cuda") + 0.5
    x = rt.from_array(data, X_BLOCK, device="cuda")
    plans = {"kmeans_fit": dedup(fit_plans)}    # phase 4's fit (dense: none)

    def caught(name, fn):
        with plan.capture_plans() as got:
            fn()
        torch.cuda.synchronize()
        plans[name] = dedup(got)

    caught("kmeans_predict_score", lambda: (km.predict(x), km.score(x)))
    caught("fold", lambda: (x.lazy().T @ x).compute())
    caught("fused_chain", lambda: plan.compute_multi(*fused_chain(torch, A, B)[0]))
    q = torch.linalg.qr(torch.randn((N_FEATURES, PCA_COLS), generator=gen,
                                    device="cuda"))[0]
    caught("power_iteration", lambda: (x.lazy().T @ (x.lazy() @ rt.from_array(
        q, (N_FEATURES, PCA_COLS), device="cuda"))).compute())
    Ab, Bb = A.astype(torch.bfloat16), B.astype(torch.bfloat16)
    caught("gemm_f32", lambda: (A.lazy() @ B).compute())
    caught("gemm_bf16", lambda: (Ab.lazy() @ Bb).compute())
    U = rt.from_array(torch.randn(NETFLIX_USERS, ALS_FACTORS, generator=gen,
                                  device="cuda") * 0.1,
                      (NETFLIX_BLOCK[0], ALS_FACTORS), device="cuda")
    caught("sparse_row_sq_norms", lambda: pkmeans._row_sq_norms(R))
    caught("sparse_ta_dense", lambda: (R.lazy().T @ U).compute())
    caught("pca_fit", lambda: PCA(n_components=PCA_K).fit(x))
    caught("ridge_fit", lambda: Ridge(alpha=RIDGE_ALPHA).fit(x, y))
    reg = ModelRegistry(device="cuda")
    reg.register("ridge", ridge, batch_sizes=(SERVE_BATCHES[-1],),
                 block_rows=SERVE_BLOCK_ROWS)
    plans["served_ridge_128"] = dedup(reg.warmed_plans())
    rec["wall_s"]["capture_s"] = time.perf_counter() - t0
    ck(not plans["kmeans_fit"], f"the dense K-means fit recorded "
       f"{len(plans['kmeans_fit'])} plans, want none (ROADMAP.md §3)")
    ck(all(plans[k] for k in plans if k != "kmeans_fit"),
       f"no plan captured: {[k for k in plans if not plans[k]]}")

    # 2. every rule over every plan ----------------------------------------
    lint_launches = None
    for name, ps in plans.items():
        for i, p in enumerate(ps):
            label = name if i == 0 else f"{name}#{i}"
            view = analysis.PlanView(p)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            g = view.graph()
            torch.cuda.synchronize()
            t_graph = time.perf_counter() - t0
            added = torch.cuda.max_memory_allocated() - base
            t0 = time.perf_counter()
            view.profile()
            t_profile = time.perf_counter() - t0
            t0 = time.perf_counter()
            rep = analysis.check(view, fail_on="warn", suppress=list(WAIVERS))
            t_rules = time.perf_counter() - t0
            naive, minimized, inputs, nodes = rep.by_rule("peak-hbm-liveness")[0].data
            found = Counter(f"{f.rule}/{f.severity}" for f in rep.findings)
            found.update(f"{f.rule}/{f.severity}/waived" for f in rep.suppressed)
            rec["plans"][label] = {
                "nodes": nodes, "ops": len(g),
                "kernel_nodes": sum(nd.kind == "kernel" for nd in g),
                "findings": dict(found),
                "waived": sorted({(f.token, tuple(f.data)) for f in rep.suppressed}),
                "naive_peak": naive, "minimized_peak": minimized,
                "input_bytes": inputs, "graph_s": t_graph,
                "graph_added_bytes": added, "profile_s": t_profile,
                "rules_s": t_rules}
            ck(rep.ok, f"{label}: unwaived findings at or above warn: "
                       f"{[str(f) for f in rep.failing]}")
            say(f"{label}: {nodes} nodes, {len(g)} ops; findings {dict(found)}; "
                f"peak naive {naive:,} minimized {minimized:,} (inputs "
                f"{inputs:,}); graph {t_graph:.3f} s (+{added / 1e6:.1f} MB), "
                f"profile {t_profile:.3f} s, rules {t_rules:.3f} s")
    lint_launches = ds_counts()
    chain = rec["plans"]["fused_chain"]["waived"]
    ck(chain == [("no-full-grid-intermediate@entry:fused-step-outputs", (4, 1))],
       f"the fused chain's waived findings {chain}: want only its 4 step "
       f"outputs against a budget of 1 (ROADMAP.md §3)")
    plain = registry.snapshot("gemm")["gemm.dispatch_plain"] - plain0
    ck(plain == 0, f"{plain} GEMMs on the card took the plain version")
    largest = max(rec["plans"], key=lambda k: rec["plans"][k]["input_bytes"])
    big = rec["plans"][largest]
    say(f"the graph plane on the largest plan ({largest}, inputs "
        f"{big['input_bytes'] / 1e9:.3f} GB): {big['graph_s']:.3f} s host, "
        f"+{big['graph_added_bytes'] / 1e6:.1f} MB peak")

    # 3. the graph does not depend on the device ---------------------------
    graphs = {dev: small_pipeline(rt, plan, dev).graph() for dev in ("cpu", "cuda")}
    kernels = {dev: [nd.op for nd in g if nd.kind == "kernel"]
               for dev, g in graphs.items()}
    ck(graphs["cuda"] == graphs["cpu"],
       f"the small pipeline's graph differs between the card and the CPU:\n"
       f"cuda:\n{graphs['cuda']}\ncpu:\n{graphs['cpu']}")
    ck(kernels["cuda"] == ["kernel:stacked_matmul"] * 2,
       f"kernel nodes {kernels}")
    say(f"the 64 x 48 pipeline: {len(graphs['cuda'])} ops on the card, "
        f"{len(graphs['cpu'])} on the CPU, equal node for node: "
        f"{graphs['cuda'] == graphs['cpu']}; kernel nodes {kernels['cuda']}")

    # 4. the CLI in a child process on the card ----------------------------
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=ANALYSIS_CLI_TIMEOUT)
    rec["wall_s"]["cli_s"] = time.perf_counter() - t0
    waived = {line.split()[-1] for line in proc.stdout.splitlines()
              if line.strip().startswith("[waived:")}
    ck(proc.returncode == 0, f"python -m repro_torch.analysis exited "
       f"{proc.returncode}: {proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    ck(waived == set(WAIVERS), f"the CLI waived {sorted(waived)}, WAIVERS "
       f"lists {sorted(WAIVERS)}")
    scenarios = re.findall(r"^== (\S+):", proc.stdout, re.M)
    say(f"python -m repro_torch.analysis: exit {proc.returncode} in "
        f"{rec['wall_s']['cli_s']:.2f} s, {len(scenarios)} plans "
        f"({', '.join(scenarios)}), waived {sorted(waived)}")

    launches = ds_counts()
    ck(lint_launches["stacked_matmul/wgmma"] > 0 and lint_launches["stacked_matmul/simt"] > 0,
       f"the linted plans' GEMMs by route {lint_launches}: want both routes")
    ck(lint_launches["kmeans_assign/mma"] > 0 and lint_launches["kmeans_assign/simt"] == 0,
       f"kmeans_assign by route {lint_launches}: want mma only")
    rec["launches"] = {k: v for k, v in launches.items() if v}
    rec["wall_s"]["phase_s"] = time.perf_counter() - t_phase
    print(f"[14] card: {smi}; analysis phase: {json.dumps(rec)}", flush=True)
    ck.raise_any()
    return launches


# ---------------------------------------------------------------------------
# phase 15: training on the card
# ---------------------------------------------------------------------------


def grad_agreement(torch, got, want):
    """(cosine, ‖got‖ / ‖want‖) of two gradient trees flattened, summed in
    float64 over one layer slice at a time (no whole-leaf fp32 copy); a
    slice of ``want`` is moved to ``got``'s device (a tree kept on the host
    crosses one slice at a time).  The leaves are matched by path (a
    placed tree's dicts need not keep the unplaced tree's key order)."""
    from repro_torch.distributed.sharding import tree_paths
    gp, gl, _ = tree_paths(got)
    wp, wl, _ = tree_paths(want)
    check(gp == wp, "the two gradient trees' paths differ")
    dot = ng = nw = 0.0
    for g, w in zip(gl, wl):
        for gs, ws in zip(g.split(1), w.split(1)) if g.ndim >= 3 else ((g, w),):
            gf, wf = gs.reshape(-1).float(), ws.to(gs.device).reshape(-1).float()
            dot += float(torch.dot(gf, wf))
            ng += float(torch.dot(gf, gf))
            nw += float(torch.dot(wf, wf))
    return dot / (ng * nw) ** 0.5, (ng / nw) ** 0.5


def attention_grad_err(torch, q, k, v, do, kw, route: str, ck, what: str) -> float:
    """``AttentionFunction`` under autograd on the card: its forward one
    launch by ``route``, its backward none, its gradients against autograd
    of the plain version on the same inputs; returns the max error over
    dq, dk, dv, each relative to max(1, its largest magnitude)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import attention_ref, flash_attention
    out = routed(lambda: flash_attention(q, k, v, **kw), fk.flash_attention, route, what)
    before = dict(fk.flash_attention.route_launches)
    got = torch.autograd.grad(out, (q, k, v), do)
    ck(fk.flash_attention.route_launches == before, "the attention backward launched a kernel")
    plain = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*plain, **kw), plain, do)
    return max(float((g.float() - w.float()).abs().max())
               / max(1.0, float(w.float().abs().max())) for g, w in zip(got, want))


def train_grad_cases(torch, gen, ck):
    """The autograd Functions' gradients on the card against autograd of the
    plain versions, at small shapes on each route the training path takes
    (attention ``wgmma`` in bf16 and ``tile`` in f32 on the model's
    (B, T, H, D) views; the SSD chunk's ``mma`` under ``ssd_scan``); the
    backward launches no kernel.  Returns the max relative error."""
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd.ops import ssd_scan
    errs = {}
    for dtype, route, tol in ((torch.bfloat16, "wgmma", 2e-2), (torch.float32, "tile", 1e-4)):
        x = torch.randn((2, 300, 12, 80), generator=gen, device="cuda").to(dtype)
        q = x[:, :, :4].transpose(1, 2).detach().requires_grad_()
        k, v = (x[:, :, i:i + 2].transpose(1, 2).detach().requires_grad_()
                for i in (4, 8))
        do = torch.randn((2, 4, 300, 80), generator=gen, device="cuda").to(dtype)
        errs[route] = attention_grad_err(torch, q, k, v, do, dict(window=100), route, ck,
                                         f"attention grads, {route}")
        ck(errs[route] <= tol, f"attention grads ({route}): rel err {errs[route]} > {tol}")
    args = [t.requires_grad_() for t in ssd_inputs(torch, gen, 8, 2, 300, 64, 64, slow=True)]
    y, h = routed(lambda: ssd_scan(*args, chunk=128), sk.ssd_chunk, "mma", "ssd grads")
    ry, rh = torch.randn_like(y), torch.randn_like(h)
    before = dict(sk.ssd_chunk.route_launches)
    got = torch.autograd.grad((y * ry).sum() + (h * rh).sum(), args)
    ck(sk.ssd_chunk.route_launches == before, "the SSD backward launched a kernel")
    plain = [t.detach().requires_grad_() for t in args]
    with plain_kernels():
        y2, h2 = ssd_scan(*plain, chunk=128)
    want = torch.autograd.grad((y2 * ry).sum() + (h2 * rh).sum(), plain)
    errs["mma"] = max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                      for g, w in zip(got, want))
    ck(errs["mma"] <= 1e-4, f"ssd grads (mma): rel err {errs['mma']} > 1e-4")
    print(f"[15] Function gradients vs plain autograd at small shapes, max rel err "
          f"by route: {errs}", flush=True)
    return errs


def phase_train(torch, seed, smi):
    """Phase 15: zamba2-2.7b trained at full width on the card; returns the
    kernels' launches by route over the phase's training runs."""
    import dataclasses
    import math
    import shutil
    import tempfile
    from torch.utils import _pytree as pytree
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline_for_model
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_mod
    from repro_torch.models.model import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import TrainState, loss_and_grads, make_train_step

    t_phase = time.perf_counter()
    ck = Checks("[15]")
    rec = {"card": smi}
    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    train_grad_cases(torch, gen, ck)

    cfg = get_config(LM_ARCH)
    check(cfg.remat and cfg.dtype == "bfloat16", f"{cfg.name}: remat {cfg.remat}, "
                                                  f"dtype {cfg.dtype}")
    model = build_model(cfg)
    with torch.no_grad():           # not inference_mode: these enter autograd
        params = model.init(gen, "cuda")
        redraw_norms(params, gen)
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    pipe = pipeline_for_model(cfg, LM_BATCH, LM_SEQ, seed=seed, device="cuda")
    batch = pipe.batch_at(0)
    tokens = LM_BATCH * LM_SEQ
    per_step = {"flash_attention": 2 * ATTN_PER_FORWARD,
                "flash_attention/wgmma": 2 * ATTN_PER_FORWARD,
                "flash_attention/tile": 0, "flash_attention/rows": 0,
                "ssd_chunk": 2 * SSD_PER_FORWARD, "ssd_chunk/mma": 2 * SSD_PER_FORWARD,
                "ssd_chunk/simt": 0}
    print(f"[15] {cfg.name}: {n_params} parameters, bf16, remat on; batch "
          f"{tuple(batch.tokens.shape)} from pipeline_for_model", flush=True)

    # 1. one step's loss and gradients: kernels against the plain versions;
    # the limit from the float32 twin's loss, forward only (phase 7's rule)
    with torch.no_grad(), plain_kernels():
        params32 = pytree.tree_map(lambda t: t.float(), params)
        twin = float(build_model(dataclasses.replace(cfg, dtype="float32")).loss(
            params32, batch.tokens, batch.labels))
        del params32
    zero_counts()
    t0 = time.perf_counter()
    loss_k, grads_k = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    rec["kernel_step_s"] = time.perf_counter() - t0
    expect_counts(read_counts(), per_step, "loss and gradients, kernels", "[15]")
    with plain_kernels():
        t0 = time.perf_counter()
        loss_p, grads_p = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        rec["plain_step_s"] = time.perf_counter() - t0
    loss_k, loss_p = float(loss_k), float(loss_p)
    e = abs(loss_p - twin)
    cos, ratio = grad_agreement(torch, grads_k, grads_p)
    del grads_k, grads_p
    rec.update(loss_kernels=loss_k, loss_plain=loss_p, loss_f32_twin=twin,
               loss_gap=abs(loss_k - loss_p), loss_limit=2 * e, grad_cos=cos,
               grad_norm_ratio=ratio)
    ck(abs(loss_k - loss_p) <= 2 * e, f"loss {loss_k} (kernels) vs {loss_p} (plain): "
       f"gap beyond 2 x E = 2 x {e} (bf16 plain vs the float32 twin {twin})")
    ck(cos >= GRAD_COS, f"gradients' cosine {cos} < {GRAD_COS}")
    ck(abs(ratio - 1) <= GRAD_NORM_RATIO, f"gradient norm ratio {ratio}")
    print(f"[15] loss kernels {loss_k:.6f}, plain {loss_p:.6f} (gap "
          f"{abs(loss_k - loss_p):.3e}, limit 2 x E = {2 * e:.3e}, float32 twin "
          f"{twin:.6f}); gradients: cosine {cos:.6f}, norm ratio {ratio:.6f}; "
          f"step s: kernels {rec['kernel_step_s']:.3f}, plain {rec['plain_step_s']:.3f}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 2. six steps of make_train_step (AdamW, fp32 moments)
    opt = make_optimizer("adamw", peak_lr=TRAIN_LR, warmup=1, total=TRAIN_STEPS)
    state = TrainState(params=params, opt_state=opt.init(params))
    del params
    step_fn = make_train_step(model, opt)
    leaves = pytree.tree_leaves(state.params)
    samples = [t.reshape(-1)[::max(1, t.numel() // 65536)].clone() for t in leaves]
    train = dict.fromkeys(per_step, 0)
    losses, norms, times = [], [], []
    torch.cuda.synchronize()
    from repro_torch.launch.costs import storage_bytes
    held = {"argument_bytes": storage_bytes((state, batch)),    # phase 20 reads these
            "live_bytes": torch.cuda.memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        b = pipe.batch_at(i)
        zero_counts()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = read_counts()
        expect_counts(got, per_step, f"train step {i}", "[15]")
        for key in train:
            train[key] += got[key]
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak_bytes = torch.cuda.max_memory_allocated()
    peak = peak_bytes / 1e9
    leaves = pytree.tree_leaves(state.params)
    finite = all(bool(torch.isfinite(s).all()) for t in leaves
                 for s in (t.split(1) if t.ndim >= 3 else (t,)))
    moved = [not torch.equal(t.reshape(-1)[::max(1, t.numel() // 65536)], s0)
             for t, s0 in zip(leaves, samples)]
    del samples
    ck(all(map(math.isfinite, losses + norms)), f"losses {losses}, grad norms {norms}")
    ck(finite, "a parameter is not finite after training")
    ck(all(moved), f"{moved.count(False)} of {len(moved)} parameter leaves did not move")
    ck(int(state.step) == TRAIN_STEPS, f"count {int(state.step)} after {TRAIN_STEPS} steps")
    s_step = statistics.median(times[1:])
    rec.update(losses=losses, grad_norms=norms, step_s=times, s_per_step=s_step,
               tokens_per_s=tokens / s_step, peak_gb=peak,
               launches_per_step={k: v // TRAIN_STEPS for k, v in train.items()})
    ck(peak <= TRAIN_PEAK_GB, f"peak {peak:.2f} GB above {TRAIN_PEAK_GB} GB")
    print(f"[15] {TRAIN_STEPS} train steps at B {LM_BATCH} x T {LM_SEQ}: losses "
          f"{[round(x, 4) for x in losses]}, grad norms {[round(x, 4) for x in norms]}; "
          f"{s_step:.3f} s/step (median of steps 2-{TRAIN_STEPS}; step 1 "
          f"{times[0]:.3f} s), {tokens / s_step:.1f} tokens/s, peak "
          f"{peak:.2f} GB (card: {smi})", flush=True)

    # where a step's time goes: one more loss and gradients of the trained
    # state, each plain backward fenced by synchronisations and timed (this
    # call's time is not the step's: it pays the fences)
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    spent = {"attention_backward_s": 0.0, "ssd_backward_s": 0.0}

    def fenced(key, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return run

    with patched(fops, "attention_grads", fenced("attention_backward_s",
                                                 fops.attention_grads)), \
            patched(sops, "ssd_chunk_grads", fenced("ssd_backward_s",
                                                    sops.ssd_chunk_grads)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_and_grads(model, state.params, batch)
        torch.cuda.synchronize()
        spent["fenced_step_s"] = time.perf_counter() - t0
    spent["plain_backward_share"] = ((spent["attention_backward_s"]
                                      + spent["ssd_backward_s"])
                                     / spent["fenced_step_s"])
    rec["backward"] = spent
    print(f"[15] one fenced loss-and-gradients call: {json.dumps(spent)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 3. greedy decode of the trained weights through launch/serve's path
    nb, np_, nn = TRAIN_DECODE
    zero_counts()
    prompt = batch.tokens[:nb, :np_]
    out, _ = serve.generate(model, state.params, prompt, nn)
    got = read_counts()
    expect_counts(got, {"flash_attention": ATTN_PER_FORWARD * (np_ + nn - 1),
                        "flash_attention/rows": ATTN_PER_FORWARD * (np_ + nn - 1),
                        "ssd_chunk": 0}, f"serve.generate {tuple(prompt.shape)} + {nn}",
                  "[15]")
    for key in train:
        train[key] += got[key]
    with torch.inference_mode():
        fwd = teacher_forced(model, state.params, prompt, out)
    agree = float((out == fwd.argmax(-1)).double().mean())
    ck(tuple(out.shape) == (nb, nn) and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
       f"decoded {tuple(out.shape)}")
    ck(agree >= BF16_AGREE, f"decoded tokens agree with the teacher-forced argmax "
                            f"at {agree}")
    print(f"[15] greedy decode of the trained weights {tuple(prompt.shape)} + {nn}: "
          f"tokens equal the teacher-forced argmax at {agree:.4f} of positions "
          f"(limit {BF16_AGREE})", flush=True)
    del state, fwd
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the driver at the smoke size: crash at 12, resume, finish at 24
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        train_mod.main(DRIVER_ARGV + ["--ckpt-dir", root])
    rec["driver_s"] = time.perf_counter() - t0
    got = read_counts()
    latest = ckpt.latest_step(root)
    done = [ln for ln in log.getvalue().splitlines() if ln.startswith("done:")]
    ck(latest == 24, f"the driver's latest checkpoint is step {latest}, not 24")
    ck(done and "failures=1" in done[0], f"the driver's last line {done}")
    expect_counts(got, {"flash_attention/tile": 4 * DRIVER_STEPS,
                        "flash_attention/wgmma": 0,
                        "ssd_chunk/mma": 8 * DRIVER_STEPS, "ssd_chunk/simt": 0},
                  f"launch.train.main {' '.join(DRIVER_ARGV)}", "[15]")
    for key in train:
        train[key] += got[key]
    print(f"[15] launch.train.main {' '.join(DRIVER_ARGV)}: {done[0] if done else '?'}; "
          f"latest checkpoint {latest}; {rec['driver_s']:.2f} s", flush=True)
    shutil.rmtree(root, ignore_errors=True)

    rec["launches"] = {k: v for k, v in train.items() if v}
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[15] card: {smi}; train phase: {json.dumps(rec)}", flush=True)
    ck.raise_any()
    held.update(peak_bytes=peak_bytes, s_per_step=s_step)
    return train, {"loss_limit": rec["loss_limit"], "s_per_step": s_step,
                   "peak_gb": peak, "driver": driver_summary(log.getvalue()),
                   "step": held}


# ---------------------------------------------------------------------------
# phase 16: the dense and SSM families at their published widths
# ---------------------------------------------------------------------------

GEMMA_ARCH, GEMMA_BATCH, GEMMA_SEQ = "gemma2-2b", 1, 8192   # the 4,096 window cuts
MAMBA_ARCH, MAMBA_BATCH, MAMBA_SEQ = "mamba2-370m", 8, 2048
GEMMA_ATTN, MAMBA_SSD = 26, 48        # kernel launches a forward: one a layer
FAMILY_DECODE = 48                    # float32 decode steps, teacher-forced
CHECK_WINDOW = 32                     # the check config: every local buffer wraps
WINDOW_SAVING = 0.9                   # a windowed layer's attention below this x a global one
FAMILY_SERVE = ["--batch", "4", "--prompt-len", "256", "--gen", "64"]


def redraw_family_norms(params, gen, final_centre: float) -> None:
    """In place, for the dense and SSM trees: the ``plus_one`` norms
    (``ln*``) and ``conv_b`` around 0, the Mamba norms (``norm``,
    ``gate_norm``) around 1, the final norm around ``final_centre`` and
    ``dt_bias`` as Mamba-2 draws it (phase 7's ``redraw_norms``)."""
    import math
    import torch

    def around(t, centre):
        t.copy_(centre + 0.1 * torch.randn(t.shape, generator=gen, device=t.device))

    def walk(node):
        for key, t in node.items():
            if isinstance(t, dict):
                walk(t)
            elif key.startswith("ln") or key == "conv_b":
                around(t, 0.0)
            elif key in ("norm", "gate_norm"):
                around(t, 1.0)
            elif key == "dt_bias":
                lo, hi = math.log(1e-3), math.log(1e-1)
                dt = torch.exp(lo + (hi - lo) * torch.rand(t.shape, generator=gen,
                                                            device=t.device))
                t.copy_(torch.log(torch.expm1(dt)))

    for stack in params.get("groups", []) + [params.get("layers", {})]:
        walk(stack)
    around(params["final_norm"], final_centre)


def family_profiles(torch, model, params, tokens, tag: str, patches=None):
    """Device time by kernel group (``device_profile``) of one forward at
    ``tokens``' shape (over ``patches``, an encoder-decoder's frames) and of
    2 decode steps of 4 sequences from position 256 (the server's decode
    phase: caches of 320 slots, about 260 in use, and an encoder-decoder's
    256 encoder slots; the caches hold zeros, which costs the same).  Two
    steps: the profiler's summary of a step's ~2,500 launches takes
    seconds."""
    profiles = [device_profile(torch, lambda: model.forward(params, tokens, patches),
                               f"{model.cfg.name} forward {tuple(tokens.shape)}", tag)]
    kw = {} if patches is None else {"enc_len": 256}
    cache = model.init_cache(4, 320, device="cuda", **kw)
    step = tokens[:1, :1].repeat(4, 1)

    def decode_window():
        cache["pos"] = 256
        for _ in range(2):
            model.decode_step(params, cache, step)

    decode_window()   # warm
    profiles.append(device_profile(torch, decode_window,
                                   f"{model.cfg.name} 2 decode steps, batch 4, from "
                                   f"position 256", tag))
    return profiles


def family_serve(torch, arch: str, per_token: dict, tag: str, once=None):
    """``launch.serve.main`` as a user runs it (times: its own weights keep
    the reference init's zero norms); its launches per token, and ``once``
    a request batch (an encoder-decoder's encoder)."""
    from repro_torch.launch import serve
    argv = ["--arch", arch] + FAMILY_SERVE
    zero_counts()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        served, times = serve.main(argv)
    launches = read_counts()
    n_req, n_prompt, n_gen = (int(FAMILY_SERVE[i]) for i in (1, 3, 5))
    once = once or {}
    expect_counts(launches, {k: v * (n_prompt + n_gen - 1) + once.get(k, 0)
                             for k, v in per_token.items()},
                  f"serve.main {' '.join(argv)}", tag)
    check(tuple(served.shape) == (n_req, n_gen), f"served {tuple(served.shape)}")
    rec = {"prefill_s": times["prefill_s"], "decode_s": times["decode_s"],
           "decode_tok_per_s": n_req * (n_gen - 1) / times["decode_s"],
           "log": log.getvalue().strip().splitlines()}
    print(f"{tag} serve.main {' '.join(argv)}: {json.dumps(rec)}", flush=True)
    return rec, launches


def attention_pairs(t: int, window: int) -> int:
    """Visible (query, key) pairs of causal attention over ``t`` tokens,
    under a sliding ``window`` (0: none)."""
    if window <= 0 or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def model_attention(torch, gen, cfg, ck, name: str, tag: str, b: int, t: int, windows,
                    decode_cases):
    """One layer's attention of ``cfg`` (Hq, Hkv, D, soft-cap) at a
    forward's shape (B ``b``, T ``t``, bf16, causal), once for each window
    in ``windows`` (0: global), on ``wgmma`` against its plain version (a
    zeroed output and, for a window, the same attention without it must
    fail the limit), timed beside its bound over the pairs it sees, the
    plain version and SDPA (causal, no window, no soft-cap: the same
    function only without both); then decode attention on ``rows``: 4
    sequences, one query each, for each (slots, valid slots, what) in
    ``decode_cases``, beside SDPA over the valid slots.  Returns the
    rows."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref
    bf16 = torch.bfloat16
    hq, hkv, d, cap = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.attn_softcap

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    def sdpa_label(window: int) -> str:
        missing = (["no window"] if window else []) + (["no soft-cap"] if cap else [])
        return ", ".join(["SDPA causal"] + missing) + (
            " (not the same function)" if missing else " (the same function)")

    q, k, v = rnd(b, hq, t, d), rnd(b, hkv, t, d), rnd(b, hkv, t, d)
    rows = []
    for window in windows:
        kw = dict(causal=True, window=window, softcap=cap, sm_scale=d ** -0.5,
                  q_offset=0, kv_len=t)
        label = (f"{name} prefill B={b} Hq={hq} Hkv={hkv} T={t} D={d} bf16 causal "
                 f"window={window} softcap={cap}, wgmma")
        out = routed(lambda: fk.flash_attention(q, k, v, **kw), fk.flash_attention,
                     "wgmma", label)
        ref = attention_ref(q, k, v, **kw)
        limit = attn_limit(q, k, v, kw, ref)
        bad = bad_count(out, ref, limit)
        ck(bad == 0, f"{label}: {bad} elements beyond the attention limit")
        err = float((out.double() - ref.double()).abs().max())
        controls = {"zeroed output": bad_count(0 * ref, ref, limit)}
        if window:
            controls["no window"] = bad_count(attention_ref(q, k, v, **dict(kw, window=0)),
                                              ref, limit)
        for control, n in controls.items():
            ck(n > 0, f"{label}: control '{control}' passed the attention limit")
        del out, ref, limit
        ms = timed(lambda: fk.flash_attention(q, k, v, **kw))
        pairs = attention_pairs(t, window)
        flops = 4.0 * b * hq * pairs * d
        nbytes = 2.0 * b * d * t * (2 * hq + 2 * hkv)     # q, o; k, v read once
        b_ms, b_by = bound(flops, nbytes, "bf16")
        row = {"name": "flash_attention.wgmma", "case": label, "ms": ms,
               "plain_ms": timed(lambda: attention_ref(q, k, v, **kw), runs=3),
               "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes,
               "pairs": pairs, "tflops": flops / ms / 1e9, "max_abs_err": err,
               "controls": controls, "library": sdpa_label(window)}
        rows.append(row)
        print(f"{tag} {label}: max abs err {err:.3e}; controls fail at {controls}; "
              f"{ms:.3f} ms ({row['tflops']:.1f} TFLOP/s over {pairs} pairs), plain "
              f"{row['plain_ms']:.3f}, bound {b_ms:.3f} by {b_by}", flush=True)
    kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
    sdpa = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kr, vr, is_causal=True, scale=d ** -0.5))
    del kr, vr, q, k, v
    for row in rows:
        row["library_ms"] = sdpa
    print(f"{tag} SDPA at {name}'s head shape (causal, no window, no soft-cap; K/V heads "
          f"repeated before the call): {sdpa:.3f} ms", flush=True)
    nb = int(FAMILY_SERVE[1])
    for tc, kv_len, what in decode_cases:
        q, k, v = rnd(nb, hq, 1, d), rnd(nb, hkv, tc, d), rnd(nb, hkv, tc, d)
        kw = dict(causal=False, window=0, softcap=cap, sm_scale=d ** -0.5, q_offset=0,
                  kv_len=kv_len)
        label = (f"{name} decode B={nb} Hq={hq} Hkv={hkv} Tq=1 {what}, {kv_len} of {tc} "
                 f"slots, D={d} bf16 softcap={cap}, rows")
        out = routed(lambda: fk.flash_attention(q, k, v, **kw), fk.flash_attention,
                     "rows", label)
        ref = attention_ref(q, k, v, **kw)
        bad = bad_count(out, ref, attn_limit(q, k, v, kw, ref))
        ck(bad == 0, f"{label}: {bad} elements beyond the attention limit")
        err = float((out.double() - ref.double()).abs().max())
        ms = timed(lambda: fk.flash_attention(q, k, v, **kw))
        flops = 4.0 * nb * hq * kv_len * d
        nbytes = 2.0 * nb * d * (2 * hq + 2 * hkv * kv_len)
        b_ms, b_by = bound(flops, nbytes, "bf16")
        kr, vr = (x[:, :, :kv_len].repeat_interleave(hq // hkv, dim=1) for x in (k, v))
        lib = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kr, vr, scale=d ** -0.5))
        row = {"name": "flash_attention.rows", "case": label, "ms": ms,
               "plain_ms": timed(lambda: attention_ref(q, k, v, **kw)), "bound_ms": b_ms,
               "bound_by": b_by, "flops": flops, "bytes": nbytes,
               "tflops": flops / ms / 1e9, "max_abs_err": err, "library_ms": lib,
               "library": "SDPA over the valid slots" + (
                   ", no soft-cap (not the same function)" if cap else
                   " (the same function)")}
        rows.append(row)
        print(f"{tag} {label}: max abs err {err:.3e}; {ms:.4f} ms, plain "
              f"{row['plain_ms']:.4f}, SDPA {lib:.4f}, bound {b_ms:.4f} by {b_by}",
              flush=True)
        del q, k, v, kr, vr, out, ref
    return rows


def gemma_attention(torch, gen, cfg, ck):
    """One gemma2 layer's attention at the forward's shape (B 1, Hq 8, Hkv
    4, T 8192, D 256, soft-cap 50), windowed (the local layers) and global
    (``model_attention``), the window's tile skip checked to save time;
    the decode shape against a full 4,096-slot rolling cache."""
    rows = model_attention(torch, gen, cfg, ck, "gemma2", "[16]", GEMMA_BATCH, GEMMA_SEQ,
                           (cfg.attn_window, 0),
                           [(cfg.attn_window, cfg.attn_window, "a full rolling cache")])
    ck(rows[0]["ms"] < WINDOW_SAVING * rows[1]["ms"],
       f"windowed attention {rows[0]['ms']:.3f} ms, not below {WINDOW_SAVING} x the "
       f"global layer's {rows[1]['ms']:.3f}: the window's tile skip saves nothing")
    return rows


def mamba_chunk(torch, gen, cfg, ck):
    """``ssd_chunk`` alone at mamba2's forward shape (B·H = 8·32 = 256 rows,
    B and C per sequence (B·G = 8), T 2048, L 128, P 64, S 128, f32, the
    slow decay of mamba2's dt) on the mma route against its plain version
    (the TF32-rounded control must fail), timed beside its bound."""
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref
    bh, bg = MAMBA_BATCH * cfg.ssm_heads, MAMBA_BATCH * cfg.ssm_ngroups
    t, L, p, s = MAMBA_SEQ, cfg.ssm_chunk, cfg.ssm_headdim, cfg.ssm_state
    args = ssd_inputs(torch, gen, bh, bg, t, p, s, slow=True)[:5]
    label = (f"mamba2 ssd_chunk BH={bh} (B, C per {bh // bg} heads) T={t} L={L} P={p} "
             f"S={s} f32, mma")
    err = ssd_chunk_check(args, L, "mma", label, phase=16)
    ms = timed(lambda: sk.ssd_chunk(*args, chunk=L))
    nc = t // L
    flops = bh * nc * (L * (L + 1) / 2 * (2.0 * s + 2.0 * p) + 2.0 * L * s * p)
    nbytes = 4.0 * (bh * t * p + bh * t + bh + 2 * bg * t * s
                    + bh * t * p + bh * nc * s * p + bh * t * s + bh * nc)
    b_ms, b_by = bound(3 * flops, nbytes, "tf32")
    row = {"name": "ssd_chunk.mma", "case": label, "ms": ms,
           "plain_ms": timed(lambda: ssd_chunk_ref(*args, chunk=L), runs=3),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
           "bytes": nbytes, "tflops": flops / ms / 1e9, "max_abs_err": err}
    print(f"[16] {label}: {ms:.3f} ms ({row['tflops']:.1f} TFLOP/s), plain "
          f"{row['plain_ms']:.3f}, bound {b_ms:.3f} by {b_by} (3xTF32)", flush=True)
    return row


def phase_families(torch, seed, smi):
    """Phase 16: gemma2-2b and mamba2-370m at their published widths through
    the normal entry points; returns the kernels' launches by route over
    the phase's model runs and the rows of the new shapes."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    ck = Checks("[16]")
    rec = {"card": smi}
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    torch.cuda.reset_peak_memory_stats()
    total = {}

    def add(counts):
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n

    # gemma2-2b
    cfg = get_config(GEMMA_ARCH)
    model = build_model(cfg)
    with torch.inference_mode():
        params = model.init(gen, "cuda")
        redraw_family_norms(params, gen, 0.0)
        n_params = sum(t.numel() for t in pytree.tree_leaves(params))
        tokens = torch.randint(0, cfg.vocab_size, (GEMMA_BATCH, GEMMA_SEQ),
                               generator=gen, device="cuda")
        print(f"[16] {cfg.name}: {n_params} parameters, bf16, {cfg.n_layers} layers "
              f"(local window {cfg.attn_window} / global), d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads of {cfg.hd} over {cfg.n_kv_heads} KV heads", flush=True)
        per_fwd = {"flash_attention": GEMMA_ATTN, "flash_attention/wgmma": GEMMA_ATTN,
                   "flash_attention/tile": 0, "flash_attention/rows": 0, "ssd_chunk": 0}
        unwindowed = build_model(dataclasses.replace(cfg, attn_window=0))
        rec["gemma"], params32, got = family_forward(
            torch, model, params, tokens, per_fwd, "[16]",
            ("no window", lambda: unwindowed.forward(params, tokens)[0]))
        add(got)
        gc.collect()
        torch.cuda.empty_cache()
        rec["gemma"]["profiles"] = family_profiles(torch, model, params, tokens, "[16]")
        attn_rows = gemma_attention(torch, gen, cfg, ck)
        # float32: decode teacher-forced; the check config's buffers wrap
        model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        short = tokens[:, :FAMILY_DECODE]
        n_dec = FAMILY_DECODE * GEMMA_ATTN
        per_decode = {"flash_attention": GEMMA_ATTN + n_dec, "flash_attention/rows": n_dec,
                      "flash_attention/tile": GEMMA_ATTN, "flash_attention/wgmma": 0,
                      "ssd_chunk": 0}
        err, _, full, got = family_decode(torch, model32, params32, short, per_decode,
                                          f"{cfg.name} float32", "[16]")
        add(got)
        ck(err < DECODE_TOL, f"{cfg.name} decode vs teacher forcing: {err}")
        check_cfg = dataclasses.replace(cfg, dtype="float32", attn_window=CHECK_WINDOW)
        err_w, got_w, full_w, got = family_decode(
            torch, build_model(check_cfg), params32, short, per_decode,
            f"check config (not a workload) {cfg.name} float32 attn_window="
            f"{CHECK_WINDOW}, rolling buffers of {CHECK_WINDOW} slots wrap", "[16]")
        add(got)
        # the steps after the local buffers wrapped, on their own; control:
        # the same steps against the forward without that window
        wrapped = float((got_w - full_w)[:, CHECK_WINDOW:].abs().max())
        ctrl = float((got_w - full)[:, CHECK_WINDOW:].abs().max())
        ck(wrapped < DECODE_TOL, f"wrapped decode vs the windowed forward: {wrapped}")
        ck(ctrl >= DECODE_TOL, f"control 'unwindowed forward' ({ctrl}) passed the wrapped "
                               f"decode's limit")
        rec["gemma"].update(decode_err=err, wrapped_decode_err=err_w,
                            after_wrap_err=wrapped, wrapped_control=ctrl)
        print(f"[16] wrapped decode, the {FAMILY_DECODE - CHECK_WINDOW} steps after the wrap: "
              f"max abs err {wrapped:.3e} (limit {DECODE_TOL}); control 'the forward "
              f"without the {CHECK_WINDOW}-token window' differs by {ctrl:.3e}", flush=True)
        del params32, model32, full, full_w, got_w, params, tokens, short
    gc.collect()
    torch.cuda.empty_cache()
    rec["gemma"]["serve"], got = family_serve(
        torch, GEMMA_ARCH, {"flash_attention": GEMMA_ATTN, "flash_attention/rows": GEMMA_ATTN,
                            "ssd_chunk": 0}, "[16]")
    add(got)
    gc.collect()
    torch.cuda.empty_cache()

    # mamba2-370m
    cfg = get_config(MAMBA_ARCH)
    model = build_model(cfg)
    with torch.inference_mode():
        params = model.init(gen, "cuda")
        redraw_family_norms(params, gen, 1.0)
        n_params = sum(t.numel() for t in pytree.tree_leaves(params))
        tokens = torch.randint(0, cfg.vocab_size, (MAMBA_BATCH, MAMBA_SEQ),
                               generator=gen, device="cuda")
        print(f"[16] {cfg.name}: {n_params} parameters, bf16, {cfg.n_layers} Mamba-2 layers, "
              f"d_model {cfg.d_model}, {cfg.ssm_heads} heads of {cfg.ssm_headdim}, state "
              f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}", flush=True)
        per_fwd = {"ssd_chunk": MAMBA_SSD, "ssd_chunk/mma": MAMBA_SSD, "ssd_chunk/simt": 0,
                   "flash_attention": 0}

        rec["mamba"], params32, got = family_forward(
            torch, model, params, tokens, per_fwd, "[16]",
            ("no inter-chunk term", lambda: without_inter_chunk(model, params, tokens)))
        add(got)
        rec["mamba"]["profiles"] = family_profiles(torch, model, params, tokens, "[16]")
        ssd_row = mamba_chunk(torch, gen, cfg, ck)
        model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        err, _, _, got = family_decode(
            torch, model32, params32, tokens[:2, :FAMILY_DECODE],
            {"ssd_chunk": MAMBA_SSD, "ssd_chunk/mma": MAMBA_SSD, "flash_attention": 0},
            f"{cfg.name} float32", "[16]")
        add(got)
        ck(err < DECODE_TOL, f"{cfg.name} decode vs teacher forcing: {err}")
        rec["mamba"]["decode_err"] = err
        del params32, model32, params, tokens
    gc.collect()
    torch.cuda.empty_cache()
    rec["mamba"]["serve"], got = family_serve(
        torch, MAMBA_ARCH, {"flash_attention": 0, "ssd_chunk": 0}, "[16]")
    add(got)

    rec["launches"] = {k: v for k, v in total.items() if v}
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[16] card: {smi}; families phase: {json.dumps(rec)}", flush=True)
    ck.raise_any()
    return total, attn_rows, ssd_row


# ---------------------------------------------------------------------------
# phase 17: the encoder-decoder family at its published width
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-medium"
# 1,536 frames: ~30 s of speech at the 50 frames a second of the w2v-BERT
# output the frontend stub stands for
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_TOKENS = 8, 1536, 256
ENCDEC_ATTN = 36                      # a forward: 12 encoder, 12 decoder self, 12 cross
ENCDEC_LAYERS = 12                    # per side
ENCDEC_TRAIN = (4, 256, 1536)         # the training step's B, T_dec, T_enc
ENCDEC_TRAIN_STEPS = 3
ENCDEC_DECODE = (2, 48)               # float32 decode: sequences, steps


def redraw_encdec_norms(params, gen) -> None:
    """In place: every norm scale of the encoder-decoder around 1 (its
    ``rms_norm`` multiplies by the scale itself; the init's zeros make every
    layer add nothing and the logits exactly 0)."""
    import torch

    def around(t):
        t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=gen, device=t.device))

    for side in ("enc_layers", "dec_layers"):
        for key, t in params[side].items():
            if key.startswith("ln"):
                around(t)
    around(params["enc_norm"])
    around(params["dec_norm"])


def causal_encoder(model, params, tokens, frames):
    """The logits of ``model``'s forward with the encoder's self-attention
    made causal (a control); the decoder's attention is unchanged."""
    from repro_torch.models import encdec
    real = encdec._mha

    def mha(p, xq, xkv, cfg, env, causal, rope):
        return real(p, xq, xkv, cfg, env, causal=causal or xq is xkv, rope=rope)

    with patched(encdec, "_mha", mha):
        return model.forward(params, tokens, frames)[0]


def encdec_grad_cases(torch, gen, ck):
    """``AttentionFunction`` at the encoder-decoder's forms under autograd:
    non-causal cross-attention with Tq != Tk at D = 64, on ``wgmma`` (bf16)
    and ``tile`` (f32): one forward launch by its route, none in the
    backward, the gradients autograd's of the plain version.  Returns the
    max relative error by route."""
    errs = {}
    for dtype, route, tol in ((torch.bfloat16, "wgmma", 2e-2), (torch.float32, "tile", 1e-4)):
        q = torch.randn((2, 4, 96, 64), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((2, 4, 300, 64), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        do = torch.randn((2, 4, 96, 64), generator=gen, device="cuda").to(dtype)
        errs[route] = attention_grad_err(torch, q, k, v, do, dict(causal=False), route, ck,
                                         f"cross-attention grads, {route}")
        ck(errs[route] <= tol, f"cross-attention grads ({route}): rel err "
                               f"{errs[route]} > {tol}")
    print(f"[17] non-causal Tq != Tk attention gradients vs plain autograd (D 64), max "
          f"rel err by route: {errs}", flush=True)
    return errs


def encdec_attention(torch, gen, cfg, ck):
    """The encoder-decoder's three attention forms at the phase's shapes,
    each against its plain version (a zeroed output and the same attention
    made causal must fail), timed beside its bound, the plain version and
    SDPA (``is_causal=False``: the same function): the encoder's
    bidirectional self-attention (B 8, H 16, T 1,536, D 64) and the
    cross-attention (Tq 256 against Tk 1,536) on ``wgmma``; decode
    cross-attention (4 sequences, one query against 256 encoder slots) on
    ``rows``."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref
    bf16 = torch.bfloat16
    h, d = cfg.n_heads, cfg.hd
    nb = int(FAMILY_SERVE[1])
    shapes = (("encoder self-attention", ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_FRAMES, "wgmma"),
              ("cross-attention", ENCDEC_BATCH, ENCDEC_TOKENS, ENCDEC_FRAMES, "wgmma"),
              ("decode cross-attention", nb, 1, int(FAMILY_SERVE[3]), "rows"))
    rows = []
    for what, b, tq, tk, route in shapes:
        q = torch.randn((b, h, tq, d), generator=gen, device="cuda").to(bf16)
        k, v = (torch.randn((b, h, tk, d), generator=gen, device="cuda").to(bf16)
                for _ in range(2))
        kw = dict(causal=False, window=0, softcap=0.0, sm_scale=d ** -0.5, q_offset=0,
                  kv_len=tk)
        label = f"seamless {what} B={b} H={h} Tq={tq} Tk={tk} D={d} bf16 non-causal, {route}"
        out = routed(lambda: fk.flash_attention(q, k, v, **kw), fk.flash_attention, route,
                     label)
        ref = attention_ref(q, k, v, **kw)
        limit = attn_limit(q, k, v, kw, ref)
        bad = bad_count(out, ref, limit)
        ck(bad == 0, f"{label}: {bad} elements beyond the attention limit")
        err = float((out.double() - ref.double()).abs().max())
        controls = {"zeroed output": bad_count(0 * ref, ref, limit)}
        if tq > 1:
            controls["made causal"] = bad_count(
                attention_ref(q, k, v, **dict(kw, causal=True)), ref, limit)
        for name, n in controls.items():
            ck(n > 0, f"{label}: control '{name}' passed the attention limit")
        del out, ref, limit
        ms = timed(lambda: fk.flash_attention(q, k, v, **kw))
        flops = 4.0 * b * h * tq * tk * d
        nbytes = 2.0 * b * h * d * (2 * tq + 2 * tk)       # q, o; k, v read once
        b_ms, b_by = bound(flops, nbytes, "bf16")
        lib = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=d ** -0.5))
        row = {"name": f"flash_attention.{route}", "case": label, "ms": ms,
               "plain_ms": timed(lambda: attention_ref(q, k, v, **kw), runs=3),
               "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes,
               "tflops": flops / ms / 1e9, "max_abs_err": err, "controls": controls,
               "library_ms": lib, "library": "SDPA, is_causal=False (the same function)"}
        rows.append(row)
        print(f"[17] {label}: max abs err {err:.3e}; controls fail at {controls}; "
              f"{ms:.4f} ms ({row['tflops']:.1f} TFLOP/s), plain {row['plain_ms']:.4f}, "
              f"SDPA {lib:.4f}, bound {b_ms:.4f} by {b_by}", flush=True)
        del q, k, v
    return rows


def encdec_train(torch, gen, model, params, ck, rec):
    """Phase 17's training: one loss-and-gradients call through the kernels
    against the same call with the plain versions (the loss within 2·E of
    it, E the plain bf16 loss against the float32 twin's; the gradients'
    cosine at least GRAD_COS), then ENCDEC_TRAIN_STEPS ``make_train_step``
    steps (AdamW, fp32 moments) on B x T_dec tokens over T_enc frames from
    the synthetic pipeline: losses finite, every leaf moved, s/step and the
    peak memory.  Consumes ``params``; returns the launches."""
    import dataclasses
    import math
    from torch.utils import _pytree as pytree
    from repro_torch.data.pipeline import PipelineConfig, SyntheticPipeline
    from repro_torch.models.model import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import TrainState, loss_and_grads, make_train_step
    cfg = model.cfg
    b, t_dec, t_enc = ENCDEC_TRAIN
    pipe = SyntheticPipeline(PipelineConfig(
        seed=0, global_batch=b, seq_len=t_dec, vocab_size=cfg.vocab_size,
        frontend=cfg.frontend, frontend_dim=cfg.frontend_dim, frontend_tokens=t_enc),
        device="cuda")
    batch = pipe.batch_at(0)
    per_step = {"flash_attention": 2 * ENCDEC_ATTN, "flash_attention/wgmma": 2 * ENCDEC_ATTN,
                "flash_attention/tile": 0, "flash_attention/rows": 0, "ssd_chunk": 0}
    with torch.no_grad(), plain_kernels():
        params32 = pytree.tree_map(lambda t: t.float(), params)
        twin = float(build_model(dataclasses.replace(cfg, dtype="float32")).loss(
            params32, batch.tokens, batch.labels, batch.patches))
        del params32
    zero_counts()
    loss_k, grads_k = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    expect_counts(read_counts(), per_step, "loss and gradients, kernels", "[17]")
    with plain_kernels():
        loss_p, grads_p = loss_and_grads(model, params, batch)
    loss_k, loss_p = float(loss_k), float(loss_p)
    e = abs(loss_p - twin)
    cos, ratio = grad_agreement(torch, grads_k, grads_p)
    del grads_k, grads_p
    rec.update(train_loss_kernels=loss_k, train_loss_plain=loss_p, train_loss_twin=twin,
               train_loss_limit=2 * e, grad_cos=cos, grad_norm_ratio=ratio)
    ck(abs(loss_k - loss_p) <= 2 * e, f"loss {loss_k} (kernels) vs {loss_p} (plain): "
       f"gap beyond 2 x E = 2 x {e} (bf16 plain vs the float32 twin {twin})")
    ck(cos >= GRAD_COS, f"gradients' cosine {cos} < {GRAD_COS}")
    ck(abs(ratio - 1) <= GRAD_NORM_RATIO, f"gradient norm ratio {ratio}")
    print(f"[17] loss kernels {loss_k:.6f}, plain {loss_p:.6f} (gap "
          f"{abs(loss_k - loss_p):.3e}, limit 2 x E = {2 * e:.3e}, float32 twin "
          f"{twin:.6f}); gradients: cosine {cos:.6f}, norm ratio {ratio:.6f}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    opt = make_optimizer("adamw", peak_lr=TRAIN_LR, warmup=1, total=ENCDEC_TRAIN_STEPS)
    state = TrainState(params=params, opt_state=opt.init(params))
    step_fn = make_train_step(model, opt)
    leaves = pytree.tree_leaves(state.params)
    samples = [t.reshape(-1)[::max(1, t.numel() // 65536)].clone() for t in leaves]
    train = dict.fromkeys(per_step, 0)
    losses, norms, times = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(ENCDEC_TRAIN_STEPS):
        zero_counts()
        t0 = time.perf_counter()
        state, m = step_fn(state, pipe.batch_at(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = read_counts()
        expect_counts(got, per_step, f"train step {i}", "[17]")
        for key in train:
            train[key] += got[key]
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    leaves = pytree.tree_leaves(state.params)
    moved = [not torch.equal(t.reshape(-1)[::max(1, t.numel() // 65536)], s0)
             for t, s0 in zip(leaves, samples)]
    ck(all(map(math.isfinite, losses + norms)), f"losses {losses}, grad norms {norms}")
    ck(all(bool(torch.isfinite(t).all()) for t in leaves),
       "a parameter is not finite after training")
    ck(all(moved), f"{moved.count(False)} of {len(moved)} parameter leaves did not move")
    s_step = statistics.median(times[1:])
    rec.update(train_losses=losses, train_grad_norms=norms, train_step_s=times,
               train_s_per_step=s_step, train_tokens_per_s=b * t_dec / s_step,
               train_frames_per_s=b * t_enc / s_step, train_peak_gb=peak)
    print(f"[17] {ENCDEC_TRAIN_STEPS} train steps at B {b} x T_dec {t_dec} over T_enc "
          f"{t_enc} frames: losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in norms]}; {s_step:.4f} s/step (median of steps 2-"
          f"{ENCDEC_TRAIN_STEPS}; step 1 {times[0]:.3f} s), peak {peak:.2f} GB", flush=True)
    return train


def phase_encdec(torch, seed, smi):
    """Phase 17: seamless-m4t-medium at its published width through the
    normal entry points; returns the kernels' launches by route over the
    phase's model runs and the rows of the new attention shapes."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    ck = Checks("[17]")
    rec = {"card": smi}
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    torch.cuda.reset_peak_memory_stats()
    total = {}

    def add(counts):
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n

    rec["grad_cases"] = encdec_grad_cases(torch, gen, ck)
    cfg = get_config(ENCDEC_ARCH)
    model = build_model(cfg)
    with torch.inference_mode():
        params = model.init(gen, "cuda")
        redraw_encdec_norms(params, gen)
        n_params = sum(t.numel() for t in pytree.tree_leaves(params))
        tokens = torch.randint(0, cfg.vocab_size, (ENCDEC_BATCH, ENCDEC_TOKENS),
                               generator=gen, device="cuda")
        frames = torch.randn((ENCDEC_BATCH, ENCDEC_FRAMES, cfg.frontend_dim),
                             generator=gen, device="cuda")
        print(f"[17] {cfg.name}: {n_params} parameters (param_count {cfg.param_count()}), "
              f"bf16, {cfg.enc_layers} encoder + {cfg.dec_layers} decoder layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}; {ENCDEC_BATCH} x {ENCDEC_FRAMES} frames, "
              f"{ENCDEC_BATCH} x {ENCDEC_TOKENS} tokens", flush=True)
        per_fwd = {"flash_attention": ENCDEC_ATTN, "flash_attention/wgmma": ENCDEC_ATTN,
                   "flash_attention/tile": 0, "flash_attention/rows": 0, "ssd_chunk": 0}
        rec["forward"], params32, got = family_forward(
            torch, model, params, tokens, per_fwd, "[17]",
            ("causal encoder", lambda: causal_encoder(model, params, tokens, frames)),
            patches=frames)
        add(got)
        fwd = rec["forward"]
        fwd["frames_per_s"] = ENCDEC_BATCH * ENCDEC_FRAMES / fwd["forward_s"]
        gc.collect()
        torch.cuda.empty_cache()
        rec["profiles"] = family_profiles(torch, model, params, tokens, "[17]",
                                          patches=frames)
        attn_rows = encdec_attention(torch, gen, cfg, ck)
        # float32: decode teacher-forced with enc_out in the cache
        nseq, nstep = ENCDEC_DECODE
        model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        n_dec = nstep * 2 * ENCDEC_LAYERS
        per_decode = {"flash_attention": ENCDEC_ATTN + ENCDEC_LAYERS + n_dec,
                      "flash_attention/tile": ENCDEC_ATTN + ENCDEC_LAYERS,
                      "flash_attention/rows": n_dec, "flash_attention/wgmma": 0,
                      "ssd_chunk": 0}
        err, _, _, got = family_decode(torch, model32, params32, tokens[:nseq, :nstep],
                                       per_decode, f"{cfg.name} float32", "[17]",
                                       frames=frames[:nseq])
        add(got)
        ck(err < DECODE_TOL, f"{cfg.name} decode vs teacher forcing: {err}")
        rec["decode_err"] = err
        del params32, model32, tokens, frames
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():           # the training state enters autograd
        params = pytree.tree_map(lambda t: t.clone(), params)
    add(encdec_train(torch, gen, model, params, ck, rec))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    per_token = {"flash_attention": 2 * ENCDEC_LAYERS,
                 "flash_attention/rows": 2 * ENCDEC_LAYERS, "flash_attention/wgmma": 0,
                 "ssd_chunk": 0}
    once = {"flash_attention": ENCDEC_LAYERS, "flash_attention/wgmma": ENCDEC_LAYERS}
    rec["serve"], got = family_serve(torch, ENCDEC_ARCH, per_token, "[17]", once=once)
    add(got)
    rec["launches"] = {k: v for k, v in total.items() if v}
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[17] card: {smi}; encoder-decoder phase: {json.dumps(rec)}", flush=True)
    ck.raise_any()
    return total, attn_rows


# ---------------------------------------------------------------------------
# phase 18: the MoE family at its published width, its depth cut
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_BATCH, MOE_SEQ = "mixtral-8x7b", 1, 8192   # the 4,096 window cuts
# the cut (mixtral is 93 GB in bf16): the checks at 4 of its 32 layers (12.1 GB,
# and 24.2 GB for the float32 twin), the timed path at 16 (47.0 GB)
MOE_CHECK_LAYERS, MOE_TIMED_LAYERS = 4, 16
MOE_HEAD_CHUNK = 8                    # query heads a plain attention call scores at once
MOE_SERVE = (4, 256, 64)              # serve.generate: requests, prompt, new tokens
# the profile's ranges: the MoE layer, its expert MLPs, the logits
MOE_RANGES = {"moe layer": ("repro_torch.models.moe", "moe_apply"),
              "expert MLPs": ("repro_torch.models.moe", "experts"),
              "logits": ("repro_torch.models.transformer", "_logits")}


def attention_by_heads(q, k, v, **kw):
    """The plain attention (``attention_ref``) over MOE_HEAD_CHUNK query
    heads and their KV heads at a time: the same function, with the fp32
    scores of 8 heads live instead of 32 (8.6 GB at T 8,192)."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    group = q.shape[1] // k.shape[1]
    step = max(1, MOE_HEAD_CHUNK // group)
    return torch.cat([attention_ref(q[:, h * group:(h + step) * group], k[:, h:h + step],
                                    v[:, h:h + step], **kw)
                      for h in range(0, k.shape[1], step)], dim=1)


class drop_counter:
    """Within the block, each ``moe.routing`` call (one a layer) records
    its dropped slots, its slots and its capacity."""

    def __enter__(self):
        from repro_torch.models import moe
        self.real, self.calls = moe.routing, []

        def routing(*args, **kw):
            r = self.real(*args, **kw)
            self.calls.append((int((~r.keep).sum()), r.keep.numel(), r.cap))
            return r

        moe.routing = routing
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.routing = self.real
        return False


def moe_checks(torch, gen, full, ck, rec, add):
    """Phase 18's checks at MOE_CHECK_LAYERS layers: the dropped slots by
    layer; the forward through the kernels against the plain-attention
    forward (``family_forward``: within 2·E, the forward without its window
    must fail); float32 decode teacher-forced on the dropless check config.
    Returns the cut config."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(full, n_layers=MOE_CHECK_LAYERS)
    model = build_model(cfg)
    per_fwd = {"flash_attention": cfg.n_layers, "flash_attention/wgmma": cfg.n_layers,
               "flash_attention/tile": 0, "flash_attention/rows": 0, "ssd_chunk": 0}
    with torch.inference_mode():
        params = model.init(gen, "cuda")
        redraw_family_norms(params, gen, 0.0)
        n_params = sum(t.numel() for t in pytree.tree_leaves(params))
        tokens = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ), generator=gen,
                               device="cuda")
        print(f"[18] {cfg.name} cut to {cfg.n_layers} layers: {n_params} parameters, bf16",
              flush=True)
        zero_counts()
        with drop_counter() as drops:
            model.forward(params, tokens)
        got = read_counts()
        expect_counts(got, per_fwd, f"{cfg.name} forward {tuple(tokens.shape)}, drops "
                                    f"counted", "[18]")
        add(got)
        check(len(drops.calls) == cfg.n_layers, f"{len(drops.calls)} routing calls")
        rec["dropped_share"] = [n / slots for n, slots, _ in drops.calls]
        print(f"[18] slots dropped by layer at capacity {drops.calls[0][2]} (capacity factor "
              f"{cfg.capacity_factor}, {drops.calls[0][1]} slots a layer): "
              f"{[n for n, _, _ in drops.calls]}, shares {rec['dropped_share']}", flush=True)
        unwindowed = build_model(dataclasses.replace(cfg, attn_window=0))
        with patched(fops, "attention_ref", attention_by_heads):
            rec["check"], params32, got = family_forward(
                torch, model, params, tokens, per_fwd, "[18]",
                ("no window", lambda: unwindowed.forward(params, tokens)[0]))
        add(got)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        # float32 decode, teacher-forced, on the dropless check config
        short = tokens[:, :FAMILY_DECODE]
        check_cfg = dataclasses.replace(cfg, dtype="float32",
                                        capacity_factor=float(cfg.n_experts))
        n_dec = FAMILY_DECODE * cfg.n_layers
        per_decode = {"flash_attention": cfg.n_layers + n_dec, "flash_attention/rows": n_dec,
                      "flash_attention/tile": cfg.n_layers, "flash_attention/wgmma": 0,
                      "ssd_chunk": 0}
        err, got_d, _, got = family_decode(
            torch, build_model(check_cfg), params32, short, per_decode,
            f"check config (not a workload) {cfg.name} float32 capacity_factor="
            f"{check_cfg.capacity_factor} (dropless)", "[18]")
        add(got)
        ck(err < DECODE_TOL, f"{cfg.name} decode vs teacher forcing: {err}")
        # the same steps against the forward at the published capacity
        # factor, which drops slots a one-token step never drops: they may
        # differ by design
        full32, _ = build_model(dataclasses.replace(cfg, dtype="float32")).forward(
            params32, short)
        rec.update(decode_err=err,
                   decode_vs_dropping_forward=float((got_d - full32).abs().max()))
        print(f"[18] the same decode against the float32 forward at capacity factor "
              f"{cfg.capacity_factor} (it may drop by design): max abs err "
              f"{rec['decode_vs_dropping_forward']:.3e}", flush=True)
    return cfg


def moe_timed(torch, gen, full, rec, add):
    """Phase 18's timed path at MOE_TIMED_LAYERS layers: the forward (its
    launches, finite logits; the median of FORWARD_RUNS warm runs, the peak
    memory), profiled by group (``device_profile`` with MOE_RANGES), 2 decode
    steps profiled, and ``serve.generate`` with MOE_SERVE requests."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(full, n_layers=MOE_TIMED_LAYERS)
    model = build_model(cfg)
    per_fwd = {"flash_attention": cfg.n_layers, "flash_attention/wgmma": cfg.n_layers,
               "flash_attention/tile": 0, "flash_attention/rows": 0, "ssd_chunk": 0}
    out = rec["timed"] = {}
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = model.init(gen, "cuda")
        redraw_family_norms(params, gen, 0.0)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        out["init_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["params"] = sum(t.numel() for t in pytree.tree_leaves(params))
        out["weights_gb"] = torch.cuda.memory_allocated() / 1e9
        tokens = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ), generator=gen,
                               device="cuda")
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        logits, aux = model.forward(params, tokens)
        torch.cuda.synchronize()
        out["forward_first_s"] = time.perf_counter() - t0
        got = read_counts()
        expect_counts(got, per_fwd, f"{cfg.name} cut to {cfg.n_layers} layers forward "
                                    f"{tuple(tokens.shape)}", "[18]")
        add(got)
        check(tuple(logits.shape) == (MOE_BATCH, MOE_SEQ, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux)),
              f"{cfg.name}: logits {tuple(logits.shape)} or aux not finite")
        out["aux"] = float(aux)
        del logits, aux
        runs = []
        for _ in range(FORWARD_RUNS):
            t0 = time.perf_counter()
            model.forward(params, tokens)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        out.update(forward_runs_s=runs, forward_s=statistics.median(runs),
                   forward_tok_per_s=tokens.numel() / statistics.median(runs),
                   forward_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"[18] {cfg.name} cut to {cfg.n_layers} layers ({out['params']} parameters, "
              f"{out['weights_gb']:.2f} GB; init {out['init_s']:.2f} s, peak "
              f"{out['init_peak_gb']:.2f} GB): forward {tuple(tokens.shape)} "
              f"{out['forward_s']:.4f} s (median of {FORWARD_RUNS} warm runs "
              f"{[round(r, 4) for r in runs]}; the first {out['forward_first_s']:.3f} s), "
              f"{out['forward_tok_per_s']:.0f} tokens/s, peak {out['forward_peak_gb']:.2f} GB",
              flush=True)
        out["profile"] = prof = device_profile(
            torch, lambda: model.forward(params, tokens),
            f"{cfg.name} ({cfg.n_layers} layers) forward {tuple(tokens.shape)}", "[18]",
            ranges=MOE_RANGES)
        if prof.get("busy_ms") and all(prof["ranges"].values()):
            spans = prof["ranges"]
            attn = prof["groups"].get("flash_attention", {}).get("ms", 0.0)
            out["forward_groups_ms"] = {
                "expert MLPs (bmm + fp32 activation)": spans["expert MLPs"],
                "dispatch torch ops": spans["moe layer"] - spans["expert MLPs"],
                "attention": attn, "logits (fp32)": spans["logits"],
                "rest": prof["busy_ms"] - spans["moe layer"] - spans["logits"] - attn}
            print(f"[18] the forward's device time by group: "
                  f"{json.dumps(out['forward_groups_ms'])} ms", flush=True)
        else:
            print("[18] the forward's device time by group: not measured (no device time "
                  "under the ranges)", flush=True)
        nb, n_prompt, n_new = MOE_SERVE
        cache = model.init_cache(nb, n_prompt + n_new, device="cuda")
        step = tokens[:1, :1].repeat(nb, 1)

        def decode_window():
            cache["pos"] = n_prompt
            for _ in range(2):
                model.decode_step(params, cache, step)

        decode_window()   # warm
        out["decode_profile"] = prof = device_profile(
            torch, decode_window, f"{cfg.name} ({cfg.n_layers} layers) 2 decode steps, "
                                  f"batch {nb}, from position {n_prompt}", "[18]")
        prompt = torch.randint(0, cfg.vocab_size, (nb, n_prompt), generator=gen,
                               device="cuda")
        del cache, tokens
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts()
    served, times = serve.generate(model, params, prompt, n_new)
    got = read_counts()
    n_rows = cfg.n_layers * (n_prompt + n_new - 1)
    expect_counts(got, {"flash_attention": n_rows, "flash_attention/rows": n_rows,
                        "flash_attention/wgmma": 0, "ssd_chunk": 0},
                  f"serve.generate {nb} x ({n_prompt} + {n_new})", "[18]")
    add(got)
    check(tuple(served.shape) == (nb, n_new), f"served {tuple(served.shape)}")
    out["serve"] = {
        "prefill_s": times["prefill_s"], "decode_s": times["decode_s"],
        "decode_tok_per_s": nb * (n_new - 1) / times["decode_s"],
        "launches_a_step": (sum(g["launches"] for g in prof["groups"].values()) / 2
                            if prof.get("groups") else None),
        "busy_share": prof["busy_ms"] / prof["wall_ms"] if prof.get("busy_ms") else None}
    print(f"[18] serve.generate {nb} requests of {n_prompt} + {n_new} tokens on "
          f"{cfg.n_layers} layers: {json.dumps(out['serve'])}", flush=True)


def phase_moe(torch, seed, smi):
    """Phase 18: mixtral-8x7b at its published width, its depth cut to fit
    one card, through the normal entry points; returns the kernels'
    launches by route over the phase's model runs and the rows of the new
    attention shapes."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    ck = Checks("[18]")
    rec = {"card": smi}
    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    torch.cuda.reset_peak_memory_stats()
    total = {}

    def add(counts):
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n

    full = get_config(MOE_ARCH)
    print(f"[18] {full.name}: {full.param_count()} parameters at its published "
          f"{full.n_layers} layers (d_model {full.d_model}, {full.n_heads} heads of "
          f"{full.hd} over {full.n_kv_heads} KV heads, d_ff {full.d_ff}, {full.n_experts} "
          f"experts top-{full.top_k}, capacity factor {full.capacity_factor}, window "
          f"{full.attn_window}, vocab {full.vocab_size}); cut to {MOE_CHECK_LAYERS} layers "
          f"for the checks and {MOE_TIMED_LAYERS} for the timed path", flush=True)
    cfg = moe_checks(torch, gen, full, ck, rec, add)
    gc.collect()
    torch.cuda.empty_cache()
    nb, n_prompt, n_new = MOE_SERVE
    attn_rows = model_attention(
        torch, gen, cfg, ck, "mixtral", "[18]", MOE_BATCH, MOE_SEQ, (cfg.attn_window,),
        [(n_prompt + n_new, n_prompt + n_new // 2, "the server's cache"),
         (cfg.attn_window, cfg.attn_window, "a full rolling cache")])
    gc.collect()
    torch.cuda.empty_cache()
    moe_timed(torch, gen, full, rec, add)
    gc.collect()
    torch.cuda.empty_cache()
    rec["launches"] = {k: v for k, v in total.items() if v}
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[18] card: {smi}; MoE phase: {json.dumps(rec)}", flush=True)
    ck.raise_any()
    return total, attn_rows


# ---------------------------------------------------------------------------
# phase 19: training over a device mesh
# ---------------------------------------------------------------------------

MESH_STEPS = 3                        # meshed AdamW steps timed (then one counted)
PSUM_TRIALS, PSUM_BYTES = 5, 64 << 20  # compressed_psum: the reference test's trials; a timed call
MESH_DRIVER_ARGV = DRIVER_ARGV + ["--mesh", "data=1,model=1"]
MESH_DRIVER_TIMEOUT = 600             # s for the torchrun child
MESH4_ARCH, MESH4_LAYERS, MESH4_BATCH = "yi-9b", 4, (4, 1024)
MESH4_RANKS = 4                       # the 2 x 2 mesh: one NCCL rank per card
MESH4_LOSS_TOL = 1e-2                 # tests/test_distributed.py's meshed-vs-one-device bound


def driver_summary(log: str) -> dict:
    """What ``launch.train`` printed: each logged step's loss, the
    ``done:`` line's first and last loss averages and its failures."""
    import re
    done = [ln for ln in log.splitlines() if ln.startswith("done:")]
    avg = re.search(r"loss (\S+) -> (\S+)", done[0]) if done else None
    fails = re.search(r"failures=(\d+)", done[0]) if done else None
    return {"steps": [[int(a), b] for a, b in re.findall(r"^step\s+(\d+) loss (\S+)",
                                                          log, re.M)],
            "losses": list(avg.groups()) if avg else None,
            "failures": int(fails.group(1)) if fails else None}


def out_proj_times(torch, env, cfg, b: int, t: int) -> dict:
    """One bf16 output projection at ``cfg``'s w_down shape over ``env``'s
    mesh (h (b, t, d_ff) and w placed as the MLP places them), forward and
    backward: ``ShardEnv.out_proj`` (bf16 operands, fp32 partial sums)
    against the same product of fp32 copies, each reduced to ``act_btd``'s
    layout in fp32 before the cast; ms of each and their outputs' max gap."""
    from repro_torch.core import placement as pl
    from repro_torch.distributed.sharding import Spec
    mesh = env.mesh
    gen = torch.Generator(device="cuda").manual_seed(28)
    h = pl.place(torch.randn(b, t, cfg.d_ff, generator=gen, device="cuda").bfloat16(),
                 mesh, pl.spec_placements(mesh, Spec("data", None, "model")))
    w = pl.place((torch.randn(cfg.d_ff, cfg.d_model, generator=gen, device="cuda")
                  / cfg.d_ff ** 0.5).bfloat16(),
                 mesh, pl.spec_placements(mesh, Spec("model", "data")))
    h.requires_grad_()
    w.requires_grad_()
    ways = {"out_proj": lambda: env.out_proj(h, w),
            "fp32 copies": lambda: env.act_btd(env.linear(h.float(), w.float())).to(h.dtype)}

    def step(fn):
        y = fn()
        torch.autograd.grad(y, (h, w), torch.ones_like(y))
        return y

    ys = {k: step(fn).full_tensor() for k, fn in ways.items()}
    return {"ms": {k: timed(lambda fn=fn: step(fn)) for k, fn in ways.items()},
            "max_gap": float((ys["out_proj"].float() - ys["fp32 copies"].float()).abs().max())}


def mesh4_rank_main(rank: int, world: int, store: str, seed: int) -> dict:
    """One of phase 19's four NCCL ranks: yi-9b at its published width, cut
    to MESH4_LAYERS layers, on a 2 x 2 mesh.  Rank 0 also takes the loss and
    gradients on its card alone and the float32 twin's loss (phase 15's E);
    the meshed gradients are gathered whole on every rank and rank 0 holds
    them to its own.  Every rank then times one output projection
    (``out_proj_times``)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.core.compat import make_mesh
    from repro_torch.data import pipeline_for_model
    from repro_torch.distributed import sharding as shlib
    from repro_torch.models import common as cm
    from repro_torch.models.model import build_model
    from repro_torch.train import loss_and_grads

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cuda")
        cfg = dataclasses.replace(get_config(MESH4_ARCH), n_layers=MESH4_LAYERS)
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed + 19)
        with torch.no_grad():
            params = model.init(gen, "cuda")
        b, t = MESH4_BATCH
        batch = pipeline_for_model(cfg, b, t, seed=seed, device="cuda").batch_at(0)
        single = twin = grads_1 = None
        if rank == 0:
            loss_1, grads_1 = loss_and_grads(model, params, batch)
            single = float(loss_1)
            with torch.no_grad(), plain_kernels():
                params32 = pytree.tree_map(lambda p: p.float(), params)
                twin = float(build_model(dataclasses.replace(cfg, dtype="float32")).loss(
                    params32, batch.tokens, batch.labels))
                del params32
        placed = shlib.distribute(params, shlib.param_shardings(params, mesh))
        del params
        dbatch = pipeline_for_model(cfg, b, t, mesh, ("data",), seed=seed,
                                    device="cuda").batch_at(0)
        env = cm.ShardEnv(mesh=mesh, dp=("data",), tp="model")
        loss_and_grads(model, placed, dbatch, env)          # warm
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(model, placed, dbatch, env)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        whole = pytree.tree_map(lambda g: g.full_tensor(), grads)   # every rank gathers
        del grads
        cos = ratio = None
        if rank == 0:
            cos, ratio = grad_agreement(torch, whole, grads_1)
        del whole, grads_1, placed
        torch.cuda.empty_cache()
        return {"rank": rank, "loss": float(loss), "single": single, "f32_twin": twin,
                "grad_cos": cos, "grad_norm_ratio": ratio, "step_s": step_s,
                "launches": launches, "peak_gb": peak,
                "out_proj": out_proj_times(torch, env, cfg, b, t)}
    finally:
        dist.destroy_process_group()


def mesh4_branch(torch, seed, ck, rec) -> None:
    """Phase 19's 2 x 2 mesh on four cards (one NCCL rank each), where the
    machine has them: the meshed loss within phase 15's rule of 2 x E (E the
    one-card loss's gap to its float32 twin) and MESH4_LOSS_TOL of one
    card's, the gathered gradients against one card's."""
    cards = torch.cuda.device_count()
    if cards < MESH4_RANKS:
        rec["mesh4"] = f"not run: {cards} card(s), the 2 x 2 mesh needs {MESH4_RANKS}"
        print(f"[19] the 2 x 2 mesh ({MESH4_ARCH} at {MESH4_LAYERS} layers) needs "
              f"{MESH4_RANKS} cards, one NCCL rank each; this machine has {cards}: "
              f"that branch did not run", flush=True)
        return
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    store = os.path.join(build, f"phase19_store4_{os.getpid()}")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--mesh-rank", str(r), "--dist-store", store],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(MESH4_RANKS)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
        if os.path.exists(store):
            os.remove(store)
    got = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        ck(p.returncode == 0, f"2 x 2 rank {r} exited {p.returncode}: {err[-2000:]}")
        if p.returncode == 0:
            got.append(json.loads(out.strip().splitlines()[-1]))
    if len(got) == MESH4_RANKS:
        one = got[0]
        gap, limit = abs(one["loss"] - one["single"]), 2 * abs(one["single"] - one["f32_twin"])
        ck(len({g["loss"] for g in got}) == 1, f"ranks' losses differ: {got}")
        ck(gap <= limit, f"2 x 2 loss {one['loss']} vs one card's {one['single']}: gap "
                         f"{gap} beyond 2 x E = {limit}")
        ck(gap <= MESH4_LOSS_TOL, f"2 x 2 loss {one['loss']} vs one card's {one['single']}")
        ck(one["grad_cos"] >= GRAD_COS, f"2 x 2 gradients' cosine {one['grad_cos']}")
        ck(abs(one["grad_norm_ratio"] - 1) <= GRAD_NORM_RATIO,
           f"2 x 2 gradient norm ratio {one['grad_norm_ratio']}")
        rec["mesh4"] = got
        print(f"[19] 2 x 2 mesh, {MESH4_ARCH} at {MESH4_LAYERS} layers, B {MESH4_BATCH[0]} "
              f"x T {MESH4_BATCH[1]}: loss {one['loss']:.6f} against one card's "
              f"{one['single']:.6f} (gap {gap:.3e}, limits 2 x E = {limit:.3e} and "
              f"{MESH4_LOSS_TOL}); gradients against one card's: cosine "
              f"{one['grad_cos']:.9f}, norm ratio {one['grad_norm_ratio']:.9f}; loss and "
              f"gradients {[round(g['step_s'], 4) for g in got]} s by rank, peak "
              f"{[round(g['peak_gb'], 2) for g in got]} GB; one bf16 output projection "
              f"(B x T x d_ff into d_model, forward and backward) by rank: "
              f"{[g['out_proj'] for g in got]}", flush=True)


def phase_mesh(torch, seed, smi, train_ref):
    """Phase 19: zamba2-2.7b's training step over a 1 x 1 mesh on a
    one-rank NCCL group at phase 15's shape, against the unmeshed step;
    returns the kernels' launches by route over the phase's steps."""
    import shutil
    import tempfile
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils import _pytree as pytree
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.core import placement as pl
    from repro_torch.core.compat import make_mesh
    from repro_torch.data import pipeline_for_model
    from repro_torch.distributed import compressed_psum
    from repro_torch.distributed import sharding as shlib
    from repro_torch.models import common as cm
    from repro_torch.models.model import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import TrainState, loss_and_grads, make_train_step

    t_phase = time.perf_counter()
    ck = Checks("[19]")
    rec = {"card": smi, "at_s": {}}

    def mark(what):             # the phase's clock at the start of each part
        rec["at_s"][what] = round(time.perf_counter() - t_phase, 3)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    store = os.path.join(build, f"phase19_store_{os.getpid()}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    cfg = get_config(LM_ARCH)
    model = build_model(cfg)
    with torch.no_grad():
        params = model.init(gen, "cuda")
        redraw_norms(params, gen)
    per_step = {"flash_attention": 2 * ATTN_PER_FORWARD,
                "flash_attention/wgmma": 2 * ATTN_PER_FORWARD,
                "flash_attention/tile": 0, "flash_attention/rows": 0,
                "ssd_chunk": 2 * SSD_PER_FORWARD, "ssd_chunk/mma": 2 * SSD_PER_FORWARD,
                "ssd_chunk/simt": 0}
    mesh_launches = dict.fromkeys(per_step, 0)

    def counted(what):
        got = read_counts()
        expect_counts(got, per_step, what, "[19]")
        for key in mesh_launches:
            mesh_launches[key] += got[key]

    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        env = cm.ShardEnv(mesh=mesh, dp=("data",), tp="model")
        batch = pipeline_for_model(cfg, LM_BATCH, LM_SEQ, seed=seed, device="cuda").batch_at(0)
        pipe_m = pipeline_for_model(cfg, LM_BATCH, LM_SEQ, mesh, ("data",), seed=seed,
                                    device="cuda")

        # 1. the unmeshed loss and gradients, profiled (the gradients to the host)
        mark("unmeshed")
        out = {}
        rec["profiles"] = {"unmeshed": device_profile(
            torch, lambda: out.update(u=loss_and_grads(model, params, batch)),
            "unmeshed loss and gradients", "[19]", host_ops=False)}
        loss_u, grads_u = out.pop("u")
        grads_u = pytree.tree_map(lambda g: g.to("cpu"), grads_u)
        loss_u = float(loss_u)
        gc.collect()
        torch.cuda.empty_cache()

        # 2. the meshed loss and gradients from the same parameters (the
        # first meshed call, which fills DTensor's caches), then profiled
        mark("meshed")
        placed = shlib.distribute(params, shlib.param_shardings(params, mesh))
        del params
        dbatch = pipe_m.batch_at(0)
        ck(pl.is_dtensor(dbatch.tokens) and torch.equal(dbatch.tokens.to_local(),
                                                          batch.tokens),
           "the meshed pipeline's batch 0 is not the unmeshed one's tokens, placed")
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_m, grads_m = loss_and_grads(model, placed, dbatch, env)
        torch.cuda.synchronize()
        rec["meshed_first_s"] = time.perf_counter() - t0
        counted("meshed loss and gradients")
        ck(all(pl.is_dtensor(g) and g.placements == p.placements for g, p in
               zip(pytree.tree_leaves(grads_m), pytree.tree_leaves(placed))),
           "a meshed gradient is not placed as its parameter")
        loss_m = float(loss_m)
        mark("agreement")
        cos, ratio = grad_agreement(torch, pytree.tree_map(pl.local, grads_m), grads_u)
        del grads_m, grads_u
        gc.collect()
        torch.cuda.empty_cache()
        rec["profiles"]["meshed"] = device_profile(
            torch, lambda: loss_and_grads(model, placed, dbatch, env),
            "meshed loss and gradients", "[19]", host_ops=False)
        limit = train_ref["loss_limit"]
        rec.update(loss_unmeshed=loss_u, loss_meshed=loss_m, loss_gap=abs(loss_m - loss_u),
                   loss_limit=limit, grad_cos=cos, grad_norm_ratio=ratio)
        ck(abs(loss_m - loss_u) <= limit, f"meshed loss {loss_m} vs unmeshed {loss_u}: "
                                          f"beyond phase 15's 2 x E = {limit}")
        ck(cos >= GRAD_COS, f"meshed gradients' cosine {cos} < {GRAD_COS}")
        ck(abs(ratio - 1) <= GRAD_NORM_RATIO, f"meshed gradient norm ratio {ratio}")
        windows = [rec["profiles"][k]["wall_ms"] / 1e3 for k in ("meshed", "unmeshed")]
        print(f"[19] {cfg.name} at B {LM_BATCH} x T {LM_SEQ} on a 1 x 1 mesh: loss meshed "
              f"{loss_m:.6f}, unmeshed {loss_u:.6f} (gap {abs(loss_m - loss_u):.3e}, limit "
              f"phase 15's 2 x E = {limit:.3e}); gradients: cosine {cos:.9f} (1 - cos = "
              f"{1 - cos:.3e}), norm ratio {ratio:.9f}; loss and gradients "
              f"{windows[0]:.3f} s meshed against {windows[1]:.3f} s unmeshed (profiled "
              f"windows; the first meshed call {rec['meshed_first_s']:.3f} s)", flush=True)
        gc.collect()
        torch.cuda.empty_cache()

        # 3. meshed AdamW steps, timed
        mark("steps")
        opt = make_optimizer("adamw", peak_lr=TRAIN_LR, warmup=1, total=TRAIN_STEPS)
        state = TrainState(params=placed, opt_state=opt.init(placed))
        del placed
        step_fn = make_train_step(model, opt, env)
        times, hosts, losses = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(MESH_STEPS):
            b = pipe_m.batch_at(i)
            zero_counts()
            torch.cuda.synchronize()
            t0, h0 = time.perf_counter(), time.thread_time()
            state, m = step_fn(state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            hosts.append(time.thread_time() - h0)
            counted(f"meshed train step {i}")
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated() / 1e9
        ck(all(np.isfinite(losses)), f"meshed losses {losses}")
        ck(int(pl.local(state.opt_state["count"])) == MESH_STEPS, "the step count")
        s_step = statistics.median(times[1:])
        rec.update(step_s=times, host_s=hosts, s_per_step=s_step, peak_gb=peak,
                   losses=losses, unmeshed_s_per_step=train_ref["s_per_step"],
                   unmeshed_peak_gb=train_ref["peak_gb"])
        ck(peak <= TRAIN_PEAK_GB, f"meshed peak {peak:.2f} GB above {TRAIN_PEAK_GB} GB")

        # 4. one more step, its collectives and redistributions counted
        mark("counted step")
        redist = {"n": 0}
        plain_redistribute = DTensor.redistribute

        def counting(self, *a, **kw):
            redist["n"] += 1
            return plain_redistribute(self, *a, **kw)

        comm = CommDebugMode()
        zero_counts()
        with patched(DTensor, "redistribute", counting), comm:
            state, m = step_fn(state, pipe_m.batch_at(MESH_STEPS))
        torch.cuda.synchronize()
        counted("the counted meshed step")
        rec.update(collectives_per_step=comm.get_total_counts(),
                   collectives_by_op={str(k): v for k, v in comm.get_comm_counts().items()},
                   redistributions_per_step=redist["n"])
        del state
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[19] {MESH_STEPS} meshed AdamW steps: losses {[round(x, 4) for x in losses]}; "
              f"{s_step:.3f} s/step (median of steps 2-{MESH_STEPS}; step 1 "
              f"{times[0]:.3f} s) against phase 15's unmeshed {train_ref['s_per_step']:.3f} "
              f"s/step in this run ({s_step / train_ref['s_per_step']:.3f}x); host thread "
              f"{[round(x, 3) for x in hosts]} s a step; peak {peak:.2f} GB (phase 15 "
              f"{train_ref['peak_gb']:.2f}); a step's collectives "
              f"{rec['collectives_per_step']} {rec['collectives_by_op']}, explicit "
              f"redistributions {redist['n']} (card: {smi})", flush=True)

        # 5. compressed_psum over the NCCL group's one-rank axis: the sum is x
        mark("compressed_psum")
        x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 64))
                             .astype(np.float32)).cuda()
        errs = []
        for trial in range(PSUM_TRIALS):
            g = torch.Generator(device="cuda").manual_seed(trial)
            errs.append((compressed_psum(x, mesh, "data", g) - x).cpu().numpy())
        err, scale = np.stack(errs), float(x.abs().max())
        ck(np.abs(err).max() < 0.1 * scale + 0.2, f"compressed_psum max error "
                                                  f"{np.abs(err).max()}")
        ck(abs(err.mean()) < 0.05 * scale, f"compressed_psum mean error {err.mean()}")
        big = torch.randn(PSUM_BYTES // 4, generator=gen, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(PSUM_TRIALS)
        ms = timed(lambda: compressed_psum(big, mesh, "data", g))
        rec.update(psum_max_err=float(np.abs(err).max()), psum_mean_err=float(err.mean()),
                   psum_scale=scale, psum_ms=ms, psum_gb_per_s=PSUM_BYTES / ms / 1e6)
        del big
        print(f"[19] compressed_psum on the one-rank NCCL axis, {PSUM_TRIALS} trials on "
              f"(4, 64): max error {np.abs(err).max():.4f} (limit "
              f"{0.1 * scale + 0.2:.4f}), mean {err.mean():.2e} (limit "
              f"{0.05 * scale:.4f}); one call on 64 MB of fp32 {ms:.4f} ms, "
              f"{PSUM_BYTES / ms / 1e6:.1f} GB/s of input", flush=True)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)

    # 6. the entry point under torchrun: phase 15's driver, on a 1 x 1 mesh
    mark("driver")
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "repro_torch.launch.train",
           *MESH_DRIVER_ARGV, "--ckpt-dir", root]
    env_vars = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env_vars,
                          timeout=MESH_DRIVER_TIMEOUT)
    rec["driver_s"] = time.perf_counter() - t0
    summary = driver_summary(proc.stdout)
    latest = ckpt.latest_step(root)
    shutil.rmtree(root, ignore_errors=True)
    ck(proc.returncode == 0, f"torchrun ... launch.train {' '.join(MESH_DRIVER_ARGV)} "
                             f"exited {proc.returncode}: {proc.stderr[-2000:]}")
    ck(latest == 24, f"the meshed driver's latest checkpoint is step {latest}, not 24")
    ck(summary["failures"] == 1, f"the meshed driver's failures: {summary}")
    ck(summary == train_ref["driver"], f"the meshed driver printed {summary}; the "
                                       f"unmeshed one {train_ref['driver']}")
    rec["driver"] = summary
    print(f"[19] torchrun --nproc_per_node 1 -m repro_torch.launch.train "
          f"{' '.join(MESH_DRIVER_ARGV)}: {summary} (phase 15 unmeshed: "
          f"{train_ref['driver']}); latest checkpoint {latest}; {rec['driver_s']:.2f} s",
          flush=True)

    # 7. the 2 x 2 mesh on four cards
    mark("four cards")
    mesh4_branch(torch, seed, ck, rec)
    rec["launches"] = {k: v for k, v in mesh_launches.items() if v}
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[19] card: {smi}; mesh phase: {json.dumps(rec, default=str)}", flush=True)
    ck.raise_any()
    return mesh_launches



# ---------------------------------------------------------------------------
# phase 20: MoE training on one card, and the dry run held to it
# ---------------------------------------------------------------------------

DRY_ARCH, DRY_LAYERS, DRY_BATCH, DRY_SEQ = "mixtral-8x7b", 4, 1, 8192
DRY_STEPS = 4                         # AdamW steps timed (median of steps 2-4)
DRY_TOL = 0.10                        # |estimated peak / measured peak - 1| at most this
BF16_PEAK_FLOPS = 989e12              # H100 SXM dense bf16
DRY_CLI_TIMEOUT = 900                 # s for each dry-run CLI child
# the dry run's own CLI: every arch at train_4k on one pod, and one cell of
# each other shape and of two pods, one niced child per cell and one child
# at a time per lane (six lanes and the phase's own process on the host's
# eight cores; grok-1's cell alone takes 130-150 s)
DRY_CLI_LANES = tuple(
    tuple(["--arch", a, "--shape", "train_4k"] for a in lane) for lane in (
        ("grok-1-314b",), ("zamba2-2.7b", "mamba2-370m"),
        ("mixtral-8x7b", "nemotron-4-15b"), ("yi-9b", "llava-next-mistral-7b"),
        ("gemma2-2b", "qwen1.5-0.5b", "seamless-m4t-medium"))) + ((
            ["--arch", "yi-9b", "--shape", "prefill_32k"],
            ["--arch", "zamba2-2.7b", "--shape", "decode_32k"],
            ["--arch", "mamba2-370m", "--shape", "long_500k"],
            # 32 sequences over 64 data ranks: the batch replicates
            ["--arch", "mixtral-8x7b", "--shape", "prefill_32k", "--multi-pod", "on"]),)
# the device time of a training step by group: forward ranges (they cover
# the remat recompute too) and the backward nodes of the same ops
DRY_RANGES = {"expert MLPs": ("repro_torch.models.moe", "experts"),
              "dispatch scatter": ("repro_torch.models.moe", "_scatter"),
              "dispatch gather": ("repro_torch.models.moe", "_gather")}
DRY_BACKWARD = {"expert bmm backward": ("BmmBackward0",),
                "dispatch backward": ("IndexPutBackward0", "IndexBackward0"),
                "attention backward (plain)": ("AttentionFunctionBackward",)}


def dry_cli_child(args, n: int):
    """Start ``python -m repro_torch.launch.dryrun`` on ``args``, at the
    lowest CPU priority (it needs no card and must not slow the timed
    steps), with the card hidden (a "cuda" mesh on the fake group needs
    none, and the child would otherwise hold a context on it), its JSON and
    log under ``build/dryrun``: (args, process, JSON path, log)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "build", "dryrun")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), CUDA_VISIBLE_DEVICES="")
    path = os.path.join(out, f"cells{n}.json")
    log = open(os.path.join(out, f"cells{n}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", path],
        env=env, cwd=root, stdout=log, stderr=subprocess.STDOUT,
        preexec_fn=lambda: os.nice(19))
    return args, proc, path, log


class DryCli:
    """The CLI children of DRY_CLI_LANES: the first cell of each lane
    starts at once, the next when its lane's child ends."""

    def __init__(self):
        self.queued = [list(lane) for lane in DRY_CLI_LANES]
        self.started = 0
        self.running = [self._next(lane) for lane in self.queued]

    def _next(self, lane):
        if not lane:
            return None
        self.started += 1
        return dry_cli_child(lane.pop(0), self.started)

    def kill(self):
        for child in self.running:
            if child is not None and child[1].poll() is None:
                child[1].kill()
                child[1].wait()
            if child is not None:
                child[3].close()

    def finish(self, torch, ck):
        """Wait for every cell (killing the children left on a failure) and
        print each: mode, accumulation, rank 0's peak against the card's
        memory, flops and collective bytes by kind.  Returns the rows."""
        total = torch.cuda.get_device_properties(0).total_memory
        rows = []
        t0 = time.perf_counter()
        try:
            while any(self.running):
                for k, child in enumerate(self.running):
                    if child is None or child[1].poll() is None:
                        continue
                    self.running[k] = self._next(self.queued[k])
                    rows += dry_cli_rows(child, total, ck, time.perf_counter() - t0)
                check(time.perf_counter() - t0 < DRY_CLI_TIMEOUT,
                      f"dry-run CLI children still running after {DRY_CLI_TIMEOUT} s")
                time.sleep(0.2)
        finally:
            self.kill()
        return rows


def dry_cli_rows(child, total: int, ck, waited: float):
    """The rows of one ended CLI child, each printed."""
    args, proc, path, log = child
    log.close()
    text = open(log.name).read()
    ck(proc.returncode == 0, f"dryrun {' '.join(args)} exited {proc.returncode}: "
                             f"{text[-2000:]}")
    if proc.returncode != 0 or not os.path.exists(path):
        return []
    rows = []
    for r in json.load(open(path)):
        ck(r["status"] in ("ok", "skipped"), f"dryrun cell {r['arch']} x {r['shape']}: "
                                             f"{r['status']} {r.get('error', '')[:300]}")
        if r["status"] != "ok":
            continue
        h = r["hlo"]
        row = {"cell": f"{r['arch']} x {r['shape']} x {'2pod' if r['multi_pod'] else '1pod'}",
               "mode": r.get("mode"), "accum_steps": r.get("accum_steps"),
               "optimizer": r.get("optimizer"), "peak_gb": r["memory"]["peak_bytes"] / 1e9,
               "fits": r["memory"]["peak_bytes"] <= total,
               "flops": h["flops"], "hbm_bytes": h["hbm_bytes"],
               "collective_bytes": {k: h[f"{k}_bytes"] for k in (
                   "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                   "collective-permute") if h[f"{k}_bytes"]},
               "collective_bytes_by_axis": h["collective_bytes_by_axis"],
               "total_s": r["total_s"], "ended_s": waited}
        rows.append(row)
        print(f"[20] dryrun {row['cell']}: mode {row['mode']}, accumulation "
              f"{row['accum_steps']}, rank 0's peak {row['peak_gb']:.2f} GB of "
              f"{total / 1e9:.2f} GB ({'fits' if row['fits'] else 'DOES NOT FIT'}), "
              f"{row['flops']:.4e} flops, collectives "
              f"{json.dumps(row['collective_bytes'])} bytes, by mesh axis "
              f"{json.dumps(row['collective_bytes_by_axis'])} ({row['total_s']} s)",
              flush=True)
    return rows


def step_profile(torch, fn, what: str):
    """One training step under ``torch.profiler``: the device time of its
    kernels by group: the forward ranges DRY_RANGES (the remat recompute
    runs them again), the backward nodes DRY_BACKWARD (their kernels, by
    the autograd node that launched them), the attention kernel, and the
    rest.  Returns the groups in ms, or None when the trace holds no device
    time."""
    import importlib
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, real):
        def wrapper(*args, **kw):
            with record_function(name):
                return real(*args, **kw)
        return wrapper

    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for name, (mod, attr) in DRY_RANGES.items():
            obj = importlib.import_module(mod)
            stack.enter_context(patched(obj, attr, ranged(name, getattr(obj, attr))))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # a range's own device-side span is not a kernel
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in DRY_RANGES]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    if not busy:
        print(f"[20] profile {what}: the profiler recorded no device time: not measured")
        return None
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    groups = {name: sum(e.device_time_total for e in cpu if e.name == name) / 1e3
              for name in DRY_RANGES}
    prefix = "autograd::engine::evaluate_function: "
    for group, nodes in DRY_BACKWARD.items():
        groups[group] = sum(e.device_time_total for e in cpu
                            if e.name.startswith(prefix)
                            and e.name[len(prefix):] in nodes) / 1e3
    groups["attention forward (kernel)"] = sum(
        e.device_time_total for e in kernels if "attn_wgmma_kernel" in e.name) / 1e3
    groups["rest"] = busy - sum(groups.values())
    top = {}
    for e in kernels:
        n, t = top.get(e.name, (0, 0.0))
        top[e.name] = (n + 1, t + e.device_time_total / 1e3)
    top = sorted(top.items(), key=lambda kv: -kv[1][1])[:10]
    print(f"[20] profile {what}: window {wall_ms:.1f} ms, device busy {busy:.1f} ms; by "
          f"group (ms): {json.dumps({k: round(v, 3) for k, v in groups.items()})}",
          flush=True)
    for name, (n, t) in top:
        print(f"[20]   {t:10.3f} ms  x{n:<5d} {name[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "groups_ms": groups,
            "top": [[name[:110], n, t] for name, (n, t) in top]}


def moe_train(torch, seed, smi, ck, rec):
    """Phase 20's path on the card: mixtral-8x7b at its published width cut
    to DRY_LAYERS layers, trained at B DRY_BATCH x T DRY_SEQ with the
    optimizer ``dryrun.pick_optimizer`` picks at its size.  Returns (the
    config, the optimizer, the measured step, the launch counts)."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline_for_model
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import costs, dryrun
    from repro_torch.models.model import build_model
    from repro_torch.train import TrainState, loss_and_grads, make_train_step

    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    cfg = dataclasses.replace(get_config(DRY_ARCH), n_layers=DRY_LAYERS)
    check(cfg.remat and cfg.dtype == "bfloat16", f"{cfg.name}: remat {cfg.remat}")
    opt, opt_name = dryrun.pick_optimizer(cfg, cfg.param_count())
    model = build_model(cfg)
    with torch.no_grad():
        params = model.init(gen, "cuda")
        redraw_family_norms(params, gen, 0.0)
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    pipe = pipeline_for_model(cfg, DRY_BATCH, DRY_SEQ, seed=seed, device="cuda")
    batch = pipe.batch_at(0)
    per_step = {"flash_attention": 2 * cfg.n_layers,
                "flash_attention/wgmma": 2 * cfg.n_layers,
                "flash_attention/tile": 0, "flash_attention/rows": 0, "ssd_chunk": 0}
    rec.update(params=n_params, active_params=cfg.active_param_count(),
               optimizer=opt_name)
    print(f"[20] {cfg.name} cut to {cfg.n_layers} of 32 layers: {n_params} parameters "
          f"({cfg.active_param_count()} active), bf16, remat on, optimizer {opt_name} "
          f"(dryrun.pick_optimizer); B {DRY_BATCH} x T {DRY_SEQ}, accumulation 1 "
          f"(pick_accum's 2 for moe needs B >= 2), no mesh", flush=True)
    counts = {}

    def add(got):
        for key, n in got.items():
            counts[key] = counts.get(key, 0) + n

    # 1. the kernels' step against the plain step (phase 15's limits); the
    # plain attention scores 8 query heads at a time (the same function)
    with torch.no_grad(), plain_kernels(), patched(fops, "attention_ref",
                                                   attention_by_heads):
        params32 = pytree.tree_map(lambda t: t.float(), params)
        twin = float(build_model(dataclasses.replace(cfg, dtype="float32")).loss(
            params32, batch.tokens, batch.labels))
        del params32
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts()
    loss_k, grads_k = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    got = read_counts()
    expect_counts(got, per_step, "loss and gradients, kernels", "[20]")
    add(got)
    with plain_kernels(), patched(fops, "attention_ref", attention_by_heads):
        loss_p, grads_p = loss_and_grads(model, params, batch)
    loss_k, loss_p = float(loss_k), float(loss_p)
    e = abs(loss_p - twin)
    cos, ratio = grad_agreement(torch, grads_k, grads_p)
    del grads_k, grads_p
    rec.update(loss_kernels=loss_k, loss_plain=loss_p, loss_f32_twin=twin,
               loss_gap=abs(loss_k - loss_p), loss_limit=2 * e, grad_cos=cos,
               grad_norm_ratio=ratio)
    ck(abs(loss_k - loss_p) <= 2 * e, f"loss {loss_k} (kernels) vs {loss_p} (plain): "
       f"gap beyond 2 x E = 2 x {e} (bf16 plain vs the float32 twin {twin})")
    ck(cos >= GRAD_COS, f"gradients' cosine {cos} < {GRAD_COS}")
    ck(abs(ratio - 1) <= GRAD_NORM_RATIO, f"gradient norm ratio {ratio}")
    print(f"[20] loss kernels {loss_k:.6f}, plain {loss_p:.6f} (gap "
          f"{abs(loss_k - loss_p):.3e}, limit 2 x E = {2 * e:.3e}, float32 twin "
          f"{twin:.6f}); gradients: cosine {cos:.6f}, norm ratio {ratio:.6f}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 2. DRY_STEPS AdamW steps: s/step, tokens/s, the peak over the steps
    state = TrainState(params=params, opt_state=opt.init(params))
    del params
    step_fn = make_train_step(model, opt)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    step = {"argument_bytes": costs.storage_bytes((state, batch)),
            "live_bytes": torch.cuda.memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(DRY_STEPS):
        b = pipe.batch_at(i)
        zero_counts()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = read_counts()
        expect_counts(got, per_step, f"train step {i}", "[20]")
        add(got)
        losses.append(float(m["loss"]))
    step["peak_bytes"] = torch.cuda.max_memory_allocated()
    import math
    ck(all(map(math.isfinite, losses)), f"losses {losses}")
    ck(int(state.step) == DRY_STEPS, f"count {int(state.step)} after {DRY_STEPS} steps")
    s_step = statistics.median(times[1:])
    step.update(losses=losses, step_s=times, s_per_step=s_step,
                tokens_per_s=DRY_BATCH * DRY_SEQ / s_step,
                attention_launches_per_step=per_step["flash_attention/wgmma"])
    print(f"[20] {DRY_STEPS} AdamW steps: losses {[round(x, 4) for x in losses]}; "
          f"{s_step:.3f} s/step (median of steps 2-{DRY_STEPS}; step 1 {times[0]:.3f} s), "
          f"{step['tokens_per_s']:.0f} tokens/s, max_memory_allocated "
          f"{step['peak_bytes'] / 1e9:.3f} GB (card: {smi})", flush=True)

    # 3. one more step, profiled by group
    zero_counts()
    b = pipe.batch_at(DRY_STEPS)

    def one():
        nonlocal state
        state, _ = step_fn(state, b)

    step["profile"] = step_profile(torch, one, f"{cfg.name} ({cfg.n_layers} layers) "
                                               f"train step {tuple(b.tokens.shape)}")
    got = read_counts()
    expect_counts(got, per_step, "the profiled train step", "[20]")
    add(got)
    del state, b
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, opt, step, counts


def held_to_card(torch, ck, what: str, est, step, smi):
    """The dry run's estimate of a step beside what the card measured: the
    arguments' bytes (equal), the peak (the live bytes that are not the
    step's arguments added: the script's own tensors, the caches of
    earlier phases), and the estimate's flops over the measured s/step."""
    mem = est["memory"]
    other = step["live_bytes"] - step["argument_bytes"]
    want = mem["peak_bytes"] + other
    got = step["peak_bytes"]
    flops = est["hlo"]["flops"]
    row = {"what": what, "estimated_peak_gb": mem["peak_bytes"] / 1e9,
           "other_live_gb": other / 1e9, "measured_peak_gb": got / 1e9,
           "peak_ratio": want / got, "argument_bytes": mem["argument_bytes"],
           "card_argument_bytes": step["argument_bytes"], "flops": flops,
           "tflops": flops / step["s_per_step"] / 1e12,
           "bf16_share": flops / step["s_per_step"] / BF16_PEAK_FLOPS,
           "trace_s": est["trace_s"], "kernel_calls": est["kernel_calls"]}
    ck(mem["argument_bytes"] == step["argument_bytes"],
       f"{what}: the dry run's arguments {mem['argument_bytes']} bytes, the card's "
       f"{step['argument_bytes']}")
    ck(abs(want / got - 1) <= DRY_TOL,
       f"{what}: the dry run's peak {want / 1e9:.3f} GB (its own "
       f"{mem['peak_bytes'] / 1e9:.3f} + {other / 1e9:.3f} GB live outside the step) "
       f"against max_memory_allocated {got / 1e9:.3f} GB: beyond {DRY_TOL:.0%}")
    print(f"[20] dry run against the card, {what}: peak estimated "
          f"{row['estimated_peak_gb']:.3f} GB (+ {row['other_live_gb']:.3f} GB live outside "
          f"the step = {want / 1e9:.3f}) vs max_memory_allocated {got / 1e9:.3f} GB "
          f"(ratio {row['peak_ratio']:.4f}, limit 1 +- {DRY_TOL}); arguments "
          f"{mem['argument_bytes']} bytes (card {step['argument_bytes']}); "
          f"{flops:.4e} flops a step / {step['s_per_step']:.3f} s = {row['tflops']:.1f} "
          f"TFLOP/s, {row['bf16_share']:.3f} of 989 bf16 (card: {smi}); traced in "
          f"{est['trace_s']} s", flush=True)
    return row


def phase_dryrun(torch, seed, smi, train_ref):
    """Phase 20: MoE training on one card (mixtral-8x7b at its published
    width, 4 of 32 layers), the dry run's estimates of that step and of
    phase 15's held to the card's allocator, and the dry run's CLI over
    DRY_CLI_CELLS.  Returns the kernels' launches by route in the MoE
    training (the dry run launches none)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import make_optimizer

    t_phase = time.perf_counter()
    ck = Checks("[20]")
    rec = {"card": smi}
    cfg, opt, step, counts = moe_train(torch, seed, smi, ck, rec)
    rec["moe_step"] = step
    rec["moe_s"] = time.perf_counter() - t_phase
    # the CLI children start after the timed and profiled steps, which keep
    # the host to themselves, and run beside the two estimates
    children = DryCli()
    try:
        est = dryrun.estimate(cfg, ShapeCell("phase20", DRY_SEQ, DRY_BATCH, "train"),
                              opt, 1, None)
        rec["held"] = [held_to_card(torch, ck, f"{cfg.name} {cfg.n_layers} layers, B "
                                    f"{DRY_BATCH} x T {DRY_SEQ}, {rec['optimizer']}",
                                    est, step, smi)]
        lm = get_config(LM_ARCH)
        est = dryrun.estimate(lm, ShapeCell("phase15", LM_SEQ, LM_BATCH, "train"),
                              make_optimizer("adamw"), 1, None)
        rec["held"].append(held_to_card(
            torch, ck, f"{lm.name} (phase 15), B {LM_BATCH} x T {LM_SEQ}, adamw-fp32",
            est, train_ref["step"], smi))
        rec["estimates_s"] = time.perf_counter() - t_phase - rec["moe_s"]
    except BaseException:
        children.kill()
        raise
    rec["cli"] = children.finish(torch, ck)
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["launches"] = {k: v for k, v in counts.items() if v}
    print(f"[20] card: {smi}; dry-run phase: {json.dumps(rec)}", flush=True)
    ck.raise_any()
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--chain-launches", action="store_true",
                        help=argparse.SUPPRESS)   # phase 6's child process
    parser.add_argument("--serve-first", choices=("cold", "warm"),
                        help=argparse.SUPPRESS)   # phase 12's child process
    parser.add_argument("--serve-model", help=argparse.SUPPRESS)
    parser.add_argument("--dist-rank", type=int,
                        help=argparse.SUPPRESS)   # phase 13's 2 x 2 ranks
    parser.add_argument("--dist-store", help=argparse.SUPPRESS)
    parser.add_argument("--mesh-rank", type=int,
                        help=argparse.SUPPRESS)   # phase 19's 2 x 2 ranks
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    if args.serve_first:        # timed from the package's import on
        emit(serve_first(args.serve_first, args.serve_model))
        return 0
    import repro_torch  # noqa: F401  (fails outside a checkout)
    if args.chain_launches:
        emit(chain_launches(args.seed))
        return 0
    if args.dist_rank is not None:
        emit(dist_rank_main(args.dist_rank, DIST_RANKS, args.dist_store, args.seed))
        return 0
    if args.mesh_rank is not None:
        emit(mesh4_rank_main(args.mesh_rank, MESH4_RANKS, args.dist_store, args.seed))
        return 0

    name, smi = phase_card(torch)
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    phase_kernels(torch, gen)
    phase_lm_kernels(torch, gen)
    x, A, B, Ab, Bb, km, launches, wall, fit_plans = main_path(torch, gen)
    kernels, whole = phase_times(torch, x, A, B, Ab, Bb, km, launches)
    print(f"[5] card: {smi}; main path wall: {json.dumps(wall)}")
    lazy = phase_lazy(torch, gen, args.seed, x, A, B, km, smi)
    del x, Ab, Bb                  # A, B and km go on to phase 11
    torch.cuda.empty_cache()
    params, hx, hkm, lm_launches, lm_wall, profiles = lm_path(torch, gen)
    del params
    torch.cuda.empty_cache()
    wide, lm_kernel_lines = lm_times(torch, gen, hx, hkm, lm_launches)
    by_path = {"dsarray_kmeans": launches["kmeans_assign"],
               "lazy_plans": lazy["kmeans_assign"],
               "composition": lm_launches["composition"]["kmeans_assign"]}
    keys = ("ms", "bound_ms", "bound_by", "simt_ms", "simt_bound_ms", "simt_bound_by",
            "plain_ms", "library_ms", "max_abs_err")
    kernels.append({
        "name": "kmeans_assign.mma", "route": "cuda",
        "source": "src/repro_torch/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans/kernel.py:57",
        "launches": sum(by_path.values()),
        "launches_by_route": {r: launches[f"kmeans_assign/{r}"]
                              + lazy[f"kmeans_assign/{r}"]
                              + lm_launches["composition"][f"kmeans_assign/{r}"]
                              for r in ("mma", "simt")},
        "launches_by_path": by_path, "shape": whole["case"],
        **{key: whole[key] for key in keys},
        "cases": [{"shape": row["case"], "form": row["form"],
                   **{key: row[key] for key in keys}}
                  for row in (whole, wide)]})
    for gemm, route in zip(kernels[:2], ("wgmma", "simt")):
        gemm["launches_by_path"] = {"dsarray_kmeans": gemm["launches"],
                                    "lazy_plans": lazy[f"stacked_matmul/{route}"]}
        gemm["launches"] += lazy[f"stacked_matmul/{route}"]
    kernels += lm_kernel_lines
    del hx, hkm
    gc.collect()
    torch.cuda.empty_cache()
    sparse_launches, sparse_rows, sparse = phase_sparse(torch, gen, smi)
    est_launches, fitted = phase_estimators(torch, args.seed, smi, sparse)
    durable = phase_durable(torch, smi, fitted, km, A, B, sparse)
    R = sparse[0]                  # phase 13 distributes it
    del sparse, fitted
    gc.collect()
    torch.cuda.empty_cache()
    served, served_gemm, ridge = phase_serve(torch, args.seed, smi, km, A, B)
    gc.collect()
    torch.cuda.empty_cache()
    distributed = phase_distributed(torch, args.seed, smi, A, B, R)
    gc.collect()
    torch.cuda.empty_cache()
    analyzed = phase_analysis(torch, args.seed, smi, fit_plans, km, A, B, R, ridge)
    del A, B, R, km, ridge, fit_plans
    gc.collect()
    torch.cuda.empty_cache()
    trained, train_ref = phase_train(torch, args.seed, smi)
    gc.collect()
    torch.cuda.empty_cache()
    families, attn_rows, ssd_row = phase_families(torch, args.seed, smi)
    gc.collect()
    torch.cuda.empty_cache()
    encdec, encdec_rows = phase_encdec(torch, args.seed, smi)
    attn_rows += encdec_rows
    gc.collect()
    torch.cuda.empty_cache()
    moe, moe_rows = phase_moe(torch, args.seed, smi)
    attn_rows += moe_rows
    gc.collect()
    torch.cuda.empty_cache()
    meshed = phase_mesh(torch, args.seed, smi, train_ref)
    gc.collect()
    torch.cuda.empty_cache()
    moe_trained = phase_dryrun(torch, args.seed, smi, train_ref)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")
    for line in kernels:
        if line["name"].startswith(("flash_attention.", "ssd_chunk.")):
            kind, route = line["name"].split(".")
            for path, counts in (("train", trained), ("families", families),
                                 ("encdec", encdec), ("moe", moe), ("mesh", meshed),
                                 ("moe_train", moe_trained)):
                line["launches_by_path"][path] = counts.get(f"{kind}/{route}", 0)
                line["launches"] += counts.get(f"{kind}/{route}", 0)
                if "launches_by_route" in line:
                    for r in line["launches_by_route"]:
                        line["launches_by_route"][r] += counts.get(f"{kind}/{r}", 0)
            line["cases"] = [{"shape": row["case"], **{key: row[key] for key in keys}}
                             for row in attn_rows + [ssd_row] if row["name"] == line["name"]]
    kernels[1]["cases"].append(served_gemm)
    for gemm, route in zip(kernels[:2], ("wgmma", "simt")):
        for path, counts in (("sparse", sparse_launches), ("estimators", est_launches),
                             ("durable", durable), ("serve", served),
                             ("distribution", distributed), ("analysis", analyzed)):
            gemm["launches_by_path"][path] = counts.get(f"stacked_matmul/{route}", 0)
            gemm["launches"] += counts.get(f"stacked_matmul/{route}", 0)
    assign = kernels[2]
    for path, counts in (("durable", durable), ("serve", served), ("analysis", analyzed)):
        assign["launches_by_path"][path] = counts.get("kmeans_assign", 0)
        assign["launches"] += counts.get("kmeans_assign", 0)
        for r in ("mma", "simt"):
            assign["launches_by_route"][r] += counts.get(f"kmeans_assign/{r}", 0)
    print(f"[9] sparse ops (torch ops, no TPU kernel): "
          f"{json.dumps({'card': smi, 'ops': sparse_rows})}", flush=True)
    print(f"[8] card: {smi}; LM path wall: {json.dumps(lm_wall)}; device profiles: "
          f"{json.dumps(profiles)}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
