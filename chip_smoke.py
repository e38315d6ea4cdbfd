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
   ``flash_attention`` on the cases of ``tests/test_kernels.py`` and D of
   80, 112 and 256 in f32 (SIMT tile), bf16 and f16 (wgmma), at the LM
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
   without its causal mask and an SSD without its inter-chunk term must
   fail;
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
   its sums pass apart).

The line before the last is ``{"kernels": [...]}`` with one object per
kernel and route; the last is ``{"ok": true, "device": {...}}``.  Without a
CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
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


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gemm_bad(out, ref, depth: int) -> int:
    """Elements beyond |out - ref| <= GEMM_ERRS·eps32·√depth·rms(ref) +
    eps_out·|ref|: the fp32 accumulation error of a depth-long reduction
    summed in another order, plus one unit in the last place of the output
    type, which both sides round their fp32 sums to."""
    import torch
    ref = ref.double()
    rms = float(ref.pow(2).mean().sqrt()) if ref.numel() else 0.0
    atol = GEMM_ERRS * torch.finfo(torch.float32).eps * depth ** 0.5 * rms
    rtol = torch.finfo(out.dtype).eps
    diff = (out.double() - ref).abs()
    return int((diff > atol + rtol * ref.abs()).sum())


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


def attn_check(out, q, k, v, kw, what: str, causal_control: bool = False):
    """``out`` against the plain attention within ``attn_limit``; a zeroed
    output (and, for causal attention, the same attention without its
    causal mask) must fail that limit.  Returns the max abs error."""
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
    for name, n in controls.items():
        check(n > 0, f"{what}: control '{name}' passed the attention limit")
    print(f"[3] {what}: max abs err {err:.3e}; controls fail at "
          f"{controls} of {ref.numel()} elements")
    return err


class plain_kernels:
    """Within the block, the models and ``ssd_scan`` run the plain attention
    and the plain SSD chunk instead of the CUDA kernels (the package has no
    such switch: the script patches the two entries it calls)."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ref as fref
        from repro_torch.kernels.ssd import ops as sops
        from repro_torch.kernels.ssd.ref import ssd_chunk_ref
        from repro_torch.models import common as cm
        self.saved = (cm.flash_attention, sops.ssd_chunk)
        cm.flash_attention = fref.attention_ref
        sops.ssd_chunk = ssd_chunk_ref
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


def expect_counts(got, want, what: str) -> None:
    for name, n in want.items():
        check(got[name] == n, f"{what}: {name} launched {got[name]} times, "
                              f"the path implies {n}")
    print(f"[7] {what}: launches {got}", flush=True)


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
        return attn_check(out, q, k, v, kw, what, causal_control=hides)

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


def main_path(torch, gen):
    """Phase 4: the main path through the public entry points."""
    import repro_torch as rt
    from repro_torch.algorithms import KMeans
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.kernels.matmul import kernel as mk
    from repro_torch.kernels.matmul.ref import stacked_matmul_ref
    from repro_torch.obs import registry, tracing

    n, m, k = N_ROWS, N_FEATURES, N_CLUSTERS
    true_centers = torch.rand(k, m, generator=gen, device="cuda") * 20 - 10
    truth = torch.randint(0, k, (n,), generator=gen, device="cuda")
    data = true_centers[truth] + torch.randn(n, m, generator=gen, device="cuda")
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
    with tracing.recording() as events:
        t0 = time.perf_counter()
        km.fit(x)
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
    return x, A, B, Ab, Bb, km, launches, wall


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


def device_profile(torch, fn, what: str):
    """Runs ``fn`` once under ``torch.profiler`` and prints the device time
    of its kernels by group (the port's kernels, cuBLAS, the rest of the
    torch ops), the top kernels, and the device's busy share of the
    window's host-clock time; returns the summary.  A trace without device
    time prints 'not measured'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a first kernel and a sync, so the trace is live before the window
        # (kernels launched right after the profiler starts can go unseen)
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, _, ms in kernels)
    if not kernels:
        print(f"[8] profile {what}: the profiler recorded no device time: not measured")
        return {"what": what, "wall_ms": wall_ms, "busy_ms": None}
    groups = {}
    for name, count, ms in kernels:
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(key in name for key in keys)), "other torch ops")
        n, t = groups.get(group, (0, 0.0))
        groups[group] = (n + count, t + ms)
    top = sorted(kernels, key=lambda k: -k[2])[:6]
    print(f"[8] profile {what}: window {wall_ms:.3f} ms (host clock, profiler on), "
          f"device busy {busy:.3f} ms ({busy / wall_ms:.3f} of it); by group: "
          + "; ".join(f"{g} {t:.3f} ms in {n} launches" for g, (n, t) in
                      sorted(groups.items(), key=lambda kv: -kv[1][1])), flush=True)
    for name, count, ms in top:
        print(f"[8]   {ms:10.3f} ms  x{count:<5d} {name[:110]}")
    return {"what": what, "wall_ms": wall_ms, "busy_ms": busy,
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
    from repro_torch.models import ssm as ssm_mod
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

        # forward through the kernels
        zero_counts()
        t0 = time.perf_counter()
        logits, _ = model.forward(params, tokens)
        torch.cuda.synchronize()
        wall["forward_first_s"] = time.perf_counter() - t0
        launches["forward"] = read_counts()
        expect_counts(launches["forward"], per_fwd, f"forward {tuple(tokens.shape)}")
        check(bool(torch.isfinite(logits).all()), "forward logits not finite")
        # the same forward with the plain versions.  Limit: a bf16 forward
        # lies about E = rms(plain bf16 - float32 model) from the float32
        # model, and two such forwards at most 2E from each other (a rounding
        # difference anywhere is amplified over 54 layers, so the kernels'
        # own error is not the scale: the bf16 model's is)
        with plain_kernels():
            plain, _ = model.forward(params, tokens)
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            model32 = build_model(cfg32)
            params32 = torch.utils._pytree.tree_map(lambda t: t.float(), params)
            exact, _ = model32.forward(params32, tokens)
            saved = ssm_mod.ssd_scan
            ssm_mod.ssd_scan = lambda *a, **kw: ssd_without_inter(*a, **kw)
            try:
                no_inter, _ = model.forward(params, tokens)
            finally:
                ssm_mod.ssd_scan = saved

        def rms(t):
            return float(t.double().pow(2).mean().sqrt())

        err = rms(logits - plain)
        own = rms(plain - exact)
        limit = 2 * own
        controls = {"zeroed logits": rms(plain), "no inter-chunk term": rms(no_inter - plain)}
        agree = float((logits.argmax(-1) == plain.argmax(-1)).double().mean())
        check(err <= limit, f"forward logits rms err {err} vs the plain forward, "
                            f"beyond 2 x the bf16 model's own {own}")
        for name, val in controls.items():
            check(val > limit, f"control '{name}' ({val}) passed the logits limit")
        print(f"[7] forward logits vs plain: rms err {err:.4e} (limit 2 x {own:.4e}, the "
              f"plain bf16 forward vs the float32 model; the kernels' forward vs the "
              f"float32 model {rms(logits - exact):.4e}; logits rms {rms(plain):.4e}); "
              f"argmax agrees at {agree:.6f} of positions; controls {controls}",
              flush=True)
        del logits, plain, exact, no_inter
        # the forward's time: median of warm runs (the first, above, is cold)
        runs = []
        for _ in range(FORWARD_RUNS):
            t0 = time.perf_counter()
            model.forward(params, tokens)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        wall["forward_runs_s"] = runs
        wall["forward_s"] = statistics.median(runs)
        wall["forward_tok_per_s"] = LM_BATCH * LM_SEQ / wall["forward_s"]

        # float32 at the same widths: decode teacher-forced against forward
        zero_counts()
        short = tokens[:, :DECODE_SEQ]
        full, _ = model32.forward(params32, short)
        cache = model32.init_cache(LM_BATCH, DECODE_SEQ, device="cuda")
        derr = 0.0
        for i in range(DECODE_SEQ):
            lg, cache = model32.decode_step(params32, cache, short[:, i:i + 1])
            derr = max(derr, float((lg[:, 0] - full[:, i]).abs().max()))
        launches["decode_f32"] = read_counts()
        expect_counts(launches["decode_f32"],
                      {"flash_attention": ATTN_PER_FORWARD * (1 + DECODE_SEQ),
                       "ssd_chunk": SSD_PER_FORWARD, "ssd_chunk/mma": SSD_PER_FORWARD,
                       "flash_attention/tile": ATTN_PER_FORWARD,     # float32
                       "flash_attention/rows": ATTN_PER_FORWARD * DECODE_SEQ},
                      f"float32 forward + {DECODE_SEQ} decode steps")
        check(derr < DECODE_TOL, f"decode vs teacher forcing: {derr}")
        print(f"[7] float32 decode vs teacher forcing over {DECODE_SEQ} tokens: max "
              f"abs err {derr:.3e} (limit {DECODE_TOL}; logits rms "
              f"{rms(full):.3e})", flush=True)
        del full, cache

        # serve.generate on the card, float32: every token the argmax of the
        # teacher-forced forward, except where that forward's top two logits
        # lie within 2 x DECODE_TOL (decode may then pick either)
        zero_counts()
        prompt = short[:, :GEN32_PROMPT]
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
        tau = TOP_ERRS * rms(fwd - exact)
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--chain-launches", action="store_true",
                        help=argparse.SUPPRESS)   # phase 6's child process
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    if args.chain_launches:
        emit(chain_launches(args.seed))
        return 0

    name, smi = phase_card(torch)
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    phase_kernels(torch, gen)
    phase_lm_kernels(torch, gen)
    x, A, B, Ab, Bb, km, launches, wall = main_path(torch, gen)
    kernels, whole = phase_times(torch, x, A, B, Ab, Bb, km, launches)
    print(f"[5] card: {smi}; main path wall: {json.dumps(wall)}")
    lazy = phase_lazy(torch, gen, args.seed, x, A, B, km, smi)
    del x, A, B, Ab, Bb, km
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
    print(f"[8] card: {smi}; LM path wall: {json.dumps(lm_wall)}; device profiles: "
          f"{json.dumps(profiles)}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
