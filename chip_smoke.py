#!/usr/bin/env python3
"""Drive the repro_torch main path once on one CUDA card, and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; the kernels are built from
``src/repro_torch/csrc`` at first use.  Phases, in order (any failure
raises and the script exits non-zero):

1. card and precision: the card, its power limit, the TF32 switches (off);
2. build: both CUDA kernels, with the build seconds and ptxas' report;
3. kernel vs plain on the card: ``stacked_matmul`` in f32/bf16/f16, with
   ``transpose_a``, ragged blocks, a strided view, split-K, the 2-D entry and
   an int32 operand that must raise; ``kmeans_assign`` with ragged n,
   gm > 1, k not a multiple of 8, and k·d past one block's shared memory
   (centers staged in chunks, the partial in global scratch);
4. the main path at a size K-means users run: 8,000,000 x 100 fp32 samples
   in 64 Gaussian blobs, blocks (262,144 x 100): ``from_array`` ->
   ``mean(axis=0)`` -> ``matmul_ta(x, x)``; 8192² ``A @ B`` and
   ``matmul_ta(A, B)`` in f32 and bf16 with blocks (2048, 2048);
   ``KMeans(64, max_iter=20, tol=1e-4, seed=0)`` fit, predict and score.
   The launch counts are zeroed just before and read just after, and every
   result is checked against a plain or float64 version; a zeroed product
   and products of bf16- or TF32-rounded inputs must fail the GEMM check;
5. times at the main path's shapes (median of 7 CUDA-event timed runs after
   a warm-up) beside the bound the card's data sheet gives, and the main
   path's wall times.

The line before the last is ``{"kernels": [...]}`` with one object per
kernel; the last is ``{"ok": true, "device": {...}}``.  Without a CUDA card
it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# NVIDIA H100 SXM data sheet (dense): fp32 on CUDA cores, bf16/f16 on tensor
# cores, HBM3 bandwidth
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12, "f16": 989e12}
PEAK_BYTES = 3.35e12

N_ROWS, N_FEATURES, N_CLUSTERS = 8_000_000, 100, 64
X_BLOCK = (262_144, 100)
SQUARE, SQUARE_BLOCK = 8192, (2048, 2048)
SAMPLE_ROWS = 1_000_000
TIMED_RUNS = 7
# GEMM limit: GEMM_ERRS x the fp32 error of a depth-K sum, eps·√K·rms(ref),
# plus one unit in the last place of the output type
GEMM_ERRS = 8
# a label may differ from its reference only at a near-tie: the float64 gap
# between the row's two nearest centers is below GAP_ERRS x the largest fp32
# error of a distance measured on these rows; and at most NEAR_TIE_SHARE of
# the rows may be such near-ties
GAP_ERRS = 4
NEAR_TIE_SHARE = 1e-4


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
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
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


def check_labels(rows, centers, got, want, what: str):
    """Holds ``got`` to ``want`` up to near-ties; returns (near_ties, err).

    ``err`` is the largest |fp32 − float64| of the distances of the first
    SAMPLE_ROWS rows to every center: the measured rounding of the fp32
    expansion, which grows with the norms, not with the distance.  A row
    whose label differs is a near-tie when the float64 gap between its two
    nearest centers is below GAP_ERRS·err; any other disagreement, or more
    near-ties than NEAR_TIE_SHARE of the rows, fails."""
    import math
    import torch
    probe = rows[:SAMPLE_ROWS].float()
    c32 = centers.float()
    err = float((sq_dists(probe, c32).double()
                 - sq_dists(probe.double(), c32.double())).abs().max())
    diff = got.long() != want.long()
    near = 0
    if bool(diff.any()):
        d = sq_dists(rows[diff].double(), c32.double())
        two = torch.topk(d, min(2, c32.shape[0]), dim=1, largest=False).values
        is_near = (two[:, -1] - two[:, 0]) < GAP_ERRS * err
        near, other = int(is_near.sum()), int((~is_near).sum())
        check(other == 0, f"{what}: {other} labels differ beyond near-ties "
                          f"(gap >= {GAP_ERRS} x {err:.3e})")
    cap = math.ceil(NEAR_TIE_SHARE * rows.shape[0])
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


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[2] build: {time.perf_counter() - t0:.3f} s", flush=True)
    for name, log in sorted(_build.BUILD_LOGS.items()):
        used = sorted({line.split(":", 1)[1].strip() for line in log.splitlines()
                       if "Used" in line})
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line})
        print(f"[2] {name}: {'; '.join(used)}; {'; '.join(spills)}")


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
    cases = [  # gi, gk, gj, bn, bk, bm, dtype, transpose_a
        (2, 2, 2, 128, 128, 128, f32, False),
        (2, 3, 2, 50, 70, 30, f32, False),        # ragged blocks
        (1, 2, 1, 300, 9, 257, f16, False),
        (2, 3, 2, 50, 70, 30, bf16, True),
        (3, 2, 1, 33, 17, 5, f32, True),
        (1, 31, 1, 100, 2000, 100, f32, True),    # split-K
    ]
    for gi, gk, gj, bn, bk, bm, dt, ta in cases:
        a = rnd(gk, gi, bk, bn, dtype=dt) if ta else rnd(gi, gk, bn, bk, dtype=dt)
        b = rnd(gk, gj, bk, bm, dtype=dt)
        out = mk.stacked_matmul(a, b, out_dtype=dt, transpose_a=ta)
        ref = stacked_matmul_ref(a, b, out_dtype=dt, transpose_a=ta)
        torch.cuda.synchronize()
        err = gemm_close(out, ref, gk * bk)
        print(f"[3] stacked_matmul {(gi, gk, gj, bn, bk, bm)} {dt} "
              f"transpose_a={ta}: max abs err {err:.3e}")
    # a permuted view (DsArray.transpose) read through its strides
    base = dsa.from_array(rnd(300, 200), (64, 48), device="cuda")
    other = dsa.from_array(rnd(300, 90), (64, 40), device="cuda")
    at = base.T
    check(not at.blocks.is_contiguous(), "transpose should be a view")
    got = (at @ other).collect()
    want = base.collect().T @ other.collect()
    err = gemm_close(got, want, 300)
    print(f"[3] stacked_matmul strided Aᵀ view: max abs err {err:.3e}")
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
    for gn, gm, bn, bm, n, k in [(3, 2, 100, 60, 250, 17), (1, 1, 600, 130, 600, 5),
                                 (4, 1, 128, 16, 500, 64), (2, 3, 97, 11, 150, 12),
                                 (4, 2, 512, 392, 2000, 10),      # 32-row tiles
                                 (3, 1, 700, 1000, 1900, 16),     # 8-center chunks
                                 (3, 7, 1000, 112, 2500, 64),     # global partial
                                 (4, 1, 1024, 64, 4000, 1000)]:   # many clusters
        x = rnd(gn, gm, bn, bm)
        valid = torch.arange(gn * bn, device="cuda").reshape(gn, 1, bn, 1) < n
        x = (x * valid).contiguous()
        c = rnd(k, gm * bm) * 0.5
        l1, s1, c1 = kk.kmeans_assign_stacked(x, c, n)
        l2, _, _ = kmeans_assign_stacked_ref(x, c, n)
        torch.cuda.synchronize()
        check(bool((l1[n:] == -1).all()), "rows >= n must get label -1")
        near, _ = check_labels(stacked_rows(x, n), c, l1[:n], l2[:n],
                               f"kmeans_assign k={k} d={gm * bm}")
        serr = check_stats(x, l1, s1, c1, f"kmeans_assign k={k} d={gm * bm}")
        plan = kk.launch_plan(lib, k, gm * bm, 0)
        print(f"[3] kmeans_assign {(gn, gm, bn, bm)} n={n} k={k} {plan}: labels "
              f"differ at {near} near-ties, sums max abs err {serr:.3e}")
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

    mk.stacked_matmul.launches = 0
    kk.kmeans_assign_stacked.launches = 0
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
    launches = {"stacked_matmul": mk.stacked_matmul.launches,
                "kmeans_assign": kk.kmeans_assign_stacked.launches}
    loop = [e["dur"] for e in events if e["name"] == "fit.loop"]
    iters = [e["dur"] for e in events if e["name"] == "fit.iteration"]
    wall["lloyd_s"] = loop[0] / 1e6
    wall["init_s"] = wall["fit_s"] - wall["lloyd_s"]
    wall["s_per_iteration"] = statistics.median(iters) / 1e6 if iters else None
    wall["n_iter"] = km.n_iter_
    print(f"[4] launches on the main path: {launches}; GEMM dispatches "
          f"{registry.snapshot('gemm')}")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")

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


def phase_times(torch, x, A, B, Ab, Bb, km, launches):
    """Phase 5: kernel, plain and library times at the main path's shapes."""
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.kernels.kmeans.ref import kmeans_assign_stacked_ref
    from repro_torch.kernels.matmul import kernel as mk
    from repro_torch.kernels.matmul import ops as mops
    from repro_torch.kernels.matmul.ref import matmul_ref, stacked_matmul_ref

    def report(row):
        lib = row["library_ms"]
        print(f"[5] {row['case']}: {row['ms']:.3f} ms (plain {row['plain_ms']:.3f}, "
              f"library {'-' if lib is None else f'{lib:.3f}'}, bound "
              f"{row['bound_ms']:.3f} by {row['bound_by']})", flush=True)
        return row

    def gemm_case(label, a, b, ta, kind, depth=None):
        """``depth`` is the reduction length the product needs (the valid
        rows of a Gram), where it is less than the padded gk·bk."""
        out_dtype = a.dtype
        av = a.permute(1, 0, 3, 2) if ta else a
        gi, gk, bn, bk = av.shape
        gj, bm = b.shape[1], b.shape[3]
        m, k, n = gi * bn, depth or gk * bk, gj * bm
        flops = 2.0 * m * n * k
        # each input read once (a Gram's one operand once), the output written once
        nbytes = a.element_size() * (m * k + (0 if b is a else k * n) + m * n)
        spec = "kiba,kjbc->ijac" if ta else "ikab,kjbc->ijac"
        out = mk.stacked_matmul(a, b, out_dtype=out_dtype, transpose_a=ta)
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

    cases = [
        gemm_case(f"A@B {SQUARE}² f32, blocks {SQUARE_BLOCK}", A.blocks, B.blocks,
                  False, "fp32"),
        gemm_case(f"matmul_ta(A,B) {SQUARE}² f32", A.blocks, B.blocks, True, "fp32"),
        gemm_case(f"A@B {SQUARE}² bf16", Ab.blocks, Bb.blocks, False, "bf16"),
        gemm_case(f"matmul_ta(A,B) {SQUARE}² bf16", Ab.blocks, Bb.blocks, True, "bf16"),
        gemm_case(f"matmul_ta(x,x) Gram {N_ROWS}x{N_FEATURES}, blocks {X_BLOCK} "
                  f"(split-K)", x.blocks, x.blocks, True, "fp32", depth=x.shape[0]),
    ]
    # the 2-D entry (the counterpart of matmul_padded), same kernel
    a2d, b2d = A.collect(), B.collect()
    flops = 2.0 * SQUARE ** 3
    nbytes = 3 * 4.0 * SQUARE * SQUARE
    b_ms, b_by = bound(flops, nbytes, "fp32")
    err = gemm_close(mops.matmul(a2d, b2d), a2d @ b2d, SQUARE)
    cases.append(report({
        "case": f"2-D matmul {SQUARE}² f32 (matmul_padded's entry)",
        "ms": timed(lambda: mops.matmul(a2d, b2d)),
        "plain_ms": timed(lambda: matmul_ref(a2d, b2d)),
        "library_ms": timed(lambda: torch.matmul(a2d, b2d)),
        "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes,
        "max_abs_err": err}))

    # kmeans_assign at the fit's shape, against the fitted centers
    blocks = x.blocks
    gn, gm, bn, bm = blocks.shape
    centers = torch.nn.functional.pad(km.centers_, (0, gm * bm - km.centers_.shape[1]))
    centers = centers.contiguous()
    n = x.shape[0]
    l1, s1, c1 = kk.kmeans_assign_stacked(blocks, centers, n)
    l2, _, _ = kmeans_assign_stacked_ref(blocks, centers, n)
    near, lerr = check_labels(stacked_rows(blocks, n), centers, l1[:n], l2[:n],
                              "kmeans_assign at full size")
    serr = check_stats(blocks, l1, s1, c1, "kmeans_assign at full size")
    del l1, s1, c1, l2
    k, d, n_pad = centers.shape[0], gm * bm, gn * bn
    # the n valid rows: distances, argmin, ‖x‖², sums; n_pad labels written
    flops = 2.0 * n * k * d + 3.0 * n * k + 2.0 * n * d + n * d
    nbytes = 4.0 * (n * d + k * d + n_pad + k * d + k)
    b_ms, b_by = bound(flops, nbytes, "fp32")
    km_row = report({
        "case": f"assign {n}x{d}, k={k}, blocks {X_BLOCK}, "
                f"{kk.launch_plan(kk._lib(), k, d, 0)}",
        "ms": timed(lambda: kk.kmeans_assign_stacked(blocks, centers, n)),
        "plain_ms": timed(lambda: kmeans_assign_stacked_ref(blocks, centers, n)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "flops": flops, "bytes": nbytes, "max_abs_err": serr,
        "label_near_ties": near})
    print(f"[5] kmeans_assign full size: labels differ from the plain version at "
          f"{near} near-ties (gap < {GAP_ERRS} x {lerr:.3e}), 0 others; sums max "
          f"abs err {serr:.3e} vs float64", flush=True)

    head = cases[0]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return [
        {"name": "stacked_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/stacked_matmul.cu",
         "replaces": "src/repro/kernels/matmul/kernel.py:75",
         "launches": launches["stacked_matmul"], "shape": head["case"],
         **{key: head[key] for key in keys}, "cases": cases},
        {"name": "kmeans_assign", "route": "cuda",
         "source": "src/repro_torch/csrc/kmeans_assign.cu",
         "replaces": "src/repro/kernels/kmeans/kernel.py:57",
         "launches": launches["kmeans_assign"], "shape": km_row["case"],
         **{key: km_row[key] for key in keys}},
    ]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    name, smi = phase_card(torch)
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    phase_kernels(torch, gen)
    x, A, B, Ab, Bb, km, launches, wall = main_path(torch, gen)
    kernels = phase_times(torch, x, A, B, Ab, Bb, km, launches)
    print(f"[5] card: {smi}; main path wall: {json.dumps(wall)}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
