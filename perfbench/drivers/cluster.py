"""Clustering traffic, the paper's §5.5 composition as a job repeated
closed loop: ``batches`` batches of ``batch`` x ``seq`` tokens through the
port's ``models/hybrid.py::forward_hidden`` under ``torch.inference_mode``,
the hidden states cast to float32 into a ds-array (``core.dsarray
.from_array`` in blocks of ``block_rows`` rows), ``KMeans(clusters,
max_iter, tol)`` fitted on it (``algorithms/kmeans.py``), then its labels
(``predict``) and inertia (``-score``): the job's answers.

Set-up draws the weights and runs one job (every shape of the window).
The window runs jobs until ``--seconds`` have passed; the rate is the
tokens of all its jobs over its time.  Afterwards the reference checks
``check_jobs`` of the window's jobs, drawn from the seed as they run (the
last one always among them): the hidden states against a float32 forward,
and the fitted centers, labels and inertia, in float64 on the program's
own hidden states, against what they claim to be: each label the nearest
center, the inertia the sum of the nearest distances, each center the
mean of the rows nearest to it among the centers the last Lloyd iteration
started from, the fit stopped only at ``tol`` or ``max_iter``, and the
inertia that of a plain float64 Lloyd loop from the centers the fit
started from.  The fit's starting centers, its last iteration's and that
iteration's shift are the program's own state, recorded as the fit runs:
the judge follows the k-means++ draw and that one step from there, and
checks the rest on its own.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time

import numpy as np
import torch

from perfbench import harness, trace, weights
from perfbench.counts import flops
from perfbench.reference import kmeans as ref_kmeans
from perfbench.reference import models as ref_models
from perfbench.reference.common import precision


def batch_tokens(run, job: int, i: int):
    tr = run.cell.traffic
    gen = torch.Generator(device=run.device).manual_seed(harness.subseed(run.seed, 4, job, i))
    return torch.randint(0, run.model_cfg.vocab_size, (tr["batch"], tr["seq"]),
                         generator=gen, device=run.device, dtype=torch.int32)


@contextlib.contextmanager
def fit_state(seen: dict):
    """``KMeans``'s k-means++ init and Lloyd step wrapped so that ``seen``
    holds the centers the fit started from (``init``), those its last Lloyd
    iteration started from (``prev``) and that iteration's shift
    (``shift``): the tensors themselves, which the fit leaves as they are."""
    from repro_torch.algorithms import kmeans
    real_init, real_step = kmeans._kmeanspp_init_ds, kmeans.KMeans._step

    def init(*args, **kw):
        seen["init"] = real_init(*args, **kw)
        return seen["init"]

    def step(self, x, rows, centers, x_sq):
        seen["prev"] = centers
        new, seen["shift"] = real_step(self, x, rows, centers, x_sq)
        return new, seen["shift"]

    kmeans._kmeanspp_init_ds, kmeans.KMeans._step = init, step
    try:
        yield
    finally:
        kmeans._kmeanspp_init_ds, kmeans.KMeans._step = real_init, real_step


def job(run, params, j: int) -> dict:
    """One job; returns its answers, its hidden states, the fit's state
    (``fit_state``) and its time.  A planted ``one_iter`` fault stops the
    fit after one Lloyd iteration."""
    from repro_torch.algorithms.kmeans import KMeans
    from repro_torch.core.dsarray import from_array
    from repro_torch.models import hybrid
    tr, cfg = run.cell.traffic, run.model_cfg
    with torch.inference_mode():
        hidden = [hybrid.forward_hidden(params, cfg, batch_tokens(run, j, i))[0]
                  for i in range(tr["batches"])]
    x = torch.cat([h.reshape(-1, h.shape[-1]) for h in hidden]).float()
    del hidden
    if run.fault == "alter":
        x[0] = x[1]
    sync = torch.cuda.synchronize if run.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    fit_rows = x[: x.shape[0] // 2] if run.fault == "half_batch" else x
    seen = {}
    max_iter = 1 if run.fault == "one_iter" else tr["max_iter"]
    with fit_state(seen):
        ds = from_array(fit_rows, (tr["block_rows"], x.shape[1]), device=run.device)
        km = KMeans(n_clusters=tr["clusters"], max_iter=max_iter, tol=tr["tol"],
                    seed=harness.subseed(run.seed, 5, j) & 0x7FFFFFFF).fit(ds)
    fit_s = time.perf_counter() - t0
    full = ds if fit_rows is x else from_array(x, (tr["block_rows"], x.shape[1]),
                                                device=run.device)
    labels = km.predict(full).collect().reshape(-1)
    if not torch.is_tensor(labels):
        labels = torch.as_tensor(labels)
    inertia = -km.score(full)
    d = x.shape[1]
    return {"x": x, "centers": km.centers_, "labels": labels, "inertia": inertia,
            "prev": seen["prev"][:, :d], "init": seen["init"][:, :d],
            "shift": seen["shift"], "n_iter": km.n_iter_, "fit_s": fit_s}


def flops_of(run, jobs) -> int:
    tr, m = run.cell.traffic, run.cell.config["model"]
    n = tr["batches"] * tr["batch"] * tr["seq"]
    per_pass = flops.kmeans_pass(n, m["d_model"], tr["clusters"])
    fwd = tr["batches"] * flops.forward(m, tr["batch"], tr["seq"])
    # each Lloyd iteration, the predict and the score make one pass each
    return sum(fwd + (j["n_iter"] + 2) * per_pass for j in jobs)


def run(run):
    from repro_torch.models.model import build_model

    tr = run.cell.traffic
    model = build_model(run.model_cfg)
    params = weights.make_params(model, run.cell.config["init"],
                                 harness.subseed(run.seed, 1), run.device)
    cuda = run.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    job(run, params, -1)
    sync()
    run.mark_setup_done()

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(harness.subseed(run.seed, 7))
    keep, done = tr["check_jobs"], []
    kept = {}
    t0 = time.perf_counter()
    while True:
        j = len(done)
        out = job(run, params, j)
        sync()
        done.append({"n_iter": out["n_iter"], "fit_s": out["fit_s"],
                     "inertia": out["inertia"]})
        # a reservoir of keep - 1 earlier jobs, and the newest
        kept[j] = out
        older = sorted(kept)[:-1]
        if len(older) >= keep:
            drop = older[int(rng.integers(len(older)))]
            kept.pop(drop)
        if time.perf_counter() - t0 >= run.seconds:
            break
    elapsed = time.perf_counter() - t0
    n = len(done)
    run.attempted = n
    run.failed = sum(1 for d in done if not np.isfinite(d["inertia"]))
    run.window = {
        "cluster_tokens_per_s": n * tr["batches"] * tr["batch"] * tr["seq"] / elapsed,
        "seconds": elapsed, "jobs": n, "model_flops": flops_of(run, done),
        "kmeans_fit_s": statistics.median(d["fit_s"] for d in done),
        "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}

    if run.trace:
        def one():
            job(run, params, n)
            return 1
        run.traced = trace.profile(one, torch)

    del params, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    gaps = check(run, kept)
    for name, value in gaps.items():
        run.compare(name, value)


def check(run, kept: dict, mode: str = "fp32", fit_mode=None) -> dict:
    """The widest gaps over the kept jobs: each job's hidden states against
    the reference's forward in ``mode``; its answers judged in float64
    (or, with ``fit_mode``, those of the reference's own fit in that
    precision, put in the program's place)."""
    from perfbench.drivers.train import p0
    tr, m = run.cell.traffic, run.cell.config["model"]
    first = p0(run)
    params = {k: first.pop(k).float() for k in list(first)}
    worst = {}
    for j, out in sorted(kept.items()):
        with torch.no_grad(), precision(mode):
            want = torch.cat([ref_models.hidden(params, m, batch_tokens(run, j, i))
                              .reshape(-1, m["d_model"]) for i in range(tr["batches"])])
        gaps = {"hidden_gap": ref_kmeans.row_gap(out["x"], want)}
        del want
        answers = out
        if fit_mode is not None:
            answers = ref_kmeans.fit(out["x"], tr["clusters"], tr["max_iter"], tr["tol"],
                                     harness.subseed(run.seed, 5, j), fit_mode)
        gaps.update(ref_kmeans.judge(out["x"], answers["centers"], answers["labels"],
                                     answers["inertia"], answers["prev"], answers,
                                     tr["max_iter"], tr["tol"]))
        for k, v in gaps.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def control(run, sides=None) -> dict:
    """Readings for the limits: the sound program's kept jobs; the
    reference forward with fp8 products and the reference K-means with
    TF32 products in the program's place (the controls); the fit on half
    the rows, one row of the hidden states altered and the fit stopped
    after one iteration (planted faults).  ``sides`` names the controls
    and faults wanted (all by default)."""
    from repro_torch.models.model import build_model
    model = build_model(run.model_cfg)
    params = weights.make_params(model, run.cell.config["init"],
                                 harness.subseed(run.seed, 1), run.device)
    outs = {}
    for fault in (None, "half_batch", "alter", "one_iter"):
        if fault is not None and sides is not None and fault not in sides:
            continue
        run.fault = fault
        outs[fault or "program"] = {0: job(run, params, 0)}
    run.fault = None
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    got = {k: check(run, v) for k, v in outs.items()}
    if sides is None or "control_fp8_forward" in sides:
        got["control_fp8_forward"] = check(run, outs["program"], mode="fp8")
    if sides is None or "control_tf32_kmeans" in sides:
        got["control_tf32_kmeans"] = check(run, outs["program"], fit_mode="tf32")
    got["detail"] = " ".join(f"{k} n_iter {v[0]['n_iter']} shift {v[0]['shift']}"
                             for k, v in outs.items())
    return got
