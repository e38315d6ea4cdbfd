"""Scoring traffic: teacher-forced scoring of one document after another,
closed loop: the port's ``Model.loss`` (``models/transformer.py::loss_fn``,
the chunked float32 loss) under ``torch.no_grad`` on each document, whose
loss is the answer.  Each document is drawn from the seed, its tokens
uniform over the vocabulary.

Set-up draws the weights and scores one document (every shape of the
window).  The window scores documents until ``--seconds`` have passed;
the rate is their tokens over the window's time.  Afterwards
``check_docs`` of the window's documents, drawn from the seed with the
first and the last among them, are scored again by the float32 reference,
and the widest relative gap of a document's loss is the compared number.

Mix parameters: ``batch`` (documents a call), ``seq``, ``check_docs``,
``trace_items`` (documents profiled after the window in a traced run).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import compare, harness, routing, trace, weights
from perfbench.counts import flops
from perfbench.reference import models as ref_models
from perfbench.reference.common import precision

MOE_RANGE = {"perfbench.moe_apply": ("repro_torch.models.moe", "moe_apply")}


def document(run, i: int):
    tr = run.cell.traffic
    gen = torch.Generator(device=run.device).manual_seed(harness.subseed(run.seed, 3, i))
    ids = torch.randint(0, run.model_cfg.vocab_size, (tr["batch"], tr["seq"] + 1),
                        generator=gen, device=run.device, dtype=torch.int32)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def sample(run, n: int):
    """The documents checked: the first and the last of the window's ``n``
    and others drawn from the seed."""
    want = min(run.cell.traffic["check_docs"], n)
    rng = np.random.default_rng(harness.subseed(run.seed, 6))
    rest = rng.permutation(np.arange(1, max(n - 1, 1)))[:max(want - 2, 0)]
    return sorted({0, n - 1, *map(int, rest)})


def scorer(run, model, params):
    """The timed call: a document's loss; with a planted fault, half the
    document scored, or each answer altered by 1 %."""
    def score(i, toks, labels):
        if run.fault == "half_batch":
            h = toks.shape[1] // 2
            toks, labels = toks[:, :h], labels[:, :h]
        loss = model.loss(params, toks, labels)
        if run.fault == "alter":
            loss = loss * 1.01
        return loss
    return score


def reference_losses(run, docs, routes=None, mode: str = "fp32"):
    """The reference's loss of each document in ``docs`` (float32 weights of
    the same draw), each sparse-expert layer following ``routes[i]`` (the
    choices of the side judged) where given; returns (losses, the routing's
    numbers (``route_margin``, ``drop_gap``), the reference's own choices
    per document)."""
    from perfbench.drivers.train import p0
    m = run.cell.config["model"]
    first = p0(run)
    params = {k: first.pop(k).float() for k in list(first)}
    out, own = [], []
    gaps = {"route_margin": 0.0, "drop_gap": 0.0}
    with torch.no_grad(), precision(mode):
        for i in docs:
            toks, labels = document(run, i)
            follow = routing.Follow(None if routes is None else routes[i])
            out.append(float(ref_models.loss(params, m, toks, labels, follow)))
            gaps = {"route_margin": max(gaps["route_margin"], follow.margin),
                    "drop_gap": max(gaps["drop_gap"], follow.drops)}
            own.append(follow.choices())
    return out, gaps, own


def window(run):
    """Set-up, the measured window and, in a traced run, the traced
    documents; returns each window document's loss and the routing the
    program recorded for it."""
    from repro_torch.models.model import build_model

    tr, cfg = run.cell.traffic, run.model_cfg
    model = build_model(cfg)
    params = weights.make_params(model, run.cell.config["init"],
                                 harness.subseed(run.seed, 1), run.device)
    score = scorer(run, model, params)
    cuda = run.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with torch.no_grad():
        warm = score(-1, *document(run, -1))
        float(warm)
    run.mark_setup_done()

    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses = []
    rec = routing.Recorder(cfg.n_layers)
    t0 = time.perf_counter()
    with torch.no_grad(), routing.recording(rec):
        while True:
            i = len(losses)
            rec.begin()
            losses.append(score(i, *document(run, i)))
            sync()
            if time.perf_counter() - t0 >= run.seconds:
                break
    elapsed = time.perf_counter() - t0
    n = len(losses)
    got = [float(x) for x in losses]
    run.attempted = n
    run.failed = sum(1 for x in got if not np.isfinite(x))
    toks = n * tr["batch"] * tr["seq"]
    run.window = {"score_tokens_per_s": toks / elapsed, "seconds": elapsed, "docs": n,
                  "model_flops": n * flops.forward(run.cell.config["model"],
                                                   tr["batch"], tr["seq"]),
                  "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}

    if run.trace:
        def docs():
            with torch.no_grad():
                for j in range(tr["trace_items"]):
                    score(n + j, *document(run, n + j))
            return tr["trace_items"]
        run.traced = trace.profile(docs, torch, host_names=lambda s: s in MOE_RANGE,
                                   range_spec=MOE_RANGE)
    return got, rec.calls


def run(run):
    with routing.planted(run.fault):
        got, calls = window(run)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    docs = sample(run, len(got))
    routes = {i: calls[i] for i in docs}
    del calls
    ref, route, _ = reference_losses(run, docs, routes)
    run.compare("score_loss_gap", compare.rel_gap([got[i] for i in docs], ref))
    for name, value in route.items():
        run.compare(name, value)
    run.notes["detail"] = f"docs {docs}: loss {[got[i] for i in docs]} ref {ref}"


def control(run, sides=None) -> dict:
    """Readings for the limits: the sound program's documents against the
    reference, and against it, each in the program's place, the reference
    in fp8 (the control), half of each document scored and each answer
    altered by 1 %, each slot sent to the next expert and 8 slots fewer
    kept an expert (planted faults); ``sides`` names the control and the
    faults wanted (all by default)."""
    from repro_torch.models.model import build_model
    model = build_model(run.model_cfg)
    params = weights.make_params(model, run.cell.config["init"],
                                 harness.subseed(run.seed, 1), run.device)
    docs = list(range(run.cell.traffic["check_docs"]))
    out, routes = {}, {}
    for fault in (None, "half_batch", "alter", "route", "drops"):
        if fault is not None and sides is not None and fault not in sides:
            continue
        run.fault = fault
        score = scorer(run, model, params)
        rec = routing.Recorder(run.model_cfg.n_layers)
        with torch.no_grad(), routing.planted(fault), routing.recording(rec):
            got = []
            for i in docs:
                rec.begin()
                got.append(float(score(i, *document(run, i))))
        out[fault or "program"], routes[fault or "program"] = got, rec.calls
    run.fault = None
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    gaps = {}
    for k, v in out.items():
        ref, route, _ = reference_losses(run, docs, routes[k])
        gaps[k] = {"score_loss_gap": compare.rel_gap(v, ref), **route}
    gaps["detail"] = f"program {out['program']}"
    if sides is None or "control_fp8" in sides:
        low, _, low_routes = reference_losses(run, docs, mode="fp8")
        ref, route, _ = reference_losses(run, docs, low_routes)
        gaps["control_fp8"] = {"score_loss_gap": compare.rel_gap(low, ref), **route}
        gaps["detail"] += f" fp8 {low} ref (fp8's routes) {ref}"
    return gaps
