"""Training traffic: one AdamW step after another on batches drawn from the
seed, through the port's ``train.step.make_train_step`` over
``models.model.build_model``.

Set-up builds the one state the window trains (weights drawn by
``weights.py``, the optimizer ``optim.make_optimizer`` builds) and drives it
through its first ``check_steps`` steps, which warm every shape and are the
steps the reference follows.  The window then steps on, each step on a
batch of its own, until ``--seconds`` have passed: the rate is the tokens
of all its steps over all its time.  A traced run profiles
``trace_steps`` more steps after the window.

Mix parameters (``traffic/<mix>.json``): ``batch``, ``seq``,
``check_steps``, ``trace_steps`` and ``optimizer`` (``peak_lr``,
``warmup``, ``total``, ``b1``, ``b2``, ``eps``, ``weight_decay``,
``clip_norm``); the configuration may set ``optimizer.moment_dtype``.
"""

from __future__ import annotations

import gc
import time

import torch

from perfbench import compare, harness, routing, trace, weights
from perfbench.counts import flops
from perfbench.reference import models as ref_models
from perfbench.reference import train as ref_train

AUTOGRAD = "autograd::engine::evaluate_function: "


def optimizer_settings(run) -> dict:
    return {**run.cell.traffic["optimizer"], **run.cell.config.get("optimizer", {})}


def tokens(run, i: int, batch: int, seq: int):
    """Batch ``i`` of the run: tokens uniform over the vocabulary, the
    labels the next tokens."""
    gen = torch.Generator(device=run.device).manual_seed(harness.subseed(run.seed, 2, i))
    ids = torch.randint(0, run.model_cfg.vocab_size, (batch, seq + 1), generator=gen,
                        device=run.device, dtype=torch.int32)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


class _Frozen:
    """An optimizer whose step leaves the state as it was (a planted fault)."""

    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        from repro_torch.optim.adamw import global_norm
        return params, state, {"grad_norm": global_norm(grads),
                               "lr": torch.zeros(())}


def half_batch(model):
    """``model`` whose loss is the mean over half the batch (half the
    sequence when the batch is one sequence): a planted fault."""
    import dataclasses
    from repro_torch.models.model import Model

    class Half(Model):
        def loss(self, params, tokens, labels, patches=None, env=None):
            if tokens.shape[0] > 1:
                h = tokens.shape[0] // 2
                return super().loss(params, tokens[:h], labels[:h])
            h = tokens.shape[1] // 2
            return super().loss(params, tokens[:, :h], labels[:, :h])

    return Half(**{f.name: getattr(model, f.name) for f in dataclasses.fields(model)})


def program_readings(run, state, step_fn, batch: int, seq: int, opt: dict):
    """Drive the state through ``check_steps`` steps; the readings the
    reference is held to (with the routing of a sparse-expert model's
    steps, ``routes``, and the weights after them on the host, ``final``),
    and the state after them."""
    out = {"loss": [], "grad_norm": [], "grad_leaf": {}, "delta_leaf": {}}
    rec = routing.Recorder(run.model_cfg.n_layers)
    for i in range(run.cell.traffic["check_steps"]):
        toks, labels = tokens(run, i, batch, seq)
        rec.begin()
        with routing.recording(rec):
            state, met = step_fn(state, _batch(toks, labels))
        out["loss"].append(float(met["loss"]))
        out["grad_norm"].append(float(met["grad_norm"]))
        if i == 0:
            scale = 1.0 / (1.0 - opt["b1"])
            out["grad_leaf"] = {k: compare.leaf_norm(t, scale) for k, t in
                                weights.leaf_names(state.opt_state["m"])}
    first = p0(run)
    for k, t in weights.leaf_names(state.params):
        out["delta_leaf"][k] = compare.diff_norm(t, first.pop(k))
    out["final"] = {k: t.detach().to("cpu", copy=True)
                    for k, t in weights.leaf_names(state.params)}
    out["routes"] = rec.calls if run.model_cfg.n_experts else None
    return state, out


def _batch(toks, labels):
    from repro_torch.data.pipeline import Batch
    return Batch(tokens=toks, labels=labels)


def p0(run):
    """The run's first weights, drawn again."""
    from repro_torch.models.model import build_model
    tree = weights.meta_tree(build_model(run.model_cfg))
    return weights.draw(tree, run.cell.config["init"], harness.subseed(run.seed, 1),
                        run.device)


def build(run):
    """The one training state of the run and its step: the weights drawn
    from the seed, the optimizer ``optim.make_optimizer`` builds as the mix
    and the configuration set it (a planted fault, where the run has one,
    under the step)."""
    from repro_torch.models.model import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train.step import TrainState, make_train_step
    opt = optimizer_settings(run)
    model = build_model(run.model_cfg)
    optimizer = make_optimizer("adamw", peak_lr=opt["peak_lr"], warmup=opt["warmup"],
                               total=opt["total"],
                               moment_dtype=opt.get("moment_dtype", "float32"),
                               weight_decay=opt["weight_decay"])
    if run.fault == "unchanged":
        optimizer = _Frozen(optimizer)
    if run.fault == "half_batch":
        model = half_batch(model)
    params = weights.make_params(model, run.cell.config["init"],
                                 harness.subseed(run.seed, 1), run.device)
    state = TrainState(params=params, opt_state=optimizer.init(params))
    return state, make_train_step(model, optimizer), opt


def window(run):
    """Set-up (the state and its first steps), the measured window and, in
    a traced run, the traced steps; returns the program's readings and
    the optimizer's settings."""
    tr = run.cell.traffic
    b, t = tr["batch"], tr["seq"]
    state, step_fn, opt = build(run)
    state, prog = program_readings(run, state, step_fn, b, t, opt)
    run.mark_setup_done()

    sync = torch.cuda.synchronize if run.device.type == "cuda" else (lambda: None)
    first = tr["check_steps"]
    sync()
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    while True:
        toks, labels = tokens(run, first + len(losses), b, t)
        state, met = step_fn(state, _batch(toks, labels))
        losses.append(met["loss"])
        sync()
        if time.perf_counter() - t0 >= run.seconds:
            break
    elapsed = time.perf_counter() - t0
    n = len(losses)
    run.attempted = n
    run.failed = sum(1 for x in losses if not torch.isfinite(x).item())
    run.window = {
        "train_tokens_per_s": n * b * t / elapsed, "seconds": elapsed, "steps": n,
        "model_flops": n * flops.train_step(run.cell.config["model"], b, t),
        "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                              if run.device.type == "cuda" else 0)}

    if run.trace:
        done = [first + n]

        def steps():
            nonlocal state
            for _ in range(tr["trace_steps"]):
                toks, labels = tokens(run, done[0], b, t)
                state, _ = step_fn(state, _batch(toks, labels))
                done[0] += 1
            return tr["trace_steps"]

        run.traced = trace.profile(steps, torch, host_names=lambda s: s.startswith(AUTOGRAD))
    return prog, opt


def run(run):
    with routing.planted(run.fault):
        prog, opt = window(run)
    _free()
    ref = reference(run, opt, prog["routes"], against={"program": prog.pop("final")})
    for name, value in gaps(prog, ref).items():
        run.compare(name, value)
    run.notes["program"], run.notes["reference"] = prog, ref
    run.notes["detail"] = (f"loss {prog['loss']} ref {ref['loss']}\n"
                           f"grad_norm {prog['grad_norm']} ref {ref['grad_norm']}\n"
                           + leaf_table(prog, ref))


def reference(run, opt: dict, routes=None, loss_fn=ref_models.loss, against=None,
              keep_final: bool = False) -> dict:
    """The reference's readings over the same batches from the same draw
    (``ref_train.readings``: ``against`` and ``keep_final`` are its); a
    sparse-expert model's layers follow the choices of ``routes`` (a list
    per step of ``(assign, keep)`` per layer) where given, and the readings
    hold the routing's numbers (``route_margin``, ``drop_gap``) and the
    reference's own choices (``routes``)."""
    m = run.cell.config["model"]
    tr = run.cell.traffic
    first = p0(run)
    stored = {k: t.dtype for k, t in first.items()}
    params = {k: first.pop(k).float() for k in list(first)}
    steps = tr["check_steps"]
    follows = [routing.Follow(None if routes is None else routes[i]) for i in range(steps)]
    batches = [(*tokens(run, i, tr["batch"], tr["seq"]), follows[i]) for i in range(steps)]
    out = ref_train.readings(params, stored, m, batches, opt, lambda: p0(run),
                             loss_fn=loss_fn, against=against, keep_final=keep_final)
    if run.model_cfg.n_experts:
        out["route_margin"] = max(f.margin for f in follows)
        out["drop_gap"] = max(f.drops for f in follows)
        out["routes"] = [f.choices() for f in follows]
    return out


def half_loss(params, m, toks, labels, follow=None):
    """The reference's loss over half the batch: a fault planted in the
    reference put in the program's place."""
    if toks.shape[0] > 1:
        h = toks.shape[0] // 2
        return ref_models.loss(params, m, toks[:h], labels[:h], follow)
    h = toks.shape[1] // 2
    return ref_models.loss(params, m, toks[:, :h], labels[:, :h], follow)


def leaf_table(prog: dict, ref: dict, top: int = 6) -> str:
    """The leaves with the widest gaps, both sides' norms beside them."""
    rows = []
    for k in ref["grad_leaf"]:
        g, gr = prog["grad_leaf"].get(k, 0.0), ref["grad_leaf"][k]
        d, dr = prog["delta_leaf"].get(k, 0.0), ref["delta_leaf"][k]
        rows.append((abs(g - gr) / max(gr, 1e-30), k, g, gr, d, dr))
    rows.sort(reverse=True)
    return "\n".join(f"leaf {k}: grad {g:.6e} ref {gr:.6e} change {d:.6e} ref {dr:.6e}"
                     for _, k, g, gr, d, dr in rows[:top])


def gaps(prog: dict, ref: dict, side: str = "program") -> dict:
    """The cell's numbers; for a sparse-expert model also the routing's."""
    out = compare.train_gaps(prog, ref, side)
    for name in ("route_margin", "drop_gap"):
        if name in ref:
            out[name] = ref[name]
    return out


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def control(run, sides=None) -> dict:
    """Readings for the limits, at the cell's own size and without a
    window: the sound program against the reference, and against it the
    reference computed in fp8 (the control) and the reference over half the
    batch (a planted fault), each in the program's place; with a
    sparse-expert model also the program with each slot sent to the next
    expert and with 8 slots fewer kept an expert (planted faults).  A step
    that leaves the state unchanged reads 1 on the leaf gaps and on
    ``param_gap`` and needs no run.  ``sides`` names the readings wanted
    (all by default); the sound program's are always read."""
    from perfbench.reference.common import precision
    tr = run.cell.traffic
    experts = bool(run.model_cfg.n_experts)
    want = lambda side: sides is None or side in sides    # noqa: E731
    out, prog = {}, None
    for fault in (None, "route", "drops") if experts else (None,):
        if fault is not None and not want(fault):
            continue
        run.fault = fault
        with routing.planted(fault):
            state, step_fn, opt = build(run)
            state, prog = program_readings(run, state, step_fn, tr["batch"], tr["seq"], opt)
        del state, step_fn
        _free()
        if experts:
            # each side's reference follows the choices of the side it judges
            side = fault or "program"
            ref = reference(run, opt, prog["routes"], against={side: prog.pop("final")})
            out[side] = gaps(prog, ref, side)
            out.setdefault("detail", leaf_table(prog, ref))
            _free()
    run.fault = None
    if experts:
        for side, kw in (("control_fp8", {}), ("fault_half_batch", {"loss_fn": half_loss})):
            if not want(side):
                continue
            with precision("fp8" if side == "control_fp8" else "fp32"):
                low = reference(run, opt, keep_final=True, **kw)
            _free()
            ref = reference(run, opt, low["routes"], against={side: low.pop("final")})
            out[side] = gaps(low, ref, side)
            _free()
        return out
    finals, sides_read = {"program": prog.pop("final")}, {}
    for side, kw in (("control_fp8", {}), ("fault_half_batch", {"loss_fn": half_loss})):
        if want(side):
            with precision("fp8" if side == "control_fp8" else "fp32"):
                sides_read[side] = reference(run, opt, keep_final=True, **kw)
            finals[side] = sides_read[side].pop("final")
            _free()
    ref = reference(run, opt, against=finals)
    out = {"program": gaps(prog, ref), "detail": leaf_table(prog, ref)}
    out.update({side: gaps(got, ref, side) for side, got in sides_read.items()})
    return out
