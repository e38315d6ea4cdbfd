"""The port's training path against the JAX package, on the CPU.

zamba2-2.7b SMOKE in float32, parameters from the reference's ``init`` with
the norms, ``conv_b`` and ``dt_bias`` redrawn (``tests/test_torch_models.py``
explains why), carried across with ``convert``; both packages take the same
NumPy tokens.  Held: the losses at rtol 1e-4 (values and gradients), the
train step's loss and ``grad_norm`` at rtol 1e-4 over 3 steps, per-leaf
gradients at rtol 1e-3 and atol 1e-3·max|g|, both optimizers on identical
gradients at atol 1e-6.  The pipeline is held to its law and to
determinism (torch cannot replay ``jax.random``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.data.pipeline import Batch as JaxBatch  # noqa: E402
from repro.data.pipeline import pipeline_for_model as jax_pipeline_for_model  # noqa: E402
from repro.distributed.fault_tolerance import \
    run_with_restarts as jax_run_with_restarts  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.step import TrainState as JaxTrainState  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import resilience as R  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.data import (Batch, PipelineConfig, SyntheticPipeline,  # noqa: E402
                              pipeline_for_model)
from repro_torch.distributed import Heartbeat, run_with_restarts  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import (clip_by_global_norm, cosine_schedule,  # noqa: E402
                               make_optimizer)
from repro_torch.optim import adamw as adamw_mod  # noqa: E402
from repro_torch.train import TrainState, make_train_step  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
B, T = 2, 40          # T = 40 at chunk 16: three SSD chunks, the last padded
STEPS = 3
TOL = dict(rtol=1e-4)


def redraw_norms(tree, rng):
    layers, shared = tree["layers"], tree["shared"]

    def around(v, centre):
        return (centre + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)

    for key in ("norm", "gate_norm"):
        layers[key] = around(layers[key], 1.0)
    layers["conv_b"] = around(layers["conv_b"], 0.0)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), layers["dt_bias"].shape))
    layers["dt_bias"] = np.log(np.expm1(dt)).astype(np.float32)
    tree["final_norm"] = around(tree["final_norm"], 1.0)
    for key in ("ln1", "ln2"):
        shared[key] = around(shared[key], 0.0)
    return tree


def _paths(tree, prefix=""):
    """{path: leaf} of nested dicts, whatever their key order."""
    if isinstance(tree, dict):
        out = {}
        for key, v in tree.items():
            out.update(_paths(v, f"{prefix}/{key}" if prefix else str(key)))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def ref():
    """The reference model, its optimizer and jitted step, the NumPy
    parameters and optimizer state, and STEPS + 1 NumPy batches."""
    cfg = jax_get_smoke_config(ARCH)
    jmodel = jax_build_model(cfg)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tree = redraw_norms(tree, np.random.default_rng(0))
    jopt = jax_make_optimizer("adamw", peak_lr=1e-2, warmup=2, total=10)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_np = jax.tree_util.tree_map(np.asarray, jopt.init(jparams))
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(STEPS + 1):
        tok = rng.integers(0, cfg.vocab_size, (B, T + 1), dtype=np.int32)
        batches.append((tok[:, :-1], tok[:, 1:]))
    jstep = jax.jit(jax_make_train_step(jmodel, jopt))
    return dict(cfg=cfg, jmodel=jmodel, tree=tree, opt_np=opt_np, jopt=jopt,
                jstep=jstep, batches=batches)


def _jbatch(ref, i):
    tok, lab = ref["batches"][i]
    return JaxBatch(tokens=jnp.asarray(tok), labels=jnp.asarray(lab))


def _batch(ref, i):
    tok, lab = ref["batches"][i]
    return Batch(tokens=torch.from_numpy(tok), labels=torch.from_numpy(lab))


def _port(ref, opt=None):
    model = build_model(get_smoke_config(ARCH))
    opt = opt or make_optimizer("adamw", peak_lr=1e-2, warmup=2, total=10)
    state = train_state_from_numpy(ref["tree"], ref["opt_np"], device="cpu")
    return model, opt, state


def _jstate(ref):
    jtree = jax.tree_util.tree_map(jnp.asarray, ref["tree"])
    return JaxTrainState(params=jtree,
                         opt_state=jax.tree_util.tree_map(jnp.asarray, ref["opt_np"]))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_mask", [False, True])
def test_softmax_xent_matches_reference(with_mask):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7), dtype=np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if with_mask else None

    def jf(lg):
        return jcm.softmax_xent(lg, jnp.asarray(labels), z_loss=1e-3,
                                mask=None if mask is None else jnp.asarray(mask))

    want, jgrad = jax.jit(jax.value_and_grad(jf))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = cm.softmax_xent(lt, torch.from_numpy(labels), z_loss=1e-3,
                          mask=None if mask is None else torch.from_numpy(mask))
    (grad,) = torch.autograd.grad(got, lt)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("t,token_chunk,softcap,z_loss", [
    (40, 8192, 0.0, 1e-4),      # one chunk
    (40, 32, 0.0, 1e-4),        # sc = 10: four chunks
    (36, 20, 15.0, 1e-2),       # sc = 9, soft-capped logits, larger z-loss
])
def test_chunked_lm_loss_matches_reference(t, token_chunk, softcap, z_loss):
    rng = np.random.default_rng(t + token_chunk)
    hidden = rng.normal(size=(2, t, 16)).astype(np.float32)
    head = (rng.normal(size=(16, 64)) / 4).astype(np.float32)
    labels = rng.integers(0, 64, (2, t), dtype=np.int32)
    kw = dict(softcap=softcap, z_loss=z_loss, token_chunk=token_chunk)

    def jf(h, w):
        return jcm.chunked_lm_loss(h, w, jnp.asarray(labels), **kw)

    want, (jdh, jdw) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(
        jnp.asarray(hidden), jnp.asarray(head))
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(head).requires_grad_()
    got = cm.chunked_lm_loss(h, w, torch.from_numpy(labels), **kw)
    dh, dw = torch.autograd.grad(got, (h, w))
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-4, atol=1e-7)


def test_largest_divisor_leq():
    assert [cm._largest_divisor_leq(n, t) for n, t in
            ((40, 4096), (40, 16), (36, 10), (7, 3), (12, 0))] == [
        jcm._largest_divisor_leq(n, t) for n, t in
        ((40, 4096), (40, 16), (36, 10), (7, 3), (12, 0))] == [40, 10, 9, 1, 1]


# ---------------------------------------------------------------------------
# the model's loss, its gradients and the train step
# ---------------------------------------------------------------------------


def test_loss_grads_match_reference_per_leaf(ref):
    jmodel, tree = ref["jmodel"], ref["tree"]
    tok, lab = ref["batches"][0]
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jnp.asarray(tok), jnp.asarray(lab))))(jparams)
    model = build_model(get_smoke_config(ARCH))
    params = params_from_numpy(tree, device="cpu")
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    for p in leaves:
        p.requires_grad_()
    loss = model.loss(params, torch.from_numpy(tok), torch.from_numpy(lab))
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    got = _paths(torch.utils._pytree.tree_unflatten(list(grads), spec))
    want_g = _paths(jax.tree_util.tree_map(np.asarray, jgrads))
    np.testing.assert_allclose(float(loss), float(want), **TOL)
    assert set(got) == set(want_g) and len(got) == 21
    for path, w in want_g.items():
        scale = float(np.abs(w).max())
        assert scale > 0, path
        np.testing.assert_allclose(got[path].numpy(), w, rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=path)


def test_train_step_matches_reference(ref):
    jstate = _jstate(ref)
    model, opt, state = _port(ref)
    step = make_train_step(model, opt)
    for i in range(STEPS):
        jstate, jm = ref["jstep"](jstate, _jbatch(ref, i))
        state, m = step(state, _batch(ref, i))
        for key in ("loss", "grad_norm", "lr"):
            assert m[key].dtype == torch.float32, key
            np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                       err_msg=f"step {i} {key}")
    assert isinstance(state, TrainState) and int(state.step) == STEPS
    assert state.step.dtype == torch.int32
    # the first moments, linear in the gradients (a parameter's Adam step
    # g/|g| flips sign where |g| is near eps, so parameters are not compared)
    got_m = _paths(state.opt_state["m"])
    for path, w in _paths(jax.tree_util.tree_map(np.asarray,
                                                 jstate.opt_state["m"])).items():
        np.testing.assert_allclose(got_m[path].numpy(), w, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(w).max()), err_msg=path)


def test_grad_accumulation_equivalence(ref):
    """accum_steps=2 against 1 (``tests/test_system.py``), on two states
    carried from the same arrays: the loss, the gradient norm and the first
    moments equal up to fp32 summation."""
    batch = _batch(ref, 0)
    out = []
    for accum in (1, 2):
        model, opt, state = _port(ref)
        state, m = make_train_step(model, opt, accum_steps=accum)(state, batch)
        out.append((state, m))
    (s1, m1), (s2, m2) = out
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                               rtol=1e-4)
    m1, m2 = _paths(s1.opt_state["m"]), _paths(s2.opt_state["m"])
    for path, m in m1.items():     # (1 - b1) x the clipped gradient
        torch.testing.assert_close(m2[path], m, rtol=1e-4,
                                   atol=1e-4 * float(m.abs().max()))
    with pytest.raises(ValueError, match="micro-batches"):
        make_train_step(model, opt, accum_steps=3)(s2, batch)


def test_remat_recomputes_each_group_once(ref, monkeypatch):
    """Under grad with remat, each group's attention and SSD chunks run
    twice a step (the forward and its recompute) and the backward calls
    neither; without remat once; serving (no grad) once.  The gradients
    are the same either way."""
    import dataclasses

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    counts = {"attn": 0, "ssd": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fops, "attention_ref", counting("attn", fops.attention_ref))
    monkeypatch.setattr(sops, "ssd_chunk_ref", counting("ssd", sops.ssd_chunk_ref))
    cfg = get_smoke_config(ARCH)
    n_attn, n_ssd = cfg.n_layers // cfg.share_period, cfg.n_layers
    tok, lab = (torch.from_numpy(t) for t in ref["batches"][0])
    grads = {}
    for remat, per_step in ((True, 2), (False, 1)):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        params = params_from_numpy(ref["tree"], device="cpu")
        leaves = torch.utils._pytree.tree_leaves(params)
        for p in leaves:
            p.requires_grad_()
        counts.update(attn=0, ssd=0)
        loss = model.loss(params, tok, lab)
        grads[remat] = torch.autograd.grad(loss, leaves)
        assert counts == {"attn": per_step * n_attn, "ssd": per_step * n_ssd}, remat
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    counts.update(attn=0, ssd=0)
    with torch.inference_mode():
        model.forward(params_from_numpy(ref["tree"], device="cpu"), tok)
    assert counts == {"attn": n_attn, "ssd": n_ssd}


# ---------------------------------------------------------------------------
# optimizers on identical gradients
# ---------------------------------------------------------------------------

OPT_SHAPES = {"w": (6, 3), "b": (3,), "stack": {"w": (4, 5, 3), "n": (4, 5)}}


def _draw(rng, shapes):
    return {k: _draw(rng, v) if isinstance(v, dict)
            else rng.normal(size=v).astype(np.float32) for k, v in shapes.items()}


@pytest.mark.parametrize("kind,mdt", [("adamw", "float32"), ("adamw", "bfloat16"),
                                      ("adafactor", "float32")])
@pytest.mark.parametrize("sliced", [False, True])
def test_optimizer_matches_reference(kind, mdt, sliced, monkeypatch):
    """Five updates from the same parameters and NumPy gradients: params,
    moments and metrics within 1e-6 of the reference's (``sliced`` cuts the
    stacked leaf into one layer a slice, as the full model's big leaves
    are)."""
    if sliced:
        monkeypatch.setattr(adamw_mod, "SLICE_ELEMS", 15)
    rng = np.random.default_rng(3)
    p0 = _draw(rng, OPT_SHAPES)
    jopt = jax_make_optimizer(kind, peak_lr=0.05, warmup=2, total=30, moment_dtype=mdt)
    opt = make_optimizer(kind, peak_lr=0.05, warmup=2, total=30, moment_dtype=mdt)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jopt.init(jp)
    p = params_from_numpy(p0, device="cpu")
    st = opt.init(p)
    for _ in range(5):
        g = _draw(rng, OPT_SHAPES)
        jp, js, jm = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        p, st, m = opt.update(params_from_numpy(g, device="cpu"), st, p)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(st["count"]) == 5 and st["count"].dtype == torch.int32
    got = _paths({"p": p, "s": {k: v for k, v in st.items() if k != "count"}})
    want = _paths({"p": jp, "s": {k: v for k, v in js.items() if k != "count"}})
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(got[path].float().numpy(), w, atol=1e-6,
                                   rtol=0, err_msg=path)


@pytest.mark.parametrize("kind,mdt", [("adamw", "float32"), ("adamw", "bfloat16"),
                                      ("adafactor", "float32")])
def test_optimizer_descends(kind, mdt):
    """``tests/test_substrate.py``'s descent case."""
    opt = make_optimizer(kind, peak_lr=0.05, warmup=2, total=30, moment_dtype=mdt)
    p = {"w": torch.ones((6, 3)), "b": torch.ones((3,))}
    st = opt.init(p)
    for _ in range(30):
        g = {k: 2 * v for k, v in p.items()}   # d/dx ||x||^2
        p, st, met = opt.update(g, st, p)
    assert float(p["w"].abs().mean()) < 0.7
    assert np.isfinite(float(met["grad_norm"]))


def test_clip_by_global_norm_and_schedule():
    g = {"a": torch.full((4,), 100.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) > 100
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
    lr = cosine_schedule(1.0, warmup=10, total=100)
    at = lambda s: float(lr(torch.tensor(s, dtype=torch.int32)))  # noqa: E731
    assert at(0) == 0.0 and abs(at(10) - 1.0) < 1e-6 and at(100) < 0.2
    assert at(55) < at(20)
    with pytest.raises(KeyError):
        make_optimizer("sgd")


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def test_pipeline_law_and_determinism():
    v = 97
    pipe = SyntheticPipeline(PipelineConfig(seed=3, global_batch=64, seq_len=64,
                                            vocab_size=v), device="cpu")
    b1, b2, b3 = pipe.batch_at(7), pipe.batch_at(7), pipe.batch_at(8)
    other = SyntheticPipeline(PipelineConfig(seed=4, global_batch=64, seq_len=64,
                                             vocab_size=v), device="cpu").batch_at(7)
    assert b1.tokens.dtype == torch.int32 and b1.labels.dtype == torch.int32
    assert torch.equal(b1.tokens, b2.tokens) and torch.equal(b1.labels, b2.labels)
    assert not torch.equal(b1.tokens, b3.tokens)
    assert not torch.equal(b1.tokens, other.tokens)
    assert torch.equal(b1.labels[:, :-1], b1.tokens[:, 1:])
    assert torch.equal(b1.labels[:, -1], b1.tokens[:, 0])
    assert int(b1.tokens.min()) >= 0 and int(b1.tokens.max()) < v
    # a walk of steps uniform in [-3, 3] modulo V (the first from the start)
    steps = torch.remainder(b1.tokens[:, 1:] - b1.tokens[:, :-1] + 3, v)
    assert int(steps.max()) <= 6
    freq = torch.bincount(steps.reshape(-1), minlength=7).double() / steps.numel()
    assert float((freq - 1 / 7).abs().max()) < 0.02
    assert next(pipe.iterate(7))[0] == 7
    assert torch.equal(next(pipe.iterate(7))[1].tokens, b1.tokens)


def test_pipeline_frontends_and_dsarray():
    pipe = SyntheticPipeline(PipelineConfig(global_batch=2, seq_len=8,
                                            vocab_size=10, frontend="vision",
                                            frontend_dim=6, frontend_tokens=4),
                             device="cpu")
    b = pipe.batch_at(0)
    assert tuple(b.patches.shape) == (2, 4, 6)
    ds = b.as_dsarray(block_rows=1)
    assert ds.shape == (2, 8) and ds.blocks.device.type == "cpu"
    assert torch.equal(ds.collect(), b.tokens)


@pytest.mark.parametrize("frontend,tokens", [("none", 0), ("vision", 16), ("audio", 0)])
def test_pipeline_for_model_matches_reference(frontend, tokens):
    import dataclasses
    jcfg = dataclasses.replace(jax_get_smoke_config(ARCH), frontend=frontend,
                               frontend_dim=12, frontend_tokens=tokens)
    cfg = dataclasses.replace(get_smoke_config(ARCH), frontend=frontend,
                              frontend_dim=12, frontend_tokens=tokens)
    want = jax_pipeline_for_model(jcfg, 4, 5000, seed=9).cfg
    got = pipeline_for_model(cfg, 4, 5000, seed=9, device="cpu").cfg
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# supervision, the driver, and resuming the reference's checkpoint
# ---------------------------------------------------------------------------


def test_run_with_restarts_recovers(tmp_path):
    crashes = {"n": 0}

    def init():
        return {"x": torch.zeros(())}

    def step(state, i):
        if i == 5 and crashes["n"] == 0:
            crashes["n"] += 1
            raise RuntimeError("boom")
        return {"x": state["x"] + 1}, {"loss": float(state["x"])}

    state, stats = run_with_restarts(
        init_state=init, step_fn=step, ckpt_root=str(tmp_path), total_steps=10,
        ckpt_every=2, heartbeat=Heartbeat(str(tmp_path / "hb.json")),
        device="cpu")
    assert stats.failures == 1 and stats.restarts_at == (5,)
    assert float(state["x"]) == 10.0  # deterministic replay-free resume
    hb = Heartbeat(str(tmp_path / "hb.json"))
    assert hb.age() is not None and hb.age() < 60


def test_run_with_restarts_stops_on_deterministic(tmp_path):
    calls = []

    def step(state, i):
        calls.append(i)
        if i == 2:
            raise R.NumericalDivergence("loss went NaN")
        return state + 1, {"loss": float(state)}

    with pytest.raises(R.NumericalDivergence):
        run_with_restarts(init_state=lambda: 0, step_fn=step,
                          ckpt_root=str(tmp_path), total_steps=6,
                          ckpt_every=2, max_failures=3, device="cpu")
    assert calls.count(2) == 1     # no restart loop: the NaN step ran once


def _final_losses(out: str):
    line = [ln for ln in out.splitlines() if ln.startswith("done:")][-1]
    first, last = line.split("loss ")[1].split(" (")[0].split(" -> ")
    return float(first), float(last), line


def test_train_main_on_cpu_learns_and_resumes(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "32", "--log-every", "100"]
    state = train_mod.main(argv + ["--steps", "40", "--ckpt-dir",
                                   str(tmp_path / "ck1")])
    first, last, line = _final_losses(capsys.readouterr().out)
    assert "failures=0" in line and last < first
    assert isinstance(state, TrainState) and int(state.step) == 40
    assert ckpt.latest_step(str(tmp_path / "ck1")) == 39
    # crash at step 12, checkpoint every 10 -> resume at 10 and finish
    state = train_mod.main(argv + ["--steps", "25", "--ckpt-every", "10",
                                   "--crash-at", "12", "--ckpt-dir",
                                   str(tmp_path / "ck2")])
    assert "failures=1" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path / "ck2")) == 24 and int(state.step) == 25
    with open(tmp_path / "ck2" / "heartbeat.json") as f:
        assert json.load(f)["step"] == 24
    # --mesh runs under torchrun (tests/test_torch_mesh_train.py); a plain
    # process has no group to build the mesh on
    with pytest.raises(RuntimeError, match="torchrun"):
        train_mod.main(argv + ["--mesh", "data=2,model=2"])


def test_resume_from_the_reference_checkpoint(ref, tmp_path):
    """A TrainState checkpoint written by the reference's run_with_restarts
    has the port's manifest paths and dtypes; the port restores it, and its
    next step's loss is the reference's."""
    jroot, root = str(tmp_path / "ref"), str(tmp_path / "port")

    def jstep(state, i):
        return ref["jstep"](state, _jbatch(ref, i))

    jstate, _ = jax_run_with_restarts(init_state=lambda: _jstate(ref),
                                      step_fn=jstep, ckpt_root=jroot,
                                      total_steps=2, ckpt_every=1)
    model, opt, state = _port(ref)
    train_step = make_train_step(model, opt)
    run_with_restarts(init_state=lambda: _port(ref)[2],
                      step_fn=lambda s, i: train_step(s, _batch(ref, i)),
                      ckpt_root=root, total_steps=2, ckpt_every=1, device="cpu")
    manifests = []
    for r in (jroot, root):
        with open(os.path.join(r, "step_00000001", "manifest.json")) as f:
            manifests.append({e["path"]: (e["dtype"], e["shape"])
                              for e in json.load(f)["leaves"]})
    assert manifests[0] == manifests[1]
    assert ".opt_state/count" in manifests[0] and ".params/embed" in manifests[0]
    # the port restores the reference's step 1 and takes step 2
    like = _port(ref)[2]
    restored = ckpt.restore(jroot, 1, like, device="cpu", allow_cast=True)
    assert int(restored.step) == 2
    _, jm = ref["jstep"](jstate, _jbatch(ref, 2))
    _, m = train_step(restored, _batch(ref, 2))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), **TOL)


def test_bf16_train_state_restores_bit_for_bit(ref, tmp_path):
    """The reference's bf16 parameters (``<V2`` leaves) restore exactly
    through ``allow_cast=True``, as ``run_with_restarts`` restores."""
    tree16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16)
                                    if a.dtype == np.float32 and a.ndim >= 2
                                    else jnp.asarray(a), ref["tree"])
    jopt = jax_make_optimizer("adamw")
    jax_ckpt.save(str(tmp_path), 0, JaxTrainState(params=tree16,
                                                  opt_state=jopt.init(tree16)))
    np16 = jax.tree_util.tree_map(np.asarray, tree16)
    like = train_state_from_numpy(np16, jax.tree_util.tree_map(
        np.asarray, jopt.init(tree16)), device="cpu")
    got = ckpt.restore(str(tmp_path), 0, like, device="cpu", allow_cast=True)
    for path, w in _paths(np16).items():
        g = _paths(got.params)[path]
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16), err_msg=path)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)


# ---------------------------------------------------------------------------
# no kernel wrapper drops a gradient silently
# ---------------------------------------------------------------------------


def _wrapper_call(name, x, y):
    from repro_torch.kernels.kmeans import ops as kops
    from repro_torch.kernels.matmul import ops as mops
    if name == "local_matmul":
        return mops.local_matmul(x.reshape(1, 1, 6, 4), y.reshape(1, 1, 4, 6))
    if name == "matmul":
        return mops.matmul(x, y)
    if name == "kmeans_assign":
        return kops.kmeans_assign(x, y.T[:3])
    return kops.kmeans_assign_stacked(x.reshape(1, 1, 6, 4), y.T[:3], 6)


@pytest.mark.parametrize("name,kernel", [("local_matmul", "stacked_matmul"),
                                         ("matmul", "stacked_matmul"),
                                         ("kmeans_assign", "kmeans_assign"),
                                         ("kmeans_assign_stacked", "kmeans_assign")])
def test_wrappers_without_backward_refuse_grad(name, kernel):
    """The GEMM and assignment wrappers have no backward: under grad mode an
    operand that requires grad raises a TypeError naming the kernel, on the
    CPU as on the card; without grad, or detached, they run."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32))
    want = _wrapper_call(name, x, y)
    for leaf in (x, y):
        leaf.requires_grad_()
        with pytest.raises(TypeError, match=f"{kernel} has no backward"):
            _wrapper_call(name, x, y)
        with torch.no_grad():
            got = _wrapper_call(name, x, y)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
        leaf.requires_grad_(False)
