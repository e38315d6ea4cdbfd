"""The port's MoE family against the JAX package, on the CPU.

The mixtral-8x7b (SwiGLU experts, sliding window) and grok-1-314b (GeGLU
experts, attention and final soft-caps) SMOKE configs in float32:
parameters from the reference's ``init`` with every norm redrawn around 0
(the ``plus_one`` norms; under the reference's init they are zero),
carried across with ``convert.params_from_numpy``.  The MoE layer alone
(``y`` and ``aux``; with a capacity factor that drops; a single token,
which is dropless), the logits, the loss with its aux and per-leaf
gradients held at rtol = atol = 1e-4 (``tests/test_differential.py``;
gradients at ``tests/test_torch_train.py``'s tolerance); ``decode_step``
against the reference's step at the same tolerance and against teacher
forcing within 5e-3 (``tests/test_models.py``; the SMOKE configs set
``capacity_factor = n_experts``, which is dropless).  Then the init tree,
``stack_layer_params``' draws, and ``launch.serve`` on the CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ARCHS = ("mixtral-8x7b", "grok-1-314b")
TOL = dict(rtol=1e-4, atol=1e-4)
# T = 40: past mixtral's 16-token SMOKE window
B, T = 2, 40
DECODE_STEPS = 24     # past the 16-slot rolling buffer: it wraps


def redraw(tree, rng):
    """In place: the ``plus_one`` norms (``ln1``, ``ln2``, ``final_norm``)
    around 0."""
    def around(v):
        return (0.1 * rng.normal(size=v.shape)).astype(v.dtype)

    for stack in tree["groups"]:
        for key in ("ln1", "ln2"):
            stack[key] = around(stack[key])
    tree["final_norm"] = around(tree["final_norm"])
    return tree


@functools.lru_cache(maxsize=None)
def models(arch: str):
    """(reference model, its params, the port's model, its params): one
    draw, carried across."""
    jmodel = jax_build_model(jax_get_smoke_config(arch))
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tree = redraw(tree, np.random.default_rng(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jmodel, jparams, build_model(get_smoke_config(arch)), params_from_numpy(tree, "cpu")


@functools.lru_cache(maxsize=None)
def layer(arch: str):
    """One MoE layer's parameters from the reference's ``moe_init``: (as
    the reference holds them, as the port holds them)."""
    cfg = jax_get_smoke_config(arch)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_moe.moe_init(jax.random.PRNGKey(3), cfg, jnp.float32))
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _configs(arch: str, **changes):
    """(the reference's SMOKE config, the port's), both with ``changes``."""
    return (dataclasses.replace(jax_get_smoke_config(arch), **changes),
            dataclasses.replace(get_smoke_config(arch), **changes))


def _x(b, t, d, seed):
    return np.random.default_rng(seed).normal(size=(b, t, d)).astype(np.float32)


def _moe_both(arch, x, **changes):
    """``moe_apply`` of both packages on ``x``: ((y, aux) reference, (y,
    aux) port, the port's routing)."""
    jcfg, cfg = _configs(arch, **changes)
    jp, p = layer(arch)
    jy, jaux = jax.jit(lambda p_, x_: jax_moe.moe_apply(p_, x_, jcfg))(jp, jnp.asarray(x))
    with torch.inference_mode():
        y, aux = moe.moe_apply(p, torch.from_numpy(x), cfg)
        r = moe.routing(p["router"], torch.from_numpy(x), cfg)
    return (np.asarray(jy), float(jaux)), (y.numpy(), float(aux)), r


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch):
    """SwiGLU (mixtral) and GeGLU (grok: the tanh GELU) experts, dropless."""
    x = _x(2, 16, 64, seed=1)
    (jy, jaux), (y, aux), r = _moe_both(arch, x)
    assert bool(r.keep.all()) and float(np.abs(jy).max()) > 1e-2
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(aux, jaux, **TOL)
    assert aux > 0.0          # tests/test_models.py::test_moe_routing_properties
    # the combine weights are a softmax over the k choices, in descending order
    w = r.weights.numpy()
    np.testing.assert_allclose(w.sum(-1), 1.0, rtol=1e-6)
    assert (np.diff(w, axis=-1) <= 0).all()


def test_capacity_factor_that_drops_matches_reference():
    """cf 1.0 at B 2 x T 32: each expert holds 32 of the 128 slots, so some
    are dropped.  The port drops at least one; its ``y`` equals the
    reference's; and a token's ``y`` differs from the dropless run's exactly
    where one of its slots was dropped, so the reference dropped the same
    slots (their expert outputs are not zero)."""
    x = _x(2, 32, 64, seed=2)
    (jy, jaux), (y, aux), r = _moe_both("mixtral-8x7b", x, capacity_factor=1.0)
    (_, _), (y_all, _), r_all = _moe_both("mixtral-8x7b", x)
    assert r.cap == 32 and bool(r_all.keep.all())
    dropped = (~r.keep).numpy().reshape(64, 2)
    assert dropped.sum() >= 1, "the case must drop a slot"
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(aux, jaux, **TOL)
    moved = np.abs(y - y_all).reshape(64, -1).max(-1) > 1e-4
    np.testing.assert_array_equal(moved, dropped.any(-1))
    jmoved = np.abs(jy - y_all).reshape(64, -1).max(-1) > 1e-4
    np.testing.assert_array_equal(jmoved, dropped.any(-1))


def test_routing_positions_are_token_major():
    """Each slot's position counts the earlier (token, choice) slots of its
    expert, in token-major order; a slot is kept when that count is below
    the capacity, so the later tokens' slots are dropped."""
    _, cfg = _configs("mixtral-8x7b", capacity_factor=1.0)
    _, p = layer("mixtral-8x7b")
    r = moe.routing(p["router"], torch.from_numpy(_x(2, 32, 64, seed=2)), cfg)
    assert r.assign.shape == r.pos.shape == (1, 128)     # one shard without a mesh
    assign = r.assign[0].tolist()
    want = [assign[:i].count(a) for i, a in enumerate(assign)]
    assert r.pos[0].tolist() == want
    assert r.keep[0].tolist() == [q < r.cap for q in want]
    assert r.cap == moe.capacity(cfg, 32, 64) == 32
    assert moe.capacity(cfg, 1, 64) == 128           # decode: dropless
    assert moe.capacity(dataclasses.replace(cfg, capacity_factor=0.01), 32, 64) == 8


def test_single_token_is_dropless():
    """T = 1 (a decode step): the capacity is n·k whatever the factor, so
    no slot is dropped, where the same tokens as one sequence would be."""
    x = _x(16, 1, 64, seed=3)
    (jy, jaux), (y, aux), r = _moe_both("grok-1-314b", x, capacity_factor=0.1)
    assert r.cap == 32 and bool(r.keep.all())
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(aux, jaux, **TOL)
    _, _, r_seq = _moe_both("grok-1-314b", x.reshape(1, 16, 64), capacity_factor=0.1)
    assert r_seq.cap == 8 and not bool(r_seq.keep.all())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    jmodel, jparams, model, params = models(arch)
    cfg = jmodel.cfg
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
    labels = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
    want, want_aux = jax.jit(jmodel.forward)(jparams, jnp.asarray(tokens))
    want_loss = jax.jit(jmodel.loss)(jparams, jnp.asarray(tokens), jnp.asarray(labels))
    with torch.inference_mode():
        got, aux = model.forward(params, torch.from_numpy(tokens))
        loss = model.loss(params, torch.from_numpy(tokens), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, cfg.vocab_size)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2    # the redrawn norms act
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert aux.dtype == torch.float32 and float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)


def _paths(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _paths(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _paths(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_match_reference_per_leaf(arch):
    """The training path's gradients (remat on: each layer checkpointed),
    the 0.01·aux term included, against ``jax.grad`` of the reference's
    loss, per leaf: the router's through the combine weights and the aux
    loss's probabilities."""
    jmodel, jparams, model, params = models(arch)
    cfg = jmodel.cfg
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
    labels = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jnp.asarray(tokens), jnp.asarray(labels))))(jparams)
    req = jax.tree_util.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    leaves = _paths(req)
    loss = model.loss(req, torch.from_numpy(tokens), torch.from_numpy(labels))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    want_g = _paths(jax.tree_util.tree_map(np.asarray, jgrads))
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    assert set(grads) == set(want_g)
    assert "/groups/0/moe/router" in grads
    for path, w in want_g.items():
        scale = float(np.abs(w).max())
        assert scale > 0, path
        np.testing.assert_allclose(grads[path].numpy(), w, rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_teacher_forcing(arch):
    jmodel, jparams, model, params = models(arch)
    tokens = np.random.default_rng(8).integers(0, jmodel.cfg.vocab_size,
                                               (B, DECODE_STEPS), dtype=np.int32)
    jcache = jmodel.init_cache(B, DECODE_STEPS)
    jstep = jax.jit(jmodel.decode_step)
    with torch.inference_mode():
        full, _ = model.forward(params, torch.from_numpy(tokens))
        cache = model.init_cache(B, DECODE_STEPS, device="cpu")
        errs = []
        for i in range(DECODE_STEPS):
            want, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, i:i + 1]))
            got, cache = model.decode_step(params, cache, torch.from_numpy(tokens[:, i:i + 1]))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            errs.append(float((got[:, 0] - full[:, i]).abs().max()))
    assert cache["pos"] == DECODE_STEPS and max(errs) < 5e-3, max(errs)
    window = jmodel.cfg.attn_window
    assert cache["layers"][0]["k"].shape[3] == (window or DECODE_STEPS)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    """The init tree's paths and shapes are the reference's (``moe`` in
    place of ``mlp``), and each expert leaf's scale is its fan-in's."""
    jmodel, _, model, _ = models(arch)
    fresh = model.init(torch.Generator().manual_seed(0), "cpu")
    jfresh = jmodel.init(jax.random.PRNGKey(1))
    shapes = {k: tuple(v.shape) for k, v in _paths(fresh).items()}
    jshapes = {k: tuple(v.shape) for k, v in _paths(jfresh).items()}
    assert shapes == jshapes
    assert not any("/mlp/" in k for k in shapes)
    cfg = model.cfg
    for name, fan in (("router", cfg.d_model), ("w_gate", cfg.d_model),
                      ("w_up", cfg.d_model), ("w_down", cfg.d_ff)):
        got = float(fresh["groups"][0]["moe"][name].std())
        ref = float(jnp.std(jfresh["groups"][0]["moe"][name]))
        assert abs(got * fan ** 0.5 - 1) < 0.1 and abs(ref * fan ** 0.5 - 1) < 0.1, name


def _stack_then_copy(n, init_fn):
    """``stack_layer_params`` as it was: every layer drawn, then stacked."""
    layers = [init_fn(i) for i in range(n)]

    def stack(trees):
        return {key: stack([t[key] for t in trees]) if isinstance(trees[0][key], dict)
                else torch.stack([t[key] for t in trees]) for key in trees[0]}
    return stack(layers)


@pytest.mark.parametrize("arch", ("mixtral-8x7b", "gemma2-2b", "mamba2-370m",
                                  "zamba2-2.7b", "seamless-m4t-medium"))
def test_stack_layer_params_keeps_the_draws(arch, monkeypatch):
    """Filling a preallocated stack layer by layer draws the same values in
    the same generator order: a seeded init equals the one that stacked
    every layer at the end, bit for bit."""
    model = build_model(get_smoke_config(arch))
    got = model.init(torch.Generator().manual_seed(11), "cpu")
    monkeypatch.setattr(cm, "stack_layer_params", _stack_then_copy)
    want = model.init(torch.Generator().manual_seed(11), "cpu")
    got, want = _paths(got), _paths(want)
    assert set(got) == set(want)
    for path in want:
        assert torch.equal(got[path], want[path]), path


def test_serve_main_runs_on_cpu(capsys):
    tokens, times = serve.main(["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu",
                                "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    cfg = get_smoke_config("mixtral-8x7b")
    assert tuple(tokens.shape) == (2, 3) and times["decode_s"] > 0
    assert bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    assert f"arch={cfg.name}" in capsys.readouterr().out
