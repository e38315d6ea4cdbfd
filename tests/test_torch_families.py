"""The port's dense, VLM and SSM families against the JAX package, on the CPU.

The six SMOKE configs in float32 (gemma2, qwen1.5, nemotron, yi, llava and
mamba2): parameters from the reference's ``init``, with every norm scale,
QKV bias, ``conv_b`` and ``dt_bias`` redrawn from a seed (under the
reference's init they are zero, and mamba2's layers are then the identity
and its logits exactly 0), carried across with ``convert.params_from_numpy``.
Logits and losses held at rtol = atol = 1e-4 (``tests/test_differential.py``);
decode against the reference's decode at the same tolerance and against
teacher forcing within 5e-3 (``tests/test_models.py``).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import all_arch_ids as jax_all_arch_ids  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import all_arch_ids, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ARCHS = ("gemma2-2b", "qwen1.5-0.5b", "nemotron-4-15b", "yi-9b",
         "llava-next-mistral-7b", "mamba2-370m")
TOL = dict(rtol=1e-4, atol=1e-4)
# T = 40: past the 16-token windows of gemma2's local layers and llava; three
# SSD chunks of 16 for mamba2, the last padded
B, T = 2, 40
DECODE_STEPS = 24     # past gemma2's 16-slot rolling buffer: it wraps
AROUND_ZERO = ("ln1", "ln2", "ln1_post", "ln2_post", "bq", "bk", "bv", "conv_b")
AROUND_ONE = ("norm", "gate_norm")


def redraw(tree, family: str, rng):
    """In place: the ``plus_one`` norms, QKV biases and ``conv_b`` around 0,
    the Mamba norms around 1, the final norm around 0 (``plus_one``) or 1
    (mamba2), and ``dt_bias`` as Mamba-2 draws it (softplus(dt_bias)
    log-uniform in [1e-3, 1e-1])."""
    def around(v, centre):
        return (centre + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)

    def walk(node):
        for key, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif key in AROUND_ZERO:
                node[key] = around(v, 0.0)
            elif key in AROUND_ONE:
                node[key] = around(v, 1.0)
            elif key == "dt_bias":
                dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), v.shape))
                node[key] = np.log(np.expm1(dt)).astype(np.float32)

    for stack in tree.get("groups", []) + [tree.get("layers", {})]:
        walk(stack)
    tree["final_norm"] = around(tree["final_norm"], 1.0 if family == "ssm" else 0.0)
    return tree


@functools.lru_cache(maxsize=None)
def models(arch: str):
    """(reference model, its params, the port's model, its params): one
    draw, carried across."""
    cfg = jax_get_smoke_config(arch)
    jmodel = jax_build_model(cfg)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tree = redraw(tree, cfg.family, np.random.default_rng(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jmodel, jparams, build_model(get_smoke_config(arch)), params_from_numpy(tree, "cpu")


def _inputs(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, t), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, t), dtype=np.int32)
    patches = (rng.normal(size=(b, cfg.frontend_tokens, cfg.frontend_dim))
               .astype(np.float32) if cfg.frontend == "vision" else None)
    return tokens, labels, patches


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for get, jget in ((get_config, jax_get_config),
                      (get_smoke_config, jax_get_smoke_config)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
    cfg, ref = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert (cfg.hd, cfg.ssm_heads, cfg.ssm_dinner) == (ref.hd, ref.ssm_heads, ref.ssm_dinner)
    assert [cfg.layer_is_global(i) for i in range(cfg.n_layers)] == \
        [ref.layer_is_global(i) for i in range(ref.n_layers)]
    assert cfg.activation_dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    jmodel, jparams, model, params = models(arch)
    cfg = jmodel.cfg
    tokens, labels, patches = _inputs(cfg, B, T, seed=1)
    assert model.needs_patches == jmodel.needs_patches == (patches is not None)
    want, _ = jax.jit(jmodel.forward)(jparams, _j(tokens), _j(patches))
    want_loss = jax.jit(jmodel.loss)(jparams, _j(tokens), _j(labels), _j(patches))
    with torch.inference_mode():
        got, aux = model.forward(params, _t(tokens), _t(patches))
        loss = model.loss(params, _t(tokens), _t(labels), _t(patches))
    t_all = T + (cfg.frontend_tokens if patches is not None else 0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, t_all, cfg.vocab_size)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2    # the redrawn norms act
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    assert aux == 0.0


@pytest.mark.parametrize("arch", ("gemma2-2b", "mamba2-370m", "qwen1.5-0.5b"))
def test_decode_matches_reference_and_teacher_forcing(arch):
    jmodel, jparams, model, params = models(arch)
    tokens, _, _ = _inputs(jmodel.cfg, B, DECODE_STEPS, seed=3)
    jcache = jmodel.init_cache(B, DECODE_STEPS)
    jstep = jax.jit(jmodel.decode_step)
    with torch.inference_mode():
        full, _ = model.forward(params, _t(tokens))
        cache = model.init_cache(B, DECODE_STEPS, device="cpu")
        errs = []
        for i in range(DECODE_STEPS):
            want, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, i:i + 1]))
            got, cache = model.decode_step(params, cache, _t(tokens[:, i:i + 1]))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            errs.append(float((got[:, 0] - full[:, i]).abs().max()))
    assert cache["pos"] == DECODE_STEPS and max(errs) < 5e-3, max(errs)
    if arch == "gemma2-2b":     # the local layers' buffers are 16 slots: wrapped
        local, glob = (kv["k"].shape[3] for kv in cache["layers"])
        assert (local, glob) == (jmodel.cfg.attn_window, DECODE_STEPS) and local < DECODE_STEPS


def _paths(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _paths(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _paths(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", ("gemma2-2b", "mamba2-370m", "llava-next-mistral-7b"))
def test_loss_grads_match_reference_per_leaf(arch):
    """The training path's gradients (remat on: each group or layer
    checkpointed) against ``jax.grad`` of the reference's loss, per leaf
    (``tests/test_torch_train.py``'s tolerance)."""
    jmodel, jparams, model, params = models(arch)
    tokens, labels, patches = _inputs(jmodel.cfg, B, T, seed=5)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, _j(tokens), _j(labels), _j(patches))))(jparams)
    req = jax.tree_util.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    leaves = _paths(req)
    loss = model.loss(req, _t(tokens), _t(labels), _t(patches))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    want_g = _paths(jax.tree_util.tree_map(np.asarray, jgrads))
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    assert set(grads) == set(want_g)
    for path, w in want_g.items():
        scale = float(np.abs(w).max())
        assert scale > 0, path
        np.testing.assert_allclose(grads[path].numpy(), w, rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=path)


def test_gemma2_tree_is_groups_of_stacks():
    """``groups`` is a list of two stacks (local, global) over n_layers / 2
    layers, the last sub-layer of each group global, as the reference's."""
    jmodel, _, model, params = models("gemma2-2b")
    cfg = model.cfg
    assert isinstance(params["groups"], list) and len(params["groups"]) == 2
    ng = cfg.n_layers // 2
    assert all(g["attn"]["wq"].shape[0] == ng for g in params["groups"])
    assert [transformer.sublayer_window(cfg, s) for s in range(2)] == [cfg.attn_window, 0]
    assert "lm_head" not in params and "ln1_post" in params["groups"][0]
    fresh = model.init(torch.Generator().manual_seed(0), "cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                     jmodel.init(jax.random.PRNGKey(0)))
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), fresh)
    assert shapes == jshapes


def test_every_reference_arch_is_ported():
    """Every architecture id of the reference: ``get_config`` and
    ``get_smoke_config`` equal the reference's, and ``build_model`` builds
    both on the reference's family module (the MoE family included)."""
    assert all_arch_ids() == jax_all_arch_ids()
    for arch in all_arch_ids():
        for get, jget in ((get_config, jax_get_config),
                          (get_smoke_config, jax_get_smoke_config)):
            cfg, ref = get(arch), jget(arch)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), arch
            model = build_model(cfg)
            assert model.cfg == cfg, arch
            assert (model.module.__name__.rsplit(".", 1)[1]
                    == jax_build_model(ref).module.__name__.rsplit(".", 1)[1]), arch


@pytest.mark.parametrize("arch", ("gemma2-2b", "mamba2-370m", "llava-next-mistral-7b",
                                  "mixtral-8x7b", "grok-1-314b"))
def test_train_main_runs_on_cpu(arch, tmp_path, capsys):
    state = train_mod.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                            "--batch", "2", "--seq", "32", "--log-every", "1",
                            "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in out.splitlines()
              if ln.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses)), out
    assert int(state.step) == 2 and ckpt.latest_step(str(tmp_path)) == 1
    leaves = jax.tree_util.tree_leaves(state.params)
    assert all(bool(torch.isfinite(t).all()) for t in leaves)
    with open(tmp_path / "heartbeat.json") as f:
        assert json.load(f)["step"] == 1


@pytest.mark.parametrize("arch", ("gemma2-2b", "mamba2-370m"))
def test_serve_main_runs_on_cpu(arch, capsys):
    tokens, times = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                                "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    cfg = get_smoke_config(arch)
    assert tuple(tokens.shape) == (2, 3) and times["decode_s"] > 0
    assert bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    assert f"arch={cfg.name}" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ("gemma2-2b", "mamba2-370m"))
def test_entry_points_default_to_the_card(arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    model = build_model(get_smoke_config(arch))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--arch", arch, "--smoke", "--steps", "1"])
