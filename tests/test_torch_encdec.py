"""The port's encoder-decoder family against the JAX package, on the CPU.

seamless-m4t-medium's SMOKE config in float32: parameters from the
reference's ``init`` with every norm scale redrawn around 1 (under the
reference's init they are zero, so every layer adds nothing and the logits
are exactly 0), carried across with ``convert.params_from_numpy``.
``encode``, the logits, the loss and per-leaf gradients held at rtol = atol
= 1e-4 (``tests/test_differential.py``; gradients at ``tests/
test_torch_train.py``'s tolerance); ``decode_step`` with ``enc_out`` in the
cache against the reference's step at the same tolerance and against
teacher forcing within 5e-3 (``tests/test_models.py``).  Then one
counterpart of each encdec case of ``tests/test_models.py`` and of the
families' serving case of ``tests/test_system.py``, ``launch.serve`` and
``launch.train`` on the CPU, and the card as the entry points' default.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
TOL = dict(rtol=1e-4, atol=1e-4)
B, T_DEC, T_ENC = 2, 12, 16
NORMS = ("ln1", "ln2", "ln_cross")


def redraw(tree, rng):
    """In place: every norm scale around 1 (the reference's rms_norm
    multiplies by the scale itself)."""
    def around(v):
        return (1.0 + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)

    for side in ("enc_layers", "dec_layers"):
        for key in NORMS:
            if key in tree[side]:
                tree[side][key] = around(tree[side][key])
    for key in ("enc_norm", "dec_norm"):
        tree[key] = around(tree[key])
    return tree


@functools.lru_cache(maxsize=None)
def models():
    """(reference model, its params, the port's model, its params): one
    draw, carried across."""
    jmodel = jax_build_model(jax_get_smoke_config(ARCH))
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tree = redraw(tree, np.random.default_rng(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return (jmodel, jparams, build_model(get_smoke_config(ARCH)),
            params_from_numpy(tree, "cpu"))


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, T_DEC), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, T_DEC), dtype=np.int32)
    frames = rng.normal(size=(B, T_ENC, cfg.frontend_dim)).astype(np.float32)
    return tokens, labels, frames


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _paths(tree[key], f"{prefix}/{key}").items()}
    return {prefix: tree}


def test_configs_match_reference():
    for get, jget in ((get_config, jax_get_config),
                      (get_smoke_config, jax_get_smoke_config)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    cfg = get_config(ARCH)
    assert cfg.param_count() == jax_get_config(ARCH).param_count()
    assert (cfg.family, cfg.enc_layers, cfg.dec_layers, cfg.hd) == ("encdec", 12, 12, 64)
    assert cfg.activation_dtype == torch.bfloat16
    assert build_model(cfg).needs_patches


def test_tree_and_checkpoint_paths_match_reference(tmp_path):
    """``init`` draws the reference's tree (paths and shapes), and a
    checkpoint of it has the reference's leaf paths."""
    jmodel, jparams, model, params = models()
    fresh = model.init(torch.Generator().manual_seed(0), "cpu")
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), jmodel.init(jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), fresh) == want
    assert all(float(t.abs().max()) == 0 for k, t in _paths(fresh).items()
               if k.rsplit("/", 1)[-1] in NORMS + ("enc_norm", "dec_norm"))
    ckpt.save(str(tmp_path / "port"), 1, params)
    jax_ckpt.save(str(tmp_path / "ref"), 1, jparams)
    manifests = [json.loads((tmp_path / side / "step_00000001" / "manifest.json").read_text())
                 for side in ("port", "ref")]
    assert [e["path"] for e in manifests[0]["leaves"]] == \
        [e["path"] for e in manifests[1]["leaves"]]


def test_encode_matches_reference():
    jmodel, jparams, model, params = models()
    _, _, frames = _inputs(model.cfg, seed=1)
    want = jax.jit(lambda p, f: jax_encdec.encode(p, jmodel.cfg, f))(jparams, frames)
    with torch.inference_mode():
        got = encdec.encode(params, model.cfg, torch.from_numpy(frames))
    assert tuple(got.shape) == (B, T_ENC, model.cfg.d_model)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2    # the redrawn norms act
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_and_loss_match_reference():
    jmodel, jparams, model, params = models()
    tokens, labels, frames = _inputs(model.cfg, seed=2)
    want, _ = jax.jit(jmodel.forward)(jparams, tokens, frames)
    want_loss = jax.jit(jmodel.loss)(jparams, tokens, labels, frames)
    with torch.inference_mode():
        got, aux = model.forward(params, torch.from_numpy(tokens), torch.from_numpy(frames))
        loss = model.loss(params, torch.from_numpy(tokens), torch.from_numpy(labels),
                          torch.from_numpy(frames))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T_DEC, model.cfg.vocab_size)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    assert aux == 0.0
    with pytest.raises(ValueError, match="frames"):
        model.forward(params, torch.from_numpy(tokens))


def test_loss_grads_match_reference_per_leaf():
    """The training path's gradients (remat on: each layer checkpointed)
    against ``jax.grad`` of the reference's loss, per leaf."""
    jmodel, jparams, model, params = models()
    tokens, labels, frames = _inputs(model.cfg, seed=3)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, tokens, labels, frames)))(jparams)
    req = jax.tree_util.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    leaves = _paths(req)
    loss = model.loss(req, torch.from_numpy(tokens), torch.from_numpy(labels),
                      torch.from_numpy(frames))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    want_g = _paths(jax.tree_util.tree_map(np.asarray, jgrads))
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    assert set(grads) == set(want_g)
    for path, w in want_g.items():
        scale = float(np.abs(w).max())
        assert scale > 0, path
        np.testing.assert_allclose(grads[path].numpy(), w, rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=path)


def test_decode_matches_reference_and_teacher_forcing():
    """``decode_step`` with ``enc_out`` in the cache: each step's logits the
    reference's, and the forward's at that position."""
    jmodel, jparams, model, params = models()
    tokens, _, frames = _inputs(model.cfg, seed=4)
    jcache = jmodel.init_cache(B, T_DEC, enc_len=T_ENC)
    jcache["enc_out"] = jax_encdec.encode(jparams, jmodel.cfg, frames)
    jstep = jax.jit(jmodel.decode_step)
    with torch.inference_mode():
        full, _ = model.forward(params, torch.from_numpy(tokens), torch.from_numpy(frames))
        cache = model.init_cache(B, T_DEC, device="cpu", enc_len=T_ENC)
        assert tuple(cache["enc_out"].shape) == (B, T_ENC, model.cfg.d_model)
        cache["enc_out"] = encdec.encode(params, model.cfg, torch.from_numpy(frames))
        errs = []
        for i in range(T_DEC):
            want, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, i:i + 1]))
            got, cache = model.decode_step(params, cache, torch.from_numpy(tokens[:, i:i + 1]))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            errs.append(float((got[:, 0] - full[:, i]).abs().max()))
    assert cache["pos"] == T_DEC and max(errs) < 5e-3, max(errs)


# -- counterparts of tests/test_models.py's encdec cases ----------------------


def _model_inputs(cfg, b=2, s=16):
    """``tests/test_models.py::make_inputs`` for the audio frontend: 12
    frames."""
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    return tokens, torch.randn((b, 12, cfg.frontend_dim), generator=gen)


def test_smoke_forward_and_train_step():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens, patches = _model_inputs(cfg)
    logits, aux = model.forward(params, tokens, patches)
    assert tuple(logits.shape) == (2, 16, cfg.vocab_size)
    assert not bool(torch.isnan(logits).any())
    req = jax.tree_util.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    leaves = list(_paths(req).values())
    loss = model.loss(req, tokens, tokens, patches)
    assert bool(torch.isfinite(loss))
    gnorm = sum(float(g.abs().sum()) for g in torch.autograd.grad(loss, leaves))
    assert np.isfinite(gnorm) and gnorm > 0


def test_decode_matches_teacher_forcing():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    b, s = 2, 12
    tokens, patches = _model_inputs(cfg, b, s)
    with torch.inference_mode():
        cache = model.init_cache(b, s, device="cpu", enc_len=patches.shape[1])
        cache["enc_out"] = encdec.encode(params, cfg, patches)
        ref_logits, _ = model.forward(params, tokens, patches)
        errs = []
        for i in range(s):
            lg, cache = model.decode_step(params, cache, tokens[:, i:i + 1])
            assert tuple(lg.shape) == (b, 1, cfg.vocab_size)
            assert not bool(torch.isnan(lg).any())
            errs.append(float((lg[:, 0] - ref_logits[:, i]).abs().max()))
    assert max(errs) < 5e-3, max(errs)


def test_full_config_sanity():
    """FULL config: the published parameter count, nothing allocated."""
    n = get_config(ARCH).param_count()
    assert 0.6 * 1.2e9 < n < 1.4 * 1.2e9, n


# -- launch.serve and launch.train ----------------------------------------------


def test_serve_main_runs_on_cpu(capsys):
    """The encdec case of the families' serving test in
    ``tests/test_system.py``: frames encoded once, then prefill and greedy
    decode."""
    tokens, times = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                                "--batch", "2", "--prompt-len", "6", "--gen", "6"])
    cfg = get_smoke_config(ARCH)
    assert tuple(tokens.shape) == (2, 6) and times["decode_s"] > 0
    assert bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    assert f"arch={cfg.name}" in capsys.readouterr().out


def test_train_main_runs_on_cpu(tmp_path, capsys):
    """The frames (``patches``) flow from the pipeline through the loss."""
    state = train_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                            "--batch", "2", "--seq", "16", "--log-every", "1",
                            "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in out.splitlines()
              if ln.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses)), out
    assert int(state.step) == 2 and ckpt.latest_step(str(tmp_path)) == 1
    assert all(bool(torch.isfinite(t).all()) for t in jax.tree_util.tree_leaves(state.params))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    model = build_model(get_smoke_config(ARCH))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 4, enc_len=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--arch", ARCH, "--smoke", "--steps", "1"])
