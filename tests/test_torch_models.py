"""The port's zamba2 hybrid against the JAX package, on the CPU.

zamba2-2.7b SMOKE in float32: parameters from the reference's ``init``, with
every norm scale, ``conv_b`` and ``dt_bias`` redrawn from a seed (under the
reference's init the norms are zero, so each Mamba layer is the identity
and the logits are exactly 0), carried across with
``convert.params_from_numpy``.  Held at rtol = atol = 1e-4
(``tests/test_differential.py``); decode against teacher forcing within
5e-3 (``tests/test_models.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.algorithms import KMeans as JaxKMeans  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.core import from_array as jax_from_array  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import from_array  # noqa: E402
from repro_torch.algorithms import KMeans  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import hybrid  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
TOL = dict(rtol=1e-4, atol=1e-4)
B, T = 2, 40          # T = 40 at chunk 16: three SSD chunks, the last padded


def redraw_norms(tree, rng):
    """Norm scales around 1 (``norm``, ``gate_norm``, ``final_norm``) and
    around 0 (the ``plus_one`` norms ``ln1``, ``ln2``); ``conv_b`` and
    ``dt_bias`` drawn too, ``dt_bias`` as Mamba-2 draws it (softplus(dt_bias)
    log-uniform in [1e-3, 1e-1]), so decays are slow and the inter-chunk
    terms carry weight."""
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


@pytest.fixture(scope="module")
def models():
    cfg = jax_get_smoke_config(ARCH)
    jmodel = jax_build_model(cfg)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tree = redraw_norms(tree, np.random.default_rng(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = build_model(get_smoke_config(ARCH))
    params = params_from_numpy(tree, device="cpu")
    return jmodel, jparams, model, params


def _tokens(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t),
                                                dtype=np.int32)


def test_configs_match_reference():
    for get, jget in ((get_config, jax_get_config),
                      (get_smoke_config, jax_get_smoke_config)):
        ours, ref = dataclasses.asdict(get(ARCH)), dataclasses.asdict(jget(ARCH))
        assert ours == ref
    cfg = get_config(ARCH)
    assert (cfg.hd, cfg.ssm_heads, cfg.ssm_dinner) == (80, 80, 5120)
    assert cfg.param_count() == jax_get_config(ARCH).param_count()
    assert cfg.activation_dtype == torch.bfloat16
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("qwen1.5-0.5b")


def test_norms_are_redrawn(models):
    """The redrawn scales make the Mamba layers act: logits are not zero."""
    jmodel, jparams, _, _ = models
    tokens = _tokens(jmodel.cfg, 1, 8, seed=2)
    logits, _ = jmodel.forward(jparams, jnp.asarray(tokens))
    assert float(jnp.abs(logits).max()) > 1e-2


def test_forward_matches_reference(models):
    jmodel, jparams, model, params = models
    tokens = _tokens(jmodel.cfg, B, T, seed=1)
    want, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(tokens))
    want_h, _ = jax.jit(lambda p, t: jmodel.module.forward_hidden(p, jmodel.cfg, t)
                        )(jparams, jnp.asarray(tokens))
    with torch.inference_mode():
        got, aux = model.forward(params, torch.from_numpy(tokens))
        got_h, _ = hybrid.forward_hidden(params, model.cfg, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    assert aux == 0.0


def test_decode_matches_reference_and_teacher_forcing(models):
    jmodel, jparams, model, params = models
    s = 12
    tokens = _tokens(jmodel.cfg, B, s, seed=3)
    jcache = jmodel.init_cache(B, s)
    jstep = jax.jit(jmodel.decode_step)
    with torch.inference_mode():
        full, _ = model.forward(params, torch.from_numpy(tokens))
        cache = model.init_cache(B, s, device="cpu")
        errs = []
        for i in range(s):
            want, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, i:i + 1]))
            got, cache = model.decode_step(params, cache,
                                           torch.from_numpy(tokens[:, i:i + 1]))
            assert tuple(got.shape) == (B, 1, 256)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            errs.append(float((got[:, 0] - full[:, i]).abs().max()))
    assert cache["pos"] == s
    assert max(errs) < 5e-3, max(errs)


def test_generate_is_greedy(models):
    """``serve.generate``'s tokens are the argmax of the reference's logits
    on the prompt followed by the tokens generated so far."""
    jmodel, jparams, model, params = models
    prompt = _tokens(jmodel.cfg, B, 6, seed=4)
    gen, times = serve.generate(model, params, torch.from_numpy(prompt), 5)
    assert tuple(gen.shape) == (B, 5) and set(times) == {"prefill_s", "decode_s"}
    seq = np.concatenate([prompt, gen.numpy()[:, :-1]], axis=1).astype(np.int32)
    want, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(seq))
    want = np.asarray(want)[:, prompt.shape[1] - 1:]
    top2 = np.sort(want, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-3   # no near-tie to flip
    np.testing.assert_array_equal(gen.numpy(), want.argmax(-1))


def test_serve_main_runs_on_cpu(capsys):
    tokens, times = serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                                "--prompt-len", "4", "--gen", "3"])
    assert tuple(tokens.shape) == (2, 3) and times["decode_s"] > 0
    assert "tok/s" in capsys.readouterr().out


def test_hidden_state_kmeans_matches_reference(models):
    """LM hidden states -> ds-array -> KMeans, in each package (the paper's
    §5.5 composition, as in ``examples/activations_kmeans.py``)."""
    jmodel, jparams, model, params = models
    cfg = jmodel.cfg
    hidden = jax.jit(lambda p, t: jmodel.module.forward_hidden(p, cfg, t)[0])
    jstates, states = [], []
    for step in range(3):
        tokens = _tokens(cfg, 4, 32, seed=10 + step)
        jstates.append(np.asarray(hidden(jparams, jnp.asarray(tokens))
                                  ).reshape(-1, cfg.d_model))
        with torch.inference_mode():
            h, _ = hybrid.forward_hidden(params, model.cfg, torch.from_numpy(tokens))
        states.append(h.float().reshape(-1, cfg.d_model))
    jx = jax_from_array(jnp.asarray(np.concatenate(jstates)), (128, cfg.d_model))
    x = from_array(torch.cat(states), (128, cfg.d_model), device="cpu")
    jkm = JaxKMeans(n_clusters=5, max_iter=25, seed=0).fit(jx)
    km = KMeans(n_clusters=5, max_iter=25, seed=0).fit(x)
    np.testing.assert_allclose(km.centers_.numpy(), np.asarray(jkm.centers_),
                               **TOL)
    np.testing.assert_array_equal(km.predict(x).collect().numpy(),
                                  np.asarray(jkm.predict(jx).collect()))
    assert km.n_iter_ == jkm.n_iter_


def test_params_from_numpy_bf16_is_bit_exact():
    import ml_dtypes
    rng = np.random.default_rng(5)
    tree = {"w": rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16),
            "layers": {"b": np.arange(4, dtype=np.float32)},
            "list": [rng.normal(size=(2,)).astype(ml_dtypes.bfloat16)]}
    got = params_from_numpy(tree, device="cpu")
    assert got["w"].dtype == torch.bfloat16 and got["layers"]["b"].dtype == torch.float32
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                  tree["w"].view(np.int16))
    np.testing.assert_array_equal(got["list"][0].view(torch.int16).numpy(),
                                  tree["list"][0].view(np.int16))
    # and through a bf16 JAX tree, as the reference builds it
    jtree = jax_build_model(jax_get_smoke_config(ARCH).__class__(
        **{**dataclasses.asdict(jax_get_smoke_config(ARCH)), "dtype": "bfloat16"})
    ).init(jax.random.PRNGKey(1))
    leaf = np.asarray(jtree["layers"]["in_proj"])
    assert leaf.dtype.name == "bfloat16"
    ours = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                             device="cpu")["layers"]["in_proj"]
    np.testing.assert_array_equal(ours.view(torch.int16).numpy(), leaf.view(np.int16))


def test_model_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    model = build_model(get_smoke_config(ARCH))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])
