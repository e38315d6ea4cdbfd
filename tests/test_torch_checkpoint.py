"""The port's checkpoints and model files (``repro_torch.checkpoint``,
``save_model``/``load_model``, the fits' ``checkpoint_dir``/``resume``)
against the JAX package's.

One counterpart of each checkpoint and persistence case of
``tests/test_resilience.py`` (the async checkpointer's errors, the dtype
mismatch, crash/resume of the CSVM, ALS and K-means, the save/load
registry, the wrong-estimator rejection, the plan-cache regression), on
``device="cpu"`` inputs, then the cross-package cases, every input built
from one NumPy array:

* a checkpoint tree either package writes has the other's manifest and
  leaf files byte for byte, and restores in the other;
* for KMeans, PCA, LinearRegression, Ridge, ALS, CascadeSVM and
  RandomForestClassifier: a model ``repro`` saves loads in ``repro_torch``
  (``device="cpu"``) and predicts equal (labels exact, floats at
  rtol = atol = 1e-4), and the reverse; both packages' manifests of the
  same fit agree in paths, order, shapes, dtypes and ``extra``, and a model
  re-saved after loading is the same files in either package;
* a bfloat16 leaf: the same bytes (``<V2``), and the same ``ValueError``
  from either package's ``restore``.
"""

import json
import os
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.algorithms as jalg  # noqa: E402
import repro.checkpoint as jck  # noqa: E402
import repro.core as jx  # noqa: E402
import repro.estimators as jest  # noqa: E402
import repro_torch as pt  # noqa: E402
import repro_torch.resilience as R  # noqa: E402
from repro_torch import checkpoint as pck  # noqa: E402
from repro_torch.algorithms import ALS, KMeans, PCA  # noqa: E402
from repro_torch.core import DsArray  # noqa: E402
from repro_torch.core import plan as plan_mod  # noqa: E402
from repro_torch.estimators import (CascadeSVM, LinearRegression,  # noqa: E402
                                    NotFittedError, RandomForestClassifier,
                                    Ridge, load_model)
from repro_torch.estimators.base import _FitCheckpoint  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

SEED = 20260808
CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_counters():
    R.reset_stats()
    plan_mod.clear_cache()
    yield


def ds(x, block):
    return pt.from_array(x, block, device=CPU)


def jds(x, block):
    return jx.from_array(jnp.asarray(x), block)


def host(a) -> np.ndarray:
    if isinstance(a, (DsArray, jx.DsArray)):
        a = a.collect()
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def manifest(root, step=0):
    with open(os.path.join(root, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def files(root, step=0):
    d = Path(root) / f"step_{step:08d}"
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


# ---------------------------------------------------------------------------
# Checkpoint satellites (counterparts of tests/test_resilience.py)
# ---------------------------------------------------------------------------

def test_async_checkpointer_error_propagates(tmp_path):
    bad_root = os.path.join(str(tmp_path), "afile")
    with open(bad_root, "w") as f:
        f.write("not a directory")
    ac = pck.AsyncCheckpointer(bad_root)
    ac.save(1, {"w": torch.ones(3)})
    with pytest.raises(pck.CheckpointWriteError):
        ac.wait()
    assert ac.last_committed is None
    ac.wait()                                    # error consumed


def test_async_checkpointer_error_from_next_save(tmp_path):
    bad_root = os.path.join(str(tmp_path), "afile2")
    with open(bad_root, "w") as f:
        f.write("x")
    ac = pck.AsyncCheckpointer(bad_root)
    ac.save(1, {"w": torch.ones(3)})
    for _ in range(100):
        if ac._thread is not None and not ac._thread.is_alive():
            break
        time.sleep(0.01)
    with pytest.raises(pck.CheckpointWriteError):
        ac.save(2, {"w": torch.ones(3)})


def test_async_checkpointer_snapshots_and_keeps(tmp_path):
    """The snapshot is taken at ``save``: a later in-place write to the
    tensor does not reach the file; ``keep`` bounds the history."""
    ac = pck.AsyncCheckpointer(str(tmp_path), keep=2)
    w = torch.arange(4, dtype=torch.float32)
    for step in (1, 2, 3):
        ac.save(step, {"w": w})
        w += 10.0
    ac.wait()
    assert ac.last_committed == 3
    assert pck.list_steps(str(tmp_path)) == [2, 3]
    back = pck.restore(str(tmp_path), 2, {"w": w}, device=CPU)
    assert torch.equal(back["w"], torch.arange(4, dtype=torch.float32) + 10.0)


def test_restore_dtype_mismatch_raises(tmp_path):
    root = str(tmp_path)
    pck.save(root, 0, {"w": torch.ones(4, dtype=torch.int32)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        pck.restore(root, 0, {"w": torch.ones(4)}, device=CPU)
    out = pck.restore(root, 0, {"w": torch.ones(4)}, device=CPU,
                      allow_cast=True)
    assert out["w"].dtype == torch.float32
    same = pck.restore(root, 0, {"w": np.ones(4, np.int32)}, device=CPU)
    assert same["w"].dtype == torch.int32


# ---------------------------------------------------------------------------
# Checkpointable fits + model registry
# ---------------------------------------------------------------------------

def _svm_np():
    rng = np.random.default_rng(SEED + 10)
    x = rng.normal(size=(96, 6)).astype(np.float32)
    w = rng.normal(size=6)
    y = (x @ w > 0).astype(np.float64)
    return x, y


def _svm_data():
    x, y = _svm_np()
    return ds(x, (32, 3)), y


def test_csvm_crash_resume_matches_uninterrupted(tmp_path):
    xd, y = _svm_data()
    ref = CascadeSVM(max_iter=5, tol=1e-12).fit(xd, y)
    pred_ref = host(ref.predict(xd)).ravel()
    d = str(tmp_path)
    interrupted = CascadeSVM(max_iter=5, tol=1e-12)
    with R.inject(R.FaultSpec(kind="crash", site="fit_iteration",
                              where={"iteration": 3})):
        with pytest.raises(R.CrashError):
            interrupted.fit(xd, y, checkpoint_dir=d)
    assert pck.list_steps(d) == [1, 2]
    resumed = CascadeSVM(max_iter=5, tol=1e-12)
    resumed.fit(xd, y, checkpoint_dir=d, resume=d)
    assert resumed.n_iter_ == ref.n_iter_
    assert resumed.n_sv_ == ref.n_sv_
    np.testing.assert_allclose(host(resumed.sv_), host(ref.sv_), rtol=1e-5)
    np.testing.assert_allclose(host(resumed.dual_coef_), host(ref.dual_coef_),
                               rtol=1e-5)
    # one process on one thread: the resumed fit has the same bits
    assert torch.equal(resumed.sv_, ref.sv_)
    assert torch.equal(resumed.dual_coef_, ref.dual_coef_)
    assert (host(resumed.predict(xd)).ravel() == pred_ref).all()


def test_als_crash_resume_matches_uninterrupted(tmp_path):
    rng = np.random.default_rng(SEED + 11)
    rd = ds((rng.random((40, 24)) * 5).astype(np.float32), (16, 8))
    ref = ALS(n_factors=4, max_iter=4, tol=1e-12, seed=3).fit(rd)
    d = str(tmp_path)
    interrupted = ALS(n_factors=4, max_iter=4, tol=1e-12, seed=3)
    with R.inject(R.FaultSpec(kind="crash", site="fit_iteration",
                              where={"iteration": 3})):
        with pytest.raises(R.CrashError):
            interrupted.fit(rd, checkpoint_dir=d)
    resumed = ALS(n_factors=4, max_iter=4, tol=1e-12, seed=3)
    resumed.fit(rd, checkpoint_dir=d, resume=d)
    assert resumed.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(host(resumed.u_), host(ref.u_), rtol=1e-5)
    np.testing.assert_allclose(host(resumed.v_), host(ref.v_), rtol=1e-5)
    assert torch.equal(resumed.u_.blocks, ref.u_.blocks)
    assert torch.equal(resumed.v_.blocks, ref.v_.blocks)
    assert resumed.u_.block_shape == ref.u_.block_shape


def test_kmeans_crash_resume(tmp_path):
    rng = np.random.default_rng(SEED + 12)
    x = rng.normal(size=(60, 5)).astype(np.float32)
    x[:30] += 4.0
    xd = ds(x, (16, 5))
    ref = KMeans(n_clusters=3, max_iter=8, seed=7).fit(xd)
    d = str(tmp_path)
    interrupted = KMeans(n_clusters=3, max_iter=8, seed=7)
    with R.inject(R.FaultSpec(kind="crash", site="fit_iteration",
                              where={"iteration": 2})):
        with pytest.raises(R.CrashError):
            interrupted.fit(xd, checkpoint_dir=d)
    resumed = KMeans(n_clusters=3, max_iter=8, seed=7)
    resumed.fit(xd, checkpoint_dir=d, resume=d)
    assert resumed.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(host(resumed.centers_), host(ref.centers_),
                               rtol=1e-5)
    assert torch.equal(resumed.centers_, ref.centers_)
    # the checkpointed fit is the plain fit, bit for bit; a finished
    # directory resumes without running an iteration
    again = KMeans(n_clusters=3, max_iter=8, seed=7).fit(
        xd, checkpoint_dir=str(tmp_path / "full"))
    assert torch.equal(again.centers_, ref.centers_)
    with R.inject(R.FaultSpec(kind="crash", site="fit_iteration",
                              times=None)):
        done = KMeans(n_clusters=3, max_iter=8, seed=7).fit(
            xd, resume=str(tmp_path / "full"))
    assert done.n_iter_ == ref.n_iter_ and torch.equal(done.centers_,
                                                       ref.centers_)


def test_save_load_model_registry(tmp_path):
    xd, y = _svm_data()
    svm = CascadeSVM(max_iter=3, tol=1e-12).fit(xd, y)
    pred_ref = host(svm.predict(xd)).ravel()
    d = str(tmp_path)
    svm.save_model(d)
    again = load_model(d, device=CPU)
    assert type(again) is CascadeSVM
    assert again.get_params() == svm.get_params()
    assert (host(again.predict(xd)).ravel() == pred_ref).all()
    assert torch.equal(again.decision_function(xd).blocks,
                       svm.decision_function(xd).blocks)
    assert again.sv_.dtype == svm.sv_.dtype
    with pytest.raises(ValueError, match="CascadeSVM"):
        LinearRegression.load_model(d, device=CPU)
    with pytest.raises(NotFittedError):
        CascadeSVM().save_model(str(tmp_path / "never-written"))
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path / "empty"), device=CPU)


def test_save_load_model_algorithms_registry(tmp_path):
    rng = np.random.default_rng(SEED + 13)
    xd = ds(rng.normal(size=(30, 4)).astype(np.float32), (10, 4))
    km = KMeans(n_clusters=2, max_iter=5, seed=1).fit(xd)
    d = str(tmp_path)
    km.save_model(d)
    back = load_model(d, device=CPU)
    assert type(back) is KMeans
    assert torch.equal(back.centers_, km.centers_)
    assert back.n_iter_ == km.n_iter_
    # versions are checkpoint steps: the newest loads unless pinned
    km2 = KMeans(n_clusters=2, max_iter=1, seed=2).fit(xd)
    km2.save_model(d, version=1)
    assert pck.list_steps(d) == [0, 1]
    assert load_model(d, device=CPU).n_iter_ == km2.n_iter_
    assert torch.equal(load_model(d, version=0, device=CPU).centers_,
                       km.centers_)


def test_fit_checkpoint_wrong_estimator_rejected(tmp_path):
    a = _FitCheckpoint(str(tmp_path), "CascadeSVM")
    a.save(1, {"w": np.ones(3, np.float32), "obj": 1.5})
    with pytest.raises(ValueError, match="CascadeSVM"):
        _FitCheckpoint(str(tmp_path), "ALS").load(device=CPU)
    it, st = a.load(device=CPU)
    assert it == 1 and st["obj"] == 1.5
    assert st["w"].dtype == torch.float32
    assert _FitCheckpoint(str(tmp_path / "none"), "ALS").load(device=CPU) is None


def test_clean_fit_keeps_plan_cache_regression():
    xd, y = _svm_data()
    plan_mod.clear_cache()
    CascadeSVM(max_iter=5, tol=1e-12).fit(xd, y)
    st = plan_mod.cache_stats()
    assert st["opt_runs"] == 1
    assert st["eager_launches"] == 0
    s = R.stats()
    assert s["retries"] == 0 and s["degradations"] == 0


# ---------------------------------------------------------------------------
# Cross-package checkpoints
# ---------------------------------------------------------------------------

def _tree(lib):
    """One tree of nested dicts, lists, tuples and None, with NumPy and
    scalar leaves, plus a 64-bit device array (a torch tensor for the port,
    a jax array for the reference: both land as 32 bits)."""
    rng = np.random.default_rng(SEED + 30)
    dev = rng.normal(size=(3, 5))
    return {
        "zeta": [np.arange(6, dtype=np.int64).reshape(2, 3),
                 {"b": 2.5, "a": rng.normal(size=(4,)).astype(np.float32)}],
        "alpha": (np.int32(7), None, [True]),
        "dev": torch.as_tensor(dev) if lib == "torch" else jnp.asarray(dev),
        "ints": {10: np.float16(1.5), 2: np.uint8(3)},     # numeric order
    }


def _as_protos(tree):
    if isinstance(tree, dict):
        return {k: _as_protos(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_protos(v) for v in tree)
    if tree is None or isinstance(tree, torch.Tensor) or hasattr(tree, "device"):
        return tree
    return np.asarray(tree)


def test_checkpoint_layout_matches_reference_byte_for_byte(tmp_path):
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    pck.save(mine, 3, _tree("torch"), extra={"k": [1, 2]})
    jck.save(ref, 3, _tree("jax"), extra={"k": [1, 2]})
    assert manifest(mine, 3) == manifest(ref, 3)
    assert files(mine, 3) == files(ref, 3)
    assert [e["path"] for e in manifest(mine, 3)["leaves"]] == [
        "alpha/0", "alpha/2/0", "dev", "ints/2", "ints/10", "zeta/0",
        "zeta/1/a", "zeta/1/b"]
    assert pck.list_steps(mine) == jck.list_steps(ref) == [3]
    assert pck.manifest_extra(mine, 3) == {"k": [1, 2]}


def test_checkpoints_restore_across_packages(tmp_path):
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    pck.save(mine, 0, _tree("torch"))
    jck.save(ref, 0, _tree("jax"))
    # restore protos need shapes: scalar leaves as 0-d arrays
    like_t = _as_protos(_tree("torch"))
    like_t["dev"] = like_t["dev"].float()
    got = pck.restore(ref, 0, like_t, device=CPU)
    like_j = _as_protos(_tree("jax"))
    want = jck.restore(mine, 0, like_j)
    assert torch.equal(got["dev"], torch.from_numpy(np.array(want["dev"])))
    assert got["zeta"][0].dtype == torch.int32          # narrowed as jnp does
    assert np.asarray(want["zeta"][0]).dtype == np.int32
    assert torch.equal(got["zeta"][1]["a"],
                       torch.from_numpy(np.array(want["zeta"][1]["a"])))
    assert got["alpha"][1] is None and isinstance(got["alpha"], tuple)
    assert float(got["ints"][10]) == float(np.asarray(want["ints"][10])) == 1.5


def test_bf16_leaf_same_bytes_and_same_error(tmp_path):
    vals = np.linspace(-3, 3, 7).astype(np.float32)
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    pck.save(mine, 0, {"w": torch.as_tensor(vals).to(torch.bfloat16)})
    jck.save(ref, 0, {"w": jnp.asarray(vals, jnp.bfloat16)})
    assert files(mine) == files(ref)
    assert manifest(mine) == manifest(ref)
    assert np.load(os.path.join(mine, "step_00000000", "leaf_00000.npy")
                   ).dtype.str == "|V2"
    with pytest.raises(ValueError) as theirs:
        jck.restore(ref, 0, {"w": jnp.zeros(7, jnp.bfloat16)})
    with pytest.raises(ValueError) as ours:
        pck.restore(mine, 0, {"w": torch.zeros(7, dtype=torch.bfloat16)},
                    device=CPU)
    assert "dtype mismatch" in str(theirs.value)
    assert "checkpoint has |V2" in str(theirs.value)
    assert str(ours.value) == str(theirs.value)
    # the explicit cast reads the records back exactly
    back = pck.restore(mine, 0, {"w": torch.zeros(7, dtype=torch.bfloat16)},
                       device=CPU, allow_cast=True)
    assert torch.equal(back["w"], torch.as_tensor(vals).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# Cross-package model files
# ---------------------------------------------------------------------------

def _blobs():
    rng = np.random.default_rng(SEED + 40)
    centers = rng.normal(size=(3, 4)).astype(np.float32) * 6.0
    x = np.concatenate([rng.normal(c, 0.5, size=(30, 4)) for c in centers]
                       ).astype(np.float32)
    y = np.repeat(np.arange(3), 30).astype(np.int64)
    perm = rng.permutation(len(x))
    return x[perm], y[perm]


def _regression():
    rng = np.random.default_rng(SEED + 41)
    x = rng.normal(size=(90, 5)).astype(np.float32)
    y = (x @ rng.normal(size=5) + 0.5 + 0.05 * rng.normal(size=90))
    return x, y                       # float64 targets: coef_ is float64


def _two_blobs():
    """Two separated classes: both packages' cascades agree to 1e-6 here."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(-1.5, 1.0, size=(60, 4)),
                        rng.normal(1.5, 1.0, size=(60, 4))]).astype(np.float32)
    y = np.repeat([0, 1], 60).astype(np.int32)
    perm = rng.permutation(len(x))
    return x[perm], y[perm]


def _ratings():
    rng = np.random.default_rng(SEED + 42)
    return (rng.normal(size=(40, 3)) @ rng.normal(size=(3, 24))).astype(np.float32)


# name -> (port factory, reference factory, data, block shape, kind)
MODELS = {
    "kmeans": (lambda: KMeans(n_clusters=3, max_iter=10, seed=0),
               lambda: jalg.KMeans(n_clusters=3, max_iter=10, seed=0),
               lambda: (_blobs()[0], None), (32, 4), "labels"),
    "pca": (lambda: PCA(n_components=2, n_iter=10),
            lambda: jalg.PCA(n_components=2, n_iter=10),
            lambda: (_blobs()[0], None), (32, 4), "transform"),
    "linreg": (lambda: LinearRegression(), lambda: jest.LinearRegression(),
               _regression, (32, 5), "floats"),
    "ridge": (lambda: Ridge(alpha=0.5), lambda: jest.Ridge(alpha=0.5),
              _regression, (32, 5), "floats"),
    "als": (lambda: ALS(n_factors=3, max_iter=4),
            lambda: jalg.ALS(n_factors=3, max_iter=4),
            lambda: (_ratings(), None), (16, 8), "als"),
    "csvm": (lambda: CascadeSVM(sv_cap=32, max_iter=3),
             lambda: jest.CascadeSVM(sv_cap=32, max_iter=3),
             _two_blobs, (32, 4), "labels+decision"),
    "forest": (lambda: RandomForestClassifier(n_estimators=3, max_depth=4),
               lambda: jest.RandomForestClassifier(n_estimators=3, max_depth=4),
               _blobs, (32, 4), "labels"),
}


def _outputs(est, x, kind):
    """What the model computes, as host arrays: labels, projections,
    predictions, decision values, or ALS's ratings U Vᵀ."""
    if kind == "als":
        return {"ratings": host(est.u_) @ host(est.v_).T}
    if kind == "transform":
        return {"transform": host(est.transform(x))}
    out = {"predict": host(est.predict(x))}
    if kind == "labels+decision":
        out["decision"] = host(est.decision_function(x))
    return out


def _same(got, want, kind):
    for k in want:
        if k == "predict" and kind.startswith("labels"):
            assert np.array_equal(got[k].ravel(), want[k].ravel()), k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """Each model fitted by both packages on one NumPy input and saved."""
    out = {}
    for name, (mk, jmk, data, block, kind) in MODELS.items():
        x, y = data()
        px, jxd = ds(x, block), jds(x, block)
        mine = mk().fit(px, y) if y is not None else mk().fit(px)
        ref = jmk().fit(jxd, y) if y is not None else jmk().fit(jxd)
        d = tmp_path_factory.mktemp(name)
        mine.save_model(str(d / "mine"))
        ref.save_model(str(d / "ref"))
        out[name] = (mine, ref, px, jxd, kind, d)
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_reference_model_loads_in_the_port(fitted, name):
    mine, ref, px, jxd, kind, d = fitted[name]
    back = load_model(str(d / "ref"), device=CPU)
    assert type(back) is type(mine)
    assert back.get_params() == ref.get_params()
    _same(_outputs(back, px, kind), _outputs(ref, jxd, kind), kind)


@pytest.mark.parametrize("name", list(MODELS))
def test_port_model_loads_in_the_reference(fitted, name):
    mine, ref, px, jxd, kind, d = fitted[name]
    back = jest.load_model(str(d / "mine"))
    assert type(back) is type(ref)
    assert back.get_params() == mine.get_params()
    _same(_outputs(back, jxd, kind), _outputs(mine, px, kind), kind)


def _same_extra(got, want, path="extra"):
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _same_extra(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_extra(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert np.isclose(got, want, rtol=1e-4, atol=1e-4), (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", list(MODELS))
def test_manifests_equal(fitted, name):
    """The same fit saved by either package: the same leaves (paths, order,
    files, shapes, dtypes) and the same ``extra`` (floats at 1e-4); loaded
    and saved again, the two packages write the same files."""
    mine, ref, px, jxd, kind, d = fitted[name]
    m, r = manifest(str(d / "mine")), manifest(str(d / "ref"))
    assert m["step"] == r["step"]
    assert m["leaves"] == r["leaves"]
    _same_extra(m["extra"], r["extra"])
    load_model(str(d / "ref"), device=CPU).save_model(str(d / "ref_port"))
    jest.load_model(str(d / "ref")).save_model(str(d / "ref_ref"))
    assert manifest(str(d / "ref_port")) == manifest(str(d / "ref_ref"))
    assert files(str(d / "ref_port")) == files(str(d / "ref_ref"))


def test_loaded_model_predicts_the_fitted_bits(fitted):
    """Within the port: save then load on the same device gives every
    output of the fitted object bit for bit."""
    for name, (mine, ref, px, jxd, kind, d) in fitted.items():
        back = load_model(str(d / "mine"), device=CPU)
        got, want = _outputs(back, px, kind), _outputs(mine, px, kind)
        for k in want:
            assert np.array_equal(got[k], want[k]), (name, k)
