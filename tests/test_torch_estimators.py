"""The port's estimator layer (``repro_torch.estimators`` and the estimator
classes of ``repro_torch.algorithms``) against the JAX package's.

One counterpart of each ``tests/test_estimators.py`` case, on ``device="cpu"``
inputs (the contract sweep over the same registry, validation, the sklearn
oracles, the solver behaviour, the sparse CSVM that never densifies and
optimises its plan once, lazy interop), then parity cases that feed both
packages one NumPy array:

* ``LinearRegression``/``Ridge`` (every solver): coefficients and intercept
  at rtol = atol = 1e-4;
* ``RandomForestClassifier``: edges, split features, bins and leaf classes
  equal, predictions equal (the bootstrap draws are the reference's own);
* ``PCA``/``pca``: both packages' starting draw patched to one array;
  components equal up to sign and variances at 1e-4;
* ``ALS``: both packages' ``random_array`` patched to one array; U and V
  after 3 iterations at rtol 1e-3 (of their scale), predictions and score;
* ``CascadeSVM``: predictions equal except where |decision| < 1e-4,
  ``dual_coef_`` at atol 1e-3;
* the sparse branches (PCA without centering, the sparse normal equations,
  the sparse CSVM) against the reference on one ``scipy.sparse`` matrix.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as ssp  # noqa: E402

import repro  # noqa: E402
import repro.core as jx  # noqa: E402
from repro.algorithms import ALS as JALS, PCA as JPCA  # noqa: E402
from repro.algorithms import als as jals, linalg as jlin  # noqa: E402
from repro.core import sparse as jsparse  # noqa: E402
from repro.estimators import (CascadeSVM as JSVM,  # noqa: E402
                              RandomForestClassifier as JRF)
import repro_torch as pt  # noqa: E402
from repro_torch.algorithms import ALS, KMeans, PCA  # noqa: E402
from repro_torch.algorithms import als as pals, linalg as plin  # noqa: E402
from repro_torch.core import DsArray, plan  # noqa: E402
from repro_torch.core import sparse as psparse  # noqa: E402
from repro_torch.estimators import (BaseClassifier,  # noqa: E402
                                    BaseEstimator, BaseRegressor, CascadeSVM,
                                    LinearRegression, NotFittedError,
                                    RandomForestClassifier, Ridge,
                                    resolve_estimator)
from repro_torch.kernels.matmul import ops as mops  # noqa: E402
from repro_torch.obs import registry  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

CPU = "cpu"


def ds(x, block):
    """``x`` as a port ds-array on the CPU."""
    return pt.from_array(x, block, device=CPU)


def jds(x, block):
    return jx.from_array(jnp.asarray(x), block)


def host(a) -> np.ndarray:
    if isinstance(a, DsArray):
        a = a.collect()
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# Fixed small datasets (those of tests/test_estimators.py)
# ---------------------------------------------------------------------------


def two_blobs(seed=0, n_per=60, d=4, sep=3.0):
    rng = np.random.default_rng(seed)
    a = rng.normal(-sep / 2, 1.0, size=(n_per, d))
    b = rng.normal(sep / 2, 1.0, size=(n_per, d))
    x = np.concatenate([a, b]).astype(np.float32)
    y = np.concatenate([np.zeros(n_per), np.ones(n_per)]).astype(np.int32)
    idx = rng.permutation(len(x))
    return x[idx], y[idx]


def three_blobs(seed=0, n_per=50, d=4, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, d)).astype(np.float32) * spread
    x = np.concatenate([rng.normal(c, 0.5, size=(n_per, d)).astype(np.float32)
                        for c in centers])
    y = np.repeat(np.arange(3), n_per).astype(np.int32)
    idx = rng.permutation(len(x))
    return x[idx], y[idx]


def regression_data(seed=0, n=150, m=5, noise=0.05):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)).astype(np.float32)
    coef = rng.normal(size=m).astype(np.float32)
    y = (x @ coef + 0.5 + noise * rng.normal(size=n)).astype(np.float32)
    return x, y, coef


def sparse_two_blobs(seed=0, n_per=60, d=8):
    """Two classes separable on sparse 'topic' features, ~46% dense."""
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((2 * n_per, d)) < 0.8, 0.0,
                 np.abs(rng.normal(size=(2 * n_per, d)))).astype(np.float32)
    sig = ((rng.random((2 * n_per, d // 2)) < 0.6) *
           np.abs(rng.normal(size=(2 * n_per, d // 2))) * 4.0)
    x[:n_per, : d // 2] += sig[:n_per].astype(np.float32)
    x[n_per:, d // 2:] += sig[n_per:].astype(np.float32)
    y = np.concatenate([np.zeros(n_per), np.ones(n_per)]).astype(np.int32)
    idx = rng.permutation(len(x))
    return x[idx], y[idx]


def low_rank_ratings(seed_u=3, seed_v=4, n=48, m=40, f=3):
    return (np.random.default_rng(seed_u).normal(size=(n, f)) @
            np.random.default_rng(seed_v).normal(size=(f, m))).astype(np.float32)


def _svm_linear():
    return CascadeSVM(kernel="linear", sv_cap=32, max_iter=3)


def _svm_rbf():
    return CascadeSVM(kernel="rbf", sv_cap=32, max_iter=3)


# (name, factory, dataset builder) — the contract-sweep registry of
# tests/test_estimators.py, with the port's classes
ESTIMATORS = [
    ("csvm_linear", _svm_linear, two_blobs),
    ("csvm_rbf", _svm_rbf, two_blobs),
    ("linreg", lambda: LinearRegression(), lambda: regression_data()[:2]),
    ("ridge", lambda: Ridge(alpha=0.5), lambda: regression_data()[:2]),
    ("forest", lambda: RandomForestClassifier(n_estimators=6, max_depth=5,
                                              seed=3), three_blobs),
    ("kmeans", lambda: KMeans(n_clusters=3, max_iter=20, seed=0),
     lambda: (three_blobs()[0], None)),
    ("pca", lambda: PCA(n_components=2, n_iter=30),
     lambda: (three_blobs()[0], None)),
    ("als", lambda: ALS(n_factors=3, reg=1e-3, max_iter=8, tol=1e-6),
     lambda: (low_rank_ratings(), None)),
]

IDS = [e[0] for e in ESTIMATORS]


def _fit(est, x, y, block=(32, None)):
    bn, bm = block
    xd = ds(x, (bn, bm or x.shape[1]))
    return est.fit(xd, y) if y is not None else est.fit(xd), xd


def _fitted_signature(est, xd):
    """Predictions where the estimator predicts rows, else its fitted
    arrays, as host NumPy."""
    if isinstance(est, (CascadeSVM, RandomForestClassifier, LinearRegression,
                        KMeans)):
        return host(est.predict(xd)).ravel()
    if isinstance(est, PCA):
        return host(est.components_)
    if isinstance(est, ALS):
        return host(est.u_ @ est.v_.T)
    raise AssertionError(type(est))


@pytest.fixture
def no_densify(monkeypatch):
    """A context manager: any densify of a sparse operand inside it raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a sparse operand was densified")

    @contextlib.contextmanager
    def guard():
        with monkeypatch.context() as mp:
            for mod, name in ((psparse, "todense"), (psparse, "_to_dense_blocks"),
                              (mops, "_to_dense_blocks")):
                mp.setattr(mod, name, refuse)
            yield
    return guard


# ---------------------------------------------------------------------------
# Contract: params round-trip, determinism, input formats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,factory,data", ESTIMATORS, ids=IDS)
def test_params_roundtrip(name, factory, data):
    est = factory()
    params = est.get_params()
    clone = type(est)(**params)
    assert clone.get_params() == params
    assert est.set_params(**params) is est
    assert est.get_params() == params
    assert not any(k.endswith("_") for k in params)
    with pytest.raises(ValueError):
        est.set_params(definitely_not_a_param=1)


@pytest.mark.parametrize("name,factory,data", ESTIMATORS, ids=IDS)
def test_deterministic_under_fixed_seed(name, factory, data):
    x, y = data()
    a, xd = _fit(factory(), x, y)
    b, _ = _fit(factory(), x, y)
    np.testing.assert_array_equal(_fitted_signature(a, xd),
                                  _fitted_signature(b, xd))


@pytest.mark.parametrize("name,factory,data", ESTIMATORS, ids=IDS)
def test_accepts_dense_bcoo_and_ragged_grids(name, factory, data):
    x, y = data()
    ref, ref_xd = _fit(factory(), x, y)
    ref_sig = _fitted_signature(ref, ref_xd)

    def check(sig, label):
        if name in ("kmeans", "csvm_linear", "csvm_rbf", "forest"):
            agree = (np.asarray(ref_sig) == np.asarray(sig)).mean()
            assert agree > 0.9, (name, label, agree)
        elif name == "als":
            # blocking changes the random init: compare each factorization
            # against the ratings matrix it reconstructs
            rmse = float(np.sqrt(((sig - x) ** 2).mean()))
            assert rmse < 0.1, (label, rmse)
        else:
            np.testing.assert_allclose(np.abs(ref_sig), np.abs(sig),
                                       rtol=5e-2, atol=5e-2,
                                       err_msg=f"{name}/{label}")

    bn, bm = 17, max(1, x.shape[1] - 1)
    xr = ds(x, (bn, bm))
    rag = factory().fit(xr, y) if y is not None else factory().fit(xr)
    check(_fitted_signature(rag, ref_xd), "ragged")

    xs = ds(x, (32, x.shape[1])).tosparse()
    sp = factory().fit(xs, y) if y is not None else factory().fit(xs)
    check(_fitted_signature(sp, ref_xd), "bcoo")


def test_predict_before_fit_raises():
    ones = ds(np.ones((4, 2), np.float32), (2, 2))
    for est, args in ((CascadeSVM(), (ones,)), (LinearRegression(), (ones,)),
                      (RandomForestClassifier(), (ones,)), (KMeans(), (ones,)),
                      (PCA(), (ones,)), (ALS(), (0, 0))):
        with pytest.raises(NotFittedError):
            if isinstance(est, PCA):
                est.transform(*args)
            else:
                est.predict(*args)


def test_validation_rejects_bad_inputs():
    x, y = two_blobs()
    xd = ds(x, (32, 4))
    with pytest.raises(ValueError):
        CascadeSVM().fit(xd, y[:-3])          # length mismatch
    with pytest.raises(ValueError):
        CascadeSVM().fit(np.ones((4, 2, 2)), [1, 0, 1, 0])   # not 2-D
    with pytest.raises(ValueError):
        CascadeSVM().fit(xd, np.zeros_like(y))               # one class
    with pytest.raises(ValueError):
        CascadeSVM(kernel="poly").fit(xd, y)
    with pytest.raises(ValueError):
        LinearRegression(solver="qr").fit(xd, y.astype(np.float32))
    with pytest.raises(ValueError):
        LinearRegression().fit(xd, ds(np.ones((len(x), 2), np.float32), (32, 2)))
    # a raw ndarray is blocked automatically, on the device it names
    raw = LinearRegression._validate_x(x, device=CPU)
    assert isinstance(raw, DsArray) and raw.shape == x.shape
    assert raw.block_shape == (120, 4) and raw.device.type == "cpu"
    est = LinearRegression().fit(raw, y.astype(np.float32))
    assert est.coef_ is not None
    # y may be a tensor or an (n, 1) ds-array as well
    y32 = y.astype(np.float32)
    want = LinearRegression().fit(xd, y32).coef_
    for yy in (torch.as_tensor(y32), ds(y32.reshape(-1, 1), (32, 1))):
        np.testing.assert_array_equal(LinearRegression().fit(xd, yy).coef_, want)
    out = est.predict(xd)
    assert isinstance(out, DsArray) and out.shape == (len(x), 1)


def test_checkpoint_arguments_are_honoured(tmp_path):
    """``checkpoint_dir``/``resume`` are honoured, never ignored (they
    raised ``NotImplementedError`` until the fit checkpoints were ported):
    a checkpointed fit commits one step per iteration and equals the plain
    fit; resuming from an empty directory is a fresh fit."""
    from repro_torch.checkpoint import list_steps
    x, y = two_blobs()
    for name, fit, fitted in (
            ("svm", lambda **kw: CascadeSVM(max_iter=2).fit(ds(x, (32, 4)), y, **kw),
             lambda e: e.sv_),
            ("als", lambda **kw: ALS(max_iter=2).fit(ds(low_rank_ratings(), (16, 8)),
                                                     **kw),
             lambda e: e.u_.blocks)):
        plain = fit()
        d = str(tmp_path / name)
        for kw in ({"checkpoint_dir": d}, {"resume": str(tmp_path / "empty")}):
            got = fit(**kw)
            assert got.n_iter_ == plain.n_iter_
            assert torch.equal(fitted(got), fitted(plain))
        assert list_steps(d) == list(range(1, plain.n_iter_ + 1))


def test_resolve_estimator_and_shared_base():
    for cls in (CascadeSVM, LinearRegression, Ridge, RandomForestClassifier,
                KMeans, ALS, PCA):
        assert issubclass(cls, BaseEstimator), cls
        assert resolve_estimator(cls.__name__) is cls
    assert issubclass(CascadeSVM, BaseClassifier)
    assert issubclass(RandomForestClassifier, BaseClassifier)
    assert issubclass(Ridge, BaseRegressor)
    with pytest.raises(KeyError):
        resolve_estimator("NoSuchEstimator")


def test_predict_plan_equals_predict():
    x, y, _ = regression_data(seed=5)
    xd = ds(x, (32, 5))
    est = LinearRegression().fit(xd, y)
    assert est.has_predict_plan() and not CascadeSVM().has_predict_plan()
    got = est.predict_plan(xd).execute()[0]
    np.testing.assert_array_equal(host(got), host(est.predict(xd)))


# ---------------------------------------------------------------------------
# Oracle agreement (sklearn optional)
# ---------------------------------------------------------------------------


def test_csvm_matches_sklearn_svc():
    svm = pytest.importorskip("sklearn.svm")
    x, y = two_blobs(seed=1)
    xd = ds(x, (32, 4))
    for kernel in ("linear", "rbf"):
        ours = CascadeSVM(kernel=kernel, c=1.0, sv_cap=48).fit(xd, y)
        theirs = svm.SVC(kernel=kernel, C=1.0, gamma="scale").fit(x, y)
        pred = host(ours.predict(xd)).ravel()
        agree = (pred == theirs.predict(x)).mean()
        assert agree >= 0.95, (kernel, agree)
        assert ours.score(xd, y) >= 0.95


def test_ridge_matches_sklearn():
    linear_model = pytest.importorskip("sklearn.linear_model")
    x, y, _ = regression_data(seed=2)
    ours = Ridge(alpha=2.0).fit(ds(x, (32, 5)), y)
    theirs = linear_model.Ridge(alpha=2.0).fit(x, y)
    np.testing.assert_allclose(ours.coef_, theirs.coef_, atol=1e-4)
    assert abs(ours.intercept_ - theirs.intercept_) < 1e-4


def test_forest_accuracy_floor():
    x, y = three_blobs(seed=5, n_per=80)
    xtr, ytr = x[:180], y[:180]
    xte, yte = x[180:], y[180:]
    f = RandomForestClassifier(n_estimators=8, max_depth=6, seed=0).fit(
        ds(xtr, (32, 4)), ytr)
    assert f.score(ds(xtr, (32, 4)), ytr) >= 0.95
    assert f.score(ds(xte, (32, 4)), yte) >= 0.85


def test_linreg_tsqr_fallback_on_ill_conditioned():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(120, 3)).astype(np.float32)
    x = np.concatenate(
        [base, base + 1e-4 * rng.normal(size=base.shape).astype(np.float32)],
        axis=1)
    y = x.sum(axis=1).astype(np.float32)
    est = LinearRegression().fit(ds(x, (32, 3)), y)
    assert est.solver_used_ == "tsqr"
    assert est.score(ds(x, (32, 3)), y) > 0.999
    xw, yw, coef = regression_data(seed=3, noise=0.0)
    est2 = LinearRegression().fit(ds(xw, (32, 5)), yw)
    assert est2.solver_used_ == "normal"
    np.testing.assert_allclose(est2.coef_, coef, atol=1e-4)
    est3 = Ridge(alpha=1.0).fit(ds(x, (32, 3)), y)
    assert est3.solver_used_ == "normal"


# ---------------------------------------------------------------------------
# Sparse-native CSVM + the cached fit-loop plan
# ---------------------------------------------------------------------------


def test_csvm_sparse_fit_never_densifies_and_caches_plan(no_densify):
    """On a sparse input: no densify anywhere in fit (the products contract
    the stored entries, the chunks stay sparse), and a 5-iteration fit
    optimizes its kernel-block plan exactly once."""
    x, y = sparse_two_blobs()
    xs = ds(x, (16, 4)).tosparse()
    assert xs.block_format == "bcoo"
    plan.clear_cache()
    est = CascadeSVM(kernel="rbf", sv_cap=32, max_iter=5, tol=-1.0)
    with no_densify():
        est.fit(xs, y)
    assert est.n_iter_ == 5
    st = plan.cache_stats()
    assert st["opt_runs"] == 1, st
    assert st["opt_skips"] == 4, st
    assert st["misses"] == 1 and st["hits"] == 4, st
    # the recorded kernel block contracts the stored entries: one sparse
    # dispatch of the GEMM entry, no dense one
    sv_ds = ds(est.sv_.T, (xs.block_shape[1], est.sv_cap))
    before = registry.snapshot("gemm")
    with no_densify():
        (xs.lazy() @ sv_ds).compute()
        assert est.score(xs, y) >= 0.9
    after = registry.snapshot("gemm")
    assert after["gemm.dispatch_sparse"] - before["gemm.dispatch_sparse"] == 2
    assert after["gemm.dispatch_plain"] == before["gemm.dispatch_plain"]


def test_csvm_sparse_chunks_stay_bcoo():
    x, y = sparse_two_blobs(seed=3)
    xs = ds(x, (16, 4)).tosparse()
    chunk = xs[0:16]
    assert chunk.block_format == "bcoo"
    chunk.check_invariants()
    np.testing.assert_allclose(host(psparse.rows_to_dense(chunk)),
                               host(xs[0:16].todense()))


def test_estimator_fit_predict_lazy_interop():
    x, y = two_blobs(seed=9)
    xd = ds(x, (32, 4))
    eager = CascadeSVM(kernel="linear", sv_cap=32, max_iter=2).fit(xd, y)
    pred_e = host(eager.predict(xd)).ravel()
    est = CascadeSVM(kernel="linear", sv_cap=32, max_iter=2)
    with pt.lazy():
        est.fit(xd, y)
        pred_l = est.predict(xd)
    np.testing.assert_array_equal(host(pred_l).ravel(), pred_e)


# ---------------------------------------------------------------------------
# Review regressions of the reference, held by the port
# ---------------------------------------------------------------------------


def test_csvm_feedback_loop_actually_iterates():
    x, y = two_blobs(seed=4)
    est = CascadeSVM(kernel="linear", sv_cap=32, max_iter=4,
                     tol=1e-3).fit(ds(x, (32, 4)), y)
    assert est.n_iter_ >= 2
    assert est.score(ds(x, (32, 4)), y) >= 0.95


def test_linreg_tsqr_survives_small_blocks():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(40, 3)).astype(np.float32)
    x = np.concatenate(
        [base, base + 1e-4 * rng.normal(size=base.shape).astype(np.float32)],
        axis=1)
    y = x.sum(axis=1).astype(np.float32)
    xd = ds(x, (4, 3))                    # block rows (4) < features (6)
    est = LinearRegression().fit(xd, y)
    assert est.solver_used_ == "tsqr"
    assert est.score(xd, y) > 0.999
    est2 = LinearRegression(solver="tsqr").fit(xd, y)
    assert est2.score(xd, y) > 0.999
    xw = ds(rng.normal(size=(4, 6)).astype(np.float32), (2, 3))
    yw = np.ones(4, np.float32)
    assert LinearRegression().fit(xw, yw).solver_used_ == "normal"


def test_classifiers_reject_string_labels():
    x, y = two_blobs(seed=2)
    labels = np.where(y == 0, "neg", "pos")
    for est in (CascadeSVM(), RandomForestClassifier()):
        with pytest.raises(ValueError, match="numeric"):
            est.fit(ds(x, (32, 4)), labels)


def test_all_estimators_fit_inside_ambient_lazy():
    x3, y3 = three_blobs(seed=1)
    xd = ds(x3, (32, 4))
    r = low_rank_ratings(3, 3)
    with pt.lazy():
        km = KMeans(n_clusters=3, max_iter=10, seed=0).fit(xd)
        pc = PCA(n_components=2, n_iter=10).fit(xd)
        assert isinstance(pc.transform(xd), DsArray)
        fr = RandomForestClassifier(n_estimators=4, max_depth=4,
                                    seed=0).fit(xd, y3)
        assert isinstance(fr.predict(xd), DsArray)
        lr = Ridge(alpha=0.5).fit(xd, x3[:, 0])
        assert isinstance(lr.predict(xd), DsArray)
        al = ALS(n_factors=3, reg=1e-3, max_iter=4).fit(ds(r, (16, 8)))
        assert np.isfinite(al.score(ds(r, (16, 8))))
    assert km.centers_ is not None and pc.components_ is not None
    assert fr.feat_ is not None and al.u_ is not None
    eager = RandomForestClassifier(n_estimators=4, max_depth=4, seed=0).fit(xd, y3)
    np.testing.assert_array_equal(eager.feat_, fr.feat_)


def test_pca_transform_uses_training_mean():
    x, _ = three_blobs(seed=2)
    est = PCA(n_components=2, n_iter=30).fit(ds(x, (32, 4)))
    full = host(est.transform(ds(x, (32, 4))))
    one = host(est.transform(ds(x[:1], (1, 4))))
    np.testing.assert_allclose(one.ravel(), full[0], rtol=1e-4, atol=1e-4)
    assert np.abs(one).max() > 1e-3


def test_ridge_tsqr_keeps_regularization():
    linear_model = pytest.importorskip("sklearn.linear_model")
    x, y, _ = regression_data(seed=4)
    ours = Ridge(alpha=50.0, solver="tsqr").fit(ds(x, (32, 5)), y)
    ols = LinearRegression(solver="tsqr").fit(ds(x, (32, 5)), y)
    sk = linear_model.Ridge(alpha=50.0).fit(x, y)
    np.testing.assert_allclose(ours.coef_, sk.coef_, atol=1e-4)
    assert np.abs(ours.coef_ - ols.coef_).max() > 1e-3


def test_csvm_duplicate_samples_keep_combined_box():
    svm = pytest.importorskip("sklearn.svm")
    x, y = two_blobs(seed=8, sep=1.5)        # overlapping: C matters
    xd2 = np.repeat(x, 2, axis=0)            # every sample twice
    yd2 = np.repeat(y, 2)
    ours = CascadeSVM(kernel="linear", c=0.05, sv_cap=64,
                      max_iter=3).fit(ds(xd2, (32, 4)), yd2)
    theirs = svm.SVC(kernel="linear", C=0.05).fit(xd2, yd2)
    pred = host(ours.predict(ds(xd2, (32, 4))))
    agree = (pred.ravel() == theirs.predict(xd2)).mean()
    assert agree >= 0.9, agree
    assert float(ours.dual_coef_.max()) > 0.05 * (1 + 1e-6)


def test_csvm_dedup_matches_reference():
    """The duplicate collapse: data-data duplicates add their multiplicity,
    a duplicate involving a model copy zeroes the copy — the reference's
    function on the same candidates."""
    rng = np.random.default_rng(11)
    b = rng.normal(size=(10, 3)).astype(np.float32)
    b[3] = b[1]                      # data-data
    b[7] = b[1]                      # model copy of a data row
    b[8] = b[9]                      # model-model
    y = np.ones(10, np.float32)
    y[5] = -1.0
    b[5] = b[0]                      # same row, other label: kept apart
    mult = np.ones(10, np.float32)
    mult[6] = 0.0
    is_data = np.arange(10) < 6
    got = CascadeSVM._dedup(b, y, mult, is_data)
    want = JSVM._dedup(b, y, mult, is_data)
    np.testing.assert_array_equal(got, want)
    assert got[1] == 2.0 and got[3] == 0.0 and got[7] == 0.0 and got[9] == 0.0


def test_linreg_rank_deficient_min_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(60, 6)).astype(np.float32)
    x[:, 3] = 0.0                              # dead feature
    w = rng.normal(size=6).astype(np.float32)
    w[3] = 0.0
    y = (x @ w).astype(np.float32)
    for xd in (ds(x, (16, 6)).tosparse(), ds(x, (16, 6))):
        est = LinearRegression().fit(xd, y)
        assert np.isfinite(est.coef_).all(), est.solver_used_
        pred = host(est.predict(xd)).ravel()
        np.testing.assert_allclose(pred, y, atol=1e-3,
                                   err_msg=est.solver_used_)


# ---------------------------------------------------------------------------
# Parity with the reference on shared NumPy inputs
# ---------------------------------------------------------------------------

LINEAR_CASES = [(cls, solver) for cls in ("LinearRegression", "Ridge")
                for solver in ("auto", "normal", "tsqr")]


@pytest.mark.parametrize("cls,solver", LINEAR_CASES,
                         ids=[f"{c}-{s}" for c, s in LINEAR_CASES])
def test_linear_parity(cls, solver):
    x, y, _ = regression_data(seed=6, n=130)
    port = getattr(pt, cls)(solver=solver).fit(ds(x, (32, 5)), y)
    ref = getattr(repro.estimators, cls)(solver=solver).fit(jds(x, (32, 5)), y)
    assert port.solver_used_ == ref.solver_used_
    np.testing.assert_allclose(port.coef_, ref.coef_, rtol=1e-4, atol=1e-4)
    assert port.intercept_ == pytest.approx(ref.intercept_, rel=1e-4, abs=1e-4)
    got, want = port.predict(ds(x, (32, 5))), ref.predict(jds(x, (32, 5)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(host(got), np.asarray(want.collect()),
                               rtol=1e-4, atol=1e-4)
    assert port.score(ds(x, (32, 5)), y) == pytest.approx(
        ref.score(jds(x, (32, 5)), y), rel=1e-4, abs=1e-4)


@pytest.mark.parametrize("block,bootstrap", [((32, 4), True), ((17, 3), False)],
                         ids=["bootstrap", "ragged-no-bootstrap"])
def test_forest_parity(block, bootstrap):
    x, y = three_blobs(seed=7)
    y = y * 3 + 1                                   # labels 1, 4, 7
    kw = dict(n_estimators=5, max_depth=4, bootstrap=bootstrap, seed=2)
    port = RandomForestClassifier(**kw).fit(ds(x, block), y)
    ref = JRF(**kw).fit(jds(x, block), y)
    for name in ("classes_", "edges_", "feat_", "bin_", "leaf_class_"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name),
                                      err_msg=name)
    got, want = port.predict(ds(x, block)), ref.predict(jds(x, block))
    assert host(got).dtype == np.asarray(want.collect()).dtype
    np.testing.assert_array_equal(host(got), np.asarray(want.collect()))


@pytest.fixture
def shared_start(monkeypatch):
    """Both packages' power iteration starts from one NumPy draw."""
    def patch(m, k):
        q0 = np.random.default_rng(m * 100 + k).normal(size=(m, k)).astype(np.float32)
        monkeypatch.setattr(plin, "_initial_q",
                            lambda m_, k_, seed, device: torch.as_tensor(q0, device=device))
        monkeypatch.setattr(jlin.jax.random, "normal",
                            lambda key, shape, *a, **kw: jnp.asarray(q0))
    return patch


def _same_components(got, want):
    got, want = host(got), np.asarray(want)
    signs = np.sign((got * want).sum(axis=1, keepdims=True))
    np.testing.assert_allclose(got * signs, want, rtol=1e-4, atol=1e-4)


def test_pca_parity(shared_start):
    x, _ = three_blobs(seed=3)
    shared_start(4, 2)
    port = PCA(n_components=2).fit(ds(x, (32, 4)))
    ref = JPCA(n_components=2).fit(jds(x, (32, 4)))
    _same_components(port.components_, ref.components_)
    np.testing.assert_allclose(host(port.explained_variance_),
                               np.asarray(ref.explained_variance_), rtol=1e-4)
    np.testing.assert_allclose(host(port.mean_), np.asarray(ref.mean_), rtol=1e-5)
    got, want = port.transform(ds(x, (32, 4))), ref.transform(jds(x, (32, 4)))
    signs = np.sign(np.einsum("km,km->k", host(port.components_),
                              np.asarray(ref.components_)))
    np.testing.assert_allclose(host(got) * signs, np.asarray(want.collect()),
                               rtol=1e-4, atol=1e-4)
    assert port.score(None) == pytest.approx(ref.score(None), rel=1e-4)


def test_pca_function_parity(shared_start):
    rng = np.random.default_rng(0)
    basis = np.linalg.qr(rng.normal(size=(6, 6)))[0]
    data = ((rng.normal(size=(400, 6)) * [10, 5, 2, .1, .1, .1]) @ basis.T
            ).astype(np.float32)
    shared_start(6, 3)
    comps, var = pt.pca(ds(data, (100, 3)), 3, n_iter=40)
    jcomps, jvar = jlin.pca(jds(data, (100, 3)), 3, n_iter=40)
    _same_components(comps, jcomps)
    np.testing.assert_allclose(host(var), np.asarray(jvar), rtol=1e-4)
    assert pt.frobenius(ds(data, (100, 3))) == pytest.approx(
        jlin.frobenius(jds(data, (100, 3))), rel=1e-5)


@pytest.fixture
def shared_factors(monkeypatch):
    """Both packages' ALS start from the same U and V (one NumPy draw each,
    told apart by their row counts)."""
    def patch(u0, v0):
        pick = lambda shape: u0 if shape[0] == u0.shape[0] else v0  # noqa: E731
        monkeypatch.setattr(pals, "random_array",
                            lambda gen, shape, block_shape, device="cuda", **kw:
                            pt.from_array(pick(shape), block_shape, device=device))
        monkeypatch.setattr(jals, "random_array",
                            lambda key, shape, block_shape, **kw:
                            jx.from_array(jnp.asarray(pick(shape)), block_shape))
    return patch


def _close_at_scale(got, want, rtol):
    got, want = host(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_als_parity(shared_factors, sparse):
    rng = np.random.default_rng(8)
    r = low_rank_ratings(5, 6, n=44, m=36, f=3)
    if sparse:
        r = (r * (rng.random(r.shape) < 0.4)).astype(np.float32)
    u0 = rng.random((44, 3)).astype(np.float32)
    v0 = rng.random((36, 3)).astype(np.float32)
    shared_factors(u0, v0)
    rp, rj = ds(r, (16, 8)), jds(r, (16, 8))
    if sparse:
        rp, rj = rp.tosparse(), rj.tosparse()
    kw = dict(n_factors=3, reg=0.05, max_iter=3, check_convergence=False)
    port, ref = ALS(**kw).fit(rp), JALS(**kw).fit(rj)
    assert port.n_iter_ == ref.n_iter_ == 3
    assert port.u_.block_format == "dense" and port.u_.shape == (44, 3)
    _close_at_scale(port.u_.collect(), ref.u_.collect(), 1e-3)
    _close_at_scale(port.v_.collect(), ref.v_.collect(), 1e-3)
    assert port.predict(3, 5) == pytest.approx(ref.predict(3, 5), rel=1e-3, abs=1e-3)
    assert port.score(rp) == pytest.approx(ref.score(rj), rel=1e-3, abs=1e-4)
    # and with the convergence check, the same number of iterations
    kw.update(check_convergence=True, max_iter=8, tol=1e-3)
    assert ALS(**kw).fit(rp).n_iter_ == JALS(**kw).fit(rj).n_iter_


def _csvm_agrees(port, ref, xp, xj):
    dec = np.asarray(ref.decision_function(xj).collect()).ravel()
    got = host(port.predict(xp)).ravel()
    want = np.asarray(ref.predict(xj).collect()).ravel()
    firm = np.abs(dec) >= 1e-4
    np.testing.assert_array_equal(got[firm], want[firm])
    np.testing.assert_allclose(host(port.dual_coef_), ref.dual_coef_, atol=1e-3)
    np.testing.assert_allclose(host(port.decision_function(xp)).ravel(), dec,
                               rtol=1e-3, atol=1e-3)
    assert port.n_iter_ == ref.n_iter_ and port.n_sv_ == ref.n_sv_
    assert port.intercept_ == pytest.approx(ref.intercept_, abs=1e-3)


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_csvm_parity(kernel):
    x, y = two_blobs(seed=12, sep=2.0)
    kw = dict(kernel=kernel, sv_cap=40, max_iter=3)
    port = CascadeSVM(**kw).fit(ds(x, (24, 4)), y)
    ref = JSVM(**kw).fit(jds(x, (24, 4)), y)
    assert port.gamma_ == pytest.approx(ref.gamma_, rel=1e-5)
    _csvm_agrees(port, ref, ds(x, (24, 4)), jds(x, (24, 4)))


# ---------------------------------------------------------------------------
# Sparse branches against the reference, from one scipy.sparse matrix
# ---------------------------------------------------------------------------


def _scipy_pair(mat, block):
    return (psparse.from_scipy(mat, block, device=CPU),
            jsparse.from_scipy(mat, block))


def test_sparse_pca_parity(shared_start, no_densify):
    mat = ssp.random(90, 12, density=0.3, random_state=3, dtype=np.float32,
                     data_rvs=lambda k: np.random.default_rng(4).random(k) * 4)
    xp, xj = _scipy_pair(mat, (32, 5))
    shared_start(12, 3)
    with no_densify():
        port = PCA(n_components=3, center=False).fit(xp)
        proj = port.transform(xp)
    ref = JPCA(n_components=3, center=False).fit(xj)
    _same_components(port.components_, ref.components_)
    np.testing.assert_allclose(host(port.explained_variance_),
                               np.asarray(ref.explained_variance_), rtol=1e-4)
    signs = np.sign(np.einsum("km,km->k", host(port.components_),
                              np.asarray(ref.components_)))
    np.testing.assert_allclose(host(proj) * signs,
                               np.asarray(ref.transform(xj).collect()),
                               rtol=1e-4, atol=1e-4)


def test_sparse_normal_equations_parity(no_densify, monkeypatch):
    mat = ssp.random(120, 7, density=0.5, random_state=5, dtype=np.float32)
    y = (mat @ np.arange(1, 8, dtype=np.float32) + 0.25).astype(np.float32)
    xp, xj = _scipy_pair(mat, (32, 7))
    # only the right-hand copy of XᵀX may take its dense form
    dense_right = []
    real = psparse.todense

    def spy(a):
        if a.device.type != "meta":          # not the metadata inference
            dense_right.append(a.shape)
        return real(a)
    for cls in ("LinearRegression", "Ridge"):
        monkeypatch.setattr(psparse, "todense", spy)
        port = getattr(pt, cls)().fit(xp, y)
        monkeypatch.setattr(psparse, "todense", real)
        ref = getattr(repro.estimators, cls)().fit(xj, y)
        assert port.solver_used_ == ref.solver_used_ == "normal"
        np.testing.assert_allclose(port.coef_, ref.coef_, rtol=1e-4, atol=1e-4)
        assert port.intercept_ == pytest.approx(ref.intercept_, rel=1e-4, abs=1e-4)
        with no_densify():
            got = port.predict(xp)
        np.testing.assert_allclose(host(got), np.asarray(ref.predict(xj).collect()),
                                   rtol=1e-4, atol=1e-4)
    assert dense_right == [xp.shape, xp.shape]


def test_sparse_csvm_parity(no_densify):
    x, y = sparse_two_blobs(seed=5)
    xp, xj = _scipy_pair(ssp.csr_matrix(x), (16, 4))
    kw = dict(kernel="rbf", sv_cap=32, max_iter=3)
    with no_densify():
        port = CascadeSVM(**kw).fit(xp, y)
    ref = JSVM(**kw).fit(xj, y)
    _csvm_agrees(port, ref, xp, xj)
