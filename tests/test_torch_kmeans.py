"""The port's KMeans against the JAX package's, end to end.

Both packages fit the same seeded blobs with the same parameters; the
k-means++ seeding draws from the same NumPy ``default_rng(seed)``, so the
fits must agree: ``centers_`` within 1e-4, ``n_iter_`` equal, ``predict``
labels equal and ``score`` within 1e-4 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jx  # noqa: E402
from repro.algorithms.kmeans import KMeans as JaxKMeans  # noqa: E402
import repro_torch as pt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.algorithms import KMeans  # noqa: E402
from repro_torch.estimators import NotFittedError  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

CASES = {  # blobs, rows per blob, features, block shape, clusters
    "4x300x16": (4, 300, 16, (128, 8), 4),
    "3x333x10-ragged": (3, 333, 10, (100, 4), 5),
}


def _blobs(n_blobs, per, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, size=(n_blobs, d))
    x = np.concatenate([c + rng.normal(size=(per, d)) for c in centers])
    return x[rng.permutation(len(x))].astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CASES))
def fitted(request):
    n_blobs, per, d, bs, k = CASES[request.param]
    x = _blobs(n_blobs, per, d, seed=per + d)
    xp = pt.from_array(x, bs, device="cpu")
    xj = jx.from_array(jnp.asarray(x), bs)
    params = dict(n_clusters=k, max_iter=20, tol=1e-4, seed=0)
    with tracing.recording() as events:
        port = KMeans(**params).fit(xp)
    ref = JaxKMeans(**params).fit(xj)
    return x, xp, xj, port, ref, events


def test_fit_matches_reference(fitted):
    x, xp, xj, port, ref, _ = fitted
    assert port.n_iter_ == ref.n_iter_ >= 1
    assert tuple(port.centers_.shape) == ref.centers_.shape
    np.testing.assert_allclose(port.centers_.numpy(), np.asarray(ref.centers_),
                               rtol=1e-4, atol=1e-4)


def test_predict_and_score_match_reference(fitted):
    x, xp, xj, port, ref, _ = fitted
    lp, lj = port.predict(xp), ref.predict(xj)
    assert lp.shape == lj.shape == (x.shape[0], 1)
    assert lp.block_shape == lj.block_shape
    assert lp.dtype == torch.int32 and str(lj.dtype) == "int32"
    lp.check_invariants()
    np.testing.assert_array_equal(lp.collect().numpy(), np.asarray(lj.collect()))
    sp, sj = port.score(xp), ref.score(xj)
    assert abs(sp - sj) <= 1e-4 * abs(sj)


def test_reference_model_carried_across(fitted):
    x, xp, xj, port, ref, _ = fitted
    moved = convert.kmeans_from_numpy(ref.get_params(), np.asarray(ref.centers_),
                                      ref.n_iter_, device="cpu")
    assert moved.get_params() == ref.get_params()
    np.testing.assert_array_equal(moved.predict(xp).collect().numpy(),
                                  np.asarray(ref.predict(xj).collect()))


def test_fit_spans(fitted):
    *_, port, _, events = fitted
    names = [e["name"] for e in events]
    assert names.count("fit.loop") == 1
    assert names.count("fit.iteration") == port.n_iter_


def test_params_and_not_fitted():
    km = KMeans(n_clusters=3)
    assert km.get_params() == {"n_clusters": 3, "max_iter": 20, "tol": 1e-4,
                               "seed": 0}
    km.set_params(max_iter=5)
    assert km.max_iter == 5
    with pytest.raises(ValueError, match="unknown parameter"):
        km.set_params(n_cluster=2)
    x = pt.from_array(np.zeros((4, 2), np.float32), (2, 2), device="cpu")
    with pytest.raises(NotFittedError):
        km.predict(x)
