"""The port's algorithms (K-means, ALS, PCA, TSQR) and its copy of the
Dataset baseline, against the JAX package's.

Counterparts of ``tests/test_algorithms.py`` (convergence, parity with the
Dataset baseline, the transpose task law) and of
``tests/test_dataset_baseline.py`` (run against ``repro_torch``'s copy of
``core/dataset_baseline.py``), then ``kmeans_dataset``/``als_dataset`` held
equal to the reference's on one input, ``tsqr`` against the reference's,
and the sparse PCA/Gram/ALS case of ``tests/test_sparse.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jx  # noqa: E402
from repro.algorithms import als_dataset as j_als_dataset  # noqa: E402
from repro.algorithms import kmeans_dataset as j_kmeans_dataset  # noqa: E402
from repro.algorithms.linalg import tsqr as j_tsqr  # noqa: E402
import repro_torch as pt  # noqa: E402
from repro_torch.algorithms import (ALS, KMeans, als_dataset,  # noqa: E402
                                    frobenius, kmeans_dataset, pca, tsqr)
from repro_torch.core import Dataset, TaskCounter, costmodel, gram  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


def ds(x, block):
    return pt.from_array(x, block, device="cpu")


def host(a) -> np.ndarray:
    if isinstance(a, pt.DsArray):
        a = a.collect()
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def blobs(seed=0, k=3, n_per=80, d=4, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * spread
    pts = np.concatenate([
        rng.normal(c, 0.4, size=(n_per, d)).astype(np.float32)
        for c in centers])
    rng.shuffle(pts)
    return pts, centers


def match_error(found, true):
    d = np.linalg.norm(true[:, None, :] - found[None], axis=-1)
    return d.min(axis=1).max()


# ---------------------------------------------------------------------------
# tests/test_algorithms.py
# ---------------------------------------------------------------------------


def test_kmeans_recovers_blobs():
    pts, true = blobs()
    x = ds(pts, (32, 4))
    km = KMeans(n_clusters=3, max_iter=50, seed=0).fit(x)
    assert match_error(host(km.centers_), true) < 0.5
    labels = km.predict(x)
    assert labels.shape == (pts.shape[0], 1)
    assert set(np.unique(host(labels))) <= {0, 1, 2}
    assert -km.score(x) < pts.shape[0] * 4 * 0.4 ** 2 * 3


def test_kmeans_parity_with_dataset_baseline():
    """Paper Fig. 9: same algorithm, same result, either data structure."""
    pts, true = blobs(seed=1)
    km = KMeans(n_clusters=3, max_iter=50, seed=0).fit(ds(pts, (40, 4)))
    cb = kmeans_dataset(Dataset.from_array(pts, 6), 3, max_iter=50, seed=0)
    assert match_error(host(km.centers_), true) < 0.5
    assert match_error(cb, true) < 0.5


def test_kmeans_blocking_invariance():
    pts, _ = blobs(seed=2)
    a = KMeans(n_clusters=3, max_iter=30, seed=0).fit(ds(pts, (16, 4)))
    b = KMeans(n_clusters=3, max_iter=30, seed=0).fit(ds(pts, (100, 2)))
    np.testing.assert_allclose(host(a.centers_), host(b.centers_), atol=1e-3)


def test_als_low_rank_recovery():
    rng = np.random.default_rng(0)
    f = 4
    u0 = rng.normal(size=(50, f)).astype(np.float32)
    v0 = rng.normal(size=(40, f)).astype(np.float32)
    r = u0 @ v0.T
    als = ALS(n_factors=f, reg=1e-3, max_iter=25, tol=1e-7).fit(ds(r, (16, 16)))
    rec = host(als.u_ @ als.v_.transpose())
    assert np.sqrt(((rec - r) ** 2).mean()) < 0.05
    assert abs(als.predict(3, 5) - r[3, 5]) < 0.3


def test_als_parity_with_dataset_baseline():
    rng = np.random.default_rng(1)
    f = 3
    r = (rng.normal(size=(30, f)) @ rng.normal(size=(f, 24))).astype(np.float32)
    als = ALS(n_factors=f, reg=1e-3, max_iter=25, tol=1e-7).fit(ds(r, (8, 8)))
    u, v = als_dataset(Dataset.from_array(r, 5), n_factors=f, reg=1e-3,
                       max_iter=25)
    e1 = np.sqrt(((host(als.u_ @ als.v_.T) - r) ** 2).mean())
    e2 = np.sqrt((((u @ v.T) - r) ** 2).mean())
    assert e1 < 0.05 and e2 < 0.05


def test_als_no_transpose_copy_needed():
    """Dataset ALS pays the N^2+N transpose tasks (its own task counter)."""
    r = np.random.default_rng(0).normal(size=(20, 20)).astype(np.float32)
    dset = Dataset.from_array(r, 4)
    before = dset.counter.tasks
    als_dataset(dset, n_factors=2, max_iter=2)
    assert dset.counter.tasks - before >= costmodel.dataset_transpose_tasks(4)


def test_pca_matches_svd():
    rng = np.random.default_rng(0)
    basis = np.linalg.qr(rng.normal(size=(6, 6)))[0]
    data = ((rng.normal(size=(400, 6)) * [10, 5, 2, .1, .1, .1]) @ basis.T
            ).astype(np.float32)
    x = ds(data, (100, 3))
    comps, var = pca(x, 2, n_iter=50)
    _, s, vt = np.linalg.svd(data - data.mean(0), full_matrices=False)
    overlap = np.abs(host(comps) @ vt[:2].T)
    assert np.allclose(np.sort(np.diag(overlap)), [1, 1], atol=0.02)
    assert np.allclose(host(var), s[:2] ** 2 / 399, rtol=0.05)
    assert abs(frobenius(x) - np.linalg.norm(data)) < 1e-2


@pytest.mark.parametrize("n,bs", [(240, 48), (200, 33)])
def test_tsqr(n, bs):
    a = np.random.default_rng(n).normal(size=(n, 8)).astype(np.float32)
    q, r = tsqr(ds(a, (bs, 8)))
    assert q.shape == (n, 8) and r.shape == (8, 8)
    assert np.allclose(host(q) @ host(r), a, atol=1e-4)
    assert np.allclose(host(q).T @ host(q), np.eye(8), atol=1e-4)
    # the reference's factors, up to the sign of each column of Q / row of R
    jq, jr = j_tsqr(jx.from_array(jnp.asarray(a), (bs, 8)))
    signs = np.sign(np.diag(host(r)) * np.diag(np.asarray(jr)))
    np.testing.assert_allclose(host(q) * signs, np.asarray(jq), atol=1e-4)
    np.testing.assert_allclose(host(r) * signs[:, None], np.asarray(jr),
                               rtol=1e-4, atol=1e-4)


def test_tsqr_of_a_sparse_input_and_wide_blocks():
    """A sparse input densifies (QR factors are dense); a block narrower
    than the array re-blocks to full rows."""
    rng = np.random.default_rng(4)
    a = (rng.normal(size=(90, 6)) * (rng.random((90, 6)) < 0.5)).astype(np.float32)
    for x in (ds(a, (30, 6)).tosparse(), ds(a, (30, 4))):
        q, r = tsqr(x)
        np.testing.assert_allclose(host(q) @ host(r), a, atol=1e-4)


# ---------------------------------------------------------------------------
# The baselines equal the reference's on one input
# ---------------------------------------------------------------------------


def test_kmeans_dataset_equals_reference():
    pts, _ = blobs(seed=3, k=4, n_per=40)
    got = kmeans_dataset(Dataset.from_array(pts, 5), 4, max_iter=30, seed=2)
    want = j_kmeans_dataset(jx.Dataset.from_array(pts, 5), 4, max_iter=30, seed=2)
    np.testing.assert_array_equal(got, want)


def test_als_dataset_equals_reference():
    r = np.random.default_rng(6).normal(size=(26, 18)).astype(np.float32)
    got = als_dataset(Dataset.from_array(r, 4), n_factors=3, max_iter=4, seed=1)
    want = j_als_dataset(jx.Dataset.from_array(r, 4), n_factors=3, max_iter=4,
                         seed=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# tests/test_sparse.py: PCA, Gram and ALS on a sparse input
# ---------------------------------------------------------------------------


def test_pca_gram_als_sparse():
    rng = np.random.default_rng(9)
    x = (rng.random((30, 10)) * (rng.random((30, 10)) < 0.25)).astype(np.float32)
    a = ds(x, (8, 4))
    s = a.tosparse()
    cd, vd = pca(a, 2, n_iter=20, center=False)
    cs, vs = pca(s, 2, n_iter=20, center=False)
    np.testing.assert_allclose(np.abs(host(cd)), np.abs(host(cs)), atol=1e-3)
    np.testing.assert_allclose(host(vd), host(vs), rtol=1e-3)
    assert frobenius(s) == pytest.approx(float(np.linalg.norm(x)), rel=1e-5)
    np.testing.assert_allclose(host(gram(s)), x.T @ x, atol=1e-3)
    rt = ((rng.random((24, 18)) < 0.3)
          * (rng.random((24, 18)) * 4 + 1)).astype(np.float32)
    rd = ds(rt, (6, 6))
    m_d = ALS(n_factors=4, max_iter=3, seed=0).fit(rd)
    m_s = ALS(n_factors=4, max_iter=3, seed=0).fit(rd.tosparse())
    assert m_s.u_.block_format == "dense"
    np.testing.assert_allclose(host(m_d.u_ @ m_d.v_.T),
                               host(m_s.u_ @ m_s.v_.T), atol=1e-2)


# ---------------------------------------------------------------------------
# tests/test_dataset_baseline.py, on the port's copy
# ---------------------------------------------------------------------------


def test_transpose_semantics_and_task_law():
    x = np.random.default_rng(0).normal(size=(30, 30)).astype(np.float32)
    for n in [2, 3, 5, 6]:
        dset = Dataset.from_array(x, n)
        before = dset.counter.tasks
        t = dset.transpose()
        assert np.allclose(t.collect(), x.T)
        assert dset.counter.tasks - before == costmodel.dataset_transpose_tasks(n)


def test_shuffle_semantics_and_task_law():
    x = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    for n in [2, 4, 5]:
        dset = Dataset.from_array(x, n)
        before = dset.counter.tasks
        s = dset.shuffle(np.random.default_rng(1))
        assert np.allclose(np.sort(s.collect(), 0), np.sort(x, 0))
        used = dset.counter.tasks - before
        size = x.shape[0] // n
        assert used <= costmodel.dataset_shuffle_tasks(n, size + 1)
        assert used >= n + n
        ref = jx.Dataset.from_array(x, n).shuffle(np.random.default_rng(1))
        np.testing.assert_array_equal(s.collect(), ref.collect())


def test_rowsum_reduction_tree():
    x = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    dset = Dataset.from_array(x, 4)
    before = dset.counter.tasks
    s = dset.sum_rows()
    assert np.allclose(s, x.sum(0, keepdims=True), atol=1e-4)
    assert dset.counter.tasks - before == costmodel.dataset_rowsum_tasks(4)


def test_task_law_separation():
    for n in [16, 64, 256, 1536]:
        assert costmodel.dsarray_transpose_tasks(n, 1) == n
        assert costmodel.dataset_transpose_tasks(n) == n * n + n
        assert costmodel.dsarray_shuffle_tasks(n) == 2 * n
    t_ds = costmodel.pycompss_time(costmodel.dataset_transpose_tasks(1536),
                                   0.05, 768)
    t_da = costmodel.pycompss_time(costmodel.dsarray_transpose_tasks(1536, 1),
                                   0.05, 768)
    assert t_ds / t_da > 100


def test_counter_bytes():
    c = TaskCounter()
    c.task(np.zeros((4, 4), np.float32))
    assert c.tasks == 1 and c.bytes_moved == 64
