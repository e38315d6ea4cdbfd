"""The port's predict server (``repro_torch.serve``) against the JAX
package's.

One counterpart of each of the 29 test functions of ``tests/test_serve.py``
(micro-batch exactness at every bucket boundary, dense and stacked COO;
the steady-state cache discipline; the degradation ladder under injected
``serve_dispatch`` faults; the registry; the fallbacks; the threaded
server; ``compile_aot``'s ``donate_argnums``), on a ``ModelRegistry(
device="cpu")``, then the cross-package cases, every input built from one
NumPy array:

* a Ridge fitted by one package, saved with ``save_model`` and loaded by
  the other, served the same stream of dense and sparse payloads by both
  servers: results within the reference's float tolerance (each package
  exact against its own direct predict), and ``serve.stats()`` (latency
  aside) and ``plan.cache_stats()`` equal key for key;
* the same stream under injected faults (a transient, a shed batch, a
  failing single dispatch): the same counters in both packages.

``tests/conftest.py`` resets only the reference's telemetry, so this file
resets the port's registry itself (``repro_torch.obs.reset_all()``).
"""

import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import repro.core as jx  # noqa: E402
import repro.core.plan as jplan  # noqa: E402
import repro.estimators as jest  # noqa: E402
import repro.resilience as jres  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro_torch.serve as serve  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import plan as plan_mod  # noqa: E402
from repro_torch.core import sparse as sparse_mod  # noqa: E402
from repro_torch.core.dsarray import from_array  # noqa: E402
from repro_torch.estimators import (RandomForestClassifier, Ridge,  # noqa: E402
                                    load_model)
from repro_torch.resilience import FaultSpec, RetryPolicy, inject  # noqa: E402
from repro_torch.serve.batching import (BucketSpec, GeometryBucket,  # noqa: E402
                                        assemble, normalize_payload,
                                        split_rows)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

SEED = 20260808
N_FEATURES = 12
CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_port_telemetry():
    obs.reset_all()
    yield
    obs.reset_all()
    obs.disable()


# ---------------------------------------------------------------------------
# fixtures (the reference's, on device="cpu")
# ---------------------------------------------------------------------------


def _ridge_data(seed=SEED, n=256, m=N_FEATURES):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, m)).astype(np.float32)
    w = rng.normal(size=(m,)).astype(np.float32)
    y = (X @ w + 0.25).reshape(-1, 1).astype(np.float32)
    return X, y


def _fit_ridge(seed=SEED, n=256, m=N_FEATURES, alpha=0.1):
    X, y = _ridge_data(seed, n, m)
    return Ridge(alpha=alpha).fit(from_array(X, (64, m), device=CPU),
                                  from_array(y, (64, 1), device=CPU))


@pytest.fixture(scope="module")
def ridge():
    return _fit_ridge()


def _registry(est, **kw):
    kw.setdefault("batch_sizes", (1, 4, 16))
    kw.setdefault("block_rows", 4)
    reg = serve.ModelRegistry(device=CPU)
    reg.register("m", est, **kw)
    return reg


def _rows(n, seed=1, m=N_FEATURES):
    return np.random.default_rng(seed).normal(size=(n, m)).astype(np.float32)


def _sparse_rows(n, seed=1, m=N_FEATURES, density=0.3):
    return sp.random(n, m, density=density, format="csr",
                     random_state=np.random.default_rng(seed),
                     dtype=np.float32)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _direct_dense(est, rows):
    """``est.predict`` on raw rows, blocked as ``_validate_x`` blocks them."""
    x = from_array(rows, (min(128, rows.shape[0]), rows.shape[1]), device=CPU)
    return _host(est.predict(x).collect())


def _direct_sparse(est, mat):
    x = sparse_mod.from_scipy(mat, (mat.shape[0], mat.shape[1]), device=CPU)
    return _host(est.predict(x).collect())


# ---------------------------------------------------------------------------
# micro-batch padding exactness at every bucket boundary
# ---------------------------------------------------------------------------

BOUNDARY_TOTALS = [4, 5, 16, 15, 13, 1]


@pytest.mark.parametrize("total", BOUNDARY_TOTALS)
def test_dense_served_equals_direct(ridge, total):
    reg = _registry(ridge)
    srv = serve.PredictServer(reg)
    rows = _rows(total, seed=total)
    sizes = [1] * total if total <= 2 else [2, total - 3, 1]
    futs, off = [], 0
    for s in sizes:
        futs.append(srv.submit("m", rows[off:off + s]))
        off += s
    assert srv.pump() == len(sizes)
    got = np.concatenate([f.result() for f in futs], axis=0)
    direct = _direct_dense(ridge, rows)
    assert got.shape == (total, 1) and isinstance(got, np.ndarray)
    assert np.array_equal(got, direct)


@pytest.mark.parametrize("total", BOUNDARY_TOTALS)
def test_bcoo_served_equals_direct(ridge, total):
    reg = _registry(ridge, formats=("dense", "bcoo"), nse=4 * N_FEATURES)
    srv = serve.PredictServer(reg)
    mat = _sparse_rows(total, seed=total)
    sizes = [1] * total if total <= 2 else [2, total - 3, 1]
    futs, off = [], 0
    for s in sizes:
        futs.append(srv.submit("m", mat[off:off + s]))
        off += s
    srv.pump()
    got = np.concatenate([f.result() for f in futs], axis=0)
    assert np.array_equal(got, _direct_sparse(ridge, mat))
    assert serve.stats()["eager_requests"] == 0


@pytest.mark.parametrize("sizes", [(2, 3, 1), (8,), (3, 3, 3, 3, 1),
                                   (1, 1, 1)])
def test_served_rows_equal_predict_on_padded_batch(ridge, sizes):
    reg = _registry(ridge)
    srv = serve.PredictServer(reg)
    payloads = [_rows(s, seed=40 + i) for i, s in enumerate(sizes)]
    futs = [srv.submit("m", p) for p in payloads]
    srv.pump()
    model = reg.get("m")
    bucket = model.spec.bucket_for(sum(sizes), "dense")
    batch = assemble(payloads, bucket)
    assert batch.device.type == "cpu"
    direct = _host(ridge.predict(batch).collect())
    off = 0
    for f, s in zip(futs, sizes):
        assert np.array_equal(f.result(), direct[off:off + s])
        off += s


def test_one_row_requests_batch_together(ridge):
    reg = _registry(ridge)
    srv = serve.PredictServer(reg)
    rows = _rows(4, seed=7)
    futs = [srv.submit("m", rows[i]) for i in range(4)]
    srv.pump()
    st = serve.stats()
    assert st["batches"] == 1 and st["batched_requests"] == 4
    got = np.concatenate([f.result() for f in futs], axis=0)
    assert np.array_equal(got, _direct_dense(ridge, rows))


# ---------------------------------------------------------------------------
# steady-state plan-cache discipline
# ---------------------------------------------------------------------------


def test_steady_state_zero_recompiles(ridge):
    plan_mod.clear_cache()
    reg = _registry(ridge, formats=("dense", "bcoo"), nse=4 * N_FEATURES)
    srv = serve.PredictServer(reg)
    warm = plan_mod.cache_stats()
    assert warm["aot_compiles"] == 6

    n_requests = 0
    for i in range(6):
        futs = [srv.submit("m", _rows(1 + (i % 3), seed=i))
                for _ in range(3)]
        futs.append(srv.submit("m", _sparse_rows(2 + (i % 3), seed=i)))
        srv.pump()
        for f in futs:
            f.result()
        n_requests += len(futs)

    after = plan_mod.cache_stats()
    assert after["misses"] == warm["misses"]
    assert after["opt_runs"] == warm["opt_runs"]
    assert after["aot_compiles"] == warm["aot_compiles"]
    st = serve.stats()
    assert st["cache_hits"] == n_requests == st["requests"]
    assert st["cache_misses"] == 0
    assert st["batch_sheds"] == 0 and st["failures"] == 0
    lat = st["latency"]
    assert lat["count"] == n_requests and lat["p99_ms"] >= lat["p50_ms"] > 0


def test_warm_is_idempotent(ridge):
    plan_mod.clear_cache()
    reg = _registry(ridge)
    model = reg.get("m")
    assert model.cache.warm() == 0
    assert reg.warm_all() == 0
    before = plan_mod.cache_stats()["aot_compiles"]
    plan_mod.clear_cache()
    assert reg.warm_all() == 3
    assert plan_mod.cache_stats()["aot_compiles"] == 3
    assert before == 3


def test_clean_run_recovery_counters_zero(ridge):
    reg = _registry(ridge)
    srv = serve.PredictServer(reg)
    f = srv.submit("m", _rows(3))
    srv.pump()
    f.result()
    st = serve.stats()
    for k in ("batch_sheds", "dispatch_retries", "bucket_fallbacks",
              "cache_misses", "failures", "single_dispatches"):
        assert st[k] == 0, k
    assert st["requests"] == st["responses"] == 1
    assert st["queue_depth"] == 0 and st["queue_depth_peak"] == 1


# ---------------------------------------------------------------------------
# fault-injected serving: the degradation ladder
# ---------------------------------------------------------------------------


def test_transient_dispatch_retries_and_recovers(ridge):
    reg = _registry(ridge)
    srv = serve.PredictServer(reg, policy=RetryPolicy(max_retries=2))
    rows = _rows(5, seed=3)
    with inject(FaultSpec(kind="transient", site="serve_dispatch", times=1)):
        f = srv.submit("m", rows)
        srv.pump()
    assert np.array_equal(f.result(), _direct_dense(ridge, rows))
    st = serve.stats()
    assert st["dispatch_retries"] == 1
    assert st["batch_sheds"] == 0
    assert st["batches"] == 1


def test_batched_fault_sheds_to_unbatched(ridge):
    reg = _registry(ridge)
    srv = serve.PredictServer(reg)
    rows = _rows(6, seed=4)
    with inject(FaultSpec(kind="crash", site="serve_dispatch", times=None,
                          where={"mode": "batched"})):
        f1 = srv.submit("m", rows[:4])
        f2 = srv.submit("m", rows[4:])
        srv.pump()
    got = np.concatenate([f1.result(), f2.result()], axis=0)
    assert np.array_equal(got, _direct_dense(ridge, rows))
    st = serve.stats()
    assert st["batch_sheds"] == 1
    assert st["single_dispatches"] == 2
    assert st["failures"] == 0


def test_oom_dispatch_sheds_to_unbatched(ridge):
    reg = _registry(ridge)
    srv = serve.PredictServer(reg)
    rows = _rows(3, seed=5)
    with inject(FaultSpec(kind="oom", site="serve_dispatch", times=1,
                          where={"mode": "batched"})):
        f = srv.submit("m", rows)
        srv.pump()
    assert np.array_equal(f.result(), _direct_dense(ridge, rows))
    st = serve.stats()
    assert st["batch_sheds"] == 1 and st["failures"] == 0


def test_plan_level_oom_absorbed_by_resilience_ladder(ridge):
    reg = _registry(ridge)
    srv = serve.PredictServer(reg)
    rows = _rows(4, seed=6)
    with inject(FaultSpec(kind="oom", site="plan_execute", times=1)):
        f = srv.submit("m", rows)
        srv.pump()
    assert np.array_equal(f.result(), _direct_dense(ridge, rows))
    st = serve.stats()
    assert st["batch_sheds"] == 0 and st["batches"] == 1


def test_retry_exhaustion_then_shed_recovers(ridge):
    reg = _registry(ridge)
    srv = serve.PredictServer(reg, policy=RetryPolicy(max_retries=1))
    rows = _rows(2, seed=8)
    with inject(FaultSpec(kind="transient", site="serve_dispatch", times=3,
                          where={"mode": "batched"})):
        f = srv.submit("m", rows)
        srv.pump()
    assert np.array_equal(f.result(), _direct_dense(ridge, rows))
    st = serve.stats()
    assert st["dispatch_retries"] == 1
    assert st["batch_sheds"] == 1


def test_single_mode_failure_is_isolated(ridge):
    reg = _registry(ridge)
    srv = serve.PredictServer(reg)
    rows = _rows(3, seed=9)
    with inject(FaultSpec(kind="crash", site="serve_dispatch", times=None,
                          where={"mode": "batched"}),
                FaultSpec(kind="crash", site="serve_dispatch", at=2, times=1,
                          where={"mode": "single"})):
        futs = [srv.submit("m", rows[i]) for i in range(3)]
        srv.pump()
    assert np.array_equal(futs[0].result(), _direct_dense(ridge, rows[:1]))
    with pytest.raises(Exception):
        futs[1].result()
    assert np.array_equal(futs[2].result(), _direct_dense(ridge, rows[2:3]))
    st = serve.stats()
    assert st["failures"] == 1 and st["responses"] == 2


def test_no_fallback_propagates_batch_error(ridge):
    reg = _registry(ridge)
    srv = serve.PredictServer(reg, unbatched_fallback=False)
    with inject(FaultSpec(kind="crash", site="serve_dispatch", times=1)):
        f = srv.submit("m", _rows(2))
        srv.pump()
    with pytest.raises(Exception):
        f.result()
    assert serve.stats()["failures"] == 1


# ---------------------------------------------------------------------------
# out-of-bucket fallbacks
# ---------------------------------------------------------------------------


def test_oversized_request_falls_back_unbatched(ridge):
    reg = _registry(ridge)
    srv = serve.PredictServer(reg)
    rows = _rows(33, seed=10)
    f = srv.submit("m", rows)
    srv.pump()
    assert np.array_equal(f.result(), _direct_dense(ridge, rows))
    st = serve.stats()
    assert st["bucket_fallbacks"] == 1
    assert st["single_dispatches"] == 1 and st["batches"] == 0


def test_bcoo_nse_overflow_falls_back_unbatched(ridge):
    reg = _registry(ridge, formats=("dense", "bcoo"), nse=4)
    srv = serve.PredictServer(reg)
    mat = _sparse_rows(4, seed=11, density=0.9)
    assert sparse_mod.max_block_nnz(mat, (4, N_FEATURES)) > 4
    f = srv.submit("m", mat)
    srv.pump()
    assert np.array_equal(f.result(), _direct_sparse(ridge, mat))
    st = serve.stats()
    assert st["bucket_fallbacks"] == 1 and st["failures"] == 0


# ---------------------------------------------------------------------------
# payload validation / batching unit behaviour
# ---------------------------------------------------------------------------


def test_submit_rejects_bad_payloads(ridge):
    srv = serve.PredictServer(_registry(ridge))
    with pytest.raises(ValueError, match="does not match"):
        srv.submit("m", np.zeros((2, N_FEATURES + 1), np.float32))
    with pytest.raises(ValueError, match="empty"):
        srv.submit("m", np.zeros((0, N_FEATURES), np.float32))
    with pytest.raises(KeyError):
        srv.submit("nope", np.zeros((1, N_FEATURES), np.float32))


def test_bucket_spec_selection():
    spec = BucketSpec(8, batch_sizes=(4, 16), block_rows=4)
    assert spec.bucket_for(1, "dense").rows == 4
    assert spec.bucket_for(4, "dense").rows == 4
    assert spec.bucket_for(5, "dense").rows == 16
    assert spec.bucket_for(17, "dense") is None
    assert spec.bucket_for(3, "bcoo") is None
    assert spec.max_rows("dense") == 16
    assert spec.bucket_for(4, "dense").device == "cuda"     # the default
    with pytest.raises(ValueError):
        BucketSpec(8, formats=("bcoo",))
    with pytest.raises(ValueError):
        GeometryBucket(4, 4, 8, "bcoo")


def test_assemble_pads_with_zeros_and_split_inverts():
    bucket = GeometryBucket(rows=8, block_rows=4, n_features=3, fmt="dense",
                            device=CPU)
    a, b = _rows(2, seed=1, m=3), _rows(3, seed=2, m=3)
    x = assemble([a, b], bucket)
    assert x.shape == (8, 3) and x.block_shape == (4, 3)
    dense = _host(x.collect())
    np.testing.assert_array_equal(dense[:2], a)
    np.testing.assert_array_equal(dense[2:5], b)
    np.testing.assert_array_equal(dense[5:], 0.0)
    parts = split_rows(dense, [2, 3])
    np.testing.assert_array_equal(parts[0], a)
    np.testing.assert_array_equal(parts[1], b)


def test_normalize_payload_shapes():
    arr, n, fmt = normalize_payload(np.zeros(5, np.float32), 5)
    assert (n, fmt) == (1, "dense") and arr.shape == (1, 5)
    with pytest.raises(ValueError):
        normalize_payload(np.zeros((2, 3, 4), np.float32), 5)


# ---------------------------------------------------------------------------
# registry: versions, model files, eager fallback
# ---------------------------------------------------------------------------


def test_registry_versioned_load_roundtrip():
    est1 = _fit_ridge(seed=1)
    est2 = _fit_ridge(seed=2)
    rows = _rows(3, seed=12)
    with tempfile.TemporaryDirectory() as d:
        mdir = os.path.join(d, "ridge")
        est1.save_model(mdir, version=1)
        est2.save_model(mdir, version=2)
        reg = serve.ModelRegistry(device=CPU)
        reg.load("ridge", mdir, version=1, batch_sizes=(4,), block_rows=4)
        reg.load("ridge", mdir, batch_sizes=(4,), block_rows=4)
        assert reg.versions("ridge") == [1, 2]
        assert reg.get("ridge").version == 2
        srv = serve.PredictServer(reg)
        f1 = srv.submit("ridge", rows, version=1)
        f2 = srv.submit("ridge", rows)
        srv.pump()
        assert np.array_equal(f1.result(), _direct_dense(est1, rows))
        assert np.array_equal(f2.result(), _direct_dense(est2, rows))
        assert not np.array_equal(f1.result(), f2.result())


def test_registry_lists_models(ridge):
    reg = serve.ModelRegistry(device=CPU)
    reg.register("a", ridge, batch_sizes=(4,), warm=False)
    reg.register("a", ridge, version=3, batch_sizes=(4,), warm=False)
    reg.register("b", ridge, batch_sizes=(4,), warm=False)
    assert reg.models() == [("a", 0), ("a", 3), ("b", 0)]
    with pytest.raises(KeyError, match="versions"):
        reg.get("a", version=7)
    if not torch.cuda.is_available():    # no device named, no card: raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.ModelRegistry()


def test_eager_fallback_estimator_serves_exactly():
    rng = np.random.default_rng(SEED)
    X = rng.normal(size=(96, 6)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int32).reshape(-1, 1)
    est = RandomForestClassifier(n_estimators=4, max_depth=3, seed=0)
    est.fit(from_array(X, (32, 6), device=CPU),
            from_array(y, (32, 1), device=CPU))
    assert not est.has_predict_plan()
    reg = serve.ModelRegistry(device=CPU)
    reg.register("forest", est, batch_sizes=(4, 8), block_rows=4)
    srv = serve.PredictServer(reg)
    rows = X[:5]
    f = srv.submit("forest", rows)
    srv.pump()
    assert np.array_equal(f.result(), _direct_dense(est, rows))
    st = serve.stats()
    assert st["eager_requests"] == 1 and st["cache_hits"] == 0


def test_predict_plan_unsupported_raises():
    est = RandomForestClassifier(n_estimators=2, max_depth=2)
    with pytest.raises(NotImplementedError):
        est._predict_expr(None)


# ---------------------------------------------------------------------------
# threaded server
# ---------------------------------------------------------------------------


def test_threaded_serve_forever_smoke(ridge):
    reg = _registry(ridge)
    rows = _rows(6, seed=13)
    direct = _direct_dense(ridge, rows)
    with serve.PredictServer(reg) as srv:
        futs = [srv.submit("m", rows[i * 2:(i + 1) * 2]) for i in range(3)]
        got = np.concatenate([f.result(timeout=30) for f in futs], axis=0)
    assert np.array_equal(got, direct)
    assert serve.stats()["responses"] == 3


def test_future_timeout():
    f = serve.PredictFuture()
    with pytest.raises(TimeoutError):
        f.result(timeout=0.01)
    assert not f.done()


# ---------------------------------------------------------------------------
# compile_aot's donate_argnums: checked and kept, nothing aliased
# ---------------------------------------------------------------------------


def test_compile_aot_accepts_donate_argnums(ridge):
    plan_mod.clear_cache()
    x = from_array(_rows(4), (4, N_FEATURES), device=CPU)
    p = ridge.predict_plan(x)
    donate = tuple(i for i, leaf in enumerate(p.leaves)
                   if getattr(leaf, "value", None) is x)
    assert donate, "the batch leaf must appear in the plan's leaves"
    with pytest.raises(ValueError, match="out of range"):
        p.compile_aot(donate_argnums=(len(p.leaves),))
    assert p.compile_aot(donate_argnums=donate) is True
    assert p.donate_argnums == donate
    assert p.compile_aot(donate_argnums=donate) is False
    st = plan_mod.cache_stats()
    assert (st["aot_compiles"], st["hits"], st["misses"], st["launches"]) \
        == (1, 0, 0, 0)
    np.testing.assert_array_equal(_host(x.collect()), _rows(4))   # readable


def test_donated_warm_serving_output_unchanged(ridge):
    from repro_torch.serve.compilecache import representative_input

    plan_mod.clear_cache()
    reg = _registry(ridge)
    model = reg.get("m")
    assert model.cache.donate_inputs
    for bucket in model.cache.spec.buckets():
        x = representative_input(bucket)
        p = ridge.predict_plan(x)
        assert model.cache._donate_argnums(p, x) != ()
        for i in model.cache._donate_argnums(p, x):
            assert p.leaves[i].value is x

    srv = serve.PredictServer(reg)
    warm = plan_mod.cache_stats()
    batches, served = [], []
    for i in range(5):
        rows = _rows(1 + (i % 3), seed=40 + i)
        f = srv.submit("m", rows)
        srv.pump()
        batches.append(rows)
        served.append(f.result())
    after = plan_mod.cache_stats()
    assert after["misses"] == warm["misses"]
    assert after["opt_runs"] == warm["opt_runs"]
    assert after["aot_compiles"] == warm["aot_compiles"]
    for rows, got in zip(batches, served):
        assert np.array_equal(got, _direct_dense(ridge, rows))


def test_donation_opt_out_warms_without_aliasing(ridge):
    from repro_torch.serve.compilecache import (PredictCompileCache,
                                                representative_input)

    plan_mod.clear_cache()
    spec = BucketSpec(N_FEATURES, batch_sizes=(4,), block_rows=4, device=CPU)
    cache = PredictCompileCache(ridge, spec, donate_inputs=False)
    bucket = spec.buckets()[0]
    x = representative_input(bucket)
    p = ridge.predict_plan(x)
    assert cache._donate_argnums(p, x) == ()
    assert cache.warm() == 1
    assert cache.warm() == 0


# ---------------------------------------------------------------------------
# parity with the reference: one fitted state, one stream, both servers
# ---------------------------------------------------------------------------


def _jfit_ridge(seed=SEED, alpha=0.1):
    X, y = _ridge_data(seed)
    return jest.Ridge(alpha=alpha).fit(
        jx.from_array(jnp.asarray(X), (64, N_FEATURES)),
        jx.from_array(jnp.asarray(y), (64, 1)))


STREAM = [  # (rounds of) payload specs: ("dense", rows) or ("bcoo", rows)
    [("dense", 1), ("dense", 3), ("bcoo", 2)],
    [("dense", 2), ("dense", 2), ("dense", 5), ("bcoo", 4)],
    [("dense", 16)],
    [("dense", 33), ("bcoo", 1)],                 # an oversized request
    [("dense", 1)],
]


def _payload(kind, n, seed):
    return _rows(n, seed=seed) if kind == "dense" \
        else _sparse_rows(n, seed=seed)


def _run_stream(pkg, est, reg_kw, faults=None):
    """Serve STREAM through one package; -> (results, serve stats without
    latency, plan cache stats)."""
    serve_mod, plan_m, res = pkg
    plan_m.clear_cache()
    reg = serve_mod.ModelRegistry(**reg_kw)
    reg.register("m", est, batch_sizes=(1, 4, 16), block_rows=4,
                 formats=("dense", "bcoo"), nse=4 * N_FEATURES)
    srv = serve_mod.PredictServer(reg, policy=res.RetryPolicy(max_retries=1))
    out = []
    ctx = res.inject(*[res.FaultSpec(**f) for f in faults]) if faults \
        else None
    if ctx is not None:
        ctx.__enter__()
    try:
        for r, round_ in enumerate(STREAM):
            futs = [srv.submit("m", _payload(k, n, seed=100 * r + i))
                    for i, (k, n) in enumerate(round_)]
            srv.pump()
            for f in futs:
                try:
                    out.append(np.asarray(f.result()))
                except Exception as exc:                 # noqa: BLE001
                    out.append(type(exc).__name__)
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    st = dict(serve_mod.stats())
    st.pop("latency")
    return out, st, plan_m.cache_stats()


JAX_PKG = (jserve, jplan, jres)


def _port_pkg():
    import repro_torch.resilience as pres
    return (serve, plan_mod, pres)


@pytest.mark.parametrize("saved_by", ["repro", "repro_torch"])
def test_served_and_stats_equal_reference_across_model_files(saved_by):
    """A Ridge saved by one package and loaded by the other: the same
    stream served by both gives equal results (each exact against its own
    direct predict) and equal counters."""
    with tempfile.TemporaryDirectory() as d:
        if saved_by == "repro":
            jr = _jfit_ridge()
            jr.save_model(d, version=1)
            pr = load_model(d, device=CPU)
        else:
            pr = _fit_ridge()
            pr.save_model(d, version=1)
            jr = jest.load_model(d)
    np.testing.assert_array_equal(np.asarray(pr.coef_, np.float32),
                                  np.asarray(jr.coef_, np.float32))
    assert float(pr.intercept_) == float(jr.intercept_)

    jres.reset_stats()
    jserve.reset_stats()
    j_out, j_st, j_cs = _run_stream(JAX_PKG, jr, {})
    p_out, p_st, p_cs = _run_stream(_port_pkg(), pr, {"device": CPU})
    assert p_st == j_st
    assert p_cs == j_cs
    assert p_st["cache_hits"] == p_st["batched_requests"] \
        and p_st["bucket_fallbacks"] == 1
    assert len(p_out) == len(j_out)
    for got, want in zip(p_out, j_out):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("faults", [
    [{"kind": "transient", "site": "serve_dispatch", "times": 1}],
    [{"kind": "crash", "site": "serve_dispatch", "times": None,
      "where": {"mode": "batched"}},
     {"kind": "crash", "site": "serve_dispatch", "at": 2, "times": 1,
      "where": {"mode": "single"}}],
    [{"kind": "transient", "site": "serve_dispatch", "times": 3,
      "where": {"mode": "batched"}},
     {"kind": "oom", "site": "plan_execute", "times": 1}],
], ids=["transient", "shed_and_fail", "exhaust_and_plan_oom"])
def test_fault_ladder_counters_equal_reference(faults):
    jr = _jfit_ridge()
    with tempfile.TemporaryDirectory() as d:
        jr.save_model(d)
        pr = load_model(d, device=CPU)
    jres.reset_stats()
    jserve.reset_stats()
    j_out, j_st, j_cs = _run_stream(JAX_PKG, jr, {}, faults)
    p_out, p_st, p_cs = _run_stream(_port_pkg(), pr, {"device": CPU}, faults)
    assert p_st == j_st
    assert p_cs == j_cs
    import repro_torch.resilience as pres
    assert pres.stats() == jres.stats()
    assert [type(v).__name__ if isinstance(v, str) else "ok" for v in p_out] \
        == [type(v).__name__ if isinstance(v, str) else "ok" for v in j_out]
    assert [v for v in p_out if isinstance(v, str)] \
        == [v for v in j_out if isinstance(v, str)]
