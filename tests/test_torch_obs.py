"""The port's telemetry (``repro_torch.obs``: metrics, tracing, the
profiler) and ``repro_torch.analysis.liveness`` against the JAX package's.

One counterpart of each case of ``tests/test_obs.py`` (the typed registry,
snapshot/reset, the nearest-rank histogram, the plain-int stats views, the
allocation-free disabled path, Chrome trace JSON, ``@traced``, the summary
tree, span coverage of a warmed serve stream / a CascadeSVM fit / the
resilience rungs / ingest chunks, stats unchanged by tracing, the threaded
hammer, the profiler's bytes against the cost model), on ``device="cpu"``.
The two ``costmodel-drift`` rule cases have their counterparts in
``tests/test_torch_analysis.py``, beside the other rules'.

Then the cross-package cases, every input built from one NumPy array: per
node of the optimized six-op chain, of the Ridge predict plan (dense and
stacked COO) and of a stacked-COO elementwise chain (whose nodes output
stacked COO), ``node_output_bytes``, the profiler's measured bytes, and
``liveness.analyze``'s two peaks equal the reference's; a warmed serve
stream leaves the same span names in both packages' traces.

``tests/conftest.py`` resets only the reference's telemetry, so this file
resets the port's registry itself (``repro_torch.obs.reset_all()``).
"""

import importlib
import json
import os
import sys
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import repro.core as jx  # noqa: E402
import repro.core.plan as jplan  # noqa: E402
import repro.estimators as jest  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.serve as jserve  # noqa: E402
from repro.analysis import liveness as jlive  # noqa: E402
import repro_torch.resilience as R  # noqa: E402
import repro_torch.serve as serve  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.analysis import liveness  # noqa: E402
from repro_torch.core import expr as expr_mod  # noqa: E402
from repro_torch.core import plan as plan_mod  # noqa: E402
from repro_torch.core import sparse as sparse_mod  # noqa: E402
from repro_torch.core.dsarray import from_array  # noqa: E402
from repro_torch.estimators import CascadeSVM, Ridge  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

SEED = 20260808
CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_port_telemetry():
    obs.reset_all()
    yield
    obs.reset_all()
    obs.disable()


# ---------------------------------------------------------------------------
# workload helpers (the reference's, on device="cpu")
# ---------------------------------------------------------------------------


def _chain_input(seed=0, shape=(64, 48)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _six_op_chain(seed=0, shape=(64, 48), bs=(8, 8)):
    a = from_array(_chain_input(seed, shape), bs, device=CPU).lazy()
    return (((a + a) * 2.0 - a).abs() * 0.5 + 0.25)


def _ridge_xy(n=64, m=8):
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(n, m)).astype(np.float32)
    y = (x @ rng.normal(size=(m, 1))).astype(np.float32)
    return x, y


def _fit_ridge(n=64, m=8):
    x, y = _ridge_xy(n, m)
    return Ridge(alpha=0.1).fit(from_array(x, (16, m), device=CPU),
                                from_array(y, (16, 1), device=CPU))


def _serve_stream(est, n_requests=6, m=8, pkg=serve, reg_kw=None):
    reg = pkg.ModelRegistry(**({"device": CPU} if reg_kw is None else reg_kw))
    reg.register("m", est, batch_sizes=(4, 16), block_rows=4)
    srv = pkg.PredictServer(reg)
    rng = np.random.default_rng(1)
    futs = [srv.submit("m", rng.normal(size=(2, m)).astype(np.float32))
            for _ in range(n_requests)]
    srv.pump()
    return [f.result() for f in futs]


def _names(events):
    return {e["name"] for e in events}


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_counter_gauge_histogram_basics():
    c = obs.registry.counter("t.c")
    c.inc()
    c.inc(4)
    assert c.value == 5
    assert obs.registry.counter("t.c") is c
    g = obs.registry.gauge("t.g")
    g.set(3)
    g.set_max(7)
    g.set_max(2)
    assert g.value == 7
    h = obs.registry.histogram("t.h")
    for v in (1.0, 2.0, 3.0, 4.0):
        h.observe(v)
    s = h.summary()
    assert s["count"] == 4 and s["max"] == 4.0 and s["mean"] == 2.5
    with pytest.raises(TypeError):
        obs.registry.gauge("t.c")


def test_snapshot_prefix_and_reset_all():
    obs.registry.counter("sn.a").inc(2)
    obs.registry.counter("sn.b").inc(3)
    obs.registry.counter("other.c").inc(1)
    assert obs.snapshot("sn") == {"sn.a": 2, "sn.b": 3}
    assert obs.snapshot()["other.c"] == 1
    obs.reset_all()
    assert obs.snapshot("sn") == {"sn.a": 0, "sn.b": 0}


def test_histogram_percentile_is_nearest_rank():
    h = obs.registry.histogram("t.lat")
    vals = [float(v) for v in range(1, 11)]
    for v in vals:
        h.observe(v)
    s = h.summary()
    srt = sorted(vals)
    for q, key in ((0.50, "p50"), (0.99, "p99")):
        i = min(len(srt) - 1, int(round(q * (len(srt) - 1))))
        assert s[key] == srt[i]
    jh = jobs.registry.histogram("t.lat")            # the reference's law
    for v in vals:
        jh.observe(v)
    assert jh.summary() == s and jh.summary(1e3) == h.summary(1e3)


def test_stats_views_are_plain_int_dicts():
    chain = _six_op_chain()
    plan_mod.clear_cache()
    chain.compute()
    cs = plan_mod.cache_stats()
    assert list(cs) == ["hits", "misses", "launches", "opt_runs",
                        "opt_skips", "eager_launches", "aot_compiles"]
    assert list(cs) == list(jplan.cache_stats())
    assert all(type(v) is int for v in cs.values())
    assert cs["misses"] == 1 and cs["launches"] == 1
    rs = R.stats()
    assert list(rs) == ["executions", "retries", "degradations",
                        "recoveries", "guard_failures"]
    assert all(type(v) is int for v in rs.values())


# ---------------------------------------------------------------------------
# tracing: the zero-overhead-disabled contract
# ---------------------------------------------------------------------------


def test_disabled_tracing_allocates_no_spans():
    chain = _six_op_chain()
    plan_mod.clear_cache()
    chain.compute()
    assert not obs.enabled()
    base = obs.span_allocations()
    for _ in range(100):
        chain.compute()
    assert obs.span_allocations() == base == 0
    assert obs.events() == []
    assert obs.span("x") is obs.span("y", a=1)


def test_span_records_chrome_event_and_error_attr():
    obs.enable()
    with obs.span("unit.ok", k=1) as sp_:
        sp_.set(extra="v")
    with pytest.raises(RuntimeError):
        with obs.span("unit.bad"):
            raise RuntimeError("boom")
    obs.disable()
    evts = obs.events()
    assert [e["name"] for e in evts] == ["unit.ok", "unit.bad"]
    ok, bad = evts
    assert ok["ph"] == "X" and ok["dur"] >= 0 and ok["args"]["extra"] == "v"
    assert bad["args"]["error"] == "RuntimeError"


def test_traced_decorator():
    @obs.traced
    def plain(x):
        return x + 1

    @obs.traced(name="custom.label", tag="t")
    def named(x):
        return x * 2

    assert plain(1) == 2 and named(2) == 4
    assert obs.events() == []
    obs.enable()
    plain(1)
    named(2)
    obs.disable()
    names = [e["name"] for e in obs.events()]
    assert "custom.label" in names
    assert any(n.endswith("plain") for n in names)


def test_trace_to_writes_valid_json_and_restores_state():
    assert not obs.enabled()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.json")
        with obs.trace_to(path):
            assert obs.enabled()
            with obs.span("a.b"):
                pass
        assert not obs.enabled()
        with open(path) as f:
            trace = json.load(f)
    assert trace["displayTimeUnit"] == "ms"
    assert [e["name"] for e in trace["traceEvents"]] == ["a.b"]


def test_summary_tree_aggregates_by_name():
    obs.enable()
    for _ in range(3):
        with obs.span("plan.launch"):
            pass
    with obs.span("plan.optimize"):
        pass
    obs.disable()
    text = obs.summary()
    assert "plan" in text and "launch" in text and "optimize" in text
    assert "3" in text


# ---------------------------------------------------------------------------
# span coverage: plan / fit / resilience / serve / ingest
# ---------------------------------------------------------------------------


def test_trace_covers_warmed_serve_stream():
    est = _fit_ridge()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "serve.json")
        with obs.trace_to(path):
            _serve_stream(est)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"]
    names = _names(events)
    assert {"serve.submit", "serve.batch", "serve.dispatch",
            "serve.slice", "plan.launch", "plan.aot_compile"} <= names
    assert all(e["ph"] == "X" and "ts" in e and "dur" in e for e in events)
    dispatches = [e for e in events if e["name"] == "serve.dispatch"]
    assert dispatches and all(e["args"]["attempt"] == 0 for e in dispatches)


def test_trace_covers_csvm_fit_iterations():
    rng = np.random.default_rng(3)
    xa = rng.normal(size=(64, 8)).astype(np.float32)
    y = (xa[:, 0] > 0).astype(np.float32)
    x = from_array(xa, (16, 8), device=CPU)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "fit.json")
        with obs.trace_to(path):
            CascadeSVM(max_iter=2, solver_iters=10, sv_cap=16).fit(x, y)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"]
    iters = [e for e in events if e["name"] == "fit.iteration"]
    assert [e["args"]["iteration"] for e in iters] == [1, 2]
    assert all(e["args"]["estimator"] == "CascadeSVM" for e in iters)
    assert "plan.launch" in _names(events)
    launches = [e for e in events if e["name"] == "plan.launch"]
    i0 = iters[0]
    assert any(i0["ts"] <= e["ts"] and
               e["ts"] + e["dur"] <= i0["ts"] + i0["dur"] + 1
               for e in launches)


def test_trace_covers_resilience_retry_rungs():
    rng = np.random.default_rng(4)
    a = from_array(rng.normal(size=(8, 12)).astype(np.float32), (4, 4),
                   device=CPU)
    b = from_array(rng.normal(size=(12, 6)).astype(np.float32), (4, 3),
                   device=CPU)
    with expr_mod.lazy():
        lz = (a @ b) * 2.0 + 1.0
    obs.enable()
    with R.inject(R.FaultSpec(kind="transient", site="plan_execute", at=1)):
        R.run_resilient(lz)
    obs.disable()
    rungs = [e for e in obs.events() if e["name"] == "resilience.rung"]
    assert len(rungs) == 2
    assert rungs[0]["args"]["attempt"] == 0
    assert rungs[0]["args"]["error"] == "TransientError"
    assert rungs[1]["args"]["attempt"] == 1
    assert "error" not in rungs[1]["args"]
    assert R.stats()["retries"] == 1


def test_trace_covers_ingest_chunks():
    from repro_torch.core.io import load_txt_file
    rng = np.random.default_rng(5)
    ref = rng.normal(size=(32, 6)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.csv")
        np.savetxt(path, ref, delimiter=",", fmt="%.6f")
        obs.enable()
        x = load_txt_file(path, (8, 6), chunk_bytes=256, device=CPU)
        obs.disable()
    assert np.allclose(x.collect().numpy(), ref, atol=1e-5)
    assert {"ingest.load", "ingest.chunk"} <= _names(obs.events())
    chunks = [e for e in obs.events() if e["name"] == "ingest.chunk"]
    assert len(chunks) > 1
    assert all(e["args"]["chunk_bytes"] > 0 for e in chunks)


# ---------------------------------------------------------------------------
# migration contract: identical stats traced vs untraced
# ---------------------------------------------------------------------------


def _stats_workload():
    plan_mod.clear_cache()
    est = _fit_ridge()
    _serve_stream(est)
    rng = np.random.default_rng(6)
    a = from_array(rng.normal(size=(8, 12)).astype(np.float32), (4, 4),
                   device=CPU)
    b = from_array(rng.normal(size=(12, 6)).astype(np.float32), (4, 3),
                   device=CPU)
    with expr_mod.lazy():
        lz = (a @ b) * 2.0 + 1.0
    with R.inject(R.FaultSpec(kind="transient", site="plan_execute", at=1)):
        R.run_resilient(lz)
    return (plan_mod.cache_stats(), R.stats(), serve.stats())


def test_stats_identical_with_and_without_tracing():
    untraced = _stats_workload()
    obs.reset_all()
    obs.enable()
    try:
        traced = _stats_workload()
    finally:
        obs.disable()
    for off, on, which in zip(untraced, traced,
                              ("plan", "resilience", "serve")):
        off = dict(off)
        on = dict(on)
        off.pop("latency", None)
        on.pop("latency", None)
        assert off == on, f"{which} stats changed under tracing"


# ---------------------------------------------------------------------------
# thread safety: the locked increments count exactly
# ---------------------------------------------------------------------------


def test_threaded_hammer_counts_exactly():
    from repro_torch.resilience import execute as rex
    serve_stats = importlib.import_module("repro_torch.serve.stats")
    n_threads, n_incs = 8, 2500
    c = obs.registry.counter("hammer.c")

    def work():
        for _ in range(n_incs):
            c.inc()
            serve_stats.bump("requests")
            rex._STATS.inc("retries")
            plan_mod._STATS.inc("hits")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    want = n_threads * n_incs
    assert c.value == want
    assert serve.stats()["requests"] == want
    assert R.stats()["retries"] == want
    assert plan_mod.cache_stats()["hits"] == want


# ---------------------------------------------------------------------------
# profiler
# ---------------------------------------------------------------------------


def test_profile_six_op_chain_matches_costmodel():
    chain = _six_op_chain()
    plan_mod.clear_cache()
    rep = obs.profile(chain)
    assert rep.nodes
    for rec in rep.nodes:
        assert rec.measured_bytes == rec.predicted_bytes, rec.site
        assert rec.time_s >= 0.0
    assert rep.drifting() == []
    assert rep.fused_time_s is not None and rep.fused_time_s > 0.0
    assert rep.compiled == {}                 # the CPU: no memory report
    text = str(rep)
    assert "within drift tolerance" in text and "fused" in text


def test_profile_accepts_plan_and_skips_fused():
    p = plan_mod.plan_for(_six_op_chain(seed=1))
    rep = obs.profile(p, fused=False, compiled=False)
    assert rep.fused_time_s is None and rep.compiled == {}
    assert rep.eager_total_s == sum(n.time_s for n in rep.nodes)


# ---------------------------------------------------------------------------
# parity with the reference: liveness, the profiler's bytes, span names
# ---------------------------------------------------------------------------


def _plans(case):
    """(port plan, reference plan) of one case, from the same NumPy."""
    if case == "six_op_chain":
        x = _chain_input()
        pa = from_array(x, (8, 8), device=CPU).lazy()
        ja = jx.from_array(jnp.asarray(x), (8, 8)).lazy()
        return tuple(pkg.plan_for(((a + a) * 2.0 - a).abs() * 0.5 + 0.25)
                     for pkg, a in ((plan_mod, pa), (jplan, ja)))
    x, y = _ridge_xy()
    pr = _fit_ridge()
    jr = jest.Ridge(alpha=0.1).fit(jx.from_array(jnp.asarray(x), (16, 8)),
                                   jx.from_array(jnp.asarray(y), (16, 1)))
    rows = np.random.default_rng(2).normal(size=(13, 8)).astype(np.float32)
    if case == "ridge_predict":
        return (pr.predict_plan(from_array(rows, (4, 8), device=CPU)),
                jr.predict_plan(jx.from_array(jnp.asarray(rows), (4, 8))))
    mat = sp.random(13, 8, density=0.3, format="csr", dtype=np.float32,
                    random_state=np.random.default_rng(3))
    ps = sparse_mod.from_scipy(mat, (4, 8), nse=16, device=CPU)
    js = jx.sparse.from_scipy(mat, (4, 8), nse=16)
    if case == "ridge_predict_bcoo":
        return pr.predict_plan(ps), jr.predict_plan(js)
    # stacked COO outputs: data plus int32 (row, col) indices, as the law
    return (plan_mod.plan_for((ps.lazy() * 2.0 + ps) * 0.5),
            jplan.plan_for((js.lazy() * 2.0 + js) * 0.5))


CASES = ["six_op_chain", "ridge_predict", "ridge_predict_bcoo", "bcoo_chain"]


@pytest.mark.parametrize("case", CASES)
def test_node_bytes_and_liveness_peaks_equal_reference(case):
    p, j = _plans(case)
    p_order = plan_mod.emission_order(p.roots)
    j_order = jplan.emission_order(j.roots)
    assert [n.describe() for n in p_order] == [n.describe() for n in j_order]
    assert [liveness.node_output_bytes(n) for n in p_order] \
        == [jlive.node_output_bytes(n) for n in j_order]
    pr, jr = liveness.analyze(p.roots), jlive.analyze(j.roots)
    assert (pr.naive_peak, pr.minimized_peak, pr.input_bytes, pr.n_nodes) \
        == (jr.naive_peak, jr.minimized_peak, jr.input_bytes, jr.n_nodes)
    assert pr.reorder_pays == jr.reorder_pays
    assert [n.describe() for n in liveness.minimized_order(p.roots)] \
        == [n.describe() for n in jlive.minimized_order(j.roots)]
    assert p.raw_roots and len(p.raw_roots) == len(j.raw_roots)


@pytest.mark.parametrize("case", CASES)
def test_profile_bytes_equal_reference(case):
    from repro.obs.profiler import profile as jprofile
    p, j = _plans(case)
    prep = obs.profile(p, fused=False, compiled=False)
    jrep = jprofile(j, fused=False, compiled=False)
    assert [(n.site, n.kind, n.measured_bytes, n.predicted_bytes)
            for n in prep.nodes] \
        == [(n.site, n.kind, n.measured_bytes, n.predicted_bytes)
            for n in jrep.nodes]
    assert prep.drifting() == jrep.drifting() == []


def test_serve_stream_span_names_equal_reference():
    x, y = _ridge_xy()
    jr = jest.Ridge(alpha=0.1).fit(jx.from_array(jnp.asarray(x), (16, 8)),
                                   jx.from_array(jnp.asarray(y), (16, 1)))
    plan_mod.clear_cache()
    jplan.clear_cache()
    with obs.recording() as p_events:
        p_out = _serve_stream(_fit_ridge())
    jobs.enable()
    try:
        j_out = _serve_stream(jr, pkg=jserve, reg_kw={})
    finally:
        jobs.disable()
    j_names = _names(jobs.events())
    assert _names(p_events) >= j_names - {"fit.iteration"}
    assert {"plan.aot_compile", "serve.dispatch"} <= _names(p_events)
    for got, want in zip(p_out, j_out):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
