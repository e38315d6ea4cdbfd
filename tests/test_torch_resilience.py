"""The port's resilience layer (``repro_torch.resilience``) against the JAX
package's: one counterpart of each injector, ``classify_error``, ladder,
guard and ``io_load`` case of ``tests/test_resilience.py``, on
``device="cpu"`` inputs, plus

* ``classify_error`` on a constructed ``torch.cuda.OutOfMemoryError``, on
  sticky CUDA error texts and on a failed kernel build or launch;
* the einsum rung's low-memory switch, a context variable that only that
  rung sets (no environment variable);
* ``finite_report`` coordinates, counts and first sites equal to
  ``repro``'s on arrays built from one NumPy array.
"""

import math
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jx  # noqa: E402
import repro.resilience as JR  # noqa: E402
import repro_torch as pt  # noqa: E402
import repro_torch.resilience as R  # noqa: E402
from repro_torch.core import expr as expr_mod  # noqa: E402
from repro_torch.core import plan as plan_mod  # noqa: E402
from repro_torch.core.dsarray import PAD_DIRTY, DsArray  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.matmul import ops as mops  # noqa: E402
from repro_torch.obs import registry  # noqa: E402
from repro_torch.resilience.inject import _Armed  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

SEED = 20260808
CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_counters():
    R.reset_stats()
    plan_mod.clear_cache()
    yield


def ds(x, block):
    return pt.from_array(x, block, device=CPU)


def _lazy_chain(a, b):
    with expr_mod.lazy():
        return (a @ b) * 2.0 + 1.0


def _mats(rng, n=8, k=12, m=6, bs=((4, 4), (4, 3))):
    x = rng.normal(size=(n, k)).astype(np.float32)
    y = rng.normal(size=(k, m)).astype(np.float32)
    return ds(x, bs[0]), ds(y, bs[1]), (x @ y) * 2.0 + 1.0


def _np(out):
    return out.collect().numpy()


# ---------------------------------------------------------------------------
# Injector determinism (the module is a copy of the reference's)
# ---------------------------------------------------------------------------

def test_injector_counting_determinism():
    spec = R.FaultSpec(kind="transient", site="s", at=3, times=2)
    for _ in range(2):
        with R.inject(spec) as (armed,):
            fired = []
            for _i in range(1, 8):
                try:
                    R.maybe_fire("s")
                    fired.append(False)
                except R.TransientError:
                    fired.append(True)
            assert fired == [False, False, True, True, False, False, False]
            assert armed.hits == 7 and armed.fired == 2


def test_injector_bernoulli_replay():
    spec = R.FaultSpec(kind="oom", site="s", p=0.5, seed=123)

    def draw(fault_spec, mod):
        seq = []
        with mod.inject(fault_spec):
            for _ in range(32):
                try:
                    mod.maybe_fire("s")
                    seq.append(0)
                except mod.OOMError:
                    seq.append(1)
        return seq

    first = draw(spec, R)
    assert first == draw(spec, R)
    assert 0 < sum(first) < 32
    # the reference's schedule for the same spec, draw for draw
    assert first == draw(JR.FaultSpec(kind="oom", site="s", p=0.5, seed=123), JR)
    other = _Armed(R.FaultSpec(kind="oom", site="s", p=0.5, seed=124))
    assert [other.arrive() for _ in range(32)] != [bool(v) for v in first]


def test_injector_site_mode_where_filters():
    with R.inject(
            R.FaultSpec(kind="transient", site="a", modes=("fused",)),
            R.FaultSpec(kind="crash", site="b",
                        where={"estimator": "X", "iteration": 2},
                        times=None)):
        R.maybe_fire("a", mode="eager")
        R.maybe_fire("b", estimator="X", iteration=1)
        R.maybe_fire("b", estimator="Y", iteration=2)
        with pytest.raises(R.TransientError):
            R.maybe_fire("a", mode="fused")
        with pytest.raises(R.CrashError):
            R.maybe_fire("b", estimator="X", iteration=2)
    R.maybe_fire("a", mode="fused")


def test_injector_is_the_ports_own_module():
    """The hooks look the injector up under the port's module name: arming
    the reference's injector fires nothing in the port."""
    rng = np.random.default_rng(SEED)
    a, b, want = _mats(rng)
    with JR.inject(JR.FaultSpec(kind="crash", site="plan_execute",
                                times=None)):
        out = R.run_resilient(_lazy_chain(a, b))
    np.testing.assert_allclose(_np(out), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# classify_error
# ---------------------------------------------------------------------------

def test_classify_error_taxonomy():
    ce = R.classify_error
    assert ce(R.TransientError("x")) == R.TRANSIENT
    assert ce(R.OOMError("x")) == R.OOM
    assert ce(MemoryError()) == R.OOM
    assert ce(R.CrashError("x")) == R.DETERMINISTIC
    assert ce(R.NumericalDivergence("nan")) == R.DETERMINISTIC
    assert ce(ValueError("bad shape")) == R.DETERMINISTIC
    assert ce(RuntimeError("RESOURCE_EXHAUSTED: out of memory")) == R.OOM
    assert ce(RuntimeError("UNAVAILABLE: socket closed")) == R.TRANSIENT
    assert ce(RuntimeError("boom")) == R.DETERMINISTIC
    assert ce(RuntimeError("boom"), default=R.TRANSIENT) == R.TRANSIENT
    # the same verdicts as the reference's on every case above
    for exc in (MemoryError(), ValueError("x"),
                RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
                RuntimeError("UNAVAILABLE: socket closed"), RuntimeError("boom")):
        assert ce(exc) == JR.classify_error(exc)


def test_classify_error_learns_torch_and_cuda():
    ce = R.classify_error
    # torch's OOM by type, whatever its text
    assert ce(torch.cuda.OutOfMemoryError("allocator said no")) == R.OOM
    assert ce(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) == R.OOM
    # sticky CUDA errors: the context is dead, a retry cannot help
    for text in ("CUDA error: an illegal memory access was encountered",
                 "CUDA error: unspecified launch failure",
                 "CUDA error: device-side assert triggered",
                 "CUDA error: misaligned address",
                 "CUDA error: an illegal instruction was encountered"):
        assert ce(RuntimeError(text)) == R.DETERMINISTIC, text
        assert ce(RuntimeError(text), default=R.TRANSIENT) == R.DETERMINISTIC
    # a failed kernel build or launch is deterministic, even when its text
    # names memory: the ladder never catches it
    assert ce(_build.KernelError("nvcc failed on stacked_matmul.cu")) \
        == R.DETERMINISTIC
    assert ce(_build.KernelError(
        "stacked_matmul (simt) launch failed with cudaError 2 "
        "(out of memory)")) == R.DETERMINISTIC
    # the plain CUDA allocator failure text still reads as OOM
    assert ce(RuntimeError("CUDA error: out of memory")) == R.OOM


# ---------------------------------------------------------------------------
# run_resilient: retry + degradation ladder
# ---------------------------------------------------------------------------

def test_clean_path_zero_stats():
    rng = np.random.default_rng(SEED)
    a, b, want = _mats(rng)
    out = R.run_resilient(_lazy_chain(a, b), guard="finite")
    np.testing.assert_allclose(_np(out), want, rtol=1e-5)
    s = R.stats()
    assert s["retries"] == 0 and s["degradations"] == 0
    assert s["recoveries"] == 0 and s["guard_failures"] == 0
    assert s["executions"] == 1
    assert registry.snapshot("resilience") == {
        f"resilience.{k}": v for k, v in s.items()}


def test_clean_path_equals_compute_bits():
    rng = np.random.default_rng(SEED + 20)
    a, b, _ = _mats(rng)
    got = R.run_resilient(_lazy_chain(a, b))
    want = pt.compute(_lazy_chain(a, b))
    assert torch.equal(got.blocks, want.blocks)
    assert got.pad_state == want.pad_state


def test_transient_retry_then_succeed():
    rng = np.random.default_rng(SEED + 1)
    a, b, want = _mats(rng)
    with R.inject(R.FaultSpec(kind="transient", site="plan_execute", at=1)):
        out = R.run_resilient(_lazy_chain(a, b))
    np.testing.assert_allclose(_np(out), want, rtol=1e-5)
    s = R.stats()
    assert s["retries"] == 1 and s["recoveries"] == 1
    assert s["degradations"] == 0


def test_transient_retry_exhaustion():
    rng = np.random.default_rng(SEED + 2)
    a, b, _ = _mats(rng)
    lz = _lazy_chain(a, b)
    with R.inject(R.FaultSpec(kind="transient", site="plan_execute",
                              times=None)):
        with pytest.raises(R.TransientError):
            R.run_resilient(lz, policy=R.RetryPolicy(max_retries=2))
    assert R.stats()["retries"] == 2


def test_retry_backoff_schedule():
    pol = R.RetryPolicy(backoff=0.1, backoff_factor=2.0, max_backoff=0.35)
    assert [pol.delay(i) for i in (1, 2, 3, 4)] == [0.1, 0.2, 0.35, 0.35]
    assert R.RetryPolicy().delay(1) == 0.0


def test_deterministic_raises_immediately():
    rng = np.random.default_rng(SEED + 3)
    a, b, _ = _mats(rng)
    lz = _lazy_chain(a, b)
    with R.inject(R.FaultSpec(kind="crash", site="plan_execute",
                              times=None)):
        with pytest.raises(R.CrashError):
            R.run_resilient(lz)
    s = R.stats()
    assert s["retries"] == 0 and s["degradations"] == 0


def test_kernel_failure_is_never_degraded(monkeypatch):
    """A failed kernel launch raises through the ladder untouched: no retry,
    no degradation, the einsum rung never runs."""
    rng = np.random.default_rng(SEED + 21)
    a, b, _ = _mats(rng)
    calls = []

    def broken(*args, **kwargs):
        calls.append(mops._LOW_MEMORY.get())
        raise _build.KernelError("stacked_matmul (simt) launch failed with "
                                 "cudaError 700")

    monkeypatch.setattr(mops, "stacked_matmul_ref", broken)
    with pytest.raises(_build.KernelError):
        R.run_resilient(_lazy_chain(a, b))
    assert calls == [False]
    s = R.stats()
    assert s["retries"] == 0 and s["degradations"] == 0


def test_oom_degrades_to_eager():
    rng = np.random.default_rng(SEED + 4)
    a, b, want = _mats(rng)
    before = plan_mod.cache_stats()["eager_launches"]
    with R.inject(R.FaultSpec(kind="oom", site="plan_execute",
                              modes=("fused",), times=None)):
        out = R.run_resilient(_lazy_chain(a, b))
    np.testing.assert_allclose(_np(out), want, rtol=1e-5)
    assert R.stats()["degradations"] == 1
    assert plan_mod.cache_stats()["eager_launches"] == before + 1


def test_oom_degrades_to_einsum():
    rng = np.random.default_rng(SEED + 5)
    a, b, want = _mats(rng)
    with R.inject(R.FaultSpec(kind="oom", site="plan_execute",
                              modes=("fused", "eager"), times=None)):
        out = R.run_resilient(_lazy_chain(a, b))
    np.testing.assert_allclose(_np(out), want, rtol=1e-5)
    s = R.stats()
    assert s["degradations"] == 2 and s["recoveries"] == 1


def test_real_oom_error_degrades(monkeypatch):
    """A ``torch.cuda.OutOfMemoryError`` raised by a GEMM (as the caching
    allocator raises it) rides the ladder down to the einsum rung, the only
    one that runs its GEMMs with the low-memory switch set."""
    rng = np.random.default_rng(SEED + 22)
    a, b, want = _mats(rng)
    real = mops.stacked_matmul_ref

    def tight(*args, **kwargs):
        if not mops._LOW_MEMORY.get():
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                              "allocate 80.00 GiB")
        return real(*args, **kwargs)

    monkeypatch.setattr(mops, "stacked_matmul_ref", tight)
    out = R.run_resilient(_lazy_chain(a, b))
    np.testing.assert_allclose(_np(out), want, rtol=1e-5, atol=1e-6)
    assert R.stats()["degradations"] == 2


def test_oom_ladder_exhausted():
    rng = np.random.default_rng(SEED + 6)
    a, b, _ = _mats(rng)
    lz = _lazy_chain(a, b)
    with R.inject(R.FaultSpec(kind="oom", site="plan_execute", times=None)):
        with pytest.raises(R.OOMError):
            R.run_resilient(lz)
    assert R.stats()["degradations"] == 2


def test_execute_eager_matches_fused(monkeypatch):
    rng = np.random.default_rng(SEED + 7)
    a, b, want = _mats(rng)
    env = dict(os.environ)
    seen = []
    real = mops.stacked_matmul_ref

    def spy(*args, **kwargs):
        seen.append(mops._LOW_MEMORY.get())
        return real(*args, **kwargs)

    monkeypatch.setattr(mops, "stacked_matmul_ref", spy)
    p = plan_mod.plan_for(_lazy_chain(a, b))
    plain0 = registry.snapshot("gemm")["gemm.dispatch_plain"]
    fused = p.execute()[0]
    eager = p.execute_eager()[0]
    einsum = p.execute_eager(backend="einsum")[0]
    for got in (fused, eager, einsum):
        np.testing.assert_allclose(_np(got), want, rtol=1e-5)
    # the low-memory switch is set for the einsum rung only; the CPU
    # takes the plain version on every rung
    assert seen == [False, False, True]
    assert mops._LOW_MEMORY.get() is False
    assert registry.snapshot("gemm")["gemm.dispatch_plain"] == plain0 + 3
    assert dict(os.environ) == env
    with pytest.raises(ValueError, match="backend"):
        p.execute_eager(backend="pallas")


def test_no_environment_variable_selects_a_gemm_route():
    for rel in ("kernels/matmul/ops.py", "kernels/matmul/kernel.py",
                "core/plan.py", "resilience/execute.py"):
        text = (ROOT / "src" / "repro_torch" / rel).read_text()
        assert "os.environ" not in text and "getenv" not in text, rel


def test_multi_root_and_prepared_plan():
    rng = np.random.default_rng(SEED + 8)
    a, b, _ = _mats(rng)
    with expr_mod.lazy():
        s1 = (a * 2.0).sum()
        s2 = (a * 2.0).mean()
    o1, o2 = R.run_resilient(s1, s2)
    assert np.isclose(float(o1), 2.0 * _np(a).sum())
    assert np.isclose(float(o2), 2.0 * _np(a).mean())
    p = plan_mod.plan_for(s1, s2)
    q1, q2 = R.run_resilient(p)
    assert float(q1) == float(o1) and float(q2) == float(o2)


# ---------------------------------------------------------------------------
# Numerical guards
# ---------------------------------------------------------------------------

def test_finite_report_dense_coordinates():
    a = ds(np.ones((5, 7), np.float32), (2, 3))
    assert a.finite_report().ok
    bad = R.poison_block(a, (1, 2))
    rep = bad.finite_report()
    assert not rep.ok and len(rep.bad_blocks) == 1
    bb = rep.bad_blocks[0]
    assert (bb.gi, bb.gj) == (1, 2) and bb.n_nan == 1 and bb.n_inf == 0
    assert "block (1, 2)" in rep.describe()
    inf_bad = R.poison_block(a, (0, 0), value=np.inf)
    assert inf_bad.finite_report().bad_blocks[0].n_inf == 1


def test_finite_report_dirty_pad_no_false_positive():
    a = ds(np.ones((3, 3), np.float32), (2, 2))
    blocks = a.blocks.clone()
    blocks[1, 1, 1, 1] = float("nan")            # pad corner (row 3, col 3)
    dirty = DsArray(blocks, a.grid, PAD_DIRTY)
    assert dirty.finite_report().ok
    assert R.all_finite(dirty)
    R.guard_finite(dirty)
    blocks = blocks.clone()
    blocks[0, 0, 1, 0] = float("nan")
    dirty2 = DsArray(blocks, a.grid, PAD_DIRTY)
    rep = dirty2.finite_report()
    assert [(b.gi, b.gj) for b in rep.bad_blocks] == [(0, 0)]
    assert rep.bad_blocks[0].first == (1, 0)


def test_finite_report_bcoo_slot():
    a = ds(np.eye(6, dtype=np.float32), (3, 3)).tosparse()
    assert a.finite_report().ok
    bad = R.poison_block(a, (1, 1))
    rep = bad.finite_report()
    assert not rep.ok and rep.block_format == "bcoo"
    bb = rep.bad_blocks[0]
    assert (bb.gi, bb.gj) == (1, 1) and bb.sparse
    assert "slot" in bb.describe()


@pytest.mark.parametrize("sparse", [False, True])
def test_finite_report_equals_reference(sparse):
    """Both packages report the same blocks, counts and first sites for
    the same poisoned NumPy array (NaN and Inf, several blocks)."""
    rng = np.random.default_rng(SEED + 23)
    x = rng.normal(size=(11, 9)).astype(np.float32)
    x[rng.random(x.shape) < 0.6] = 0.0
    for (r, c), v in (((0, 1), np.nan), ((4, 8), np.inf), ((5, 7), np.nan),
                      ((10, 0), -np.inf), ((10, 2), np.nan)):
        x[r, c] = v
    bs = (4, 3)
    mine = ds(x, bs)
    ref = jx.from_array(jnp.asarray(x), bs)
    if sparse:
        mine, ref = mine.tosparse(), ref.tosparse()
    got, want = mine.finite_report(), ref.finite_report()
    assert got.block_format == want.block_format
    key = (lambda b: (b.gi, b.gj, b.n_nan, b.n_inf, b.sparse)) if sparse else \
        (lambda b: (b.gi, b.gj, b.n_nan, b.n_inf, b.first, b.sparse))
    assert [key(b) for b in got.bad_blocks] == [key(b) for b in want.bad_blocks]
    assert len(got.bad_blocks) == 3          # two blocks hold two each
    if not sparse:
        assert got.describe() == want.describe()


def test_guard_finite_on_poisoned_plan_output():
    rng = np.random.default_rng(SEED + 9)
    a, b, _ = _mats(rng)
    with R.inject(R.FaultSpec(kind="poison", site="plan_result",
                              block=(0, 1))):
        with pytest.raises(R.NumericalDivergence) as ei:
            R.run_resilient(_lazy_chain(a, b), guard="finite")
    assert "block (0, 1)" in str(ei.value)
    assert ei.value.report is not None
    assert R.stats()["guard_failures"] == 1


def test_guard_finite_scalars_and_ints():
    R.guard_finite(torch.tensor(1.5), np.float32(2.0), torch.arange(3))
    with pytest.raises(R.NumericalDivergence, match="non-finite"):
        R.guard_finite(torch.tensor([1.0, math.inf]))
    ints = ds(np.arange(12, dtype=np.int32).reshape(3, 4), (2, 2))
    assert R.guard_finite(ints) is ints


def test_require_finite_host():
    ok = np.arange(4.0)
    assert R.require_finite_host(ok, "x") is ok
    with pytest.raises(R.NumericalDivergence, match="1 nan"):
        R.require_finite_host(np.array([1.0, np.nan]), "solver out")
    R.require_finite_host(np.arange(3), "ints")


def test_linear_solver_divergence_falls_back():
    from repro_torch.estimators import LinearRegression
    x = np.ones((12, 3), np.float32)             # rank-1: singular Gram
    y = np.arange(12.0)
    est = LinearRegression(alpha=0.0).fit(ds(x, (12, 3)), y)
    assert np.isfinite(np.asarray(est.coef_)).all()


def test_io_load_injection():
    import repro_torch.core.io as rio
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x.npy")
        np.save(p, np.ones((4, 4), np.float32))
        loaded = rio.load_npy_rows(p, (2, 2), device=CPU)
        assert loaded.shape == (4, 4)
        with R.inject(R.FaultSpec(kind="io", site="io_load")):
            with pytest.raises(R.IOLoadError):
                rio.load_npy_rows(p, (2, 2), device=CPU)
        # a mid-stream fault at one block row
        with R.inject(R.FaultSpec(kind="io", site="io_load",
                                  where={"source": "load_npy_rows",
                                         "block_row": 1})) as (armed,):
            with pytest.raises(R.IOLoadError):
                rio.load_npy_rows(p, (2, 2), device=CPU)
        assert armed.fired == 1
        assert issubclass(R.IOLoadError, OSError)


def test_low_memory_rung_caps_the_split_k_workspace():
    """The einsum rung's GEMM plan keeps split-K within the low-memory
    workspace cap, and still splits a deep K where the output is small."""
    from repro_torch.kernels.matmul import kernel as mk
    a = torch.zeros((1, 8, 256, 8192))           # (gi, gk, bn, bk): K = 65,536
    b = torch.zeros((8, 1, 8192, 256))
    full = mk.plan(a, b, sms=132)
    low = mk.plan(a, b, sms=132, workspace=mk.LOW_MEMORY_WORKSPACE)
    out = 256 * 256 * 4
    assert full.splits * out > mk.LOW_MEMORY_WORKSPACE >= low.splits * out
    assert 1 < low.splits < full.splits
