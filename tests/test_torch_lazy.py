"""The port's lazy plan layer against the JAX package's, case by case.

One counterpart of each test of ``tests/test_lazy.py``: both packages are
built from one seeded NumPy array and record the same expression; the
results agree (rtol = atol = 1e-4 for floats, exact for ints, as
``tests/test_differential.py``) with equal shape, block shape, dtype,
``pad_state`` and ``block_format``, the optimizer reports the same
``nodes_before``/``nodes_after``/``fused_elementwise``, and the plan
counters move alike.  Where the reference inspects its jaxpr (remasks,
the transpose fold) the port is held to the same property through the
calls its plan makes.  Two more cases: recording moves no launch
counter, and the metadata inferred for every node of a mixed chain equals
what running that node gives.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro.core as jx  # noqa: E402
from repro.analysis import count_selects  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
import repro_torch as pt  # noqa: E402
from repro_torch.core import dsarray as pdsarray  # noqa: E402
from repro_torch.core import expr as pexpr  # noqa: E402
from repro_torch.core import plan as pplan  # noqa: E402
from repro_torch.kernels.matmul import ops as mops  # noqa: E402
from repro_torch.obs import registry, tracing  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
STAT_KEYS = ("nodes_before", "nodes_after", "fused_elementwise")
RNG = np.random.default_rng(20261017)


def mk(n=13, m=9, bn=4, bm=3, dtype=np.float32, shift=1.0):
    """One NumPy array and its two ds-arrays: (x, port, reference)."""
    x = RNG.normal(size=(n, m)) * 2 + shift
    if np.issubdtype(np.dtype(dtype), np.integer):
        x = np.round(x * 10)
    x = x.astype(dtype)
    return x, pt.from_array(x, (bn, bm), device="cpu"), jx.from_array(
        jnp.asarray(x), (bn, bm))


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def assert_same(p, j):
    """Port result ``p`` against reference result ``j`` (ds-array or 0-d)."""
    if not isinstance(j, jx.DsArray):
        assert _dtype_name(p.dtype) == str(j.dtype)
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)
        return
    assert p.shape == j.shape and p.block_shape == j.block_shape
    assert _dtype_name(p.dtype) == str(j.dtype)
    assert (p.pad_state.kind, p.pad_state.fill) == \
        (j.pad_state.kind, j.pad_state.fill)
    assert p.block_format == j.block_format
    p.check_invariants()
    got, want = p.collect().numpy(), np.asarray(j.collect())
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def assert_bits(p, q):
    """Two port ds-arrays hold the same bits and metadata."""
    assert p.shape == q.shape and p.block_shape == q.block_shape
    assert p.dtype == q.dtype and p.pad_state == q.pad_state
    assert torch.equal(p.collect(), q.collect())


def stats_of(p):
    return {k: p.stats[k] for k in STAT_KEYS}


def assert_same_stats(p_lazy, j_lazy):
    """The port's optimizer reports what the reference's reports."""
    if not isinstance(p_lazy, tuple):
        p_lazy, j_lazy = (p_lazy,), (j_lazy,)
    assert stats_of(pplan.plan_for(*p_lazy)) == stats_of(jplan.plan_for(*j_lazy))


def clear_both():
    pplan.clear_cache()
    jplan.clear_cache()


def assert_same_counters():
    got, want = pplan.cache_stats(), jplan.cache_stats()
    assert got == {k: want[k] for k in got}, (got, want)


@pytest.fixture
def remasks(monkeypatch):
    """Counts ``DsArray._remask`` calls (the port's mask passes)."""
    calls = []
    real = pdsarray.DsArray._remask

    def counting(self, fill=0):
        calls.append(fill)
        return real(self, fill)

    monkeypatch.setattr(pdsarray.DsArray, "_remask", counting)
    return calls


# ---------------------------------------------------------------------------
# Oracle equality
# ---------------------------------------------------------------------------


def test_chain_matches_eager_and_numpy():
    x, a, ja = mk()
    y, b, jb = mk()

    def chain(t, o):
        return ((t + o) * 2.0 - o).abs() * 0.5 + 0.25

    with pt.lazy():
        r = chain(a, b)
    with repro.lazy():
        jr = chain(ja, jb)
    assert isinstance(r, pexpr.LazyDsArray)
    out, eager = r.compute(), chain(a, b)
    assert_bits(out, eager)
    np.testing.assert_allclose(out.collect().numpy(),
                               np.abs((x + y) * 2.0 - y) * 0.5 + 0.25, rtol=1e-5)
    assert_same(out, jr.compute())
    assert_same_stats(r, jr)
    # the node-by-node run bypasses the cache and gives the same bits
    before = pplan.cache_stats()
    p = pplan.plan_for(r)
    assert_bits(p.execute_eager()[0], out)
    after = pplan.cache_stats()
    assert after["eager_launches"] == before["eager_launches"] + 1
    assert (after["hits"], after["misses"]) == (before["hits"], before["misses"])


_FLOAT_OPS = {
    "add_s": lambda t, o: t + 1.5,
    "mul_s": lambda t, o: t * 2.0,
    "sub_b": lambda t, o: t - o,
    "add_b": lambda t, o: t + o,
    "rsub": lambda t, o: 3.0 - t,
    "neg": lambda t, o: -t,
    "abs": lambda t, o: t.abs(),
    "sqrt_abs": lambda t, o: t.abs().sqrt(),
    "div_s": lambda t, o: t / 2.0,
}

_INT_OPS = {
    "add_s": lambda t, o: t + 2,
    "mul_s": lambda t, o: t * 3,
    "sub_b": lambda t, o: t - o,
    "add_b": lambda t, o: t + o,
    "neg": lambda t, o: -t,
    "abs": lambda t, o: t.abs(),
}


def _property_corpus(count=10, seed=5):
    """A fixed, seeded corpus in place of the reference's hypothesis draws
    (same ranges: n 1-40, m 1-17, blocks 1-8, 1-6 ops)."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(count):
        dtype = (np.float32, np.int32)[int(rng.integers(2))]
        ops = sorted(_FLOAT_OPS if dtype == np.float32 else _INT_OPS)
        cases.append((int(rng.integers(1, 41)), int(rng.integers(1, 18)),
                      int(rng.integers(1, 9)), int(rng.integers(1, 9)), dtype,
                      tuple(ops[int(i)] for i in
                            rng.integers(len(ops), size=int(rng.integers(1, 7))))))
    return cases


@pytest.mark.parametrize("n,m,bn,bm,dtype,op_names", _property_corpus(),
                         ids=lambda v: getattr(v, "__name__", None))
def test_property_lazy_equals_eager(n, m, bn, bm, dtype, op_names):
    ops = _FLOAT_OPS if dtype == np.float32 else _INT_OPS
    _, a, ja = mk(n, m, bn, bm, dtype)
    _, b, jb = mk(n, m, bn, bm, dtype)

    def chain(t, o):
        for name in op_names:
            t = ops[name](t, o)
        return t

    eager = chain(a, b)
    with pt.lazy():
        lazy_r = chain(a, b)
    with repro.lazy():
        jr = chain(ja, jb)
    out = lazy_r.compute()
    assert_bits(out, eager)
    assert_same(out, jr.compute())
    assert_same_stats(lazy_r, jr)


def _structural(label, a, b, pkg):
    conv, int32 = (pt.concat_rows, torch.int32) if pkg == "pt" \
        else (jx.concat_rows, jnp.int32)
    return {
        "transpose": lambda: (a + 1.0).T,
        "slice": lambda: (a * 2.0)[2:9, 1:7],
        "filter": lambda: a[[0, 5, 12, 3]],
        "rechunk": lambda: (a + b).rechunk((5, 2)),
        "concat": lambda: conv([a, b]),
        "astype": lambda: (a * 2.5).astype(int32),
        "matmul": lambda: (a + 1.0) @ (b.T + 2.0),
        "mean0": lambda: a.mean(axis=0),
        "sum1": lambda: (a + 1.0).sum(axis=1),
        "max": lambda: a.max(axis=0),
        "norm1": lambda: a.norm(axis=1),
    }[label]


@pytest.mark.parametrize("label", ["transpose", "slice", "filter", "rechunk",
                                   "concat", "astype", "matmul", "mean0",
                                   "sum1", "max", "norm1"])
def test_structural_ops_lazy_equivalence(label):
    _, a, ja = mk(17, 13, 4, 3)
    _, b, jb = mk(17, 13, 4, 3)
    build, jbuild = _structural(label, a, b, "pt"), _structural(label, ja, jb, "jx")
    with pt.lazy():
        lazy_r = build()
    with repro.lazy():
        jr = jbuild()
    out, want = lazy_r.compute(), build()
    assert out.shape == want.shape and out.pad_state == want.pad_state
    np.testing.assert_allclose(out.collect().numpy(), want.collect().numpy(),
                               **TOL)
    assert_same(out, jr.compute())
    assert_same_stats(lazy_r, jr)


def test_scalar_reductions_and_mean():
    _, a, ja = mk(11, 7, 3, 3)
    with pt.lazy():
        s, nrm, mn = (a * a).sum(), a.norm(), a.mean()
    with repro.lazy():
        js, jn, jm = (ja * ja).sum(), ja.norm(), ja.mean()
    for lz, jlz, eager in ((s, js, (a * a).sum()), (nrm, jn, a.norm()),
                           (mn, jm, a.mean())):
        assert isinstance(lz, pexpr.LazyScalar)
        got = lz.compute()
        assert float(got) == pytest.approx(float(eager), rel=1e-5)
        assert_same(got, jlz.compute())
        assert_same_stats(lz, jlz)
    # an integer mean promotes before summing, lazily too
    _, ai, jai = mk(9, 5, 4, 2, np.int32)
    with pt.lazy():
        mi = ai.mean(axis=0)
    with repro.lazy():
        jmi = jai.mean(axis=0)
    assert_bits(mi.compute(), ai.mean(axis=0))
    assert_same(mi.compute(), jmi.compute())


def test_lazy_shuffles_match_eager():
    """Lazy equals eager bit for bit for one generator state (the draws
    happen when the op is recorded); metadata and row content as the
    reference's (``torch`` cannot replay ``jax.random``'s bits)."""
    x, a, ja = mk(16, 6, 4, 3)
    key = jax.random.PRNGKey(7)
    for fn, jfn in ((pt.exact_shuffle, jx.exact_shuffle),
                    (pt.pseudo_shuffle, jx.pseudo_shuffle)):
        gen = torch.Generator().manual_seed(7)
        state = gen.get_state()
        with pt.lazy():
            lz = fn(gen, a)
        with repro.lazy():
            jlz = jfn(key, ja)
        gen.set_state(state)
        eager = fn(gen, a)
        out, jout = lz.compute(), jlz.compute()
        assert_bits(out, eager)
        assert (out.shape, out.block_shape, out.pad_state.kind) == \
            (jout.shape, jout.block_shape, jout.pad_state.kind)
        assert sorted(map(tuple, out.collect().numpy().tolist())) == \
            sorted(map(tuple, np.asarray(jout.collect()).tolist()))
        assert_same_stats(lz, jlz)


def test_tensor_scalar_operand_takes_the_eager_pad():
    """A 0-d tensor operand is baked on the host when recorded: the plan's
    pad state is the eager op's (a FILL constant, not DIRTY), and so are
    its dtype and bits."""
    _, a, ja = mk()
    for scalar, jscalar in ((torch.tensor(2.0), jnp.asarray(2.0, jnp.float32)),
                            (torch.tensor(3, dtype=torch.int32),
                             jnp.asarray(3, jnp.int32))):
        eager = (a + 1.0) * scalar
        with pt.lazy():
            lz = (a + 1.0) * scalar
        assert lz.pad_state == eager.pad_state == pt.PadState("fill", float(scalar))
        assert_bits(lz.compute(), eager)
        assert_same(lz.compute(), (ja + 1.0) * jscalar)


def test_dsarray_interop_without_flag():
    """DsArray ∘ LazyDsArray records through the reflected ops."""
    x, a, ja = mk()
    y, b, jb = mk()
    r = a - b.lazy()            # DsArray.__sub__ -> NotImplemented -> __rsub__
    assert isinstance(r, pexpr.LazyDsArray)
    np.testing.assert_allclose(r.compute().collect().numpy(), x - y,
                               rtol=1e-6, atol=1e-6)
    assert_same(r.compute(), (ja - jb.lazy()).compute())
    r2 = a @ b.lazy().T
    np.testing.assert_allclose(r2.compute().collect().numpy(), x @ y.T,
                               rtol=1e-4, atol=1e-5)
    assert_same(r2.compute(), (ja @ jb.lazy().T).compute())


# ---------------------------------------------------------------------------
# A 6-op chain becomes one fused per-block function
# ---------------------------------------------------------------------------


def test_six_op_chain_single_fused_body(remasks):
    _, a, ja = mk(64, 48, 8, 8)

    def chain(t):
        return ((t + t) * 2.0 - t).abs() * 0.5 + 0.25   # add,mul,sub,abs,mul,add

    with pt.lazy():
        r = chain(a)
    with repro.lazy():
        jr = chain(ja)
    p = pplan.plan_for(r)
    assert p.stats["nodes_after"] == 2, p.stats           # leaf + fused node
    assert p.stats["fused_elementwise"] == 5, p.stats     # 6 ops -> 1 node
    assert_same_stats(r, jr)
    root = p.roots[0]
    assert isinstance(root, pexpr.Blockwise)
    assert [type(c) for c in root.children] == [pexpr.Leaf]
    # the chain ends FILL-padded: bookkeeping only, no mask pass
    before = pplan.cache_stats()["launches"]
    out = r.compute()
    assert pplan.cache_stats()["launches"] == before + 1
    assert len(remasks) <= 1
    assert_bits(out, chain(a))
    assert_same(out, jr.compute())


def test_zero_preserving_chain_into_reduce_no_remask(remasks):
    """As many mask passes as the reference's jaxpr has selects: none for a
    zero-preserving chain into a sum, one for a FILL chain."""
    _, a, ja = mk(64, 48, 8, 8)
    for build in (lambda t: (-((t + t) * 2.0).abs()).sum(),
                  lambda t: ((t + 1.0) * 2.0 + 3.0).sum()):
        with pt.lazy():
            r = build(a)
        with repro.lazy():
            jr = build(ja)
        del remasks[:]
        got = r.compute()
        assert len(remasks) == count_selects(jplan.plan_for(jr).jaxpr())
        assert_same(got, jr.compute())
    assert len(remasks) == 1


# ---------------------------------------------------------------------------
# Transpose folding + sibling reductions
# ---------------------------------------------------------------------------


def test_matmul_transpose_folded(monkeypatch):
    x, a, ja = mk(24, 16, 8, 8)
    y, b, jb = mk(24, 32, 8, 8)
    with pt.lazy():
        r = a.T @ b
    with repro.lazy():
        jr = ja.T @ jb
    p = pplan.plan_for(r)
    root = p.roots[0]
    assert isinstance(root, pexpr.MatMul) and root.transpose_a
    assert_same_stats(r, jr)
    # the folded plan never transposes its input: one GEMM reads it transposed
    transposes, gemms = [], []
    real_t, real_mm = pdsarray.DsArray.transpose, mops.local_matmul
    monkeypatch.setattr(pdsarray.DsArray, "transpose",
                        lambda self: transposes.append(1) or real_t(self))

    def counting_mm(a_, b_, **kw):
        gemms.append(kw.get("transpose_a", False))
        return real_mm(a_, b_, **kw)

    monkeypatch.setattr(mops, "local_matmul", counting_mm)
    plain = registry.snapshot("gemm")["gemm.dispatch_plain"]
    out = r.compute()
    assert transposes == [] and gemms == [True]
    assert registry.snapshot("gemm")["gemm.dispatch_plain"] == plain + 1
    np.testing.assert_allclose(out.collect().numpy(), x.T @ y, **TOL)
    assert_same(out, jr.compute())
    assert_bits(out, pt.matmul_ta(a, b))


def test_transpose_hoisted_through_elementwise():
    """(a.T * 2 + b.T) fuses below a single hoisted transpose."""
    x, a, ja = mk(12, 8, 4, 4)
    y, b, jb = mk(12, 8, 4, 4)
    with pt.lazy():
        r = a.T * 2.0 + b.T
    with repro.lazy():
        jr = ja.T * 2.0 + jb.T
    kinds = [type(n).__name__ for n in pplan.plan_for(r).roots]
    assert kinds == ["Transpose"]
    assert kinds == [type(n).__name__ for n in jplan.plan_for(jr).roots]
    assert_same_stats(r, jr)
    np.testing.assert_allclose(r.compute().collect().numpy(),
                               (x * 2.0 + y).T, rtol=1e-5)
    assert_same(r.compute(), jr.compute())


def test_transpose_not_hoisted_over_position_dependent_map():
    """A position-dependent map_blocks fn does not commute with the
    transpose, so the hoist must not fire for it."""
    _, a, ja = mk(5, 4, 2, 2)
    fn = lambda b: b * torch.arange(b.shape[-1], dtype=b.dtype,  # noqa: E731
                                    device=b.device)
    jfn = lambda b: b * jnp.arange(b.shape[-1], dtype=b.dtype)  # noqa: E731
    eager = a.T.map_blocks(fn, pad=pt.PAD_DIRTY)
    with pt.lazy():
        lz = a.T.map_blocks(fn, pad=pt.PAD_DIRTY)
    with repro.lazy():
        jlz = ja.T.map_blocks(jfn, pad=jx.PAD_DIRTY)
    out = lz.compute()
    assert_bits(out, eager)
    assert out.pad_state == pt.PAD_DIRTY
    np.testing.assert_allclose(out.collect().numpy(), np.asarray(jlz.collect()),
                               **TOL)
    assert_same_stats(lz, jlz)


def test_explicit_dirty_pad_survives_plan_rewrites():
    """pad=PAD_DIRTY on a position-dependent map_blocks is not replaced by
    a (wrong) probe in rebuilds or fusion: the sum still refills the pad."""
    _, a, ja = mk(5, 4, 2, 2)

    def fn(b):
        return b + torch.arange(b.shape[2], dtype=b.dtype,
                                device=b.device)[:, None]

    jfn = lambda b: b + jax.lax.broadcasted_iota(b.dtype, b.shape, 2)  # noqa: E731
    eager = float(a.map_blocks(fn, pad=pt.PAD_DIRTY).sum())
    with pt.lazy():
        s = a.map_blocks(fn, pad=pt.PAD_DIRTY).sum()
    with repro.lazy():
        js = ja.map_blocks(jfn, pad=jx.PAD_DIRTY).sum()
    assert float(s.compute()) == pytest.approx(eager, rel=1e-6)
    assert float(s.compute()) == pytest.approx(float(js.compute()), rel=1e-5)


def test_plan_cache_is_bounded(monkeypatch):
    clear_both()
    monkeypatch.setattr(pplan, "_CACHE_MAX", 8)
    _, a, ja = mk(8, 8, 4, 4)
    for i in range(12):
        with pt.lazy():
            r = (a.map_blocks(lambda b: b * 1.0) + float(i)).sum()
        r.compute()     # a fresh lambda every iteration: every plan misses
        with repro.lazy():
            jr = (ja.map_blocks(lambda b: b * 1.0) + float(i)).sum()
        jr.compute()
    assert len(pplan._CACHE) <= 8 and len(pplan._OPT_CACHE) <= 8
    assert pplan.cache_stats()["misses"] == 12
    assert_same_counters()


def test_sibling_reductions_share_operand():
    _, a, ja = mk(32, 24, 8, 8)
    with pt.lazy():
        c = a * 2.0 + 1.0
        s0, m0 = c.sum(axis=0), c.max(axis=0)
    with repro.lazy():
        jc = ja * 2.0 + 1.0
        js0, jm0 = jc.sum(axis=0), jc.max(axis=0)
    p = pplan.plan_for(s0, m0)
    r1, r2 = p.roots
    assert r1.children[0] is r2.children[0]      # CSE: one shared operand
    assert_same_stats((s0, m0), (js0, jm0))
    got_s, got_m = pplan.compute_multi(s0, m0)
    eager_c = a * 2.0 + 1.0
    assert_bits(got_s, eager_c.sum(axis=0))
    assert_bits(got_m, eager_c.max(axis=0))
    want_s, want_m = jplan.compute_multi(js0, jm0)
    assert_same(got_s, want_s)
    assert_same(got_m, want_m)
    # identical duplicate reductions collapse to ONE root computation
    with pt.lazy():
        d1, d2 = c.sum(axis=0), c.sum(axis=0)
    with repro.lazy():
        jd1, jd2 = jc.sum(axis=0), jc.sum(axis=0)
    pd = pplan.plan_for(d1, d2)
    assert pd.roots[0] is pd.roots[1]
    assert_same_stats((d1, d2), (jd1, jd2))


# ---------------------------------------------------------------------------
# The plan caches
# ---------------------------------------------------------------------------


def test_plan_cache_hits_on_fresh_data():
    clear_both()

    def run_both(build, n=16, m=12, bn=4, bm=4, shift=1.0):
        _, a, ja = mk(n, m, bn, bm, shift=shift)
        with pt.lazy():
            r = build(a)
        with repro.lazy():
            jr = build(ja)
        assert_same(r.compute(), jr.compute())
        assert_same_counters()

    for i in range(3):
        run_both(lambda t: ((t + 1.0) * 2.0).sum(axis=0), shift=float(i))
    st_ = pplan.cache_stats()
    assert st_["misses"] == 1 and st_["hits"] == 2, st_
    run_both(lambda t: ((t + 1.0) * 2.0 + 3.0).sum(axis=0))   # an extra op
    assert pplan.cache_stats()["misses"] == 2
    run_both(lambda t: ((t + 1.0) * 5.0).sum(axis=0))         # another constant
    assert pplan.cache_stats()["misses"] == 3
    run_both(lambda t: ((t + 1.0) * 2.0).sum(axis=0), bn=8)   # another geometry
    assert pplan.cache_stats()["misses"] == 4


def test_scalar_dtype_in_plan_key():
    """``a + 1`` and ``a + 1.0`` are different plans: the baked scalar's
    type is part of the key."""
    clear_both()
    _, ai, jai = mk(8, 6, 4, 3, np.int32)
    with pt.lazy():
        ri = ai + 1
        rf = ai + 1.0
    with repro.lazy():
        jri = jai + 1
        jrf = jai + 1.0
    out_i, out_f = ri.compute(), rf.compute()
    assert out_i.dtype == torch.int32 and out_f.dtype == torch.float32
    assert pplan.cache_stats()["misses"] == 2
    assert_same(out_i, jri.compute())
    assert_same(out_f, jrf.compute())
    assert_same_counters()


@pytest.mark.parametrize("iters", [10, 20])
def test_optimizer_runs_once_across_recorded_hot_loop(iters):
    """Recording an unchanged DAG again skips the optimizer: across the PCA
    power-iteration loop the optimizer runs ONCE, the run is built once,
    and the counters move as the reference's."""
    clear_both()
    x, a, ja = mk(24, 16, 8, 8)
    xl, jxl = a.lazy(), ja.lazy()
    q0 = RNG.normal(size=(16, 4)).astype(np.float32)
    for i in range(iters):
        out = (xl.T @ (xl @ pt.from_array(q0 + i, (8, 4), device="cpu"))).compute()
        jout = (jxl.T @ (jxl @ jx.from_array(jnp.asarray(q0 + i), (8, 4)))).compute()
        np.testing.assert_allclose(out.collect().numpy(), x.T @ (x @ (q0 + i)),
                                   rtol=1e-3, atol=1e-3)
        assert_same(out, jout)
    st_ = pplan.cache_stats()
    assert st_["opt_runs"] == 1 and st_["opt_skips"] == iters - 1, st_
    assert st_["misses"] == 1 and st_["hits"] == iters - 1, st_
    assert st_["launches"] == iters
    assert_same_counters()
    # a skipped-optimization plan has the key and roots of a fresh one
    cached = pplan.plan_for(xl.T @ (xl @ pt.from_array(q0, (8, 4), device="cpu")))
    assert pplan.cache_stats()["opt_skips"] == iters
    pplan.clear_cache()
    fresh = pplan.plan_for(xl.T @ (xl @ pt.from_array(q0, (8, 4), device="cpu")))
    assert cached.key == fresh.key
    assert pplan._plan_key(cached.roots)[0] == pplan._plan_key(fresh.roots)[0]


def test_optimizer_cache_distinguishes_leaf_aliasing():
    """``c + c`` (one array twice) and ``c + d`` (two arrays of one
    signature) have one skeleton but different CSE outcomes."""
    clear_both()
    _, c, jc = mk(8, 6, 4, 3)
    _, d, jd = mk(8, 6, 4, 3)
    with pt.lazy():
        r1 = c + c
        r2 = c + d
    with repro.lazy():
        jr1 = jc + jc
        jr2 = jc + jd
    out1, out2 = r1.compute(), r2.compute()
    assert pplan.cache_stats()["opt_runs"] == 2
    assert_bits(out1, c + c)
    assert_bits(out2, c + d)
    assert_same(out1, jr1.compute())
    assert_same(out2, jr2.compute())
    assert_same_counters()


def test_lazy_mode_is_scoped_and_reentrant():
    _, a, _ = mk()
    assert isinstance(a + 1.0, pt.DsArray)
    with pt.lazy():
        with pt.lazy():
            assert isinstance(a + 1.0, pexpr.LazyDsArray)
        assert isinstance(a + 1.0, pexpr.LazyDsArray)
        with pexpr.suspend_lazy():
            assert isinstance(a + 1.0, pt.DsArray)
    assert isinstance(a + 1.0, pt.DsArray)
    # the format conversions record (tests/test_torch_sparse.py holds
    # their values): dense todense is the identity, a lazy tosparse needs
    # an explicit nse
    lz = a.lazy()
    assert lz.todense() is lz
    with pytest.raises(ValueError, match="nse"):
        lz.tosparse()
    assert isinstance(lz.tosparse(nse=4).expr, pexpr.ToSparse)


# ---------------------------------------------------------------------------
# Recording reads no data: launch counters and inferred metadata
# ---------------------------------------------------------------------------


def _launch_counts():
    from repro_torch.kernels.kmeans import kernel as kk
    from repro_torch.kernels.matmul import kernel as mk_
    counts = dict(registry.snapshot())
    for fn in (mk_.stacked_matmul, kk.kmeans_assign_stacked):
        counts[fn.__name__] = (fn.launches, dict(fn.route_launches))
    return counts


def _mixed_chain(a, b, gen):
    """One of each recordable op, ending in two roots."""
    c = ((a + b) * 2.0).abs().sqrt().exp() / 3.0
    t = (c.T @ b).astype(torch.float32)
    g = c[[1, 4, 0, 12], 2:8].rechunk((3, 2))
    s = pt.concat_rows([c[:8], b[5:]])
    sh = pt.exact_shuffle(gen, pt.pseudo_shuffle(gen, s))
    return (t.sum(axis=0) + 1.0, g.max(axis=1), sh.norm(axis=1),
            (a - 1.5).mean(), c[3].min())


def test_recording_moves_no_launch_counter():
    """Recording and metadata inference run no kernel, no plain version and
    no plan: every counter of the registry and every kernel's launch counts
    stay where they were."""
    _, a, _ = mk(16, 12, 4, 3)
    _, b, _ = mk(16, 12, 4, 3)
    pexpr._META_MEMO.clear()
    before = _launch_counts()
    with pt.lazy():
        roots = _mixed_chain(a, b, torch.Generator().manual_seed(1))
    assert _launch_counts() == before
    assert all(isinstance(r, (pexpr.LazyDsArray, pexpr.LazyScalar)) for r in roots)
    # running it does move them: the GEMM takes its plain version once
    pplan.compute_multi(*roots)
    assert registry.snapshot("gemm")["gemm.dispatch_plain"] == \
        before["gemm.dispatch_plain"] + 1


def _walk(roots):
    seen, order = set(), []

    def visit(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        for c in n.children:
            visit(c)
        order.append(n)

    for r in roots:
        visit(r)
    return order


def test_inferred_metadata_equals_eager_on_every_node():
    """Every node's meta (inferred on meta tensors) equals what running the
    node on the real data gives: shape, stacked shape, dtype, pad state and
    block format."""
    _, a, _ = mk(16, 12, 4, 3)
    _, b, _ = mk(16, 12, 4, 3)
    pexpr._META_MEMO.clear()
    with pt.lazy():
        roots = _mixed_chain(a, b, torch.Generator().manual_seed(2))
        fill = (a.astype(torch.int32) + 2) * 3          # int FILL pads
    nodes = _walk([r.expr for r in roots] + [fill.expr])
    assert len(nodes) > 25
    vals = {}
    with pexpr.suspend_lazy():
        for n in nodes:
            if isinstance(n, pexpr.Leaf):
                vals[id(n)] = n.value
            elif isinstance(n, pexpr.ArrayLeaf):
                vals[id(n)] = n.value
            else:
                vals[id(n)] = n.lower(*[vals[id(c)] for c in n.children])
            got, meta = vals[id(n)], n.meta
            if isinstance(meta, pt.DsArray):
                assert meta.blocks.device.type == "meta"
                assert (got.shape, got.block_shape, tuple(got.blocks.shape),
                        got.dtype, got.pad_state, got.block_format) == \
                    (meta.shape, meta.block_shape, tuple(meta.blocks.shape),
                     meta.dtype, meta.pad_state, meta.block_format), n
                got.check_invariants()
            else:
                assert (tuple(got.shape), got.dtype) == \
                    (tuple(meta.shape), meta.dtype), n


def test_plan_spans_and_counter_group():
    """``plan.optimize`` on an optimizer run, ``plan.launch`` per execution;
    ``capture_plans`` sees every plan built; the counters live in the
    registry under ``plan``."""
    pplan.clear_cache()
    _, a, _ = mk(8, 8, 4, 4)
    with tracing.recording() as events, pplan.capture_plans() as plans:
        for _ in range(2):
            ((a.lazy() + 1.0) * 2.0).sum().compute()
    assert len(plans) == 2 and plans[0].key == plans[1].key
    names = [e["name"] for e in events]
    assert names.count("plan.optimize") == 1 and names.count("plan.launch") == 2
    assert [e["args"]["cached"] for e in events if e["name"] == "plan.launch"] \
        == [False, True]
    assert registry.snapshot("plan") == {f"plan.{k}": v for k, v in
                                         pplan.cache_stats().items()}
