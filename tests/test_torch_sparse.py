"""The port's sparse blocks against the JAX package's, case by case.

One counterpart of each test of ``tests/test_sparse.py``: both packages
are built from one seeded NumPy (or scipy) array on the CPU and run the
same op; the results agree on values (rtol = atol = 1e-4 for floats, exact
for ints, as ``tests/test_differential.py``), shape, block shape, dtype,
``pad_state`` and ``block_format``, and on the stored-entry capacity
``nse`` wherever the two packages size it by the same rule.  They do not
for sp * sp: the reference sizes it at ``nse_l · nse_r``
(``jax/experimental/sparse/bcoo.py:2240``), the port at
``min(nse_l, nse_r)``; ``test_pair_multiply_capacity_is_the_smaller_nse``
pins the port's rule with the values equal.  Where the reference asserts on
its jaxpr that the sparse operand is never densified, the port runs with
``todense`` patched to raise.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ssp = pytest.importorskip("scipy.sparse")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro.core as jx  # noqa: E402
from repro.algorithms.kmeans import KMeans as JKMeans  # noqa: E402
from repro.core import costmodel as jcostmodel  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import sparse as jsparse_mod  # noqa: E402
import repro_torch as pt  # noqa: E402
from repro_torch.algorithms.kmeans import KMeans as PKMeans  # noqa: E402
from repro_torch.algorithms import kmeans as pkmeans  # noqa: E402
from repro_torch.core import costmodel as pcostmodel  # noqa: E402
from repro_torch.core import expr as pexpr  # noqa: E402
from repro_torch.core import plan as pplan  # noqa: E402
from repro_torch.core import sparse as psparse  # noqa: E402
from repro_torch.kernels.matmul import ops as mops  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
RNG = np.random.default_rng(20261018)


def mk_sparse(n=13, m=9, bn=4, bm=3, dtype=np.float32, density=0.3):
    """One NumPy array, its port dense/sparse and reference dense/sparse
    ds-arrays: (x, pd, ps, jd, js)."""
    x = (RNG.random((n, m)) < density) * RNG.normal(size=(n, m))
    if np.issubdtype(np.dtype(dtype), np.integer):
        x = np.round(x * 10)
    x = x.astype(dtype)
    pd = pt.from_array(x, (bn, bm), device="cpu")
    jd = jx.from_array(jnp.asarray(x), (bn, bm))
    return x, pd, pd.tosparse(), jd, jd.tosparse()


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def assert_same(p, j, nse: bool = True):
    """Port result ``p`` against reference result ``j``; ``nse``: the
    stored-entry capacities are equal too (sparse results)."""
    if not isinstance(j, jx.DsArray):
        assert _dtype_name(p.dtype) == str(j.dtype)
        np.testing.assert_allclose(np.asarray(p), np.asarray(j), **TOL)
        return
    assert p.shape == j.shape and p.block_shape == j.block_shape
    assert p.stacked_grid == tuple(j.stacked_grid)
    assert _dtype_name(p.dtype) == str(j.dtype)
    assert (p.pad_state.kind, p.pad_state.fill) == \
        (j.pad_state.kind, j.pad_state.fill)
    assert p.block_format == j.block_format
    if nse and p.is_sparse:
        assert p.blocks.nse == j.blocks.nse
    p.check_invariants()
    got, want = p.collect().numpy(), np.asarray(j.collect())
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture
def no_densify(monkeypatch):
    """A context manager: any densify of a sparse operand inside it raises
    (the results are compared outside it, where ``collect`` may densify)."""
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
# Construction + conversions
# ---------------------------------------------------------------------------


def test_roundtrip_and_invariants():
    x, pd, ps, jd, js = mk_sparse()
    assert ps.block_format == "bcoo" and pd.block_format == "dense"
    assert ps.is_sparse and not pd.is_sparse
    assert_same(ps, js)
    assert_same(ps.todense(), js.todense())
    assert isinstance(ps.blocks, psparse.StackedCOO)
    assert ps.blocks.indices.dtype == torch.int32
    assert ps.blocks.indices_sorted and ps.blocks.unique_indices
    assert ps.tosparse() is ps and pd.todense() is pd


def test_random_sparse_density_and_pad():
    """Held to its distribution (torch cannot replay ``jax.random``): the
    reference's capacity rule, the pad invariant, the density, and the same
    array from the same generator state."""
    r = pt.random_sparse(torch.Generator().manual_seed(0), (21, 13), (6, 4),
                         density=0.15, device="cpu")
    j = jx.random_sparse(jax.random.PRNGKey(0), (21, 13), (6, 4), density=0.15)
    assert r.blocks.nse == j.blocks.nse and r.stacked_grid == j.stacked_grid
    assert r.block_format == "bcoo" and r.pad_state == pt.PAD_ZERO
    r.check_invariants()                 # incl. zero entries in the pad region
    assert 0.05 < psparse.density(r) < 0.3
    r2 = pt.random_sparse(torch.Generator().manual_seed(0), (21, 13), (6, 4),
                          density=0.15, device="cpu")
    assert torch.equal(r.collect(), r2.collect())
    u = pt.random_sparse(torch.Generator().manual_seed(1), (60, 40), (20, 20),
                         density=0.5, distribution="uniform", device="cpu")
    vals = u.blocks.data[u.blocks.data != 0]
    assert float(vals.min()) >= 0.0 and float(vals.max()) < 1.0
    assert abs(float(vals.mean()) - 0.5) < 0.05


def test_from_scipy_never_densifies_layout():
    m = ssp.random(23, 17, density=0.12, random_state=3, format="csr",
                   dtype=np.float32)
    assert_same(pt.from_scipy(m, (6, 5), device="cpu"), jx.from_scipy(m, (6, 5)))
    empty = ssp.csr_matrix((5, 4), dtype=np.float32)
    assert_same(pt.from_scipy(empty, (2, 2), device="cpu"),
                jx.from_scipy(empty, (2, 2)))
    # float64 input narrows to float32 as the reference does
    m64 = ssp.random(9, 7, density=0.3, random_state=4, format="coo")
    assert_same(pt.from_scipy(m64, (4, 3), device="cpu"),
                jx.from_scipy(m64, (4, 3)))


def test_from_scipy_blocks_of_very_different_nnz():
    """One dense corner block and near-empty others: every block pads to the
    densest block's nnz, and the capacity guard raises below it."""
    dense = np.zeros((40, 30), np.float32)
    dense[:10, :10] = RNG.normal(size=(10, 10))
    dense[35, 29] = 2.5
    dense[12, 3] = -1.0
    m = ssp.csr_matrix(dense)
    p = pt.from_scipy(m, (10, 10), device="cpu")
    assert_same(p, jx.from_scipy(m, (10, 10)))
    assert p.blocks.nse == psparse.max_block_nnz(m, (10, 10)) == \
        jsparse_mod.max_block_nnz(m, (10, 10)) == 100
    assert int((p.blocks.data != 0).sum()) == int((dense != 0).sum())
    with pytest.raises(ValueError):
        pt.from_scipy(m, (10, 10), nse=50, device="cpu")
    wide = pt.from_scipy(m, (10, 10), nse=128, device="cpu")
    assert_same(wide, jx.from_scipy(m, (10, 10), nse=128))
    assert_same(pt.from_scipy(m, (10, 10), nse=40, check_nse=False, device="cpu"),
                jx.from_scipy(m, (10, 10), nse=40, check_nse=False))


def test_stacked_builder_matches_from_scipy():
    m = ssp.random(26, 11, density=0.3, random_state=5, format="csr",
                   dtype=np.float32)
    coo = m.tocoo()
    for nse in (None, 40):
        pb = psparse.StackedBCOOBuilder(11, (8, 4), nse=nse, device="cpu")
        jb = jsparse_mod.StackedBCOOBuilder(11, (8, 4), nse=nse)
        for r0 in range(0, 26, 8):
            sel = (coo.row >= r0) & (coo.row < r0 + 8)
            args = (coo.row[sel] - r0, coo.col[sel], coo.data[sel],
                    min(8, 26 - r0))
            pb.append_blockrow(*args)
            jb.append_blockrow(*args)
        assert_same(pb.finalize(), jb.finalize())
    with pytest.raises(ValueError):
        psparse.StackedBCOOBuilder(4, (2, 2), device="cpu").append_blockrow(
            [0], [7], [1.0], 1)


def test_io_density_auto_pick():
    """The costmodel half (``from_array_auto`` waits for the port's io
    loaders): the storage-crossover and conversion laws equal the
    reference's."""
    assert pcostmodel.sparse_storage_crossover_density(4) == \
        jcostmodel.sparse_storage_crossover_density(4) == pytest.approx(1 / 3)
    for d in (0.0, 0.01, 0.2, 0.3, 0.9):
        for s in (1, 2, 4):
            assert pcostmodel.tosparse_pays(d, streaming_ops=s) == \
                jcostmodel.tosparse_pays(d, streaming_ops=s)
    assert pcostmodel.tosparse_pays(0.01) and not pcostmodel.tosparse_pays(0.9)


def test_bcoo_requires_zero_pad_claim():
    _, _, ps, _, _ = mk_sparse()
    with pytest.raises(ValueError):
        pt.DsArray(ps.blocks, ps.grid, pt.PadState("fill", 3.0))


def test_check_invariants_catches_violations():
    _, _, ps, _, _ = mk_sparse(8, 6, 4, 3)
    sp = ps.blocks
    data, idx = sp.data.clone(), sp.indices.clone()
    data[0, 0, -1] = 7.0                        # a sentinel slot with data
    idx[0, 0, -1] = torch.tensor([4, 3], dtype=torch.int32)
    bad = psparse.StackedCOO(data, idx, sp.shape)
    with pytest.raises(AssertionError, match="out-of-bounds"):
        pt.DsArray(bad, ps.grid).check_invariants()
    _, _, ragged, _, _ = mk_sparse(13, 9, 4, 3)  # an entry in the pad region
    data = ragged.blocks.data.clone()
    idx = ragged.blocks.indices.clone()
    data[-1, -1, 0] = 9.0
    idx[-1, -1, 0] = torch.tensor([3, 2], dtype=torch.int32)  # global (15, 8)
    with pytest.raises(AssertionError, match="pad region"):
        pt.DsArray(psparse.StackedCOO(data, idx, ragged.blocks.shape),
                   ragged.grid).check_invariants()
    _, dense, _, _, _ = mk_sparse(13, 9, 4, 3)
    blocks = dense.blocks.clone()
    blocks[-1, -1, -1, -1] = 9.0
    with pytest.raises(AssertionError):
        pt.DsArray(blocks, dense.grid, pt.PAD_ZERO).check_invariants()


def test_constructions_pass_check_invariants():
    """The reference validates every construction under ``REPRO_DEBUG=1``;
    the port has no such switch, so every result of a chain is checked."""
    x, pd, ps, _, _ = mk_sparse()
    for out in (ps * 2.0, -(ps * 2.0), (ps + ps).abs(), ps.T, ps[0:8],
                ps.astype(torch.int32), ps._pad_grid_to((5, 4))):
        out.check_invariants()
    np.testing.assert_allclose((ps * 2.0).collect().numpy(), x * 2.0, **TOL)


# ---------------------------------------------------------------------------
# Op policy: sparse-native vs densifying (the table, executable)
# ---------------------------------------------------------------------------


_X, _PD, _PS, _JD, _JS = mk_sparse()
_Y = (RNG.normal(size=_X.shape) + 2.5).astype(np.float32)
_PB = pt.from_array(_Y, _PD.block_shape, device="cpu")
_JB = jx.from_array(jnp.asarray(_Y), _JD.block_shape)
_PSB, _JSB = _PB.tosparse(), _JB.tosparse()

ELEMENTWISE = {
    "scale": (lambda s, b, sb: s * 2.0, "bcoo"),
    "div_s": (lambda s, b, sb: s / 2.0, "bcoo"),
    "neg": (lambda s, b, sb: -s, "bcoo"),
    "abs": (lambda s, b, sb: s.abs(), "bcoo"),
    "sqrt_abs": (lambda s, b, sb: s.abs().sqrt(), "bcoo"),
    "pow2": (lambda s, b, sb: s ** 2, "bcoo"),
    "add_s": (lambda s, b, sb: s + 1.0, "dense"),
    "exp": (lambda s, b, sb: s.exp(), "dense"),
    "rdiv": (lambda s, b, sb: 2.0 / (s + 3.0), "dense"),
    "pair_add": (lambda s, b, sb: s + sb, "bcoo"),
    "pair_sub": (lambda s, b, sb: s - sb, "bcoo"),
    "pair_mul": (lambda s, b, sb: s * sb, "bcoo"),
    "gather_mul": (lambda s, b, sb: s * b, "bcoo"),
    "gather_div": (lambda s, b, sb: s / b, "bcoo"),
    "rev_gather": (lambda s, b, sb: b * s, "bcoo"),
    "dense_div_sp": (lambda s, b, sb: b / s, "dense"),
    "sp_add_dense": (lambda s, b, sb: s + b, "dense"),
}


@pytest.mark.parametrize("label", sorted(ELEMENTWISE))
def test_elementwise_policy_and_values(label):
    build, fmt = ELEMENTWISE[label]
    p, j = build(_PS, _PB, _PSB), build(_JS, _JB, _JSB)
    assert p.block_format == j.block_format == fmt
    if label == "dense_div_sp":           # x / 0 at the implicit zeros
        assert p.block_format == "dense"
        p.check_invariants()
        got, want = p.collect().numpy(), np.asarray(j.collect())
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], **TOL)
        return
    assert_same(p, j, nse=label != "pair_mul")


def test_mixed_format_with_mismatched_blocks():
    """A block-shape mismatch rechunks — which densifies a sparse operand —
    and the dispatch then takes the dense path."""
    x, pd, ps, jd, js = mk_sparse(12, 9, 4, 3)
    y = (RNG.normal(size=(12, 9)) + 2.0).astype(np.float32)
    pdd = pt.from_array(y, (5, 2), device="cpu")
    jdd = jx.from_array(jnp.asarray(y), (5, 2))
    for build in (lambda d, s: d * s, lambda d, s: s * d,
                  lambda d, s: d / (s + 2.0), lambda d, s: s / d,
                  lambda d, s: d + s, lambda d, s: s - d.tosparse()):
        assert_same(build(pdd, ps), build(jdd, js))


def test_nonlinear_data_map_after_index_merge():
    """abs/astype over sp ± sp (split entries) merge them first."""
    x, pd, ps, jd, js = mk_sparse()
    y, pb, psb, jb, jsb = mk_sparse(13, 9, 4, 3)
    pm, jm = (ps * 2.0) - psb, (js * 2.0) - jsb
    assert not pm.blocks.unique_indices
    assert_same(pm.abs(), jm.abs())
    assert_same(pm.astype(torch.int32), jm.astype(jnp.int32))
    assert_same(pm.map_blocks(torch.square), jm.map_blocks(jnp.square))


def test_transpose_reductions_mean_norm():
    x, pd, ps, jd, js = mk_sparse(11, 7, 3, 3)
    assert_same(ps.T, js.T)
    assert_same(ps.sum(), js.sum())
    for axis in (0, 1):
        assert_same(ps.sum(axis=axis), js.sum(axis=axis))
        assert_same(ps.min(axis=axis), js.min(axis=axis))
        assert_same(ps.mean(axis=axis), js.mean(axis=axis))
    assert_same(ps.max(), js.max())
    assert float(ps.norm()) == pytest.approx(float(js.norm()), rel=1e-5)
    xi, pdi, psi, jdi, jsi = mk_sparse(9, 5, 4, 2, np.int32)
    assert_same(psi.sum(), jsi.sum())
    assert_same(psi.sum(axis=1), jsi.sum(axis=1))
    assert_same(psi.mean(axis=0), jsi.mean(axis=0))


def test_structural_ops_densify_but_match():
    x, pd, ps, jd, js = mk_sparse(17, 13, 4, 3)
    for key in ((slice(2, 9), slice(1, 7)), [0, 5, 12, 3]):
        assert_same(ps[key], js[key])
    assert_same(ps.rechunk((5, 2)), js.rechunk((5, 2)))
    y, pb, psb, jb, jsb = mk_sparse(17, 13, 4, 3)
    assert_same(pt.concat_rows([ps, psb]), jx.concat_rows([js, jsb]))
    out = pt.exact_shuffle(torch.Generator().manual_seed(5), ps)
    assert out.block_format == "dense"
    assert sorted(out.collect().numpy().ravel().tolist()) == \
        sorted(x.ravel().tolist())


def test_grid_padding_keeps_invariant():
    x, pd, ps, jd, js = mk_sparse(10, 6, 4, 3)
    assert_same(ps._pad_grid_to((5, 4)), js._pad_grid_to((5, 4)))
    assert ps._pad_grid_to((5, 4)).stacked_grid == (5, 4)


def test_canonicalize_matches_reference_capacity():
    x, pd, ps, jd, js = mk_sparse(12, 9, 4, 3, density=0.6)
    y, pb, psb, jb, jsb = mk_sparse(12, 9, 4, 3, density=0.6)
    for p, j in ((ps + psb, js + jsb), ((ps - psb) + ps, (js - jsb) + js)):
        assert_same(psparse.canonicalize(p), jsparse_mod.canonicalize(j))
        assert_same(psparse.canonicalize(p, nse=7),
                    jsparse_mod.canonicalize(j, nse=7))


# ---------------------------------------------------------------------------
# sp @ dense / spᵀ @ dense / sparse reductions never densify
# ---------------------------------------------------------------------------


def test_spmm_matches_and_never_densifies(no_densify):
    x, pd, ps, jd, js = mk_sparse(24, 18, 6, 6, density=0.2)
    w = RNG.normal(size=(18, 10)).astype(np.float32)
    pw = pt.from_array(w, (6, 5), device="cpu")
    before = mops._DISPATCHES.as_dict()
    with no_densify():
        out = ps @ pw
        again = ps @ pw
    after = mops._DISPATCHES.as_dict()
    assert after["dispatch_sparse"] == before["dispatch_sparse"] + 2
    assert after["dispatch_plain"] == before["dispatch_plain"]
    assert out.block_format == "dense"
    assert_same(out, js @ jx.from_array(jnp.asarray(w), (6, 5)))
    np.testing.assert_allclose(out.collect().numpy(), x @ w, **TOL)
    assert torch.equal(again.collect(), out.collect())   # same bits


def test_spmm_transpose_a_never_densifies(no_densify):
    x, pd, ps, jd, js = mk_sparse(20, 12, 5, 4, density=0.25)
    w = RNG.normal(size=(20, 6)).astype(np.float32)
    pw = pt.from_array(w, (5, 3), device="cpu")
    with no_densify():
        out = pt.matmul_ta(ps, pw)
        eager_t = ps.T @ pw
    assert_same(out, jx.matmul_ta(js, jx.from_array(jnp.asarray(w), (5, 3))))
    # the eager transpose then a plain product: the same entry order, so
    # the same bits as the folded form
    assert torch.equal(eager_t.collect(), out.collect())


def test_sparse_matvec():
    x, pd, ps, jd, js = mk_sparse(24, 18, 6, 6, density=0.1)
    v = RNG.normal(size=(18, 1)).astype(np.float32)
    assert_same(ps @ pt.from_array(v, (6, 1), device="cpu"),
                js @ jx.from_array(jnp.asarray(v), (6, 1)))


def test_small_chunks_give_the_same_sums(monkeypatch):
    """A product split into many chunks of stored entries (rows cut between
    chunks) sums to the one-chunk product."""
    x, pd, ps, jd, js = mk_sparse(24, 18, 6, 6, density=0.4)
    w = pt.from_array(RNG.normal(size=(18, 5)).astype(np.float32), (6, 5),
                      device="cpu")
    whole = ps @ w
    monkeypatch.setattr(mops, "_CHUNK_FLOOR", 1)
    monkeypatch.setattr(mops, "_CHUNK_SHARE", 1 << 40)   # one entry a chunk
    np.testing.assert_allclose((ps @ w).collect().numpy(),
                               whole.collect().numpy(), rtol=1e-6, atol=1e-6)


def test_sparse_reductions_never_densify(no_densify):
    x, pd, ps, jd, js = mk_sparse(24, 18, 6, 6, density=0.2)
    with no_densify():
        got = [ps.sum(), ps.sum(axis=0), ps.sum(axis=1)]
    for p, j in zip(got, [js.sum(), js.sum(axis=0), js.sum(axis=1)]):
        assert_same(p, j)


def test_sparse_elementwise_never_densifies(no_densify):
    x, pd, ps, jd, js = mk_sparse(24, 18, 6, 6, density=0.2)
    y = (RNG.normal(size=x.shape) + 2.0).astype(np.float32)
    pb = pt.from_array(y, (6, 6), device="cpu")
    jb = jx.from_array(jnp.asarray(y), (6, 6))
    with no_densify():
        got = [ps * pb, ps * 2.0, ps.abs().sqrt()]
        out = psparse.gather_fn(torch.mul, True)(ps.blocks, pb.blocks)
    for p, j in zip(got, [js * jb, js * 2.0, js.abs().sqrt()]):
        assert_same(p, j)
    assert out.data.shape == ps.blocks.data.shape


def test_pair_multiply_capacity_is_the_smaller_nse():
    """The deviation from the reference: sp * sp keeps ``min(nse_l, nse_r)``
    slots, where jax's ``bcoo_multiply_sparse`` keeps ``nse_l · nse_r``;
    the values are equal, split entries included."""
    x, pd, ps, jd, js = mk_sparse(16, 12, 4, 4, density=0.5)
    y, pb, psb, jb, jsb = mk_sparse(16, 12, 4, 4, density=0.2)
    split = ps + ps                                        # duplicates
    for p, q, j, k in ((ps, psb, js, jsb), (split, psb, js + js, jsb),
                       (ps, ps, js, js)):
        got, want = p * q, j * k
        assert got.blocks.nse == min(p.blocks.nse, q.blocks.nse)
        assert want.blocks.nse == j.blocks.nse * k.blocks.nse
        assert_same(got, want, nse=False)
    assert psb.blocks.nse < ps.blocks.nse


def test_inferred_metadata_equals_eager_on_sparse_nodes():
    """Every node of a sparse plan: meta (inferred on meta tensors) equals
    what running the node gives, ``nse`` included."""
    x, pd, ps, jd, js = mk_sparse(16, 12, 4, 4)
    y, pb, psb, _, _ = mk_sparse(16, 12, 4, 4)
    with pt.lazy():
        roots = [((ps * 2.0) - psb).abs(), ps * psb, ps * pb, (ps + 1.0),
                 ps.T.sum(axis=0), pd.lazy().tosparse(nse=10),
                 ps.lazy().todense(),
                 ps[0:8], pexpr.LazyDsArray(pexpr.Canonicalize(
                     (ps + psb).expr, 9)), ps.astype(torch.float64)]
    seen, vals = set(), {}

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        for c in n.children:
            walk(c)
        vals[id(n)] = n.value if isinstance(n, pexpr.Leaf) else \
            n.lower(*[vals[id(c)] for c in n.children])
        got, meta = vals[id(n)], n.meta
        assert (got.shape, got.stacked_grid, got.dtype, got.pad_state,
                got.block_format) == (meta.shape, meta.stacked_grid,
                                      meta.dtype, meta.pad_state,
                                      meta.block_format), n
        if got.is_sparse:
            assert got.blocks.nse == meta.blocks.nse, n
        got.check_invariants()

    with pexpr.suspend_lazy():
        for r in roots:
            walk(r.expr)


# ---------------------------------------------------------------------------
# Lazy integration: formats in metadata, fusion boundary, CSE + cache
# ---------------------------------------------------------------------------


def test_lazy_sparse_formats_and_values():
    x, pd, ps, jd, js = mk_sparse()
    y = (RNG.normal(size=x.shape) + 2.0).astype(np.float32)
    pb = pt.from_array(y, pd.block_shape, device="cpu")
    jb = jx.from_array(jnp.asarray(y), jd.block_shape)

    def chains(s, b):
        return [((s * 2.0) - b.tosparse()).abs(), (s * 3.0) + 1.0, s * b]

    with pt.lazy():
        lp = chains(ps, pb)
    with repro.lazy():
        lj = chains(js, jb)
    for p, j, fmt in zip(lp, lj, ("bcoo", "dense", "bcoo")):
        assert p.block_format == j.block_format == fmt
        assert_same(p.compute(), j.compute())


def test_lazy_sparse_is_fusion_boundary_but_cses_and_caches():
    def stats(lazy_mod, plan_mod, s, a):
        with lazy_mod():
            chain = ((s * 2.0) * 3.0).abs()
        with lazy_mod():
            dense_chain = ((a * 2.0) * 3.0).abs()
        return (plan_mod.plan_for(chain).stats["fused_elementwise"],
                plan_mod.plan_for(dense_chain).stats["fused_elementwise"])

    x, pd, ps, jd, js = mk_sparse(16, 12, 4, 4)
    assert stats(pt.lazy, pplan, ps, pd) == stats(repro.lazy, jplan, js, jd) \
        == (0, 2)
    with pt.lazy():
        c = ps * 2.0
        s0, s1 = c.sum(axis=0), c.sum(axis=1)
    p = pplan.plan_for(s0, s1)
    assert p.roots[0].children[0] is p.roots[1].children[0]
    # the cache: same structure and capacity on fresh data hits
    for plan_mod, lazy_mod, side in ((pplan, pt.lazy, 0), (jplan, repro.lazy, 1)):
        plan_mod.clear_cache()
        for _ in range(3):
            a = mk_sparse(16, 12, 4, 4)[1 + 2 * side]
            with lazy_mod():
                r = (a.tosparse(nse=8) * 2.0).sum(axis=0)
            r.compute()
        with lazy_mod():
            r = (mk_sparse(16, 12, 4, 4)[1 + 2 * side].tosparse(nse=16)
                 * 2.0).sum(axis=0)
        r.compute()
    pst, jst = pplan.cache_stats(), jplan.cache_stats()
    assert (pst["misses"], pst["hits"]) == (jst["misses"], jst["hits"]) == (2, 2)


def test_lazy_conversion_nodes():
    x, pd, ps, jd, js = mk_sparse()
    with pt.lazy():
        r = pd.lazy().tosparse(nse=16) * 2.0
        d = ps.lazy().todense() + 1.0
    with repro.lazy():
        rj = jd.lazy().tosparse(nse=16) * 2.0
        dj = js.lazy().todense() + 1.0
    assert r.block_format == "bcoo" and d.block_format == "dense"
    assert r.expr.meta.blocks.nse == 16
    assert_same(r.compute(), rj.compute())
    assert_same(d.compute(), dj.compute())
    with pytest.raises(ValueError):
        pd.lazy().tosparse()           # a lazy conversion needs nse


# ---------------------------------------------------------------------------
# Algorithms accept sparse inputs
# ---------------------------------------------------------------------------


def _blob_points(n=40, m=12):
    c0 = np.zeros(m)
    c0[1] = 5.0
    c1 = np.zeros(m)
    c1[7] = -5.0
    return np.stack([(c0 if i % 2 == 0 else c1)
                     + (RNG.random(m) < 0.2) * RNG.normal(size=m) * 0.1
                     for i in range(n)]).astype(np.float32)


def test_kmeans_sparse_matches_reference():
    """Fit centers within 1e-4 of the reference's sparse fit (and of the
    port's dense fit); predict and score agree."""
    pts = _blob_points()
    pxs = pt.from_array(pts, (8, 5), device="cpu").tosparse()
    jxs = jx.from_array(jnp.asarray(pts), (8, 5)).tosparse()
    kp = PKMeans(n_clusters=2, seed=1).fit(pxs)
    kj = JKMeans(n_clusters=2, seed=1).fit(jxs)
    kd = PKMeans(n_clusters=2, seed=1).fit(pt.from_array(pts, (8, 5),
                                                         device="cpu"))
    np.testing.assert_allclose(kp.centers_.numpy(), np.asarray(kj.centers_),
                               atol=1e-4)
    np.testing.assert_allclose(np.sort(kp.centers_.numpy(), axis=0),
                               np.sort(kd.centers_.numpy(), axis=0), atol=1e-4)
    assert kp.n_iter_ == kj.n_iter_
    labels = kp.predict(pxs)
    assert labels.shape == (40, 1)
    np.testing.assert_array_equal(labels.collect().numpy(),
                                  np.asarray(kj.predict(jxs).collect()))
    assert kp.score(pxs) == pytest.approx(kj.score(jxs), rel=1e-4, abs=1e-4)


def test_kmeans_sparse_random_data_matches_reference():
    x, pd, ps, jd, js = mk_sparse(60, 14, 16, 5, density=0.3)
    kp = PKMeans(n_clusters=3, max_iter=10, seed=4).fit(ps)
    kj = JKMeans(n_clusters=3, max_iter=10, seed=4).fit(js)
    np.testing.assert_allclose(kp.centers_.numpy(), np.asarray(kj.centers_),
                               atol=1e-4)


def test_kmeans_sparse_assignment_never_densifies(no_densify):
    x, pd, ps, jd, js = mk_sparse(24, 12, 6, 4, density=0.2)
    gn, gm, bn, bm = ps.blocks.shape
    centers = torch.from_numpy(RNG.normal(size=(3, gm * bm)).astype(np.float32))
    row_valid = torch.ones((gn, bn), dtype=torch.bool)
    with no_densify():
        x_sq = pkmeans._row_sq_norms(ps)
        labels, sums, counts = pkmeans._sparse_center_stats(ps, row_valid,
                                                            centers, x_sq)
    xp = np.zeros((gn * bn, gm * bm), np.float32)
    xp[:24, :12] = x
    d = ((xp[:, None, :] - centers.numpy()[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(labels.reshape(-1).numpy(), d.argmin(1))
    onehot = np.eye(3, dtype=np.float32)[d.argmin(1)]
    np.testing.assert_allclose(sums.numpy(), onehot.T @ xp, **TOL)
    np.testing.assert_allclose(counts.numpy(), onehot.sum(0))
    np.testing.assert_allclose(x_sq.reshape(-1).numpy(), (xp * xp).sum(1), **TOL)


def test_pca_gram_als_sparse():
    """The ``gram`` half (PCA and ALS wait for the port's estimators)."""
    x, pd, ps, jd, js = mk_sparse(30, 10, 8, 4, density=0.25)
    got = pt.gram(ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx.gram(js)), **TOL)
    np.testing.assert_allclose(got.numpy(), x.T @ x, atol=1e-3)
    assert got.dtype == torch.float32


def test_fetch_row_dense_matches_reference():
    x, pd, ps, jd, js = mk_sparse(13, 9, 4, 3, density=0.5)
    for p, j in ((ps, js), (ps + ps, js + js)):
        for i in (0, 5, 12):
            np.testing.assert_allclose(psparse.fetch_row_dense(p, i).numpy(),
                                       np.asarray(jsparse_mod.fetch_row_dense(j, i)),
                                       **TOL)


# ---------------------------------------------------------------------------
# Sparse-native aligned slicing + lazy nse re-compaction
# ---------------------------------------------------------------------------


ALIGNED_KEYS = [
    (slice(0, 8), slice(None)),          # aligned rows, full cols
    (slice(4, 21), slice(0, 6)),         # aligned both, stop at edge
    (slice(0, 7), slice(3, 11)),         # stop mid-block (data mask)
    (slice(8, 8), slice(None)),          # empty selection
    (slice(None), slice(6, 13)),         # full rows, aligned cols
    (0, slice(None)),                    # aligned single row
    (slice(12, 21), slice(9, 13)),       # tail blocks
]
_AX, _APD, _APS, _AJD, _AJS = mk_sparse(21, 13, 4, 3)


@pytest.mark.parametrize("key", ALIGNED_KEYS, ids=str)
def test_sparse_aligned_slice_stays_bcoo_and_matches_dense(key):
    out = _APS[key]
    assert out.block_format == "bcoo"
    assert_same(out, _AJS[key])
    dense = _APD[key]
    assert out.shape == dense.shape and out.block_shape == dense.block_shape
    np.testing.assert_allclose(out.collect().numpy(), dense.collect().numpy())


def test_sparse_unaligned_selections_densify():
    assert _APS[1:5].block_format == _AJS[1:5].block_format == "dense"
    assert _APS[[0, 5, 2]].block_format == "dense"


def test_sparse_aligned_slice_no_todense_in_plan(no_densify):
    """The lazy slice of a sparse array runs without any densify and stays
    a batch-dim slice of data/indices."""
    lz = _APS.lazy()[0:8, 0:6]
    assert lz.block_format == "bcoo"
    with no_densify():
        out = lz.compute()
    assert out.blocks.nse == _APS.blocks.nse
    out.check_invariants()
    assert_same(out, _AJS.lazy()[0:8, 0:6].compute())


def test_rows_to_dense_matches_collect():
    x, pd, ps, jd, js = mk_sparse(19, 11, 4, 3)
    np.testing.assert_allclose(psparse.rows_to_dense(ps).numpy(), x)
    np.testing.assert_allclose(psparse.rows_to_dense(pd).numpy(), x)
    np.testing.assert_allclose(psparse.rows_to_dense(ps + ps).numpy(),
                               np.asarray(jsparse_mod.rows_to_dense(js + js)),
                               **TOL)


def test_lazy_sparse_chain_recompacts_nse():
    """A recorded sp ± sp chain inserts a capacity-cutting Canonicalize once
    the capacity passes the block bound, as the reference does; a scalar
    data map stays untouched."""
    triples = [mk_sparse(8, 6, 2, 3, density=0.5) for _ in range(6)]
    lp, lj = triples[0][2].lazy(), triples[0][4].lazy()
    ep, ej = triples[0][2], triples[0][4]
    for t in triples[1:]:
        lp, lj = lp + t[2], lj + t[4]
        ep, ej = ep + t[2], ej + t[4]
    assert ep.blocks.nse == ej.blocks.nse > 6
    assert lp.expr.meta.blocks.nse == lj.expr.meta.blocks.nse <= 6

    def kinds(root):
        seen, out = set(), set()

        def walk(n):
            if id(n) not in seen:
                seen.add(id(n))
                out.add(type(n).__name__)
                for c in n.children:
                    walk(c)
        walk(root)
        return out

    assert "Canonicalize" in kinds(pplan.plan_for(lp).roots[0])
    assert_same(lp.compute(), lj.compute())
    assert_same(lp.compute(), ej, nse=False)
    small = triples[0][2].lazy() * 2.0
    assert "Canonicalize" not in kinds(pplan.plan_for(small).roots[0])


def test_recompaction_costmodel_law():
    assert not pcostmodel.bcoo_recompaction_pays(5, 6)
    assert pcostmodel.bcoo_recompaction_pays(7, 6)
    saved = pcostmodel.bcoo_recompaction_saved_bytes(12, 6, 4, e=4)
    assert saved == jcostmodel.bcoo_recompaction_saved_bytes(12, 6, 4, e=4) == \
        4 * (pcostmodel.bcoo_bytes(12, 4) - pcostmodel.bcoo_bytes(6, 4))
