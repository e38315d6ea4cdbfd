"""The port's row shuffles, counterparts of ``tests/test_shuffle.py``.

``torch`` cannot replay ``jax.random``, so the shuffles are held to what a
shuffle must give, not to the reference's bits: every row keeps exactly one
copy, pseudo and exact agree as row multisets, shapes, block shapes and pad
states are the reference's, one generator state gives one result, the
exact shuffle is uniform, and no rank-2 global ``(n, m)`` tensor is ever
formed (the reference checks its jaxpr; here every torch call's output is
logged).
"""

import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

import repro.core as jx  # noqa: E402
import repro_torch as pt  # noqa: E402
from repro_torch.core import plan as pplan  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

RNG = np.random.default_rng(31)


def mk(n, m, bn, bm):
    x = (RNG.normal(size=(n, m)) + 1.0).astype(np.float32)
    return x, pt.from_array(x, (bn, bm), device="cpu"), \
        jx.from_array(jnp.asarray(x), (bn, bm))


def row_multiset(arr):
    return sorted(map(tuple, np.round(np.asarray(arr, np.float64), 5)))


def assert_pad_zero(a):
    gn, gm, bn, bm = a.blocks.shape
    g = a.blocks.permute(0, 2, 1, 3).reshape(gn * bn, gm * bm).numpy()
    n, m = a.shape
    assert np.all(g[n:] == 0) and np.all(g[:, m:] == 0)


class _Shapes(TorchFunctionMode):
    """Logs the shape of every tensor a torch call returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def global_intermediates(fn, a):
    """Rank-2 tensors of the global (n, m) or padded global shape that
    ``fn(a)`` forms."""
    n, m = a.shape
    pn, pm = a.grid.padded_shape
    with _Shapes() as log:
        out = fn(a)
    return out, [s for s in log.shapes if s in ((n, m), (pn, pm))]


@pytest.mark.parametrize("n,m,bn,bm", [(16, 6, 4, 3),    # rows tile evenly
                                       (13, 9, 4, 3),    # ragged tail
                                       (5, 5, 8, 8),     # single block
                                       (24, 4, 6, 4)])
def test_shuffles_preserve_row_multiset(n, m, bn, bm):
    x, a, ja = mk(n, m, bn, bm)
    gen = torch.Generator().manual_seed(n * 31 + m)
    key = jax.random.PRNGKey(n * 31 + m)
    ex, ps = pt.exact_shuffle(gen, a), pt.pseudo_shuffle(gen, a)
    for out, ref in ((ex, jx.exact_shuffle(key, ja)),
                     (ps, jx.pseudo_shuffle(key, ja))):
        assert (out.shape, out.block_shape, out.pad_state.kind,
                out.pad_state.fill) == (ref.shape, ref.block_shape,
                                        ref.pad_state.kind, ref.pad_state.fill)
        assert row_multiset(out.collect()) == row_multiset(x)
        out.check_invariants()
        assert_pad_zero(out.ensure_zero_pad())
    # pseudo and exact agree as row multisets: pseudo differs only in the
    # distribution of its permutations
    assert row_multiset(ps.collect()) == row_multiset(ex.collect())


def test_exact_shuffle_deterministic_and_actually_permutes():
    x, a, _ = mk(32, 5, 4, 5)
    s1 = pt.exact_shuffle(torch.Generator().manual_seed(0), a).collect()
    s2 = pt.exact_shuffle(torch.Generator().manual_seed(0), a).collect()
    assert torch.equal(s1, s2)
    assert not np.array_equal(s1.numpy(), x)   # 32 rows: identity is 1/32!
    # the generator must be on the array's device
    on_meta = pt.DsArray(a.blocks.to("meta"), a.grid)
    with pytest.raises(ValueError, match="generator"):
        pt.exact_shuffle(torch.Generator().manual_seed(0), on_meta)


def test_exact_shuffle_traces_through_a_plan():
    """The shuffle inside a recorded plan: rows move unchanged, and a second
    recording with fresh draws replays the cached plan (the permutation is
    a plan input, not plan structure)."""
    x, a, _ = mk(24, 6, 5, 5)
    pplan.clear_cache()
    gen = torch.Generator().manual_seed(3)
    outs = [(pt.exact_shuffle(gen, a.lazy()) * 2.0).compute() for _ in range(2)]
    for out in outs:
        assert row_multiset(out.collect()) == row_multiset(2.0 * x)
    assert not torch.equal(outs[0].collect(), outs[1].collect())
    st = pplan.cache_stats()
    assert (st["misses"], st["hits"], st["opt_runs"]) == (1, 1, 1), st


def test_exact_shuffle_no_global_intermediate():
    _, a, _ = mk(64, 48, 8, 8)
    gen = torch.Generator().manual_seed(0)
    out, bad = global_intermediates(lambda t: pt.exact_shuffle(gen, t), a)
    assert not bad, f"global-shape intermediates produced: {bad}"
    assert out.shape == a.shape
    # the control: collect() forms one
    assert global_intermediates(lambda t: t.collect(), a)[1]


def test_pseudo_shuffle_ragged_falls_back_to_exact_blockwise():
    """Ragged rows: pseudo takes the exact shuffle, which stays
    block-native and content-preserving; its draws are the exact
    shuffle's."""
    x, a, ja = mk(13, 9, 4, 3)
    out, bad = global_intermediates(
        lambda t: pt.pseudo_shuffle(torch.Generator().manual_seed(5), t), a)
    assert not bad, bad
    assert row_multiset(out.collect()) == row_multiset(x)
    assert torch.equal(out.collect(), pt.exact_shuffle(
        torch.Generator().manual_seed(5), a).collect())
    assert out.pad_state.kind == jx.pseudo_shuffle(jax.random.PRNGKey(0),
                                                   ja).pad_state.kind


@pytest.mark.parametrize("kind", ["exact", "pseudo"])
def test_shuffle_distribution(kind):
    """exact: all 4! orders of 4 rows about equally often.  pseudo (2 block
    rows of 2): the 2!·2!·2! = 8 orders it can give, about equally often,
    and never one that splits a block-row."""
    _, a, _ = mk(4, 1, 2, 1)
    gen = torch.Generator().manual_seed(11)
    fn = pt.exact_shuffle if kind == "exact" else pt.pseudo_shuffle
    rows = a.collect().reshape(-1).tolist()
    draws = 4800
    seen = {}
    for _ in range(draws):
        order = tuple(rows.index(v) for v in fn(gen, a).collect().reshape(-1).tolist())
        seen[order] = seen.get(order, 0) + 1
    if kind == "exact":
        want = set(itertools.permutations(range(4)))
    else:
        want = {p for p in itertools.permutations(range(4))
                if {p[0] // 2, p[1] // 2} in ({0}, {1})}
    assert set(seen) == want
    expected = draws / len(want)
    # each count within 5 binomial standard deviations of its mean
    sd = math.sqrt(expected * (1 - 1 / len(want)))
    assert all(abs(c - expected) < 5 * sd for c in seen.values()), seen
