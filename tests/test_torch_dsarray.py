"""The port's ds-array core against the JAX package, op by op.

Each case builds both arrays from one seeded NumPy input, runs the same op
on both and checks values (rtol = atol = 1e-4 for floats, exact for ints,
``tests/test_differential.py``), shape, block shape, dtype, ``pad_state``
and ``block_format``, plus ``check_invariants()`` on the port's side.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jx  # noqa: E402
import repro_torch as pt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import structural  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def assert_same(p, j):
    """Port DsArray ``p`` against reference DsArray ``j`` (or 0-d arrays)."""
    if not isinstance(j, jx.DsArray):
        assert _dtype_name(p.dtype) == str(j.dtype)
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)
        return
    assert p.shape == j.shape
    assert p.block_shape == j.block_shape
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


def both(arr, bs):
    return (pt.from_array(arr, bs, device="cpu"),
            jx.from_array(jnp.asarray(arr), bs))


RNG = np.random.default_rng(20261016)
X = RNG.normal(size=(10, 7)).astype(np.float32)
Y = RNG.normal(size=(10, 7)).astype(np.float32)
XI = RNG.integers(-50, 50, size=(10, 7)).astype(np.int32)


@pytest.mark.parametrize("shape,bs", [((7, 5), (3, 2)), ((10, 1), (4, 1)),
                                      ((1, 9), (1, 4)), ((16, 16), (4, 4)),
                                      ((5, 3), (8, 8))])
def test_from_array_ragged(shape, bs):
    arr = RNG.normal(size=shape).astype(np.float32)
    p, j = both(arr, bs)
    assert tuple(p.blocks.shape) == j.blocks.shape
    np.testing.assert_array_equal(p.blocks.numpy(), np.asarray(j.blocks))
    assert_same(p, j)


def test_from_array_narrows_64bit():
    p64 = pt.from_array(X.astype(np.float64), (3, 3), device="cpu")
    pi64 = pt.from_array(XI.astype(np.int64), (3, 3), device="cpu")
    assert p64.dtype == torch.float32 and pi64.dtype == torch.int32
    assert_same(p64, jx.from_array(jnp.asarray(X.astype(np.float64)), (3, 3)))
    assert_same(pi64, jx.from_array(jnp.asarray(XI.astype(np.int64)), (3, 3)))


BINARY = {
    "add_scalar": lambda a, b: a + 1.5,
    "radd_int": lambda a, b: 2 + a,
    "sub_scalar": lambda a, b: a - 3,
    "rsub": lambda a, b: 2.0 - a,
    "mul_scalar": lambda a, b: a * 2,
    "div_scalar": lambda a, b: a / 4,
    "div_zero": lambda a, b: a / 0,
    "rdiv": lambda a, b: 1.0 / a,
    "pow": lambda a, b: a ** 2,
    "neg": lambda a, b: -a,
    "add_array": lambda a, b: a + b,
    "mul_array": lambda a, b: a * b,
    "div_array": lambda a, b: a / b,
    "chain_fill": lambda a, b: (a + 1) * 2 - b,
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_ops_and_pad_state(name):
    op = BINARY[name]
    (px, jxa), (py, jy) = both(X, (3, 2)), both(Y, (3, 2))
    assert_same(op(px, py), op(jxa, jy))


@pytest.mark.parametrize("name", ["add_scalar", "mul_scalar", "div_scalar",
                                  "add_array", "neg"])
def test_binary_ops_int32(name):
    op = BINARY[name]
    (px, jxa), (py, jy) = both(XI, (4, 3)), both(XI[::-1].copy(), (4, 3))
    assert_same(op(px, py), op(jxa, jy))


def test_binary_rechunks_other_operand():
    (px, jxa) = both(X, (3, 2))
    (py, jy) = both(Y, (4, 5))
    assert_same(px + py, jxa + jy)


@pytest.mark.parametrize("src", ["zero", "fill", "dirty", "int"])
@pytest.mark.parametrize("op", ["sum", "max", "min", "mean"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_reductions(src, op, axis):
    if src == "int":
        p, j = both(XI, (3, 4))
    else:
        p, j = both(X, (3, 4))
        if src == "fill":
            p, j = p + 1.5, j + 1.5
        elif src == "dirty":
            py, jy = both(Y, (3, 4))
            p, j = p / py, j / jy            # 0/0 pads: DIRTY
    assert_same(getattr(p, op)(axis=axis), getattr(j, op)(axis=axis))


def test_transpose_collect_norm_astype():
    p, j = both(X, (3, 2))
    assert_same(p.T, j.T)
    assert_same(p.T.T, j.T.T)
    assert_same((p + 1.5).T, (j + 1.5).T)
    np.testing.assert_allclose(p.collect().numpy(), X)
    np.testing.assert_allclose(float(p.norm()), float(j.norm()), **TOL)
    assert_same((p + 2.5).astype(torch.int32), (j + 2.5).astype(jnp.int32))
    assert_same(p.astype(torch.float16), j.astype(jnp.float16))


BOOL_SCALAR = {
    "add_int": lambda a: a + 1,
    "mul_int": lambda a: a * 2,
    "pow_int": lambda a: a ** 2,
    "rsub_int": lambda a: 1 - a,
    "rsub_float": lambda a: 1.5 - a,
}


@pytest.mark.parametrize("name", sorted(BOOL_SCALAR))
def test_bool_with_python_scalar_takes_32_bits(name):
    """A bool ds-array with a Python int is int32 (float: float32), as the
    reference's weak scalar gives; ``1 - b`` does not raise."""
    p, j = both(X > 0, (3, 2))
    got, want = BOOL_SCALAR[name](p), BOOL_SCALAR[name](j)
    assert_same(got, want)
    assert got.dtype in (torch.int32, torch.float32)


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_unsigned_sum_accumulates_uint32(axis):
    """A uint8 sum is uint32 (``jnp.sum``'s accumulator for unsigned
    types), wide enough for sums past 255."""
    u = RNG.integers(0, 256, size=(10, 7)).astype(np.uint8)
    p, j = both(u, (3, 4))
    got, want = p.sum(axis=axis), j.sum(axis=axis)
    assert got.dtype == torch.uint32
    assert_same(got, want)


def test_astype_int32_saturates_like_the_reference():
    """+inf and 3e9 become 2147483647, NaN 0, -inf and -3e9 -2147483648,
    as the reference's cast does on the CPU (also through ``x / 0``)."""
    f = np.array([[np.inf, np.nan, 3e9, 2.5], [-np.inf, -3e9, -1.7, 7.0]],
                 np.float32)
    p, j = both(f, (1, 3))
    assert_same(p.astype(torch.int32), j.astype(jnp.int32))
    assert_same((p / 0.0).astype(torch.int32), (j / 0.0).astype(jnp.int32))
    assert_same((p + 1.5).astype(torch.int8), (j + 1.5).astype(jnp.int8))


@pytest.mark.parametrize("key", [
    3, 4, -1, slice(2, 9), slice(0, 6), slice(None, None, 2),
    slice(8, 1, -2), (slice(3, 7), slice(1, 4)), (slice(0, 6), slice(0, 4)),
    (slice(None), 2), [0, 5, 2, 9], np.array([True, False] * 5),
    (np.array([1, 1, 7]), slice(2, 7)),
], ids=lambda k: repr(k)[:40])
def test_getitem(key):
    p, j = both(X, (3, 2))
    assert_same(p[key], j[key])


def test_take_rows_cols_and_errors():
    p, j = both(X, (3, 2))
    assert_same(structural.take_rows(p, [9, 0, 4]), jx.take_rows(j, [9, 0, 4]))
    assert_same(structural.take_cols(p, [6, 1]), jx.take_cols(j, [6, 1]))
    with pytest.raises(IndexError):
        p[[10]]
    with pytest.raises(IndexError):
        p[11]


@pytest.mark.parametrize("new_bs", [(1, 7), (6, 2), (3, 4), (4, 3), (10, 7)])
def test_rechunk(new_bs):
    p, j = both(X, (3, 2))
    assert_same(p.rechunk(new_bs), j.rechunk(new_bs))
    assert_same((p + 1).rechunk(new_bs), (j + 1).rechunk(new_bs))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_matmul_mismatched_blocks(dtype):
    a = RNG.normal(size=(10, 7)) * 4
    b = RNG.normal(size=(7, 5)) * 4
    pa, ja = both(a.astype(dtype), (3, 2))
    pb, jb = both(b.astype(dtype), (3, 4))      # rechunked to (2, 4)
    assert_same(pa @ pb, ja @ jb)
    assert_same((pa + 1) @ pb, (ja + 1) @ jb)   # FILL pad is re-masked first


def test_matmul_ta_and_gram():
    (pa, ja) = both(X, (3, 2))
    (pz, jz) = both(RNG.normal(size=(10, 4)).astype(np.float32), (4, 2))
    assert_same(pt.matmul_ta(pa, pz), jx.matmul_ta(ja, jz))
    assert_same(pt.matmul_ta(pa, pa), jx.matmul_ta(ja, ja))
    assert_same(pt.gram(pa), jx.gram(ja))
    assert_same(pt.gram(pa.astype(torch.float16)), jx.gram(ja.astype(jnp.float16)))


def test_creation_routines():
    assert_same(pt.zeros((5, 7), (2, 3), device="cpu"), jx.zeros((5, 7), (2, 3)))
    assert_same(pt.full((5, 7), (2, 3), 2.5, device="cpu"),
                jx.full((5, 7), (2, 3), 2.5))
    assert_same(pt.eye(7, (3, 2), device="cpu"), jx.eye(7, (3, 2)))
    assert_same(pt.eye(5, (5, 5), dtype=torch.int32, device="cpu"),
                jx.eye(5, (5, 5), dtype=jnp.int32))


def test_random_array_distribution():
    gen = torch.Generator().manual_seed(0)
    u = pt.random_array(gen, (300, 200), (64, 48), device="cpu")
    u.check_invariants()
    vals = u.collect()
    assert u.pad_state.kind == "zero" and u.shape == (300, 200)
    assert 0.0 <= float(vals.min()) and float(vals.max()) < 1.0
    assert abs(float(vals.mean()) - 0.5) < 0.01
    g = pt.random_array(gen, (300, 200), (64, 48), distribution="normal",
                        device="cpu").collect()
    assert abs(float(g.mean())) < 0.02 and abs(float(g.std()) - 1.0) < 0.02


@pytest.mark.parametrize("pad", ["zero", "fill", "dirty"])
def test_convert_dsarray_from_numpy(pad):
    j = jx.from_array(jnp.asarray(X), (3, 2))
    j = {"zero": j * 2, "fill": j + 1.5, "dirty": j / 0.0}[pad]
    p = convert.dsarray_from_numpy(np.asarray(j.blocks), j.shape, j.block_shape,
                                   j.pad_state.kind, j.pad_state.fill,
                                   device="cpu")
    assert_same(p, j)
    assert_same(p.sum(axis=0), j.sum(axis=0))


def test_full_casts_the_fill_into_the_dtype():
    """``full`` with a fill the dtype cannot hold stores the cast value and
    claims it: FILL(1) for 1.5 in int32, and ``check_invariants`` passes.
    (The reference claims FILL(1.5) over data holding 1, which its own
    ``check_invariants`` rejects: ``repro/core/dsarray.py:1097-1101``.)"""
    p = pt.full((5, 7), (2, 3), 1.5, dtype=torch.int32, device="cpu")
    assert p.dtype == torch.int32
    assert (p.pad_state.kind, p.pad_state.fill) == ("fill", 1)
    p.check_invariants()
    assert bool((p.collect() == 1).all())
    assert_same(p + 0, jx.full((5, 7), (2, 3), 1, dtype=jnp.int32) + 0)


@pytest.mark.parametrize("op", ["sqrt", "exp", "abs"])
@pytest.mark.parametrize("src", ["zero", "fill", "dirty"])
def test_sqrt_exp_abs(op, src):
    p, j = both(X, (3, 4))
    p, j = {"zero": (p, j), "fill": (p + 1.5, j + 1.5),
            "dirty": (p / 0.0, j / 0.0)}[src]
    if op == "sqrt":
        p, j = p.abs(), j.abs()
    assert_same(getattr(p, op)(), getattr(j, op)())


APPLY_FNS = {  # name: (port fn, reference fn)
    "norm": (lambda v: torch.sqrt(torch.sum(v * v)),
             lambda v: jnp.sqrt(jnp.sum(v * v))),
    "max": (lambda v: v.max(), lambda v: v.max()),
    "min_max": (lambda v: torch.stack([v.min(), v.max()]),
                lambda v: jnp.stack([v.min(), v.max()])),
    "scaled": (lambda v: v * 2.0 + 1.0, lambda v: v * 2.0 + 1.0),
}


@pytest.mark.parametrize("name", sorted(APPLY_FNS))
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("src", ["zero", "fill"])
def test_apply_along_axis(name, axis, src):
    """Scalar and vector ``fn`` on both axes, ragged edge blocks, a FILL
    pad (zeroed first, as the reference does)."""
    fn, jfn = APPLY_FNS[name]
    p, j = both(X, (3, 4))
    if src == "fill":
        p, j = p + 1.5, j + 1.5
    assert_same(pt.apply_along_axis(fn, axis, p),
                jx.apply_along_axis(jfn, axis, j))


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("bs", [(3, 4), (10, 7), (4, 2)])
def test_norm_axis(axis, bs):
    p, j = both(X, bs)
    assert_same(p.norm(axis=axis), j.norm(axis=axis))
    np.testing.assert_allclose(
        np.asarray(p.norm(axis=axis).collect() if axis is not None
                   else p.norm()).reshape(-1),
        np.linalg.norm(X.astype(np.float64), axis=axis).reshape(-1), **TOL)


@pytest.mark.parametrize("n,bs,dtype", [(7, (3, 2), torch.float32),
                                        (6, (6, 6), torch.int32),
                                        (5, (2, 4), torch.float16)])
def test_identity_like(n, bs, dtype):
    p = pt.zeros((n, n), bs, dtype=dtype, device="cpu")
    j = jx.zeros((n, n), bs, dtype=jnp.dtype(_dtype_name(dtype)))
    assert_same(pt.identity_like(p), jx.identity_like(j))
    with pytest.raises(ValueError, match="square"):
        pt.identity_like(pt.zeros((3, 4), (2, 2), device="cpu"))


CONCAT_CASES = {  # name: list of (rows, block shape) of the parts
    "aligned": [(6, (3, 2)), (9, (3, 2)), (4, (3, 2))],
    "ragged": [(5, (3, 2)), (7, (3, 2)), (2, (3, 2))],
    "rechunked": [(6, (3, 2)), (4, (2, 5)), (3, (4, 3))],
    "empty_part": [(6, (3, 2)), (0, (3, 2)), (5, (3, 2))],
    "one": [(7, (4, 3))],
}


@pytest.mark.parametrize("name", sorted(CONCAT_CASES))
@pytest.mark.parametrize("pad", ["zero", "fill"])
def test_concat_rows(name, pad):
    """Aligned parts take the grid stack, ragged ones the gather; parts of
    other block shapes are rechunked to the first's; FILL pads are zeroed."""
    ps, js = [], []
    for rows, bs in CONCAT_CASES[name]:
        arr = RNG.normal(size=(rows, 7)).astype(np.float32)
        p, j = both(arr, bs)
        if pad == "fill":
            p, j = p + 1.5, j + 1.5
        ps.append(p)
        js.append(j)
    got = pt.concat_rows(ps)
    assert_same(got, jx.concat_rows(js))
    np.testing.assert_array_equal(
        got.collect().numpy(), np.concatenate([q.collect().numpy() for q in ps]))
    with pytest.raises(ValueError, match="column mismatch"):
        pt.concat_rows([ps[0], pt.zeros((2, 3), (2, 3), device="cpu")])
