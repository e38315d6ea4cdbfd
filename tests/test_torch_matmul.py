"""The port's stacked GEMM against the JAX package's Pallas kernel.

The port's ``local_matmul`` on CPU tensors (its plain version) must agree
with ``stacked_matmul(interpret=True)`` and ``local_matmul(backend=
"einsum")`` on the same NumPy inputs, and the port's 2-D ``matmul`` with the
reference's ``matmul(interpret=True)``, at the reference's tolerances:
``1e-4·bk`` in fp32 and ``3e-2·bk`` in f16/bf16 (``tests/test_gemm.py``).
The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.matmul.kernel import stacked_matmul as jax_stacked_matmul  # noqa: E402
from repro.kernels.matmul.ops import local_matmul as jax_local_matmul  # noqa: E402
from repro.kernels.matmul.ops import matmul as jax_matmul  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.matmul import kernel  # noqa: E402
from repro_torch.kernels.matmul.ops import _DISPATCHES, local_matmul, matmul  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "f16": (torch.float16, jnp.float16),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _operand(rng, shape, name):
    """The same values as a torch tensor and a jax array in dtype ``name``
    (values are rounded to the dtype once, through torch)."""
    tdt, jdt = DTYPES[name]
    t = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(tdt)
    return t, jnp.asarray(t.float().numpy(), jdt)


def _tol(name, bk):
    return (1e-4 if name == "f32" else 3e-2) * bk


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy().astype(np.float64),
                               np.asarray(ref, np.float64), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["f32", "f16", "bf16"])
@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("dims", [(2, 2, 2, 8, 8, 8),      # aligned
                                  (2, 3, 2, 5, 7, 3),      # ragged
                                  (1, 2, 3, 9, 4, 6)],
                         ids=["aligned", "ragged", "ragged2"])
def test_local_matmul_matches_pallas_and_einsum(dims, transpose_a, dtype):
    gi, gk, gj, bn, bk, bm = dims
    rng = np.random.default_rng(sum(dims) + 7 * transpose_a)
    a_shape = (gk, gi, bk, bn) if transpose_a else (gi, gk, bn, bk)
    ta, ja = _operand(rng, a_shape, dtype)
    tb, jb = _operand(rng, (gk, gj, bk, bm), dtype)
    before = _DISPATCHES["dispatch_plain"]
    out = local_matmul(ta, tb, transpose_a=transpose_a)
    assert _DISPATCHES["dispatch_plain"] == before + 1
    pallas = jax_stacked_matmul(ja, jb, interpret=True, transpose_a=transpose_a)
    einsum = jax_local_matmul(ja, jb, backend="einsum", transpose_a=transpose_a)
    assert tuple(out.shape) == pallas.shape == (gi, gj, bn, bm)
    assert str(out.dtype).replace("torch.", "") == str(pallas.dtype)
    _close(out, pallas, _tol(dtype, bk))
    _close(out, einsum, _tol(dtype, bk))


def test_local_matmul_mixed_dtypes_promote():
    rng = np.random.default_rng(1)
    ta, ja = _operand(rng, (2, 2, 4, 5), "f16")
    tb, jb = _operand(rng, (2, 1, 5, 3), "f32")
    out = local_matmul(ta, tb)
    ref = jax_local_matmul(ja, jb, backend="einsum")
    assert out.dtype == torch.float32 and str(ref.dtype) == "float32"
    _close(out, ref, _tol("f16", 5))


def test_local_matmul_rejects_inner_mismatch():
    a = torch.zeros((1, 2, 3, 4))
    b = torch.zeros((3, 1, 4, 2))
    with pytest.raises(ValueError, match="inner mismatch"):
        local_matmul(a, b)


@pytest.mark.parametrize("dtype", ["f32", "f16"])
@pytest.mark.parametrize("mkn", [(37, 50, 29), (130, 129, 1), (1, 7, 140)])
def test_matmul_2d_matches_pallas(mkn, dtype):
    m, k, n = mkn
    rng = np.random.default_rng(m * k + n)
    ta, ja = _operand(rng, (m, k), dtype)
    tb, jb = _operand(rng, (k, n), dtype)
    out = matmul(ta, tb)
    ref = jax_matmul(ja, jb, block_m=128, block_n=128, block_k=128,
                     interpret=True)
    assert tuple(out.shape) == ref.shape == (m, n)
    assert str(out.dtype).replace("torch.", "") == str(ref.dtype)
    _close(out, ref, _tol(dtype, k))


@pytest.mark.parametrize("tiles,k_steps,out_elems,want", [
    (4096, 1024, 4 * 4 * 2048 * 2048, 1),     # 8192² product: tiles fill the card
    (1, 31 * 32768, 100 * 100, 528),          # 8 M x 100 Gram: ~4 blocks per SM
    (1, 100, 100 * 100, 1),                   # shallow K: no split
    (2, 64 * 40, 2 * 128 * 128, 40),          # >= 64 K steps per split
])
def test_split_count(tiles, k_steps, out_elems, want):
    assert kernel.split_count(tiles, k_steps, out_elems, sms=132) == want


def _main_path_layouts():
    """The ds-array products of the main path, as the wrapper sees them
    (``av`` viewed as (gi, gk, bn, bk), ``b`` as (gk, gj, bk, bm)): 8192²
    with blocks 2048² stacked as (4, 4, 2048, 2048)."""
    x = torch.empty((4, 4, 2048, 2048), dtype=torch.bfloat16)
    y = torch.empty((4, 4, 2048, 2048), dtype=torch.bfloat16)
    return {"contiguous": (x, y),
            "transpose_a": (x.permute(1, 0, 3, 2), y),
            "DsArray.T view": (x.permute(1, 0, 3, 2), y)}


E = 2                                   # bytes of a bf16
BLOCK = 2048 * 2048 * E


@pytest.mark.parametrize("layout,a_k_major,a_strides", [
    # A K-major: rows of bk (4096 B), blocks of gk, then gi
    ("contiguous", True, (2048 * E, BLOCK, 4 * BLOCK)),
    # Aᵀ read in place: bn innermost, rows of bk 4096 B apart, gk, gi swapped
    ("transpose_a", False, (2048 * E, 4 * BLOCK, BLOCK)),
    ("DsArray.T view", False, (2048 * E, 4 * BLOCK, BLOCK)),
])
def test_plan_main_path_layouts_take_wgmma(layout, a_k_major, a_strides):
    av, b = _main_path_layouts()[layout]
    p = kernel.plan(av, b, sms=132)
    assert p.route == "wgmma" and p.tile == kernel.WGMMA_TILE and p.splits == 1
    assert p.a.k_major is a_k_major and p.a.strides == a_strides
    assert p.a.dims == (2048, 2048, 4, 4)
    assert p.a.box == ((64, 128) if a_k_major else (64, 64))
    # B (gk, gj, bk, bm) row-major: N-major, rows of bm, then gj, gk
    assert p.b.k_major is False and p.b.box == (64, 64)
    assert p.b.dims == (2048, 2048, 4, 4)
    assert p.b.strides == (2048 * E, BLOCK, 4 * BLOCK)


def test_plan_dsarray_transpose_is_the_strided_view():
    """``DsArray.T`` hands the GEMM the permuted view the planner sees."""
    from repro_torch.core import dsarray as dsa
    x = dsa.from_array(torch.zeros((256, 128), dtype=torch.bfloat16), (64, 64),
                       device="cpu")
    assert not x.T.blocks.is_contiguous()
    p = kernel.plan(x.T.blocks, x.blocks, sms=132)
    assert p.route == "wgmma" and p.a.k_major is False
    # bk rows 128 B apart; grid-k (the stored row grid) 2 blocks apart; gi 1
    assert p.a.strides == (64 * E, 2 * 64 * 64 * E, 64 * 64 * E)


@pytest.mark.parametrize("case", ["f32", "bk70_bf16", "offset_view", "int_like"])
def test_plan_simt_route(case):
    if case == "f32":
        a = torch.zeros((4, 4, 2048, 2048))
        b = torch.zeros((4, 4, 2048, 2048))
    elif case == "bk70_bf16":            # 140-byte rows: not a multiple of 16
        a = torch.zeros((2, 3, 50, 70), dtype=torch.bfloat16)
        b = torch.zeros((3, 2, 70, 64), dtype=torch.bfloat16)
    elif case == "offset_view":          # base 2 bytes off a 16-byte boundary
        flat = torch.zeros(1 + 2 * 2 * 64 * 64, dtype=torch.bfloat16)
        a = flat[1:].view(2, 2, 64, 64)
        b = torch.zeros((2, 2, 64, 64), dtype=torch.bfloat16)
    else:                                # neither of A's last two dims unit-stride
        a = torch.zeros((2, 2, 64, 64, 2), dtype=torch.bfloat16)[..., 0]
        b = torch.zeros((2, 2, 64, 64), dtype=torch.bfloat16)
    p = kernel.plan(a, b, sms=132)
    assert p.route == "simt" and p.tile == kernel.SIMT_TILE
    assert p.a is None and p.b is None


@pytest.mark.parametrize("dims,splits", [
    ((1, 31, 1, 100, 262144, 100), 528),   # the 8 M x 100 Gram (f32): 4 blocks/SM
    ((1, 16, 1, 128, 2048, 128), 8),       # one bf16 tile: >= 64 K steps a split
    ((4, 4, 4, 2048, 2048, 2048), 1),      # 8192²: the tiles fill the card
])
def test_plan_split_count(dims, splits):
    gi, gk, gj, bn, bk, bm = dims
    dt = torch.float32 if bk == 262144 else torch.bfloat16
    a = torch.empty((gi, gk, bn, bk), dtype=dt)
    b = torch.empty((gk, gj, bk, bm), dtype=dt)
    assert kernel.plan(a, b, sms=132).splits == splits


def test_plan_normalises_size_one_dims():
    """A dim of size 1 has no stride to check; the map gets the packed one."""
    a = torch.zeros((1, 1, 64, 48), dtype=torch.float16)
    b = torch.zeros((1, 1, 48, 40), dtype=torch.float16)
    p = kernel.plan(a, b, sms=132)
    assert p.route == "wgmma"
    assert p.a.strides == (96, 96 * 64, 96 * 64)
    assert p.b.strides == (80, 80 * 48, 80 * 48)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper checks its inputs before it touches the library, so
    a CPU tensor never reaches the kernel."""
    a = torch.zeros((1, 1, 4, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.stacked_matmul(a, a, out_dtype=torch.float32)


def test_build_dir_names_the_sources():
    d = _build._build_dir()
    assert d.parent == _build.BUILD_ROOT
    assert _build.BUILD_ROOT.parts[-2:] == ("build", "repro_torch_kernels")
    assert {p.stem for p in _build._sources()} == {
        "stacked_matmul", "kmeans_assign", "flash_attention", "ssd_chunk"}
    assert _build._build_dir() == d          # content hash: stable
