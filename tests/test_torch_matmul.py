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
