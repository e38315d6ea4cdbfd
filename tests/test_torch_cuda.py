"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither jax nor ``repro``, so on a machine with a card and no jax it runs
on its own:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.kmeans import kernel as kk  # noqa: E402
from repro_torch.kernels.kmeans.ref import kmeans_assign_stacked_ref  # noqa: E402
from repro_torch.kernels.matmul import kernel as mk  # noqa: E402
from repro_torch.kernels.matmul.ops import local_matmul  # noqa: E402
from repro_torch.kernels.matmul.ref import stacked_matmul_ref  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_cuda_int32_raises(card):
    """A CUDA tensor of a type the kernel does not take raises; it never
    falls back to the plain version."""
    a = torch.ones((1, 1, 4, 4), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        local_matmul(a, a)


@pytest.mark.parametrize("dims,dtype,transpose_a", [
    ((2, 3, 2, 50, 70, 30), torch.float32, False),
    ((2, 3, 2, 50, 70, 30), torch.bfloat16, True),
    ((1, 2, 1, 300, 9, 257), torch.float16, False),
])
def test_stacked_matmul_matches_plain(card, dims, dtype, transpose_a):
    gi, gk, gj, bn, bk, bm = dims
    g = torch.Generator(device=card).manual_seed(sum(dims))
    a_shape = (gk, gi, bk, bn) if transpose_a else (gi, gk, bn, bk)
    a = torch.randn(a_shape, generator=g, device=card).to(dtype)
    b = torch.randn((gk, gj, bk, bm), generator=g, device=card).to(dtype)
    out = mk.stacked_matmul(a, b, out_dtype=dtype, transpose_a=transpose_a)
    ref = stacked_matmul_ref(a, b, out_dtype=dtype, transpose_a=transpose_a)
    depth = gk * bk
    rms = float(ref.float().pow(2).mean().sqrt())
    atol = 8 * torch.finfo(torch.float32).eps * depth ** 0.5 * rms
    rtol = torch.finfo(dtype).eps
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


def _blobs(card, n, d, k, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 4
    x = centers[rng.integers(0, k, size=n)] + rng.normal(size=(n, d)) * 0.3
    return (torch.from_numpy(x.astype(np.float32)).to(card),
            torch.from_numpy(centers).to(card))


@pytest.mark.parametrize("n,d,k,bs", [
    (3000, 100, 64, (1024, 100)),     # the main path's layout
    (2000, 784, 10, (512, 392)),      # 32-row tiles, gm = 2
    (1500, 1000, 16, (700, 1000)),    # centers staged 8 at a time
    (1200, 784, 64, (500, 784)),      # the partial in global scratch
    (4000, 64, 1000, (1024, 64)),     # many clusters, two chunks
])
def test_kmeans_assign_matches_plain(card, n, d, k, bs):
    x, c = _blobs(card, n, d, k, seed=n + k)
    bn, bm = bs
    gn, gm = -(-n // bn), d // bm
    blocks = torch.zeros((gn * bn, d), device=card)
    blocks[:n] = x
    blocks = blocks.reshape(gn, bn, gm, bm).permute(0, 2, 1, 3).contiguous()
    l1, s1, c1 = kk.kmeans_assign_stacked(blocks, c, n)
    l2, s2, c2 = kmeans_assign_stacked_ref(blocks, c, n)
    torch.testing.assert_close(l1, l2, atol=0, rtol=0)
    torch.testing.assert_close(c1, c2, atol=0, rtol=0)
    torch.testing.assert_close(s1, s2, atol=1e-4 * float(s2.abs().max()), rtol=1e-4)
