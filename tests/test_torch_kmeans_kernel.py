"""The port's K-means assignment against the JAX package's Pallas kernel.

``kmeans_assign`` and ``kmeans_assign_stacked`` of the port (plain version,
CPU) against ``kmeans_assign(interpret=True)`` and ``kmeans_assign_ref`` on
the same well-separated blobs: labels exact (``tests/test_kernels.py``),
sums at rtol = atol = 1e-4 (``tests/test_differential.py``), counts exact.
The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import from_array as jax_from_array  # noqa: E402
from repro.kernels.kmeans.ops import kmeans_assign as jax_kmeans_assign  # noqa: E402
from repro.kernels.kmeans.ref import kmeans_assign_ref as jax_kmeans_assign_ref  # noqa: E402
from repro_torch.kernels.kmeans import kernel  # noqa: E402
from repro_torch.kernels.kmeans.ops import (kmeans_assign,  # noqa: E402
                                            kmeans_assign_ref,
                                            kmeans_assign_stacked)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _blobs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(k, d)) * 4).astype(np.float32)
    labels = rng.integers(0, k, size=n)
    x = centers[labels] + rng.normal(size=(n, d)).astype(np.float32) * 0.3
    jitter = rng.normal(size=(k, d)).astype(np.float32) * 0.1
    return x.astype(np.float32), centers + jitter


@pytest.mark.parametrize("n,d,k", [(10, 2, 2), (300, 16, 5), (600, 130, 17),
                                   (257, 33, 8), (129, 7, 3),
                                   (40, 2560, 17)])   # zamba2-2.7b's width
def test_kmeans_assign_matches_pallas(n, d, k):
    x, c = _blobs(n, d, k, seed=n + d + k)
    labels, sums, counts = kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    jl, js, jc = jax_kmeans_assign(jnp.asarray(x), jnp.asarray(c), block_n=128,
                                   interpret=True)
    rl, rs, rc = jax_kmeans_assign_ref(jnp.asarray(x), jnp.asarray(c))
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (n,)
    assert sums.dtype == torch.float32 and tuple(sums.shape) == (k, d)
    assert counts.dtype == torch.float32 and tuple(counts.shape) == (k,)
    for ref_l, ref_s, ref_c in ((jl, js, jc), (rl, rs, rc)):
        np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_l))
        np.testing.assert_allclose(sums.numpy(), np.asarray(ref_s), **TOL)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_c))


def test_kmeans_assign_ref_matches_reference_oracle():
    x, c = _blobs(200, 9, 4, seed=3)
    got = kmeans_assign_ref(torch.from_numpy(x), torch.from_numpy(c))
    want = jax_kmeans_assign_ref(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("n,d,k,bs", [(250, 120, 17, (100, 60)),   # gm = 2
                                      (300, 33, 5, (128, 11)),     # gm = 3
                                      (97, 16, 12, (40, 16)),
                                      (600, 130, 9, (600, 130))])
def test_kmeans_assign_stacked_matches_pallas(n, d, k, bs):
    x, c = _blobs(n, d, k, seed=n * k)
    blocks = np.array(jax_from_array(jnp.asarray(x), bs).blocks)
    gn, gm, bn, bm = blocks.shape
    c_pad = np.zeros((k, gm * bm), np.float32)
    c_pad[:, :d] = c
    labels, sums, counts = kmeans_assign_stacked(
        torch.from_numpy(blocks), torch.from_numpy(c_pad), n)
    jl, js, jc = jax_kmeans_assign(jnp.asarray(x), jnp.asarray(c), block_n=128,
                                   interpret=True)
    assert tuple(labels.shape) == (gn * bn,)
    np.testing.assert_array_equal(labels[:n].numpy(), np.asarray(jl))
    assert (labels[n:] == -1).all()
    np.testing.assert_allclose(sums[:, :d].numpy(), np.asarray(js), **TOL)
    assert (sums[:, d:] == 0).all()
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))


class _SmemLib:
    """Stands in for the built library's shared-memory queries."""

    def __init__(self, limit):
        self.limit = limit

    def kmeans_assign_smem_limit(self, device):
        return self.limit

    @staticmethod
    def kmeans_assign_smem_bytes(k, d, rows, chunk, smem_partial, d_slice):
        # the layouts of csrc/kmeans_assign.cu
        if d_slice:
            return 4 * (chunk * d_slice + rows * (d_slice | 1) + chunk + 2 * 256)
        kpad = -(-k // 8) * 8
        partial = k * (d + 1) if smem_partial else 0
        return 4 * (chunk * d + kpad + partial + rows * (d | 1) + rows + 2 * 256)


@pytest.mark.parametrize("k,d,plan", [
    (64, 100, (256, 64, True, 0)),       # the main path: all on chip, one chunk
    (10, 784, (32, 16, True, 0)),        # MNIST-sized, 10 clusters
    (16, 1000, (32, 8, True, 0)),        # centers staged 8 at a time
    (64, 784, (32, 32, False, 0)),       # MNIST-sized, 64 clusters: global partial
    (1000, 64, (256, 504, False, 0)),    # many clusters: two chunks
    (64, 2560, (32, 64, False, 256)),    # zamba2-2.7b hidden states: D-tiled
    (5, 2560, (32, 8, False, 256)),      # D-tiled, one group of centers
    (1000, 16384, (32, 64, False, 256)),  # D-tiled, 16 chunks of centers
])
def test_tile_rows_fit_shared_memory(k, d, plan):
    lib = _SmemLib(232448)                       # sm_90 opt-in limit
    got = kernel.launch_plan(lib, k, d, 0)
    assert tuple(got) == plan
    assert lib.kmeans_assign_smem_bytes(k, d, *got) <= lib.limit


def test_launch_plan_raises_past_one_tile():
    """Rows wider than one 32-row tile and 8 centers fill (~1,450 features)
    take the D-tiled layout instead of raising, at any k."""
    lib = _SmemLib(232448)
    for d in (2560, 4096):
        for k in (1, 16, 64, 100_000):
            got = kernel.launch_plan(lib, k, d, 0)
            assert got.d_slice == 256 and got.tile_rows == 32
            assert not got.smem_partial
            assert got.chunk == min(-(-k // 8) * 8, 64)
            assert lib.kmeans_assign_smem_bytes(k, d, *got) <= lib.limit
    # a smaller shared memory takes a narrower slice
    small = _SmemLib(48 * 1024)
    got = kernel.launch_plan(small, 64, 4096, 0)
    assert got == (32, 64, False, 64)
    assert small.kmeans_assign_smem_bytes(64, 4096, *got) <= small.limit


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.kmeans_assign_stacked(torch.zeros((1, 1, 4, 2)),
                                     torch.zeros((2, 2)), 4)
