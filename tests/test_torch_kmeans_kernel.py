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


def _aligned(*shape):
    return torch.zeros(shape)


@pytest.mark.parametrize("blocks,k,want,centers_offset", [
    (_aligned(31, 1, 1024, 100), 64, "mma", 0),     # the ds-array fit's layout
    (_aligned(16, 1, 64, 2560), 64, "mma", 0),      # zamba2-2.7b hidden states
    (_aligned(4, 1, 100, 120), 17, "mma", 0),       # k not a multiple of 8
    (_aligned(4, 1, 512, 128), 64, "mma", 0),       # rows padded to a pitch of 136
    (_aligned(2, 1, 300, 100), 128, "mma", 0),      # K_MMA centers
    (_aligned(4, 2, 100, 60), 17, "simt", 0),       # gm = 2: TMA cannot read rows
    (_aligned(4, 2, 512, 64), 64, "simt", 0),       # gm = 2, d = 128
    (_aligned(31, 1, 1024, 100), 200, "simt", 0),   # too many centers
    (_aligned(4, 1, 256, 98), 64, "simt", 0),       # bm % 4 != 0
    (torch.zeros(2 * 256 * 100 + 1)[1:].view(2, 1, 256, 100), 64, "simt", 0),  # 4-byte offset
    (_aligned(2, 1, 100, 256).transpose(2, 3), 64, "simt", 0),   # not contiguous
    (_aligned(2, 1, 256, 100), 64, "simt", 1),      # centers 4 bytes off
])
def test_route(blocks, k, want, centers_offset):
    """The route is a function of shapes, strides and alignment, so it is
    decided here on CPU tensors exactly as on the card."""
    d = blocks.shape[1] * blocks.shape[3]
    centers = torch.zeros(k * d + centers_offset)[centers_offset:].view(k, d)
    assert kernel.route(blocks, centers) == want


class _MmaLib(_SmemLib):
    """Stands in for the mma route's shared-memory query (the resident form
    of csrc/kmeans_assign.cu: the split table, counts, labels, and one x
    tile of 128 rows)."""

    @staticmethod
    def kmeans_assign_mma_smem_bytes(k, d, resident):
        f = -(-d // 8) * 8
        px = f if f % 16 == 8 else f + 8
        return 4 * (32 + f // 8 * 64 * 16 + 64 + 128 + 128 * px)


@pytest.mark.parametrize("k,d,want", [(64, 100, True), (17, 120, True),
                                      (64, 16, True), (64, 128, True), (65, 100, False),
                                      (64, 136, False), (64, 2560, False)])
def test_resident_form(k, d, want):
    """The mma route keeps the center table on chip and fuses the sums at
    the fit's shape (k = 64, d = 100); wider rows or more centers stream."""
    lib = _MmaLib(232448)
    assert kernel.resident(lib, k, d, 0) == want


def _tf32(t):
    """``t`` rounded to TF32's 10-bit mantissa, to nearest with ties away
    from zero (``cvt.rna.tf32.f32``)."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _sq_dists(x, c):
    return (x * x).sum(1, keepdim=True) - 2 * x @ c.T + (c * c).sum(1)[None]


def _near_tie_rule(x, c, got, want, gap_errs=4, share=1e-4):
    """``chip_smoke.check_labels``: labels may differ only where the float64
    gap between a row's two nearest centers is below gap_errs x the largest
    |fp32 - float64| distance error on these rows, and at most a share of
    1e-4 of the rows may be such near-ties.  Returns (ok, near, other)."""
    err = float((_sq_dists(x, c).double() - _sq_dists(x.double(), c.double()))
                .abs().max())
    diff = got != want
    d = _sq_dists(x[diff].double(), c.double())
    two = torch.topk(d, 2, dim=1, largest=False).values
    near = (two[:, 1] - two[:, 0]) < gap_errs * err
    n_near, n_other = int(near.sum()), int((~near).sum())
    return n_other == 0 and n_near <= np.ceil(share * x.shape[0]), n_near, n_other


def test_3xtf32_assign_matches_plain_and_1xtf32_does_not():
    """The mma route's precision design, emulated by bit rounding: 3xTF32
    distances (hi·lo' + lo·hi', then hi·hi') give the plain labels up to the
    near-tie rule, and the fused sums (fp32, each cluster's rows added in
    row order) stay within 1e-4 of the float64 sums; single-TF32 distances
    break the rule.  Blobs offset far from the origin, as unstandardised
    features are."""
    rng = np.random.default_rng(16)
    n, d, k = 20_000, 100, 64
    cen = (100.0 + rng.normal(size=(k, d))).astype(np.float32)
    x = torch.from_numpy((cen[rng.integers(0, k, n)]
                          + rng.normal(size=(n, d))).astype(np.float32))
    c = torch.from_numpy((cen + 0.1 * rng.normal(size=(k, d))).astype(np.float32))
    want, _, _ = kmeans_assign_ref(x, c)
    xh, ch = _tf32(x), _tf32(c)
    xl, cl = _tf32(x - xh), _tf32(c - ch)
    xsq, csq = (x * x).sum(1, keepdim=True), (c * c).sum(1)[None]
    dot3 = (xh @ cl.T + xl @ ch.T) + xh @ ch.T
    l3 = torch.argmin((xsq - 2 * dot3) + csq, dim=1)
    l1 = torch.argmin((xsq - 2 * (xh @ ch.T)) + csq, dim=1)
    ok3, near3, other3 = _near_tie_rule(x, c, l3, want.long())
    ok1, near1, other1 = _near_tie_rule(x, c, l1, want.long())
    assert ok3, (near3, other3)
    assert not ok1, (near1, other1)
    sums = torch.zeros(k, d).index_add_(0, l3, x)
    sums64 = torch.zeros(k, d, dtype=torch.float64).index_add_(0, l3, x.double())
    assert float((sums - sums64).abs().max()) <= 1e-4 * float(sums64.abs().max())


def test_tf32_rounded_inputs_fail_the_near_tie_rule_on_centred_rows():
    """The control that the plain version fed TF32-rounded rows and centers
    must fail: on centred random rows (no blobs, so gaps near 0 are common
    and fp32's own distance error is small) rounding the inputs moves a gap
    by about 2^-11 of |x|·|c2 - c1| and changes labels beyond the near-tie
    rule, while the 3xTF32 distances keep to it."""
    rng = np.random.default_rng(17)
    n, d, k = 32768, 100, 64
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    c = torch.from_numpy((0.5 * rng.normal(size=(k, d))).astype(np.float32))
    want = _sq_dists(x, c).argmin(1)
    xh, ch = _tf32(x), _tf32(c)
    dot3 = (xh @ _tf32(c - ch).T + _tf32(x - xh) @ ch.T) + xh @ ch.T
    l3 = ((x * x).sum(1, keepdim=True) - 2 * dot3 + (c * c).sum(1)[None]).argmin(1)
    ok3, near3, other3 = _near_tie_rule(x, c, l3, want)
    ok_r, near_r, other_r = _near_tie_rule(x, c, _sq_dists(xh, ch).argmin(1), want)
    assert ok3, (near3, other3)
    assert not ok_r and other_r > 0, (near_r, other_r)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.kmeans_assign_stacked(torch.zeros((1, 1, 4, 2)),
                                     torch.zeros((2, 2)), 4)
