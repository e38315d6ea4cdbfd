"""The port's SSD against the JAX package's Pallas kernel and oracle.

``ssd_scan`` of the port (the chunk kernel's plain version on the CPU, then
the inter-chunk recurrence) against ``ssd_scan(interpret=True)`` and the
sequential ``ssd_ref`` on the cases of ``tests/test_kernels.py`` (atol
2e-4), the chunk-local plain version against all four outputs of
``ssd_chunk_padded(interpret=True)``, and ``ssd_decode_step`` (atol 1e-4).
The CUDA kernel itself runs only on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd.kernel import ssd_chunk_padded  # noqa: E402
from repro.kernels.ssd.ops import ssd_decode_step as jax_decode_step  # noqa: E402
from repro.kernels.ssd.ops import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel  # noqa: E402
from repro_torch.kernels.ssd.ops import (ssd_chunk, ssd_decode_step,  # noqa: E402
                                         ssd_ref, ssd_scan)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

CASES = [(4, 256, 64, 32, 64),
         (2, 130, 32, 16, 64),   # ragged tail chunk
         (3, 64, 16, 8, 32),
         (1, 32, 128, 128, 16)]  # big state


def _inputs(bh, t, p, s, seed, slow=True):
    """Slow decay (dt in [0.001, 0.1], a in [-2, -0.5]) carries the states
    across chunks; fast decay is the main path's (dt ~ 0.7, a in [-16, -1])."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bh, t, p)).astype(np.float32)
    if slow:
        dt = rng.uniform(0.001, 0.1, size=(bh, t)).astype(np.float32)
        a = (-rng.uniform(0.5, 2.0, size=(bh,))).astype(np.float32)
    else:
        dt = rng.uniform(0.5, 1.0, size=(bh, t)).astype(np.float32)
        a = (-rng.uniform(1.0, 16.0, size=(bh,))).astype(np.float32)
    b = rng.normal(size=(bh, t, s)).astype(np.float32)
    c = rng.normal(size=(bh, t, s)).astype(np.float32)
    h0 = rng.normal(size=(bh, s, p)).astype(np.float32)
    return x, dt, a, b, c, h0


@pytest.mark.parametrize("bh,t,p,s,chunk", CASES)
def test_ssd_scan_matches_pallas_and_oracle(bh, t, p, s, chunk):
    args = _inputs(bh, t, p, s, seed=bh * t + p)
    y, h = ssd_scan(*map(torch.from_numpy, args), chunk=chunk)
    y1, h1 = jax_ssd_scan(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    y2, h2 = jax_ssd_ref(*map(jnp.asarray, args))
    assert tuple(y.shape) == (bh, t, p) and tuple(h.shape) == (bh, s, p)
    for want_y, want_h in ((y1, h1), (y2, h2)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=2e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=2e-4)


@pytest.mark.parametrize("slow", [True, False])
def test_ssd_scan_without_h0_matches_oracle(slow):
    x, dt, a, b, c, _ = _inputs(3, 100, 16, 8, seed=21, slow=slow)
    args = (x, dt, a, b, c)
    y, h = ssd_scan(*map(torch.from_numpy, args), chunk=32)
    y2, h2 = jax_ssd_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y2), atol=2e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h2), atol=2e-4)
    # the port's own sequential oracle agrees too
    y3, h3 = ssd_ref(*map(torch.from_numpy, args))
    np.testing.assert_allclose(y3.numpy(), np.asarray(y2), atol=2e-4)
    np.testing.assert_allclose(h3.numpy(), np.asarray(h2), atol=2e-4)


@pytest.mark.parametrize("bh,t,p,s,chunk", CASES[:1] + CASES[2:])
def test_ssd_chunk_matches_pallas_chunk_kernel(bh, t, p, s, chunk):
    x, dt, a, b, c, _ = _inputs(bh, t, p, s, seed=t + s)
    y, states, c_dec, decay = ssd_chunk(*map(torch.from_numpy, (x, dt, a, b, c)),
                                        chunk=chunk)
    jy, jstates, jc_dec, jdecay = ssd_chunk_padded(
        jnp.asarray(x), jnp.asarray(dt)[..., None], jnp.asarray(a)[:, None],
        jnp.asarray(b), jnp.asarray(c), chunk=chunk, interpret=True)
    nc = t // chunk
    assert tuple(states.shape) == (bh, nc, s, p) and tuple(decay.shape) == (bh, nc)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-4)
    np.testing.assert_allclose(states.numpy(), np.asarray(jstates), atol=2e-4)
    np.testing.assert_allclose(c_dec.numpy(), np.asarray(jc_dec), atol=2e-4)
    np.testing.assert_allclose(decay.numpy(), np.asarray(jdecay)[:, :, 0, 0],
                               rtol=1e-5)


def test_grouped_b_c_equal_per_head_copies():
    """B and C given per group (BG rows) read the same values as BH copies."""
    x, dt, a, b, c, h0 = _inputs(6, 48, 8, 4, seed=31)
    bg, cg = b[::3], c[::3]                      # 2 groups of 3 heads
    per_head = [torch.from_numpy(np.repeat(m, 3, axis=0)) for m in (bg, cg)]
    y1, h1 = ssd_scan(*map(torch.from_numpy, (x, dt, a, bg, cg, h0)), chunk=16)
    y2, h2 = ssd_scan(*map(torch.from_numpy, (x, dt, a)), *per_head,
                      torch.from_numpy(h0), chunk=16)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(h1, h2, rtol=0, atol=0)


def test_ssd_decode_step_matches_reference_and_scan():
    x, dt, a, b, c, _ = _inputs(3, 5, 16, 8, seed=41)
    y_ref, h_ref = jax_ssd_ref(*map(jnp.asarray, (x, dt, a, b, c)))
    h = torch.zeros((3, 8, 16))
    jh = jnp.zeros((3, 8, 16))
    ys = []
    for t in range(5):
        step = [x[:, t], dt[:, t], a, b[:, t], c[:, t]]
        y, h = ssd_decode_step(*map(torch.from_numpy, step), h)
        jy, jh = jax_decode_step(*map(jnp.asarray, step), jh)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4)
        ys.append(y)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), np.asarray(y_ref),
                               atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-4)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, dt, a, b, c, _ = _inputs(1, 16, 4, 4, seed=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.ssd_chunk(*map(torch.from_numpy, (x, dt, a, b, c)), chunk=16)
