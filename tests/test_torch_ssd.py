"""The port's SSD against the JAX package's Pallas kernel and oracle.

``ssd_scan`` of the port (the chunk kernel's plain version on the CPU, then
the inter-chunk recurrence) against ``ssd_scan(interpret=True)`` and the
sequential ``ssd_ref`` on the cases of ``tests/test_kernels.py`` (atol
2e-4), the chunk-local plain version against all four outputs of
``ssd_chunk_padded(interpret=True)``, and ``ssd_decode_step`` (atol 1e-4).
The CUDA kernels themselves run only on the card; here ``kernel.route``
picks between them on CPU tensors, and the precision of the ``mma`` route's
3xTF32 products is emulated by rounding mantissas to TF32's 10 bits.
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


def _route_args(bh, bg, t, p, s, b_pitch=None):
    x, dt = torch.empty((bh, t, p)), torch.empty((bh, t))
    b = torch.empty((bg, t, b_pitch or s))[..., :s]
    return x, dt, b, torch.empty((bg, t, s))


@pytest.mark.parametrize("args,chunk,want", [
    (_route_args(160, 2, 4096, 64, 64), 128, "mma"),    # zamba2's main path
    (_route_args(4, 4, 96, 16, 16), 32, "mma"),
    (_route_args(4, 4, 96, 16, 12), 32, "simt"),        # S = 12
    (_route_args(4, 4, 96, 16, 16), 24, "simt"),        # chunk = 24
    (_route_args(4, 4, 96, 16, 16, b_pitch=18), 32, "simt"),  # B rows 18 floats apart
])
def test_route(args, chunk, want):
    assert kernel.route(*args, chunk) == want


def test_route_refuses_non_f32():
    """No route takes non-f32: the wrapper refuses it before ``route``."""
    x, dt, b, c = _route_args(4, 4, 96, 16, 16)
    with pytest.raises(TypeError, match="f32"):
        kernel.ssd_chunk(x.bfloat16(), dt, torch.empty(4), b, c, chunk=32)


def _tf32(t):
    """``t`` rounded to TF32's 10-bit mantissa, to nearest with ties away
    from zero (``cvt.rna.tf32.f32``)."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _mm_3xtf32(a, b):
    """a @ b as the mma route computes it: hi = rna(v), lo = rna(v - hi),
    the cross terms hi·lo' + lo·hi' summed before hi·hi'."""
    ahi, bhi = _tf32(a), _tf32(b)
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    return (ahi @ blo + alo @ bhi) + ahi @ bhi


def _chunk_products(mm, x, dt, a, b, c, chunk):
    """y_intra and the chunk states of ``ssd_chunk_ref`` with each of the
    three products computed by ``mm``, the gate and dt folded into W as the
    mma kernel folds them."""
    bh, t, p = x.shape
    s, nc = b.shape[-1], t // chunk
    xc, dtc = x.reshape(bh, nc, chunk, p), dt.reshape(bh, nc, chunk)
    bc, cc = b.reshape(bh, nc, chunk, s), c.reshape(bh, nc, chunk, s)
    ell = torch.cumsum(a[:, None, None] * dtc, dim=2)
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    diff = torch.where(tri, ell[..., :, None] - ell[..., None, :], 0.0)
    w = mm(cc, bc.transpose(-1, -2)) * torch.where(tri, torch.exp(diff), 0.0)
    y = mm(w * dtc[..., None, :], xc)
    w_end = torch.exp(ell[..., -1:] - ell) * dtc
    states = mm((bc * w_end[..., None]).transpose(-1, -2), xc)
    return y.reshape(bh, t, p), states


def _beyond_card_tolerance(got, want):
    """Elements beyond the card test's limit (``test_ssd_chunk_matches_plain``:
    atol 2e-5·max(1, max|ref|), rtol 1e-5)."""
    atol = 2e-5 * max(1.0, float(want.abs().max()))
    return int(((got - want).abs() > atol + 1e-5 * want.abs()).sum())


@pytest.mark.parametrize("slow", [True, False])
def test_3xtf32_products_meet_the_card_tolerance_and_1xtf32_does_not(slow):
    """The mma route's precision design: the plain chunk's three products in
    emulated 3xTF32 stay within the card test's tolerance of
    ``ssd_chunk_ref``; in single TF32 they do not."""
    x, dt, a, b, c, _ = map(torch.from_numpy, _inputs(4, 256, 64, 64, seed=7, slow=slow))
    y_ref, states_ref, _, _ = ssd_chunk(x, dt, a, b, c, chunk=128)
    y3, states3 = _chunk_products(_mm_3xtf32, x, dt, a, b, c, 128)
    y1, states1 = _chunk_products(_mm_1xtf32, x, dt, a, b, c, 128)
    assert _beyond_card_tolerance(y3, y_ref) == 0
    assert _beyond_card_tolerance(states3, states_ref) == 0
    assert _beyond_card_tolerance(y1, y_ref) > 0
    assert _beyond_card_tolerance(states1, states_ref) > 0


# ---------------------------------------------------------------------------
# gradients: the chunk Function's backward (the plain chunk's gradient,
# recomputed) under ssd_scan, against jax.grad of the reference's
# ssd_chunked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,t,h,g,p,s,chunk,with_h0", [
    (2, 40, 4, 1, 8, 8, 16, True),     # B, C per group (BG < BH), T ragged
    (1, 32, 2, 2, 8, 4, 16, False),    # one group per head, no h0
])
def test_ssd_scan_grads_match_jax(b, t, h, g, p, s, chunk, with_h0):
    import jax
    from repro.models.ssm import ssd_chunked
    rng = np.random.default_rng(t + h + g)
    x = rng.normal(size=(b, t, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, t, h)).astype(np.float32)
    a = (-rng.uniform(0.5, 2.0, size=(h,))).astype(np.float32)
    bm = rng.normal(size=(b, t, g, s)).astype(np.float32)
    cm = rng.normal(size=(b, t, g, s)).astype(np.float32)
    h0 = rng.normal(size=(b, h, s, p)).astype(np.float32)
    ry = rng.normal(size=(b, t, h, p)).astype(np.float32)
    rh = rng.normal(size=(b, h, s, p)).astype(np.float32)

    def jloss(x, dt, a, bm, cm, h0):
        y, hf = ssd_chunked(x, dt, a, bm, cm, h0 if with_h0 else None,
                            chunk=chunk)
        return jnp.sum(y * ry) + jnp.sum(hf * rh)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(6 if with_h0 else 5))))(
        *map(jnp.asarray, (x, dt, a, bm, cm, h0)))

    leaves = [torch.from_numpy(v).requires_grad_() for v in (x, dt, a, bm, cm, h0)]
    tx, tdt, ta, tb, tc, th0 = leaves

    def grouped(m):      # (B, T, G, S) -> ssd_scan's (B·G, T, S)
        return m.transpose(1, 2).reshape(b * g, t, s)

    y, hf = ssd_scan(tx.transpose(1, 2).reshape(b * h, t, p),
                     tdt.transpose(1, 2).reshape(b * h, t), ta.repeat(b),
                     grouped(tb), grouped(tc),
                     th0.reshape(b * h, s, p) if with_h0 else None, chunk=chunk)
    loss = ((y.reshape(b, h, t, p).transpose(1, 2) * torch.from_numpy(ry)).sum()
            + (hf.reshape(b, h, s, p) * torch.from_numpy(rh)).sum())
    got = torch.autograd.grad(loss, leaves[:len(want)])
    for name, gt, w in zip(("x", "dt", "a", "b", "c", "h0"), got, want):
        w = np.asarray(w)
        assert tuple(gt.shape) == w.shape, name
        np.testing.assert_allclose(gt.numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_ssd_chunk_backward_launches_nothing(monkeypatch):
    """The chunk's forward version runs once per call; its backward
    recomputes the plain chunk and never calls the forward version."""
    from repro_torch.kernels.ssd import ops as sops
    calls = []
    plain = sops.ssd_chunk_ref
    monkeypatch.setattr(sops, "ssd_chunk_ref",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    args = [torch.from_numpy(v).requires_grad_()
            for v in _inputs(2, 32, 8, 4, seed=5)[:5]]
    y, h = ssd_scan(*args, chunk=16)
    (y.sum() + h.sum()).backward()
    assert len(calls) == 1 and all(v.grad is not None for v in args)
