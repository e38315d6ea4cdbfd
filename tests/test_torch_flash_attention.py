"""The port's fused attention against the JAX package's Pallas kernel.

``flash_attention`` of the port (plain version, CPU) against
``flash_attention(interpret=True)`` and ``attention_ref`` on the cases of
``tests/test_kernels.py`` (atol 3e-5 in f32, 3e-2 in bf16), with ``kv_len``
and in the decode form against ``decode_attention``.  The CUDA kernel itself
runs only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.models.common import decode_attention as jax_decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


def _qkv(b, hq, hkv, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, tq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, tk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, tk, d)).astype(np.float32))


@pytest.mark.parametrize("tq,tk,hq,hkv,d,causal,window,cap,qoff", [
    (128, 128, 4, 2, 64, True, 0, 0.0, 0),
    (100, 100, 4, 4, 48, True, 0, 0.0, 0),
    (64, 256, 2, 1, 64, True, 0, 0.0, 192),
    (128, 128, 8, 2, 64, True, 64, 0.0, 0),
    (128, 128, 4, 2, 64, True, 0, 30.0, 0),
    (96, 160, 4, 2, 64, False, 0, 0.0, 0),
    (1, 300, 4, 2, 64, True, 0, 0.0, 299),
    (256, 512, 2, 2, 128, True, 128, 50.0, 0),
])
def test_flash_attention_matches_pallas(tq, tk, hq, hkv, d, causal, window, cap,
                                        qoff):
    q, k, v = _qkv(2, hq, hkv, tq, tk, d, seed=tq + tk + d)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = jax_flash(*map(jnp.asarray, (q, k, v)), block_q=128, block_k=128,
                     interpret=True, **kw)
    oracle = jax_attention_ref(*map(jnp.asarray, (q, k, v)), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=3e-5)


def test_flash_attention_bf16():
    q, k, v = _qkv(1, 2, 2, 128, 128, 128, seed=7)
    got = flash_attention(*(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)))
    want = jax_flash(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                     interpret=True)
    oracle = jax_attention_ref(*map(jnp.asarray, (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=3e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(oracle), atol=3e-2)


@pytest.mark.parametrize("causal,qoff", [(False, 0), (True, 40)])
def test_kv_len_hides_the_tail(causal, qoff):
    """Keys at positions >= kv_len are hidden: the same as attention over
    the first kv_len keys only."""
    q, k, v = _qkv(2, 4, 2, 24, 80, 32, seed=11)
    n = 57
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          q_offset=qoff, kv_len=n)
    want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k[:, :, :n]),
                             jnp.asarray(v[:, :, :n]), causal=causal,
                             q_offset=qoff)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_fully_masked_rows_are_zero():
    q, k, v = _qkv(1, 2, 1, 8, 16, 16, seed=12)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                          kv_len=0)
    assert bool((got == 0).all())


@pytest.mark.parametrize("rolling,length", [(False, 37), (True, 37), (True, 90)])
def test_decode_attention_matches_reference(rolling, length):
    """The decode form: one query against a (possibly rolling) cache of 64
    slots, ``length`` tokens written."""
    q, k, v = _qkv(3, 4, 2, 1, 64, 80, seed=length + rolling)
    got = cm.decode_attention(*map(torch.from_numpy, (q, k, v)), length,
                              rolling=rolling)
    want = jax_decode_attention(*map(jnp.asarray, (q, k, v)), jnp.int32(length),
                                rolling=rolling)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_attention_on_permuted_views():
    """The models pass (B, T, H, D) projections as (B, H, T, D) views."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(3, 2, 50, 4, 16)).astype(np.float32)   # qkv, B, T, H, D
    q, k, v = (torch.from_numpy(x[i]).transpose(1, 2) for i in range(3))
    got = cm.attention(q, k, v, causal=True)
    want = jax_attention_ref(*(jnp.asarray(x[i].transpose(0, 2, 1, 3)) for i in range(3)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("d", [48, 64, 80, 128])
def test_route_bf16_head_dims_take_wgmma(d):
    q = torch.zeros((2, 4, 256, d), dtype=torch.bfloat16)
    kv = torch.zeros((2, 2, 256, d), dtype=torch.bfloat16)
    assert kernel.route(q, kv, kv) == "wgmma"


@pytest.mark.parametrize("case,want", [
    ("decode", "rows"),             # Tq = 1
    ("fp32", "tile"),
    ("d72", "tile"),                # D not a multiple of 16
    ("d80_unaligned", "tile"),      # a (B, T, H, D) view with 20-byte head stride
    ("prefill_views", "wgmma"),     # the model's (B, T, H, D) -> (B, H, T, D) views
])
def test_route_by_shape_dtype_and_strides(case, want):
    if case == "decode":
        q = torch.zeros((4, 32, 1, 80), dtype=torch.bfloat16)
        kv = torch.zeros((4, 32, 320, 80), dtype=torch.bfloat16)
        args = (q, kv, kv)
    elif case == "fp32":
        q = torch.zeros((2, 32, 4096, 80))
        args = (q, q, q)
    elif case == "d72":
        q = torch.zeros((2, 4, 128, 72), dtype=torch.bfloat16)
        args = (q, q, q)
    elif case == "d80_unaligned":
        x = torch.zeros((2, 128, 4, 90), dtype=torch.bfloat16)[..., :80]
        args = (x.transpose(1, 2),) * 3
    else:
        x = torch.zeros((3, 2, 4096, 32, 80), dtype=torch.bfloat16)
        args = tuple(x[i].transpose(1, 2) for i in range(3))
    assert kernel.route(*args) == want


def test_kernel_wrapper_refuses_cpu_tensors():
    t = torch.zeros((1, 1, 4, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_attention(t, t, t, causal=True, window=0, softcap=0.0,
                               sm_scale=1.0)


# ---------------------------------------------------------------------------
# gradients: the autograd Function's backward (the plain version's gradient,
# recomputed in q-chunks) against jax.grad of the reference's attention_xla
# ---------------------------------------------------------------------------

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_attention_grads(q, k, v, do, *, q_chunk, **kw):
    import jax
    from repro.models.common import attention_xla

    def f(q, k, v):
        out = attention_xla(q, k, v, q_chunk=q_chunk, **kw)
        return jnp.sum(out * jnp.asarray(do))

    return [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))]


@pytest.mark.parametrize("tq,hq,hkv,window,cap,qoff,q_chunk", [
    (48, 4, 2, 0, 0.0, 0, 1024),     # GQA 4/2, causal
    (48, 4, 2, 11, 0.0, 0, 1024),    # sliding window
    (48, 4, 4, 0, 20.0, 0, 1024),    # soft-cap
    (64, 4, 2, 9, 0.0, 0, 16),       # Tq > the reference's q chunk, banded
    (64, 2, 1, 0, 30.0, 0, 16),      # Tq > q chunk, dense chunks, soft-cap
    (32, 4, 2, 0, 0.0, 24, 1024),    # q_offset: queries at 24 .. 55
])
def test_flash_attention_grads_match_jax(tq, hq, hkv, window, cap, qoff, q_chunk):
    from repro_torch.kernels.flash_attention.ref import attention_grads
    tk = tq + qoff
    q, k, v = _qkv(2, hq, hkv, tq, tk, 16, seed=tq + window + qoff)
    do = np.random.default_rng(q_chunk).normal(size=q.shape).astype(np.float32)
    kw = dict(causal=True, window=window, softcap=cap, q_offset=qoff)
    want = _jax_attention_grads(q, k, v, do, q_chunk=q_chunk, **kw)
    tq_, tk_, tv_ = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = flash_attention(tq_, tk_, tv_, **kw)
    got = torch.autograd.grad(out, (tq_, tk_, tv_), torch.from_numpy(do))
    # the backward's own q-chunks, cut at the reference's chunk
    chunked = attention_grads(*map(torch.from_numpy, (q, k, v, do)),
                              q_chunk=q_chunk, **kw)
    for g, c, w in zip(got, chunked, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)
        np.testing.assert_allclose(c.numpy(), w, **GRAD_TOL)


def test_flash_attention_grads_honour_kv_len():
    """Keys at positions >= kv_len take no gradient; the others take the
    reference's gradient over the first kv_len keys."""
    q, k, v = _qkv(2, 4, 2, 8, 40, 16, seed=3)
    do = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    want = _jax_attention_grads(q, k[:, :, :29], v[:, :, :29], do, q_chunk=1024,
                                causal=False)
    tq_, tk_, tv_ = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = flash_attention(tq_, tk_, tv_, causal=False, kv_len=29)
    dq, dk, dv = torch.autograd.grad(out, (tq_, tk_, tv_), torch.from_numpy(do))
    np.testing.assert_allclose(dq.numpy(), want[0], **GRAD_TOL)
    for g, w in ((dk, want[1]), (dv, want[2])):
        np.testing.assert_allclose(g[:, :, :29].numpy(), w, **GRAD_TOL)
        assert not g[:, :, 29:].any()


def test_flash_attention_grads_keep_the_input_dtype():
    """bf16 q, k, v: fp32 inside, bf16 grads out, within bf16 rounding of
    the fp32 gradient."""
    q, k, v = _qkv(1, 4, 2, 24, 24, 16, seed=9)
    do = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    bf = [torch.from_numpy(t).to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
    out = flash_attention(*bf)
    assert out.dtype == torch.bfloat16
    got = torch.autograd.grad(out, bf, torch.from_numpy(do).to(torch.bfloat16))
    f32 = [t.detach().float().requires_grad_() for t in bf]
    want = torch.autograd.grad(flash_attention(*f32), f32,
                               torch.from_numpy(do).to(torch.bfloat16).float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w, rtol=1e-2, atol=1e-2 * float(w.abs().max()))


def test_flash_attention_backward_launches_nothing(monkeypatch):
    """The backward recomputes with the plain gradient: the forward version
    runs once per call, and the backward calls it never."""
    from repro_torch.kernels.flash_attention import ops as fops
    calls = []
    plain = fops.attention_ref
    monkeypatch.setattr(fops, "attention_ref",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    q, k, v = (torch.from_numpy(t).requires_grad_() for t in _qkv(1, 2, 2, 8, 8, 16, 1))
    out = flash_attention(q, k, v)
    out.sum().backward()
    assert len(calls) == 1 and q.grad is not None and k.grad.abs().sum() > 0
