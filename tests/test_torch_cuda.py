"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither jax nor ``repro``, so on a machine with a card and no jax it runs
on its own:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.kmeans import kernel as kk  # noqa: E402
from repro_torch.kernels.kmeans.ref import kmeans_assign_stacked_ref  # noqa: E402
from repro_torch.kernels.matmul import kernel as mk  # noqa: E402
from repro_torch.kernels.matmul.ops import local_matmul  # noqa: E402
from repro_torch.kernels.matmul.ref import stacked_matmul_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunk_ref, ssd_ref  # noqa: E402

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


def _gemm_operands(card, dims, dtype, a_major, b_major, seed):
    """A as (gi, gk, bn, bk) and B as (gk, gj, bk, bm) views whose innermost
    dim is K ("k") or M/N ("mn"): the other layouts are permuted views of
    contiguous storage, read through their strides."""
    gi, gk, gj, bn, bk, bm = dims
    g = torch.Generator(device=card).manual_seed(seed)
    if a_major == "k":
        a = torch.randn((gi, gk, bn, bk), generator=g, device=card).to(dtype)
    else:
        a = torch.randn((gi, gk, bk, bn), generator=g, device=card).to(dtype)
        a = a.transpose(2, 3)
    if b_major == "mn":
        b = torch.randn((gk, gj, bk, bm), generator=g, device=card).to(dtype)
    else:
        b = torch.randn((gk, gj, bm, bk), generator=g, device=card).to(dtype)
        b = b.transpose(2, 3)
    return a, b


def _gemm_close(out, ref, depth):
    rms = float(ref.float().pow(2).mean().sqrt())
    atol = 8 * torch.finfo(torch.float32).eps * depth ** 0.5 * rms
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=torch.finfo(out.dtype).eps)


def _routed(counter, route, fn):
    before = dict(counter)
    out = fn()
    torch.cuda.synchronize()
    assert counter[route] == before[route] + 1, (route, before, dict(counter))
    return out


@pytest.mark.parametrize("dims", [
    (2, 2, 2, 128, 128, 128),      # multiples of the tile
    (2, 3, 2, 200, 72, 136),       # ragged blocks
    (1, 2, 1, 40, 24, 56),         # blocks smaller than one tile
])
@pytest.mark.parametrize("a_major,b_major", [("k", "mn"), ("mn", "mn"),
                                             ("k", "k"), ("mn", "k")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_stacked_matmul_wgmma_route(card, dims, a_major, b_major, dtype):
    """Every combination of K-major and MN-major operands (the descriptors'
    transpose bits), at the tile, ragged and below one tile: the wgmma
    route, held to the plain version."""
    a, b = _gemm_operands(card, dims, dtype, a_major, b_major, seed=sum(dims))
    p = mk.plan(a, b, sms=132)
    assert p.route == "wgmma" and p.a.k_major == (a_major == "k")
    assert p.b.k_major == (b_major == "k")
    out = _routed(mk.stacked_matmul.route_launches, "wgmma",
                  lambda: mk.stacked_matmul(a, b, out_dtype=dtype))
    _gemm_close(out, stacked_matmul_ref(a, b, out_dtype=dtype), dims[1] * dims[4])


@pytest.mark.parametrize("dims,transpose_a", [
    ((1, 16, 1, 128, 2048, 128), False),    # one tile: split-K
    ((1, 16, 1, 96, 2048, 80), True),
    ((2, 2, 2, 256, 256, 256), False),      # no split
])
def test_stacked_matmul_wgmma_deterministic(card, dims, transpose_a):
    """Split-K and direct products in bf16: two runs give the same bits."""
    gi, gk, gj, bn, bk, bm = dims
    g = torch.Generator(device=card).manual_seed(3)
    a_shape = (gk, gi, bk, bn) if transpose_a else (gi, gk, bn, bk)
    a = torch.randn(a_shape, generator=g, device=card).bfloat16()
    b = torch.randn((gk, gj, bk, bm), generator=g, device=card).bfloat16()
    av = a.permute(1, 0, 3, 2) if transpose_a else a
    p = mk.plan(av, b, torch.cuda.get_device_properties(card).multi_processor_count)
    assert p.route == "wgmma" and (p.splits > 1) == (gi * gj == 1)
    run = lambda: mk.stacked_matmul(a, b, out_dtype=torch.bfloat16,  # noqa: E731
                                    transpose_a=transpose_a)
    first = _routed(mk.stacked_matmul.route_launches, "wgmma", run)
    assert torch.equal(first, run())
    ref = stacked_matmul_ref(a, b, out_dtype=torch.bfloat16, transpose_a=transpose_a)
    _gemm_close(first, ref, gk * bk)


@pytest.mark.parametrize("case", ["bk70_bf16", "offset_view", "f32"])
def test_stacked_matmul_simt_route(card, case):
    """What TMA cannot read takes the SIMT route: a bk of 70 bf16 (140-byte
    rows), a view one element off a 16-byte boundary, every fp32 product."""
    g = torch.Generator(device=card).manual_seed(5)
    if case == "bk70_bf16":
        a = torch.randn((2, 3, 50, 70), generator=g, device=card).bfloat16()
        b = torch.randn((3, 2, 70, 64), generator=g, device=card).bfloat16()
    elif case == "offset_view":
        flat = torch.randn(1 + 2 * 2 * 64 * 64, generator=g, device=card).bfloat16()
        a = flat[1:].view(2, 2, 64, 64)
        b = torch.randn((2, 2, 64, 64), generator=g, device=card).bfloat16()
    else:
        a = torch.randn((2, 2, 128, 128), generator=g, device=card)
        b = torch.randn((2, 2, 128, 128), generator=g, device=card)
    assert mk.plan(a, b, sms=132).route == "simt"
    out = _routed(mk.stacked_matmul.route_launches, "simt",
                  lambda: mk.stacked_matmul(a, b, out_dtype=a.dtype))
    _gemm_close(out, stacked_matmul_ref(a, b, out_dtype=a.dtype), a.shape[1] * a.shape[3])


def _stack(card, x, bs):
    n, d = x.shape
    bn, bm = bs
    gn, gm = -(-n // bn), d // bm
    blocks = torch.zeros((gn * bn, d), device=card)
    blocks[:n] = x
    return blocks.reshape(gn, bn, gm, bm).permute(0, 2, 1, 3).contiguous()


def _blobs(card, n, d, k, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 4
    x = centers[rng.integers(0, k, size=n)] + rng.normal(size=(n, d)) * 0.3
    return (torch.from_numpy(x.astype(np.float32)).to(card),
            torch.from_numpy(centers).to(card))


KMEANS_CASES = [
    (3000, 100, 64, (1024, 100)),     # the main path's layout
    (2000, 784, 10, (512, 392)),      # 32-row tiles, gm = 2
    (1500, 1000, 16, (700, 1000)),    # centers staged 8 at a time
    (1200, 784, 64, (500, 784)),      # the partial in global scratch
    (4000, 64, 1000, (1024, 64)),     # many clusters, two chunks
    (3000, 2560, 64, (1024, 2560)),   # zamba2-2.7b hidden states: D-tiled
    (1000, 4096, 17, (512, 1024)),    # D-tiled, gm = 4, a ragged chunk
    (700, 3000, 100, (300, 3000)),    # D-tiled, two chunks, a ragged slice
    (3000, 40, 2000, (1024, 40)),     # sums pass with its partial in global memory
    (900, 98, 33, (256, 98)),         # bm % 4 != 0: simt by the rule
    (2000, 128, 64, (512, 128)),      # mma resident, rows at a pitch of 136
    (2000, 128, 64, (512, 64)),       # gm = 2: simt by the rule
]


@pytest.mark.parametrize("n,d,k,bs", KMEANS_CASES)
@pytest.mark.parametrize("forced", [None, "simt"])
def test_kmeans_assign_matches_plain(card, monkeypatch, n, d, k, bs, forced):
    """Each shape on the route the rule gives it, and forced onto simt by
    patching ``route`` (the package has no such option)."""
    x, c = _blobs(card, n, d, k, seed=n + k)
    blocks = _stack(card, x, bs)
    r = kk.route(blocks, c)
    assert r == ("mma" if k <= kk.K_MMA and bs[1] % 4 == 0 and bs[1] == d else "simt")
    if forced:
        monkeypatch.setattr(kk, "route", lambda *args: forced)
        r = forced
    l1, s1, c1 = _routed(kk.kmeans_assign_stacked.route_launches, r,
                         lambda: kk.kmeans_assign_stacked(blocks, c, n))
    l2, s2, c2 = kmeans_assign_stacked_ref(blocks, c, n)
    torch.testing.assert_close(l1, l2, atol=0, rtol=0)
    torch.testing.assert_close(c1, c2, atol=0, rtol=0)
    torch.testing.assert_close(s1, s2, atol=1e-4 * float(s2.abs().max()), rtol=1e-4)


@pytest.mark.parametrize("n,d,k,bs", [(3000, 100, 64, (1024, 100)),
                                      (3000, 2560, 64, (1024, 2560)),
                                      (2000, 784, 10, (512, 784)),
                                      (2000, 128, 64, (512, 128))])
def test_kmeans_assign_mma_is_deterministic(card, n, d, k, bs):
    """The mma route adds in a fixed order (no float atomics): a second
    run gives the same bits."""
    x, c = _blobs(card, n, d, k, seed=n * k)
    blocks = _stack(card, x, bs)
    first = _routed(kk.kmeans_assign_stacked.route_launches, "mma",
                    lambda: kk.kmeans_assign_stacked(blocks, c, n))
    second = kk.kmeans_assign_stacked(blocks, c, n)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,d,k,bs", [(3000, 100, 64, (1024, 100)),
                                      (250, 120, 17, (100, 120)),
                                      (2000, 128, 64, (512, 128))])
def test_kmeans_mma_streamed_gives_the_resident_labels(card, monkeypatch, n, d, k, bs):
    """The streamed form adds every distance in the resident form's order:
    the same labels and counts bit for bit; the resident form's sums within
    the card tolerance of the plain version."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(card)
    c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).to(card)
    blocks = _stack(card, x, bs)
    assert kk.route(blocks, c) == "mma" and kk.resident(kk._lib(), k, d, card.index or 0)
    l1, s1, c1 = kk.kmeans_assign_stacked(blocks, c, n)
    _, s_ref, _ = kmeans_assign_stacked_ref(blocks, c, n)
    torch.testing.assert_close(s1, s_ref, atol=1e-4 * float(s_ref.abs().max()), rtol=1e-4)
    monkeypatch.setattr(kk, "resident", lambda *args: False)
    l2, s2, c2 = kk.kmeans_assign_stacked(blocks, c, n)
    assert torch.equal(l1, l2) and torch.equal(c1, c2)
    torch.testing.assert_close(s1, s2, atol=1e-4 * float(s1.abs().max()), rtol=1e-4)


@pytest.mark.parametrize("n,d,k,bs", [(3000, 100, 64, (1024, 100)),
                                      (2000, 784, 10, (512, 392))])
def test_kmeans_labels_do_not_depend_on_the_layout(card, monkeypatch, n, d, k, bs):
    """The simt route's D-tiled layout sums every distance in the same
    order as its whole-row one: forced onto a shape the whole-row layout
    takes, it gives the same labels bit for bit (and the same counts)."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(card)
    c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).to(card)
    blocks = _stack(card, x, bs)
    monkeypatch.setattr(kk, "route", lambda *args: "simt")
    assert kk.launch_plan(kk._lib(), k, d, card.index or 0).d_slice == 0
    l1, s1, c1 = kk.kmeans_assign_stacked(blocks, c, n)
    for ds in (256, 32):
        plan = kk.Plan(32, min(-(-k // 8) * 8, 64), False, ds)
        monkeypatch.setattr(kk, "launch_plan", lambda *args, plan=plan: plan)
        l2, s2, c2 = kk.kmeans_assign_stacked(blocks, c, n)
        torch.testing.assert_close(l1, l2, atol=0, rtol=0)
        torch.testing.assert_close(c1, c2, atol=0, rtol=0)
        torch.testing.assert_close(s1, s2, atol=1e-4 * float(s1.abs().max()),
                                   rtol=1e-4)


FLASH_CASES = [  # tq, tk, hq, hkv, d, causal, window, cap, qoff
    (128, 128, 4, 2, 64, True, 0, 0.0, 0),
    (100, 100, 4, 4, 48, True, 0, 0.0, 0),
    (64, 256, 2, 1, 64, True, 0, 0.0, 192),
    (128, 128, 8, 2, 64, True, 64, 0.0, 0),
    (128, 128, 4, 2, 64, True, 0, 30.0, 0),
    (96, 160, 4, 2, 64, False, 0, 0.0, 0),
    (1, 300, 4, 2, 64, True, 0, 0.0, 299),
    (256, 512, 2, 2, 128, True, 128, 50.0, 0),
    (300, 300, 4, 4, 80, True, 0, 0.0, 0),     # zamba2's head dim
    (70, 90, 2, 2, 256, False, 0, 0.0, 0),     # gemma2's head dim
    (200, 260, 4, 2, 80, True, 0, 0.0, 60),    # D = 80 with q_offset
    (150, 150, 2, 1, 112, True, 48, 0.0, 0),   # D = 112: a zeroed padding chunk
]


def _attn_route(q, dtype):
    tq, d = q.shape[2], q.shape[3]
    if tq <= 8:
        return "rows"
    return "wgmma" if dtype != torch.float32 and d % 16 == 0 else "tile"


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_attention_matches_plain(card, case, dtype):
    tq, tk, hq, hkv, d, causal, window, cap, qoff = case
    g = torch.Generator(device=card).manual_seed(tq + tk + d)
    q = torch.randn((2, hq, tq, d), generator=g, device=card).to(dtype)
    k = torch.randn((2, hkv, tk, d), generator=g, device=card).to(dtype)
    v = torch.randn((2, hkv, tk, d), generator=g, device=card).to(dtype)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff,
              sm_scale=d ** -0.5)
    r = _attn_route(q, dtype)
    assert fk.route(q, k, v) == r
    got = _routed(fk.flash_attention.route_launches, r,
                  lambda: fk.flash_attention(q, k, v, **kw))
    want = attention_ref(q, k, v, **kw)
    atol = 3e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("kv_len", [0, 1, 57, 200])
def test_flash_attention_decode_and_strided_views(card, kv_len):
    """Tq = 1 against a cache with kv_len valid slots, and q/k/v passed as
    (B, T, H, D) -> (B, H, T, D) views (read through their strides)."""
    g = torch.Generator(device=card).manual_seed(kv_len)
    x = torch.randn((3, 2, 200, 32, 80), generator=g, device=card)
    q = x[0, :, :1].transpose(1, 2)
    k, v = x[1].transpose(1, 2), x[2].transpose(1, 2)
    kw = dict(causal=False, window=0, softcap=0.0, sm_scale=80 ** -0.5,
              kv_len=kv_len)
    got = fk.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(got, attention_ref(q, k, v, **kw), atol=3e-5, rtol=0)
    if kv_len == 0:
        assert bool((got == 0).all())


@pytest.mark.parametrize("kv_len", [0, 100, 333])
def test_flash_attention_wgmma_strided_views(card, kv_len):
    """The model's prefill layout: (B, T, H, D) projections passed as
    (B, H, T, D) views, D = 80, causal with kv_len cutting the keys."""
    g = torch.Generator(device=card).manual_seed(kv_len)
    x = torch.randn((3, 2, 333, 8, 80), generator=g, device=card).bfloat16()
    q, k, v = (x[i].transpose(1, 2) for i in range(3))
    kw = dict(causal=True, window=0, softcap=0.0, sm_scale=80 ** -0.5,
              q_offset=0, kv_len=kv_len)
    got = _routed(fk.flash_attention.route_launches, "wgmma",
                  lambda: fk.flash_attention(q, k, v, **kw))
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, **kw).float(),
                               atol=3e-2, rtol=0)
    if kv_len == 0:
        assert bool((got == 0).all())


def test_flash_attention_int_raises(card):
    t = torch.ones((1, 1, 4, 8), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        fk.flash_attention(t, t, t, causal=True, window=0, softcap=0.0, sm_scale=1.0)


def _ssd_inputs(card, bh, bg, t, p, s, slow, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    u = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(shape, generator=g, device=card)  # noqa: E731
    x = torch.randn((bh, t, p), generator=g, device=card)
    dt = u(0.001, 0.1, bh, t) if slow else u(0.5, 1.0, bh, t)
    a = -(u(0.5, 2.0, bh) if slow else u(1.0, 16.0, bh))
    b = torch.randn((bg, t, s), generator=g, device=card)
    c = torch.randn((bg, t, s), generator=g, device=card)
    h0 = torch.randn((bh, s, p), generator=g, device=card)
    return x, dt, a, b, c, h0


@pytest.mark.parametrize("bh,bg,t,p,s,chunk", [
    (4, 4, 256, 64, 32, 64), (3, 3, 64, 16, 8, 32), (1, 1, 32, 128, 128, 16),
    (8, 1, 512, 64, 64, 128),      # zamba2: one group of B, C for all heads
    (2, 2, 96, 16, 12, 24),        # S = 12, chunk 24: the simt route by the rule
])
@pytest.mark.parametrize("slow", [True, False])
@pytest.mark.parametrize("forced", [None, "simt"])
def test_ssd_chunk_matches_plain(card, monkeypatch, bh, bg, t, p, s, chunk, slow,
                                 forced):
    """Each shape on the route the rule gives it, and forced onto simt by
    patching ``route`` (the package has no such option)."""
    x, dt, a, b, c, _ = _ssd_inputs(card, bh, bg, t, p, s, slow, seed=t + p)
    r = sk.route(x, dt, b, c, chunk)
    assert r == ("mma" if chunk % 16 == 0 and s % 8 == 0 else "simt")
    if forced:
        monkeypatch.setattr(sk, "route", lambda *args: forced)
        r = forced
    got = _routed(sk.ssd_chunk.route_launches, r,
                  lambda: sk.ssd_chunk(x, dt, a, b, c, chunk=chunk))
    want = ssd_chunk_ref(x, dt, a, b, c, chunk=chunk)
    for name, g_, w_ in zip(("y_intra", "states", "c_dec", "decay"), got, want):
        scale = max(1.0, float(w_.abs().max()))
        torch.testing.assert_close(g_, w_, atol=2e-5 * scale, rtol=1e-5, msg=name)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_on_the_card_matches_the_oracle(card, with_h0):
    x, dt, a, b, c, h0 = _ssd_inputs(card, 6, 2, 300, 32, 16, True, seed=5)
    y, h = ssd_scan(x, dt, a, b, c, h0 if with_h0 else None, chunk=64)
    y2, h2 = ssd_ref(x, dt, a, b, c, h0 if with_h0 else None)
    torch.testing.assert_close(y, y2, atol=2e-4, rtol=1e-5)
    torch.testing.assert_close(h, h2, atol=2e-4, rtol=1e-5)


def test_ssd_chunk_bf16_raises(card):
    x, dt, a, b, c, _ = _ssd_inputs(card, 2, 2, 32, 8, 8, True, seed=0)
    with pytest.raises(TypeError):
        sk.ssd_chunk(x.bfloat16(), dt, a, b, c, chunk=16)


def _lazy_inputs(card, n, m, bn, seed):
    import repro_torch as pt
    g = torch.Generator(device=card).manual_seed(seed)
    return pt.from_array(torch.randn((n, m), generator=g, device=card), (bn, m),
                         device=card)


def test_lazy_fold_is_one_transposed_gemm(card, monkeypatch):
    """``(X.lazy().T @ X).compute()`` launches ``stacked_matmul`` once, with
    the transpose read through strides, and gives eager ``matmul_ta``'s
    bits; ``X.T`` is never materialised."""
    import repro_torch as pt
    from repro_torch.core import dsarray
    x = _lazy_inputs(card, 5000, 40, 1024, 1)
    want = pt.matmul_ta(x, x)
    recorded = x.lazy().T @ x      # metadata inference transposes meta tensors
    transposes = []
    real_t = dsarray.DsArray.transpose
    monkeypatch.setattr(dsarray.DsArray, "transpose",
                        lambda self: transposes.append(1) or real_t(self))
    before = mk.stacked_matmul.launches
    got = recorded.compute()
    torch.cuda.synchronize()
    assert mk.stacked_matmul.launches == before + 1
    assert transposes == []
    assert torch.equal(got.blocks, want.blocks)
    assert got.pad_state == want.pad_state and got.shape == want.shape


def test_lazy_hot_loop_optimizes_once_on_the_card(card):
    """The PCA power-iteration body recorded 20 times: the optimizer runs
    once, the run is built once, two GEMM launches an iteration, and each
    iteration's bits equal the eager loop's."""
    import repro_torch as pt
    from repro_torch.core import plan
    x = _lazy_inputs(card, 6000, 24, 1024, 2)
    xl = x.lazy()
    q = torch.linalg.qr(torch.randn((24, 4), device=card))[0]
    plan.clear_cache()
    before = mk.stacked_matmul.launches
    for _ in range(20):
        qd = pt.from_array(q, (24, 4), device=card)
        got = (xl.T @ (xl @ qd)).compute()
        want = pt.matmul_ta(x, x @ qd)
        assert torch.equal(got.blocks, want.blocks)
        q = torch.linalg.qr(got.collect())[0]
    st = plan.cache_stats()
    assert (st["opt_runs"], st["opt_skips"], st["misses"], st["hits"]) == \
        (1, 19, 1, 19), st
    assert mk.stacked_matmul.launches == before + 80     # lazy 40, eager 40


# ---------------------------------------------------------------------------
# Sparse blocks: products and the Lloyd step over stored entries
# ---------------------------------------------------------------------------


def _sparse_mid(card, seed):
    """A 40,000 x 4,000 ratings-like matrix (1.5 % stored, ratings 1..5) as
    a scipy CSR and as a sparse ds-array with blocks (4096, 1024)."""
    import repro_torch as pt
    ssp = pytest.importorskip("scipy.sparse")
    rng = np.random.default_rng(seed)
    mat = ssp.random(40_000, 4_000, density=0.015, random_state=seed, format="csr",
                     data_rvs=lambda k: rng.integers(1, 6, k)).astype(np.float32)
    return mat, pt.from_scipy(mat, (4096, 1024), device=card)


def _stored_bytes(r) -> int:
    return r.blocks.data.numel() * r.blocks.data.element_size() + \
        r.blocks.indices.numel() * 4


def _added_peak(fn):
    """(result, bytes): ``fn()`` and the device memory it added at its peak."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _within_depth(out, ref, depth: int):
    """|out - ref| <= 8·eps32·√depth·rms(ref) + eps32·|ref|: the fp32 error
    of a depth-long sum in another order (chip_smoke's GEMM limit); a
    zeroed output must fail it."""
    ref = ref.double()
    rms = float(ref.pow(2).mean().sqrt())
    eps = torch.finfo(torch.float32).eps
    lim = 8 * eps * depth ** 0.5 * rms + eps * ref.abs()
    assert bool(((out.double() - ref).abs() <= lim).all())
    assert not bool(((0 * ref - ref).abs() <= lim).all())


@pytest.fixture
def never_densified(monkeypatch):
    from repro_torch.core import sparse as smod
    from repro_torch.kernels.matmul import ops as mops

    def refuse(*args, **kwargs):
        raise AssertionError("a sparse operand was densified")
    for mod, name in ((smod, "todense"), (smod, "_to_dense_blocks"),
                      (mops, "_to_dense_blocks")):
        monkeypatch.setattr(mod, name, refuse)


def test_sparse_products_on_the_card(card, never_densified):
    """``R @ V`` and ``matmul_ta(R, U)`` (f = 16): float64 agreement, the
    same bits twice, added peak memory below half of R's stored bytes, no
    GEMM kernel launched."""
    import repro_torch as pt
    mat, r = _sparse_mid(card, 3)
    g = torch.Generator(device=card).manual_seed(4)
    v = torch.randn((4_000, 16), generator=g, device=card)
    u = torch.randn((40_000, 16), generator=g, device=card)
    vd = pt.from_array(v, (1024, 16), device=card)
    ud = pt.from_array(u, (4096, 16), device=card)
    m64 = mat.astype(np.float64)
    before = mk.stacked_matmul.launches
    rv, rv_added = _added_peak(lambda: r @ vd)
    rtu, rtu_added = _added_peak(lambda: pt.matmul_ta(r, ud))
    assert mk.stacked_matmul.launches == before
    assert torch.equal((r @ vd).blocks, rv.blocks)
    assert torch.equal(pt.matmul_ta(r, ud).blocks, rtu.blocks)
    assert torch.equal((r.T @ ud).blocks, rtu.blocks)
    row_depth = int(np.diff(mat.indptr).max())
    col_depth = int(np.bincount(mat.indices, minlength=4_000).max())
    _within_depth(rv.collect(), torch.from_numpy(m64 @ v.double().cpu().numpy()).to(card),
                  row_depth)
    _within_depth(rtu.collect(),
                  torch.from_numpy(np.asarray(m64.T @ u.double().cpu().numpy())).to(card),
                  col_depth)
    half = _stored_bytes(r) / 2
    assert rv_added < half and rtu_added < half, (rv_added, rtu_added, half)


def test_sparse_lloyd_step_on_the_card(card, never_densified):
    """One sparse Lloyd assignment (k = 8): labels are the float64 argmin
    except at near-ties, sums and counts are float64 sums under those
    labels, the same bits twice, added peak below half of R's stored bytes,
    no K-means kernel launched."""
    from repro_torch.algorithms import kmeans as kmod
    mat, r = _sparse_mid(card, 5)
    g = torch.Generator(device=card).manual_seed(6)
    gn, gm, bn, bm = r.blocks.shape
    k, n = 8, r.shape[0]
    centers = torch.zeros((k, gm * bm), device=card)
    centers[:, :4_000] = torch.rand((k, 4_000), generator=g, device=card) * 0.2
    rows = torch.arange(gn * bn, device=card).reshape(gn, bn)
    row_valid = rows < n
    x_sq = kmod._row_sq_norms(r)
    before = kk.kmeans_assign_stacked.launches
    (labels, sums, counts), added = _added_peak(
        lambda: kmod._sparse_center_stats(r, row_valid, centers, x_sq))
    again = kmod._sparse_center_stats(r, row_valid, centers, x_sq)
    assert kk.kmeans_assign_stacked.launches == before
    for a, b in zip((labels, sums, counts), again):
        assert torch.equal(a, b)
    assert added < _stored_bytes(r) / 2, added
    m64 = mat.astype(np.float64)
    c64 = centers[:, :4_000].double().cpu().numpy()
    x_sq64 = np.asarray(m64.multiply(m64).sum(axis=1)).ravel()
    dist64 = x_sq64[:, None] - 2 * np.asarray(m64 @ c64.T) + (c64 * c64).sum(1)
    dist32 = (x_sq[..., None] - 2.0 * kmod._dots(r, centers)
              + (centers * centers).sum(1)).reshape(-1, k)[:n].double().cpu().numpy()
    err = np.abs(dist32 - dist64).max()
    got = labels.reshape(-1)[:n].cpu().numpy()
    diff = got != dist64.argmin(1)
    two = np.sort(dist64[diff], axis=1)[:, :2]
    assert np.all(two[:, 1] - two[:, 0] < 4 * err) and diff.sum() <= 4
    onehot = np.eye(k)[got]
    want_sums = np.asarray(m64.T @ onehot).T                   # (k, 4000)
    _within_depth(sums[:, :4_000], torch.from_numpy(want_sums).to(card),
                  int(onehot.sum(0).max()))
    assert float(sums[:, 4_000:].abs().max()) == 0.0
    np.testing.assert_array_equal(counts.cpu().numpy(), onehot.sum(0))


# ---------------------------------------------------------------------------
# The estimators: each fitted on the card and on the CPU, in the port
# ---------------------------------------------------------------------------


def _on(x, block, device):
    import repro_torch as pt
    return pt.from_array(x, block, device=device)


def _host(a):
    from repro_torch.core import DsArray
    if isinstance(a, DsArray):
        a = a.collect()
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _est_data(seed, n=600, m=12):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, m)) * 4
    lab = rng.integers(0, 4, n)
    x = (centers[lab] + rng.normal(size=(n, m))).astype(np.float32)
    y = (x @ rng.normal(size=m) + 0.3 + 0.05 * rng.normal(size=n)).astype(np.float32)
    return x, y, lab.astype(np.int32)


@pytest.mark.parametrize("solver,alpha", [("auto", 0.0), ("tsqr", 0.0), ("auto", 1.0)])
def test_linear_on_the_card(card, solver, alpha):
    """Coefficients within rtol = atol = 1e-4 of the CPU fit; the products
    launch ``stacked_matmul`` and never take the plain version."""
    from repro_torch.estimators import LinearRegression
    from repro_torch.obs import registry
    x, y, _ = _est_data(1)
    before, plain = mk.stacked_matmul.launches, registry.snapshot("gemm")["gemm.dispatch_plain"]
    gpu = LinearRegression(alpha=alpha, solver=solver).fit(_on(x, (128, 12), card), y)
    pred = gpu.predict(_on(x, (128, 12), card))
    assert mk.stacked_matmul.launches > before
    assert registry.snapshot("gemm")["gemm.dispatch_plain"] == plain
    cpu = LinearRegression(alpha=alpha, solver=solver).fit(_on(x, (128, 12), "cpu"), y)
    assert gpu.solver_used_ == cpu.solver_used_
    np.testing.assert_allclose(gpu.coef_, cpu.coef_, rtol=1e-4, atol=1e-4)
    assert gpu.intercept_ == pytest.approx(cpu.intercept_, rel=1e-4, abs=1e-4)
    np.testing.assert_allclose(_host(pred).ravel(), x @ gpu.coef_ + gpu.intercept_,
                               rtol=1e-4, atol=1e-4)


def test_forest_on_the_card(card):
    """The same trees on the card as on the CPU, and the same predictions."""
    from repro_torch.estimators import RandomForestClassifier
    x, _, lab = _est_data(2)
    gpu = RandomForestClassifier(n_estimators=4, max_depth=5).fit(_on(x, (100, 12), card), lab)
    cpu = RandomForestClassifier(n_estimators=4, max_depth=5).fit(_on(x, (100, 12), "cpu"), lab)
    for name in ("edges_", "feat_", "bin_", "leaf_class_"):
        np.testing.assert_array_equal(getattr(gpu, name), getattr(cpu, name))
    np.testing.assert_array_equal(_host(gpu.predict(_on(x, (100, 12), card))),
                                  _host(cpu.predict(_on(x, (100, 12), "cpu"))))


def test_pca_and_tsqr_on_the_card(card, monkeypatch):
    """PCA from one starting draw: components up to sign and variances at
    1e-4 of the CPU fit; TSQR's Q·R and QᵀQ within 1e-4."""
    from repro_torch.algorithms import PCA, linalg, tsqr
    x, _, _ = _est_data(3)
    q0 = np.random.default_rng(0).normal(size=(12, 3)).astype(np.float32)
    monkeypatch.setattr(linalg, "_initial_q",
                        lambda m, k, seed, device: torch.as_tensor(q0, device=device))
    gpu = PCA(n_components=3).fit(_on(x, (128, 12), card))
    cpu = PCA(n_components=3).fit(_on(x, (128, 12), "cpu"))
    g, c = _host(gpu.components_), _host(cpu.components_)
    signs = np.sign((g * c).sum(1, keepdims=True))
    np.testing.assert_allclose(g * signs, c, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_host(gpu.explained_variance_),
                               _host(cpu.explained_variance_), rtol=1e-4)
    q, r = tsqr(_on(x, (128, 12), card))
    q64, r64 = q.double(), r.double()
    assert float((q64 @ r64 - torch.as_tensor(x, device=card).double()).abs().max()) < 1e-4
    assert float((q64.T @ q64 - torch.eye(12, device=card, dtype=torch.float64)).abs().max()) < 1e-4


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_als_on_the_card(card, monkeypatch, sparse):
    """ALS from one starting U and V: U and V after 3 iterations within
    rtol 1e-3 (of their scale) of the CPU fit."""
    import repro_torch as pt
    from repro_torch.algorithms import ALS, als
    rng = np.random.default_rng(4)
    r = (rng.normal(size=(300, 4)) @ rng.normal(size=(4, 200))).astype(np.float32)
    if sparse:
        r = (r * (rng.random(r.shape) < 0.3)).astype(np.float32)
    u0 = rng.random((300, 4)).astype(np.float32)
    v0 = rng.random((200, 4)).astype(np.float32)
    monkeypatch.setattr(als, "random_array",
                        lambda gen, shape, block_shape, device="cuda", **kw:
                        pt.from_array(u0 if shape[0] == 300 else v0, block_shape,
                                      device=device))
    fits = []
    for dev in (card, "cpu"):
        rd = _on(r, (64, 64), dev)
        fits.append(ALS(n_factors=4, max_iter=3, check_convergence=False)
                    .fit(rd.tosparse() if sparse else rd))
    for name in ("u_", "v_"):
        g, c = _host(getattr(fits[0], name)), _host(getattr(fits[1], name))
        np.testing.assert_allclose(g, c, rtol=1e-3, atol=1e-3 * np.abs(c).max())


@pytest.mark.parametrize("kernel,sparse", [("linear", False), ("rbf", False),
                                           ("rbf", True)])
def test_csvm_on_the_card(card, kernel, sparse):
    """Predictions equal the CPU fit's except where |decision| < 1e-4, and
    ``dual_coef_`` within 1e-3."""
    from repro_torch.estimators import CascadeSVM
    x, _, lab = _est_data(5, n=400)
    if sparse:
        x = np.where(np.abs(x) < 2.0, 0.0, x).astype(np.float32)
    y = (lab < 2).astype(np.int32)
    fits, decs = [], []
    for dev in (card, "cpu"):
        xd = _on(x, (50, 12), dev)
        xd = xd.tosparse() if sparse else xd
        est = CascadeSVM(kernel=kernel, sv_cap=48, max_iter=3).fit(xd, y)
        fits.append(_host(est.predict(xd)).ravel())
        decs.append(_host(est.decision_function(xd)).ravel())
        fits.append(_host(est.dual_coef_))
    firm = np.abs(decs[1]) >= 1e-4
    np.testing.assert_array_equal(fits[0][firm], fits[2][firm])
    np.testing.assert_allclose(fits[1], fits[3], atol=1e-3)
