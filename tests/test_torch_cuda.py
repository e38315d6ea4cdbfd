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
    (256, 384, 8, 4, 256, True, 128, 50.0, 128),   # gemma2: window, soft-cap, GQA 8:4
    (1, 300, 8, 4, 256, False, 0, 50.0, 0),    # gemma2 decode: D = 256 on the rows kernel
    (200, 260, 4, 2, 80, True, 0, 0.0, 60),    # D = 80 with q_offset
    (150, 150, 2, 1, 112, True, 48, 0.0, 0),   # D = 112: a zeroed padding chunk
    # the encoder-decoder (seamless-m4t-medium: 16 heads of 64)
    (200, 200, 16, 16, 64, False, 0, 0.0, 0),  # bidirectional encoder
    (96, 600, 16, 16, 64, False, 0, 0.0, 0),   # cross-attention, Tq < Tk
    (500, 70, 4, 4, 64, False, 0, 0.0, 0),     # Tq > Tk, a ragged last key tile
    (1, 256, 16, 16, 64, False, 0, 0.0, 0),    # decode cross-attention: rows, every slot
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
    (8, 2, 256, 64, 128, 128),     # mamba2: S = 128 at P = 64, chunk 128
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


@pytest.mark.parametrize("dtype,route,window,cap", [
    (torch.bfloat16, "wgmma", 0, 0.0), (torch.bfloat16, "wgmma", 40, 0.0),
    (torch.float32, "tile", 0, 0.0), (torch.float32, "tile", 0, 30.0)])
def test_flash_attention_grads_on_the_card_match_plain(card, dtype, route, window,
                                                       cap):
    """``ops.flash_attention`` under autograd on the card: its forward
    launches the kernel once by ``route``, its backward none, and its
    gradients are autograd's of the plain version on the same inputs
    (the model's (B, T, H, D) views, GQA 4/2, D = 80)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    g = torch.Generator(device=card).manual_seed(window)
    x = torch.randn((2, 200, 12, 80), generator=g, device=card).to(dtype)
    q = x[:, :, :4].transpose(1, 2).detach().requires_grad_()
    k, v = (x[:, :, i:i + 2].transpose(1, 2).detach().requires_grad_()
            for i in (4, 8))
    do = torch.randn((2, 4, 200, 80), generator=g, device=card).to(dtype)
    kw = dict(causal=True, window=window, softcap=cap)
    out = _routed(fk.flash_attention.route_launches, route,
                  lambda: flash_attention(q, k, v, **kw))
    before = dict(fk.flash_attention.route_launches)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert fk.flash_attention.route_launches == before
    plain = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*plain, **kw), plain, do)
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g_, w_ in zip("qkv", got, want):
        assert g_.dtype == dtype
        scale = max(1.0, float(w_.float().abs().max()))
        torch.testing.assert_close(g_.float(), w_.float(), atol=atol * scale,
                                   rtol=0, msg=f"d{name}")


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "tile")])
def test_flash_attention_grads_non_causal_rectangular(card, dtype, route):
    """The encoder-decoder's forms under autograd on the card: non-causal
    attention with Tq != Tk at D = 64 (cross-attention), the forward one
    launch by ``route``, the backward none, the gradients autograd's of the
    plain version."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    g = torch.Generator(device=card).manual_seed(7)
    q = torch.randn((2, 4, 96, 64), generator=g, device=card).to(dtype).requires_grad_()
    k, v = (torch.randn((2, 4, 300, 64), generator=g, device=card).to(dtype)
            .requires_grad_() for _ in range(2))
    do = torch.randn((2, 4, 96, 64), generator=g, device=card).to(dtype)
    kw = dict(causal=False)
    out = _routed(fk.flash_attention.route_launches, route,
                  lambda: flash_attention(q, k, v, **kw))
    before = dict(fk.flash_attention.route_launches)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert fk.flash_attention.route_launches == before
    plain = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*plain, **kw), plain, do)
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g_, w_ in zip("qkv", got, want):
        scale = max(1.0, float(w_.float().abs().max()))
        torch.testing.assert_close(g_.float(), w_.float(), atol=atol * scale,
                                   rtol=0, msg=f"d{name}")


def test_ssd_scan_grads_on_the_card_match_plain(card):
    """``ssd_scan`` under autograd on the card: the chunk kernel launches
    once on the mma route, its backward none, and the gradients of all six
    inputs (B, C per group) are autograd's of the scan over the plain
    chunk."""
    from repro_torch.kernels.ssd import ops as sops
    args = [t.requires_grad_() for t in
            _ssd_inputs(card, 8, 2, 300, 64, 64, True, seed=11)]
    gen = torch.Generator(device=card).manual_seed(12)
    y, h = _routed(sk.ssd_chunk.route_launches, "mma",
                   lambda: ssd_scan(*args, chunk=128))
    ry = torch.randn(y.shape, generator=gen, device=card)
    rh = torch.randn(h.shape, generator=gen, device=card)
    before = dict(sk.ssd_chunk.route_launches)
    got = torch.autograd.grad((y * ry).sum() + (h * rh).sum(), args)
    assert sk.ssd_chunk.route_launches == before
    plain = [t.detach().requires_grad_() for t in args]
    saved = sops.ssd_chunk
    sops.ssd_chunk = ssd_chunk_ref
    try:
        y2, h2 = ssd_scan(*plain, chunk=128)
    finally:
        sops.ssd_chunk = saved
    want = torch.autograd.grad((y2 * ry).sum() + (h2 * rh).sum(), plain)
    for name, g_, w_ in zip(("x", "dt", "a", "b", "c", "h0"), got, want):
        scale = max(1.0, float(w_.abs().max()))
        torch.testing.assert_close(g_, w_, atol=1e-4 * scale, rtol=1e-4, msg=name)


@pytest.mark.parametrize("case", [
    (2, 8, 2, 300, 300, 128, torch.bfloat16, dict(causal=True, window=64)),  # wgmma
    (2, 4, 4, 40, 40, 80, torch.float32, dict(causal=True)),                 # tile
    (4, 8, 2, 1, 320, 64, torch.bfloat16, dict(causal=False, kv_len=200)),  # rows
])
def test_meta_branches_give_the_kernels_outputs(card, case):
    """The shape-only branch a dry run takes (``meta`` operands) gives the
    shapes, dtypes and strides of what the kernels return on the card."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd.ops import ssd_chunk
    b, hq, hkv, tq, tk, d, dt, kw = case
    g = torch.Generator(device=card).manual_seed(tq)
    q, k, v = (torch.randn(s, generator=g, device=card).to(dt)
               for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
    real = flash_attention(q, k, v, **kw)
    meta = flash_attention(*(t.to("meta") for t in (q, k, v)), **kw)
    assert (meta.shape, meta.dtype, meta.stride()) == (real.shape, real.dtype, real.stride())
    x = torch.randn(8, 256, 64, generator=g, device=card)
    args = (x, torch.rand(8, 256, generator=g, device=card), -torch.rand(8, device=card),
            torch.randn(2, 256, 64, generator=g, device=card),
            torch.randn(2, 256, 64, generator=g, device=card))
    real = ssd_chunk(*args, chunk=128)
    meta = ssd_chunk(*(t.to("meta") for t in args), chunk=128)
    assert [(m.shape, m.dtype, m.stride()) for m in meta] == [
        (r.shape, r.dtype, r.stride()) for r in real]


def test_kernels_without_backward_refuse_grad_on_the_card(card):
    a = torch.ones((1, 1, 8, 8), device=card, requires_grad=True)
    with pytest.raises(TypeError, match="stacked_matmul has no backward"):
        local_matmul(a, a)
    with torch.no_grad():
        assert not local_matmul(a, a).requires_grad


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


# ---------------------------------------------------------------------------
# The durable path: fit resume and streaming ingestion on the card
# ---------------------------------------------------------------------------


def test_kmeans_crash_resume_on_the_card(card, tmp_path):
    """A K-means fit crashed halfway and resumed from its checkpoint gives
    the uninterrupted fit's ``n_iter_`` and center bits, as does the
    checkpointed fit itself; every assignment launches ``kmeans_assign``."""
    import repro_torch as pt
    import repro_torch.resilience as R
    from repro_torch.algorithms import KMeans
    x, _, _ = _est_data(6, n=20000)
    xd = _on(x, (4096, x.shape[1]), card)
    kw = dict(n_clusters=8, max_iter=8, tol=0.0, seed=3)
    before = kk.kmeans_assign_stacked.launches
    ref = KMeans(**kw).fit(xd)
    assert kk.kmeans_assign_stacked.launches - before == ref.n_iter_ >= 3
    ck = KMeans(**kw).fit(xd, checkpoint_dir=str(tmp_path / "full"))
    assert torch.equal(ck.centers_, ref.centers_)
    d = str(tmp_path / "crash")
    with R.inject(R.FaultSpec(kind="crash", site="fit_iteration",
                              where={"iteration": max(2, ref.n_iter_ // 2)})):
        with pytest.raises(R.CrashError):
            KMeans(**kw).fit(xd, checkpoint_dir=d)
    resumed = KMeans(**kw).fit(xd, checkpoint_dir=d, resume=d)
    assert resumed.n_iter_ == ref.n_iter_
    assert torch.equal(resumed.centers_, ref.centers_)
    back = pt.load_model(_saved(ref, tmp_path / "model"), device=card)
    assert torch.equal(back.predict(xd).blocks, ref.predict(xd).blocks)


def _saved(est, path):
    est.save_model(str(path))
    return str(path)


def test_npy_load_fault_mid_stream_frees_the_card(card, tmp_path):
    """An ``io_load`` fault at block row 3 of a ``.npy`` load raises
    ``IOLoadError`` and leaves ``memory_allocated`` where it was; the load
    then gives the file's bits."""
    import gc
    import repro_torch.resilience as R
    from repro_torch.core import io as rio
    arr = np.random.default_rng(7).normal(size=(10000, 48)).astype(np.float32)
    p = str(tmp_path / "x.npy")
    np.save(p, arr)
    gc.collect()                      # earlier tests' garbage, before the base
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    raised = False
    try:
        with R.inject(R.FaultSpec(kind="io", site="io_load",
                                  where={"source": "load_npy_rows",
                                         "block_row": 3})):
            rio.load_npy_rows(p, (1024, 48), device=card)
    except R.IOLoadError:
        raised = True
    gc.collect()
    assert raised
    assert torch.cuda.memory_allocated() == base
    got = rio.load_npy_rows(p, (1024, 48), device=card)
    assert torch.equal(got.collect().cpu(), torch.from_numpy(arr))


def test_einsum_rung_keeps_the_kernel_in_low_memory(card):
    """The ladder's last rung on the card launches ``stacked_matmul`` with
    its split-K workspace within the low-memory cap where the fused run's
    passes it; it never takes the plain version, and both results are
    within the GEMM limit of float64."""
    import repro_torch as pt
    import repro_torch.resilience as R
    from repro_torch.obs import registry
    rng = np.random.default_rng(11)
    x = pt.from_array(rng.normal(size=(65536, 256)).astype(np.float32),
                      (8192, 256), device=card)
    chain = x.lazy().T @ x               # four 128² tiles, K = 65,536: split-K
    mk.stacked_matmul.max_workspace = 0
    fused = pt.compute(chain)
    assert mk.stacked_matmul.max_workspace > mk.LOW_MEMORY_WORKSPACE
    mk.stacked_matmul.max_workspace = 0
    n = mk.stacked_matmul.launches
    plain = registry.snapshot("gemm")["gemm.dispatch_plain"]
    R.reset_stats()
    with R.inject(R.FaultSpec(kind="oom", site="plan_execute",
                              modes=("fused", "eager"), times=None)):
        low = R.run_resilient(chain)
    assert R.stats()["degradations"] == 2
    assert mk.stacked_matmul.launches > n
    assert 0 < mk.stacked_matmul.max_workspace <= mk.LOW_MEMORY_WORKSPACE
    assert registry.snapshot("gemm")["gemm.dispatch_plain"] == plain
    ref = x.collect().double().T @ x.collect().double()
    rms = float(ref.pow(2).mean().sqrt())
    atol = 8 * torch.finfo(torch.float32).eps * 65536 ** 0.5 * rms
    for got in (fused, low):
        torch.testing.assert_close(got.collect().double(), ref, atol=atol,
                                   rtol=torch.finfo(torch.float32).eps)


# ---------------------------------------------------------------------------
# the predict server and the profiler on the card
# ---------------------------------------------------------------------------


def _card_ridge(card, n=4096, m=512, seed=21):
    import repro_torch as pt
    from repro_torch.estimators import Ridge
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)).astype(np.float32)
    y = x @ rng.normal(size=(m,)).astype(np.float32) + 0.5
    return Ridge(alpha=0.1).fit(pt.from_array(x, (1024, m), device=card), y)


def test_served_rows_are_predict_on_the_padded_batch_on_the_card(card):
    """Each served row is the bits of ``predict`` on the padded bucket batch
    (the same batch served twice gives the same bits: the split-K
    workspace does not change them); a lone row is a direct one-row
    predict's bits; no GEMM takes the plain version."""
    import repro_torch.serve as serve
    from repro_torch.obs import registry
    from repro_torch.serve.batching import assemble
    est = _card_ridge(card)
    reg = serve.ModelRegistry(device="cuda")
    model = reg.register("ridge", est, batch_sizes=(1, 8, 32), block_rows=32)
    srv = serve.PredictServer(reg)
    rng = np.random.default_rng(5)
    plain = registry.snapshot("gemm")["gemm.dispatch_plain"]
    for sizes in ((3, 4), (20, 7, 1), (8,)):
        payloads = [rng.normal(size=(s, 512)).astype(np.float32) for s in sizes]
        runs = []
        for _ in range(2):
            futs = [srv.submit("ridge", p) for p in payloads]
            srv.pump()
            runs.append(np.concatenate([f.result() for f in futs]))
        assert np.array_equal(runs[0], runs[1])
        batch = assemble(payloads, model.spec.bucket_for(sum(sizes), "dense"))
        want = est.predict(batch).collect().cpu().numpy()[:sum(sizes)]
        assert np.array_equal(runs[0], want)
    row = rng.normal(size=(1, 512)).astype(np.float32)
    f = srv.submit("ridge", row)
    srv.pump()
    assert np.array_equal(f.result(), model.predict_direct(row))
    assert registry.snapshot("gemm")["gemm.dispatch_plain"] == plain


def test_warmed_stream_has_zero_recompiles_on_the_card(card):
    """Across a warmed stream: ``opt_runs``, ``misses`` and ``aot_compiles``
    frozen, ``cache_hits == requests``, no shed, fallback or failure; the
    K-means model serves eagerly, every assign on the mma route, labels
    equal to a direct predict."""
    import repro_torch as pt
    import repro_torch.serve as serve
    from repro_torch.algorithms import KMeans
    from repro_torch.core import plan as plan_mod
    serve.reset_stats()
    plan_mod.clear_cache()
    est = _card_ridge(card)
    rng = np.random.default_rng(6)
    km = KMeans(n_clusters=8, max_iter=5, seed=0).fit(pt.from_array(
        rng.normal(size=(4096, 64)).astype(np.float32), (1024, 64),
        device=card))
    reg = serve.ModelRegistry(device="cuda")
    reg.register("ridge", est, batch_sizes=(1, 8, 32), block_rows=32)
    reg.register("km", km, n_features=64, batch_sizes=(1, 8, 32),
                 block_rows=32)
    srv = serve.PredictServer(reg)
    warm = plan_mod.cache_stats()
    kk.kmeans_assign_stacked.route_launches = dict.fromkeys(
        kk.kmeans_assign_stacked.route_launches, 0)
    n = 0
    for i in range(12):
        s = (1, 5, 8, 30)[i % 4]
        fr = srv.submit("ridge", rng.normal(size=(s, 512)).astype(np.float32))
        rows = rng.normal(size=(s, 64)).astype(np.float32)
        fk_ = srv.submit("km", rows)
        srv.pump()
        fr.result()
        assert np.array_equal(fk_.result(), reg.get("km").predict_direct(rows))
        n += 1
    after = plan_mod.cache_stats()
    for k in ("opt_runs", "misses", "aot_compiles"):
        assert after[k] == warm[k], k
    st = serve.stats()
    assert st["cache_hits"] == n and st["eager_requests"] == n
    assert st["requests"] == st["responses"] == 2 * n
    for k in ("batch_sheds", "bucket_fallbacks", "failures", "cache_misses",
              "dispatch_retries"):
        assert st[k] == 0, k
    routes = kk.kmeans_assign_stacked.route_launches
    assert routes["mma"] > 0 and routes["simt"] == 0


def test_profile_bytes_equal_the_law_on_the_card(card):
    """Every node's measured bytes equal the cost model's, on the card, for
    a fused chain and a served Ridge plan; the fused run's memory report
    counts the leaves and the outputs."""
    import repro_torch as pt
    from repro_torch import obs
    rng = np.random.default_rng(8)
    a = pt.from_array(rng.normal(size=(1000, 700)).astype(np.float32),
                      (256, 256), device=card).lazy()
    chain = (((a + a) * 2.0 - a).abs() * 0.5 + 0.25)
    est = _card_ridge(card)
    x = pt.from_array(rng.normal(size=(32, 512)).astype(np.float32),
                      (32, 512), device=card)
    for target in (chain, est.predict_plan(x)):
        rep = obs.profile(target)
        assert rep.nodes and rep.drifting() == []
        for rec in rep.nodes:
            assert rec.measured_bytes == rec.predicted_bytes, rec.site
        assert set(rep.compiled) == {"argument_bytes", "output_bytes",
                                     "temp_bytes"}
        assert rep.compiled["argument_bytes"] > 0
        assert rep.compiled["output_bytes"] == rep.nodes[-1].measured_bytes


def test_compile_aot_builds_the_kernels_before_the_first_request(card,
                                                                  monkeypatch):
    """With every kernel library unloaded, registering (``warm=True``) loads
    ``stacked_matmul``'s; the first request then needs no build: a build
    attempt would raise."""
    import repro_torch.serve as serve
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import _build
    est = _card_ridge(card)
    plan_mod.clear_cache()          # earlier tests cached runs of these keys
    monkeypatch.setattr(_build, "_libs", {})
    reg = serve.ModelRegistry(device="cuda")
    reg.register("ridge", est, batch_sizes=(1, 8), block_rows=8)
    assert "stacked_matmul" in _build._libs

    def no_build():
        raise AssertionError("a request built a kernel")

    monkeypatch.setattr(_build, "build_all", no_build)
    n = mk.stacked_matmul.launches
    srv = serve.PredictServer(reg)
    f = srv.submit("ridge", np.ones((5, 512), np.float32))
    srv.pump()
    assert f.result().shape == (5, 1)
    assert mk.stacked_matmul.launches > n


# ---------------------------------------------------------------------------
# Distribution: a one-rank NCCL mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_mesh(card, tmp_path):
    """A one-rank NCCL group (its store a file under ``tmp_path``) and a
    1 x 1 ``("data", "model")`` mesh on the card."""
    import torch.distributed as dist
    from repro_torch.core.compat import make_mesh
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype,route", [(torch.float32, "simt"),
                                         (torch.bfloat16, "wgmma")])
def test_summa_matmul_on_a_one_rank_nccl_mesh(nccl_mesh, dtype, route):
    """``summa_matmul`` at 4096² launches ``stacked_matmul`` once, on the
    route the dtype gives, on the rank's local shards: within the GEMM
    limit of the plain product, the same bits twice, the result on the
    mesh; its blocks (a DTensor) given to ``local_matmul`` raise."""
    import repro_torch as pt
    from repro_torch.core import placement, shmap_ops
    n, bs = 4096, (1024, 1024)
    g = torch.Generator(device="cuda").manual_seed(11)
    A = pt.from_array(torch.rand(n, n, generator=g, device="cuda") - 0.5, bs,
                      device="cuda").astype(dtype)
    B = pt.from_array(torch.rand(n, n, generator=g, device="cuda") - 0.5, bs,
                      device="cuda").astype(dtype)
    before = dict(mk.stacked_matmul.route_launches)
    C = shmap_ops.summa_matmul(A, B, nccl_mesh)
    torch.cuda.synchronize()
    after = mk.stacked_matmul.route_launches
    assert {r: after[r] - before[r] for r in after} == \
        {r: int(r == route) for r in after}
    assert C.is_distributed and C.mesh_axes[1] == ("data", "model")
    out = placement.local(C.blocks)
    _gemm_close(out, stacked_matmul_ref(A.blocks, B.blocks, out_dtype=dtype), n)
    again = placement.local(shmap_ops.summa_matmul(A, B, nccl_mesh).blocks)
    assert torch.equal(out, again)
    with pytest.raises(TypeError, match="DTensor"):
        local_matmul(C.blocks, C.blocks)


# ---------------------------------------------------------------------------
# The graph plane: the same graph on the card and on the CPU
# ---------------------------------------------------------------------------


def test_plan_graph_is_the_same_on_the_card_and_the_cpu(card):
    """The ds-array pipeline at 64 x 48 in 8 x 8 blocks (the six-op chain,
    one ``@`` and one folded ``matmul_ta``) recorded as one plan on the
    card and on the CPU: the two graphs are equal node for node, each
    ``stacked_matmul`` call one ``kernel:`` node on both (a ctypes launch
    on the card, the plain version's ops on the CPU)."""
    import repro_torch as pt
    from repro_torch.core import plan
    rng = np.random.default_rng(0)
    xa = rng.standard_normal((64, 48), np.float32)
    wa = rng.standard_normal((48, 32), np.float32)
    graphs = {}
    for dev in ("cpu", "cuda"):
        a = pt.from_array(xa, (8, 8), device=dev)
        w = pt.from_array(wa, (8, 8), device=dev)
        chain = ((a.lazy() + a) * 2.0 - a).abs() * 0.5 + 0.25
        p = plan.plan_for(chain, a.lazy() @ w, a.lazy().T @ a)
        before = mk.stacked_matmul.launches
        graphs[dev] = p.graph()
        torch.cuda.synchronize()
        if dev == "cuda":
            assert mk.stacked_matmul.launches == before + 2
    assert graphs["cuda"] == graphs["cpu"], (str(graphs["cuda"]),
                                             str(graphs["cpu"]))
    assert [n.op for n in graphs["cuda"] if n.kind == "kernel"] == \
        ["kernel:stacked_matmul"] * 2


# ---------------------------------------------------------------------------
# The MoE family: the attention kernel at D = 128 inside the model
# ---------------------------------------------------------------------------


def test_moe_forward_with_the_kernel_matches_the_plain_attention(card, monkeypatch):
    """mixtral's forward at a small width (2 layers, d_model 512, 4 query
    heads of 128 over 2 KV heads, 4 experts, window 64; T 200, so the
    window cuts), bf16: one ``flash_attention`` launch a layer, all on
    ``wgmma`` at D = 128, and the logits within 2·E of the same forward
    with the plain attention, E = rms(plain bf16 forward − its float32
    twin).  Every token goes to every expert (top-4 of 4, a dropless
    capacity), so the logits are a continuous function of the attention's
    output: under top-2 a rounding difference flips near-ties between
    experts, and such a jump is as large as E itself (chip_smoke.py holds
    the top-2 forward at its published width)."""
    import dataclasses
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.models import common as cm
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=2, d_model=512,
                              n_heads=4, n_kv_heads=2, d_ff=1024, vocab_size=1000,
                              n_experts=4, top_k=4, capacity_factor=4.0, attn_window=64)
    model = build_model(cfg)
    g = torch.Generator(device=card).manual_seed(21)
    with torch.inference_mode():
        params = model.init(g, card)
        tokens = torch.randint(0, cfg.vocab_size, (2, 200), generator=g, device=card)
        before = dict(fk.flash_attention.route_launches)
        got, aux = model.forward(params, tokens)
        torch.cuda.synchronize()
        diff = {r: n - before[r] for r, n in fk.flash_attention.route_launches.items()}
        assert diff == {r: 2 * (r == "wgmma") for r in diff}
        monkeypatch.setattr(cm, "flash_attention",
                            lambda q, k, v, **kw: attention_ref(q, k, v, **kw))
        plain, plain_aux = model.forward(params, tokens)
        twin = build_model(dataclasses.replace(cfg, dtype="float32"))
        exact, _ = twin.forward(pytree.tree_map(lambda t: t.float(), params), tokens)
    rms = lambda a, b: float((a.double() - b.double()).pow(2).mean().sqrt())  # noqa: E731
    own = rms(plain, exact)
    assert bool(torch.isfinite(got).all()) and own > 0
    assert rms(got, plain) <= 2 * own, (rms(got, plain), own)
    assert abs(float(aux) - float(plain_aux)) <= 1e-2 * float(plain_aux)


def test_meshed_step_on_one_rank_matches_unmeshed(card, tmp_path):
    """zamba2 SMOKE on a one-rank NCCL group and a 1 x 1 mesh: the meshed
    loss and gradients (DTensor parameters and batch, the kernels on each
    rank's local shards through ``local_map``) equal the unmeshed ones, with
    the same attention and SSD launches, route by route, on both."""
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.compat import make_mesh
    from repro_torch.data.pipeline import PipelineConfig, SyntheticPipeline
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import common as cm
    from repro_torch.models.model import build_model
    from repro_torch.train import loss_and_grads
    cfg = get_smoke_config("zamba2-2.7b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(3), card)
    for stack in (params["layers"], params["shared"]):
        for key in ("norm", "gate_norm", "ln1", "ln2"):
            if key in stack:
                stack[key].normal_(0.0 if key.startswith("ln") else 1.0, 0.1)
    pcfg = PipelineConfig(global_batch=4, seq_len=64, vocab_size=cfg.vocab_size)

    def counts():
        return {**{f"attn/{r}": n for r, n in fk.flash_attention.route_launches.items()},
                **{f"ssd/{r}": n for r, n in sk.ssd_chunk.route_launches.items()}}

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        c0 = counts()
        loss_u, grads_u = loss_and_grads(model, params, SyntheticPipeline(
            pcfg, device=card).batch_at(0))
        c1 = counts()
        placed = sh.distribute(params, sh.param_shardings(params, mesh))
        loss_m, grads_m = loss_and_grads(model, placed, SyntheticPipeline(
            pcfg, mesh).batch_at(0), cm.ShardEnv(mesh=mesh))
        c2 = counts()
        got = {p: g.to_local() for p, g in zip(*sh.tree_paths(grads_m)[:2])}
    finally:
        dist.destroy_process_group()
    unmeshed = {k: c1[k] - c0[k] for k in c0}
    meshed = {k: c2[k] - c1[k] for k in c1}
    assert unmeshed == meshed and unmeshed["attn/tile"] > 0 and unmeshed["ssd/mma"] > 0
    torch.testing.assert_close(loss_m, loss_u, rtol=1e-5, atol=0)
    for p, w in zip(*sh.tree_paths(grads_u)[:2]):
        scale = max(1e-6, float(w.abs().max()))
        torch.testing.assert_close(got[p], w, rtol=1e-4, atol=1e-4 * scale, msg=p)
