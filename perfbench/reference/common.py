"""Plain PyTorch building blocks of the references: float32 throughout, TF32
off, no kernel of the port and nothing imported from it.

Every product goes through :func:`prod`, whose precision is set by
:func:`precision`: ``"fp32"`` (the reference), ``"tf32"`` or ``"fp8"``
(the controls: the same arithmetic in the next precision below the one
the configuration states).  Under ``"fp8"`` both operands of a product,
and the gradient that reaches it, are rounded to float8 e4m3 with a
per-tensor scale, and so is each layer's output (:func:`held`); under
``"tf32"`` the products run with TF32 on and what :func:`held` holds is
rounded to TF32's 10 bits of mantissa.
"""

from __future__ import annotations

import contextlib
import math
import torch
import torch.nn.functional as F

_MODE = {"p": "fp32"}
FP8_MAX = 448.0


@contextlib.contextmanager
def precision(mode: str):
    """Products in ``mode`` (``fp32``, ``tf32`` or ``fp8``) inside the block."""
    if mode not in ("fp32", "tf32", "fp8"):
        raise ValueError(mode)
    saved = (_MODE["p"], torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _MODE["p"] = mode
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        (_MODE["p"], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale (float32 out)."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / FP8_MAX
    return ((t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (float32 with 10 bits of mantissa), to nearest."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _round(t: torch.Tensor) -> torch.Tensor:
    if _MODE["p"] != "fp8" or t.dtype == torch.bool or not t.is_floating_point():
        return t
    if t.requires_grad:
        return _Straight.apply(t)
    return fp8(t)


class _Straight(torch.autograd.Function):
    """fp8 rounding, its gradient passed on unchanged."""

    @staticmethod
    def forward(ctx, t):
        return fp8(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """The identity, whose gradient is rounded to fp8."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return fp8(g)


def held(t: torch.Tensor) -> torch.Tensor:
    """An activation as the current precision holds it between layers
    (rounded to fp8 under ``"fp8"``, its gradient too; to TF32 under
    ``"tf32"``, which no gradient passes)."""
    if _MODE["p"] == "tf32":
        return tf32(t)
    if _MODE["p"] != "fp8":
        return t
    return _RoundGrad.apply(_round(t))


def prod(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` in the current precision."""
    out = torch.einsum(eq, _round(a), _round(b))
    if _MODE["p"] == "fp8" and out.requires_grad:
        out = _RoundGrad.apply(out)
    return out


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K) and w (K, N)."""
    return prod("...k,kn->...n", x, w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             plus_one: bool = False) -> torch.Tensor:
    y = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return y * (1.0 + scale if plus_one else scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, H, T, D), positions 0..T-1: rotary embedding, halves rotated."""
    d, t = x.shape[-1], x.shape[-2]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _mask(lo: int, hi: int, tk: int, window: int, device) -> torch.Tensor:
    q = torch.arange(lo, hi, device=device)[:, None]
    k = torch.arange(tk, device=device)[None, :]
    m = q >= k
    if window > 0:
        m = m & ((q - k) < window)
    return m


def _qe(eq, a, b):
    """An einsum of plain tensors in the current precision (no autograd)."""
    return torch.einsum(eq, _round(a), _round(b))


class Attention(torch.autograd.Function):
    """Causal (optionally windowed) softmax attention, q (B, H, T, D) and
    k, v (B, Hkv, T, D), scale 1/sqrt(D): scores and softmax in fp32, the
    queries taken ``CHUNK`` at a time in the forward and again in the
    backward, so that the live scores are (B, H, CHUNK, T)."""

    CHUNK = 1024

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        b, h, t, d = q.shape
        g = h // k.shape[1]
        kf, vf = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        out = torch.empty_like(q)
        for lo in range(0, t, Attention.CHUNK):
            hi = min(t, lo + Attention.CHUNK)
            s = _qe("bhqd,bhkd->bhqk", q[:, :, lo:hi], kf) / math.sqrt(d)
            s.masked_fill_(~_mask(lo, hi, t, window, q.device), float("-inf"))
            p = torch.softmax(s, dim=-1)
            out[:, :, lo:hi] = _qe("bhqk,bhkd->bhqd", p, vf)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        b, h, t, d = q.shape
        hkv = k.shape[1]
        g = h // hkv
        kf, vf = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        do = _round(do)
        dq = torch.empty_like(q)
        dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
        for lo in range(0, t, Attention.CHUNK):
            hi = min(t, lo + Attention.CHUNK)
            qc, doc = q[:, :, lo:hi], do[:, :, lo:hi]
            s = _qe("bhqd,bhkd->bhqk", qc, kf) / math.sqrt(d)
            s.masked_fill_(~_mask(lo, hi, t, ctx.window, q.device), float("-inf"))
            p = torch.softmax(s, dim=-1)
            dv += _qe("bhqk,bhqd->bhkd", p, doc)
            dp = _qe("bhqd,bhkd->bhqk", doc, vf)
            ds = p * (dp - (p * dp).sum(-1, keepdim=True)) / math.sqrt(d)
            dq[:, :, lo:hi] = _qe("bhqk,bhkd->bhqd", ds, kf)
            dk += _qe("bhqk,bhqd->bhkd", ds, qc)
        return (dq, dk.reshape(b, hkv, g, t, d).sum(2),
                dv.reshape(b, hkv, g, t, d).sum(2), None)


def attention(q, k, v, window: int = 0):
    return Attention.apply(q, k, v, window)


def swiglu(x, w_gate, w_up, w_down):
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def lm_loss(hidden: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
            z_loss: float = 1e-4, chunk: int = 4096) -> torch.Tensor:
    """Token-mean next-token cross-entropy plus ``z_loss``·lse² from the final
    hidden states (B, T, D), the logits formed ``chunk`` tokens at a time
    (again in the backward)."""
    from torch.utils.checkpoint import checkpoint
    b, t, _ = hidden.shape

    def part(h, lab):
        logits = mm(h, head)
        lse = torch.logsumexp(logits, dim=-1)
        nll = lse - logits.gather(-1, lab[..., None].long())[..., 0]
        return (nll + z_loss * lse * lse).sum(dim=-1)

    total = hidden.new_zeros(b)
    for lo in range(0, t, chunk):
        args = (hidden[:, lo:lo + chunk], labels[:, lo:lo + chunk])
        total = total + (checkpoint(part, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else part(*args))
    return total.sum() / (b * t)


# ---------------------------------------------------------------------------
# The SSD (Mamba-2's state-space dual), chunked
# ---------------------------------------------------------------------------


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, chunk: int) -> torch.Tensor:
    """The recurrence h_t = exp(a dt_t) h_{t-1} + dt_t B_t x_tᵀ, y_t = C_t h_t
    from h_0 = 0, in chunks: x (B, T, H, P), dt (B, T, H), a (H,), b/c
    (B, T, G, S) with head i reading group i // (H // G) -> y (B, T, H, P)."""
    bs, t, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    nc, L = t // chunk, chunk
    rep = h // g
    xc = x.reshape(bs, nc, L, h, p)
    dtc = dt.reshape(bs, nc, L, h)
    bc = b.repeat_interleave(rep, 2).reshape(bs, nc, L, h, s)
    cc = c.repeat_interleave(rep, 2).reshape(bs, nc, L, h, s)
    ell = torch.cumsum(a * dtc, dim=2)                                 # (B,NC,L,H)
    tri = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    diff = ell[:, :, :, None, :] - ell[:, :, None, :, :]               # (B,NC,L,L,H)
    gate = torch.where(tri[None, None, :, :, None],
                       torch.exp(torch.where(tri[None, None, :, :, None], diff, 0.0)),
                       0.0)
    scores = prod("bnlhs,bnmhs->bnlmh", cc, bc) * gate
    y = prod("bnlmh,bnmhp->bnlhp", scores, xc * dtc[..., None])
    w_end = torch.exp(ell[:, :, -1:] - ell)                            # (B,NC,L,H)
    states = prod("bnlhs,bnlhp->bnhsp", bc * (w_end * dtc)[..., None], xc)
    decay = torch.exp(ell[:, :, -1])                                   # (B,NC,H)
    hstate = x.new_zeros(bs, h, s, p)
    prev = []
    for n in range(nc):
        prev.append(hstate)
        hstate = decay[:, n, :, None, None] * hstate + states[:, n]
    y_inter = prod("bnlhs,bnhsp->bnlhp", cc * torch.exp(ell)[..., None],
                   torch.stack(prev, 1))
    return (y + y_inter).reshape(bs, t, h, p)


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution along T: x (B, T, C), w (K, C)."""
    k, t = w.shape[0], x.shape[1]
    xx = F.pad(x, (0, 0, k - 1, 0))
    out = xx[:, 0:t] * w[0]
    for i in range(1, k):
        out = out + xx[:, i:i + t] * w[i]
    return out + bias
