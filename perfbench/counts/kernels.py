"""Each kernel's operations and bytes from the shapes of its call: what the
work needs, whatever a kernel does (each input read once, each output
written once, only the pairs a mask keeps).  With ``peaks.least_time``
they give a call's least time, the numerator of a roofline share."""

from __future__ import annotations

from perfbench.counts.flops import pairs


def attention(b: int, hq: int, hkv: int, t: int, d: int, window: int = 0,
              itemsize: int = 2):
    """Causal (windowed) attention forward, q (B, Hq, T, D), k/v (B, Hkv,
    T, D): (flops, bytes).  QKᵀ and PV, 2·D flops each a kept pair and
    head; q, k, v read and the output written once."""
    flop = 4 * d * b * hq * pairs(t, window)
    nbytes = itemsize * b * t * d * (2 * hq + 2 * hkv)
    return flop, nbytes


def ssd_chunk(bh: int, t: int, p: int, s: int, bg: int, chunk: int):
    """The SSD's chunk-local terms (float32): per head and chunk of L
    positions, C·Bᵀ over the kept (lower) L(L+1)/2 pairs (2·S each), their
    product with x·dt (2·P each), and the chunk's state Bᵀ(x·dt) (2·S·P a
    position).  Reads x (BH, T, P), dt (BH, T), a (BH,), B and C (BG, T,
    S); writes y (BH, T, P), the states (BH, T/L, S, P), C·exp(ℓ) (BH, T,
    S) and the decays (BH, T/L)."""
    nc = t // chunk
    tri = chunk * (chunk + 1) // 2
    flop = bh * nc * (2 * s * tri + 2 * p * tri + 2 * s * p * chunk)
    words = (bh * t * p + bh * t + bh + 2 * bg * t * s          # read
             + bh * t * p + bh * nc * s * p + bh * t * s + bh * nc)   # written
    return flop, 4 * words


def kmeans_assign(n: int, d: int, k: int):
    """One assignment pass over n rows of d float32 features and k centers:
    2·n·k·d flops; the rows and centers read, the labels (int32), the
    per-cluster sums and counts written."""
    flop = 2 * n * k * d
    nbytes = 4 * (n * d + k * d + n + k * d + k)
    return flop, nbytes
