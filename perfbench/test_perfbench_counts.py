"""The yardstick's counts against hand counts at small sizes."""

import pytest

from perfbench.counts import flops, kernels, peaks

HYBRID = {"family": "hybrid", "n_layers": 4, "d_model": 8, "n_heads": 2, "n_kv_heads": 2,
          "d_ff": 16, "vocab_size": 10, "ssm_state": 4, "ssm_expand": 2,
          "ssm_headdim": 4, "ssm_ngroups": 1, "share_period": 2}
MOE = {"family": "moe", "n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
       "d_ff": 16, "vocab_size": 10, "n_experts": 4, "top_k": 2, "attn_window": 3}


def test_pairs():
    assert flops.pairs(4) == 10                        # 1 + 2 + 3 + 4
    assert flops.pairs(5, 2) == 1 + 2 + 2 + 2 + 2
    assert flops.pairs(3, 8) == 6


def test_hybrid_applied_parameters():
    # mamba: in_proj 8 x (16 + 16 + 8 + 4) = 352 (x, z, B, C, dt), out_proj 16 x 8
    mamba = 8 * (2 * 16 + 2 * 4 + 4) + 16 * 8
    shared = 4 * 8 * 8 + 3 * 8 * 16                    # q, k, v, o; gate, up, down
    assert flops.applied_params(HYBRID) == 4 * mamba + 2 * shared + 8 * 10


def test_moe_applied_parameters_and_step():
    attn = 8 * 8 + 2 * 8 * 4 + 8 * 8                   # hd 2: q 8, k/v 4 each, o 8
    layer = attn + 8 * 4 + 2 * 3 * 8 * 16              # router, top-2 experts
    n = 2 * layer + 8 * 10
    assert flops.applied_params(MOE) == n
    b, t = 2, 5
    attn_fwd = 4 * 2 * 4 * b * flops.pairs(t, 3) * 2    # 4·hd·heads a pair, 2 layers
    assert flops.forward(MOE, b, t) == 2 * n * b * t + attn_fwd
    assert flops.train_step(MOE, b, t) == 3 * flops.forward(MOE, b, t)


def test_kernel_counts():
    f, nb = kernels.attention(1, 2, 1, 4, 8, 0, itemsize=2)
    assert f == 4 * 8 * 2 * 10
    assert nb == 2 * 4 * 8 * (2 + 2 + 1 + 1)           # q, o: 2 heads; k, v: 1
    f, nb = kernels.ssd_chunk(bh=2, t=8, p=3, s=5, bg=1, chunk=4)
    tri = 10
    assert f == 2 * 2 * (2 * 5 * tri + 2 * 3 * tri + 2 * 5 * 3 * 4)
    read = 2 * 8 * 3 + 2 * 8 + 2 + 2 * 1 * 8 * 5
    written = 2 * 8 * 3 + 2 * 2 * 5 * 3 + 2 * 8 * 5 + 2 * 2
    assert nb == 4 * (read + written)
    f, nb = kernels.kmeans_assign(100, 10, 4)
    assert f == 2 * 100 * 4 * 10 and nb == 4 * (100 * 10 + 40 + 100 + 40 + 4)


def test_least_time_takes_the_larger_bound():
    assert peaks.least_time(989e12, 0, "bf16") == pytest.approx(1.0)
    assert peaks.least_time(0, 3.35e12, "fp32") == pytest.approx(1.0)
    assert peaks.least_time(67e12, 3.35e12 / 2, "fp32") == pytest.approx(1.0)
