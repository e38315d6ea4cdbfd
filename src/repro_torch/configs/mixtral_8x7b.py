"""mixtral-8x7b [moe] — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000; 8 experts top-2;
sliding window 4096 (SWA).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    capacity_factor=1.25,
    attn_window=4096,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    n_experts=4,
    top_k=2,
    capacity_factor=4.0,  # = n_experts: dropless (decode==teacher-forcing)
    attn_window=16,
    mlp_type="swiglu",
    dtype="float32",
)
