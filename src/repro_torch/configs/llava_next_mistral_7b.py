"""llava-next-mistral-7b [vlm] — Mistral-7B backbone + anyres vision prefix.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000; sliding window 4096
(Mistral-7B-v0.1).  Vision frontend is a STUB: input_specs supplies
precomputed CLIP-ViT-L/14 patch embeddings (dim 1024); anyres tiling at
672x672 gives 576 base + 4x576 tile patches — we use one 576-token tile
(the backbone cost model is unchanged by tile count).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    attn_window=4096,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_dim=1024,
    frontend_tokens=576,
)

SMOKE = ModelConfig(
    name="llava-next-mistral-7b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    attn_window=16,
    mlp_type="swiglu",
    frontend="vision",
    frontend_dim=48,
    frontend_tokens=8,
    dtype="float32",
)
