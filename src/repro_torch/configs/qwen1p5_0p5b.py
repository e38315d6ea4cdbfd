"""qwen1.5-0.5b [dense] — MHA with QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]
24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936; QKV bias; tied embeds.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    mlp_type="swiglu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-0.5b-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=512,
    qkv_bias=True,
    mlp_type="swiglu",
    tie_embeddings=True,
    dtype="float32",
)
