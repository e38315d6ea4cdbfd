"""yi-9b [dense] — llama-architecture GQA.

[arXiv:2403.04652; hf]
48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    mlp_type="swiglu",
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="yi-9b-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=160,
    vocab_size=256,
    mlp_type="swiglu",
    dtype="float32",
)
