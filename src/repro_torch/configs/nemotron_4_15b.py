"""nemotron-4-15b [dense] — GQA + squared-ReLU MLP (no gate).

[arXiv:2402.16819; unverified]
32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000; squared-ReLU.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="relu2",
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="nemotron-4-15b-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    mlp_type="relu2",
    dtype="float32",
)
