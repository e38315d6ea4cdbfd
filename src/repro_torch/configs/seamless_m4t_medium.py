"""seamless-m4t-medium [audio] — encoder-decoder, multimodal backbone.

[arXiv:2308.11596; hf]
12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206; enc-dec (12+12); the
speech frontend is a STUB (input_specs supplies precomputed frame embeddings
of dim 1024, i.e. the w2v-BERT output the published model consumes).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=24,          # 12 enc + 12 dec
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    enc_layers=12,
    dec_layers=12,
    mlp_type="gelu",
    frontend="audio",
    frontend_dim=1024,
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke",
    family="encdec",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=512,
    enc_layers=2,
    dec_layers=2,
    mlp_type="gelu",
    frontend="audio",
    frontend_dim=48,
    dtype="float32",
)
