"""mamba2-370m [ssm] — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]
48L d_model=1024 (attn-free) vocab=50280, ssm_state=128, expand=2,
headdim=64 (=> 32 SSD heads), 1 B/C group, chunk 128; tied embeddings
(GPT-NeoX tokenizer vocab rounded to 50280 as published).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_chunk=128,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=16,
    ssm_ngroups=1,
    ssm_chunk=16,
    tie_embeddings=True,
    dtype="float32",
)
