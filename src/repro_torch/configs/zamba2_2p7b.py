"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf]
54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Simplification noted in DESIGN.md: the shared transformer block (one set of
weights, applied every ``share_period=6`` mamba layers => 9 applications)
omits the per-application LoRA deltas and the concatenated-embedding input
of the published model; head_dim 80 = 2560/32.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    mlp_type="swiglu",
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_chunk=128,
    share_period=6,
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=256,
    mlp_type="swiglu",
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=16,
    ssm_ngroups=1,
    ssm_chunk=16,
    share_period=2,
    dtype="float32",
)
