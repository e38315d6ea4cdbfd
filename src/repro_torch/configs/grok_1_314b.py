"""grok-1-314b [moe] — 8-expert top-2 MoE with attention logit softcap.

[hf:xai-org/grok-1; unverified]
64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072; MoE 8e top-2;
attn logit softcap 30 (grok "attn_output_multiplier"-style tanh capping).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    top_k=2,
    capacity_factor=1.25,
    attn_softcap=30.0,
    final_softcap=30.0,
    mlp_type="geglu",
)

SMOKE = ModelConfig(
    name="grok-1-314b-smoke",
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
    attn_softcap=30.0,
    final_softcap=30.0,
    mlp_type="geglu",
    dtype="float32",
)
