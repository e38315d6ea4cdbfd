"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf]
26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000; sliding window 4096 on
local layers, global every 2nd layer; attn softcap 50, final softcap 30;
sandwich (pre+post) RMSNorm; tied embeddings; head_dim 256.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    attn_window=4096,
    local_global_period=2,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_type="swiglu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2-2b-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=512,
    attn_window=16,
    local_global_period=2,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_type="swiglu",
    tie_embeddings=True,
    dtype="float32",
)
