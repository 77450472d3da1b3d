"""RecurrentGemma-9B [arXiv:2402.19427; unverified] — RG-LRU + local attention, 1:2.

Pattern (rec, rec, attn) over 38 layers = 12 full superlayers + 2 trailing
recurrent layers. MQA (kv=1), head_dim 256, GeGLU MLP, local window 2048.
Runs long_500k: state = RG-LRU hidden + bounded local-attn KV window.
"""
from repro_torch.config import ArchSpec, ModelConfig, HYBRID, GEGLU

FULL = ModelConfig(
    name="recurrentgemma-9b",
    family=HYBRID,
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    mlp_variant=GEGLU,
    use_rope=True,
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    lru_width=4096,
    conv_width=4,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke",
    family=HYBRID,
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    mlp_variant=GEGLU,
    use_rope=True,
    block_pattern=("rec", "rec", "attn"),
    local_window=16,
    lru_width=64,
    conv_width=4,
    tie_embeddings=True,
)

SPEC = ArchSpec(
    arch_id="recurrentgemma-9b",
    full=FULL,
    smoke=SMOKE,
    source="arXiv:2402.19427; unverified",
    skip_shapes={},
)
