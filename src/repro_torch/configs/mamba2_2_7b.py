"""Mamba2-2.7B [arXiv:2405.21060; unverified] — SSD (state-space duality), attn-free.

Runs long_500k: decode state is O(1) in sequence length (conv + SSD state).
"""
from repro_torch.config import ArchSpec, ModelConfig, SSM

FULL = ModelConfig(
    name="mamba2-2.7b",
    family=SSM,
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    use_rope=False,
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    ssm_n_groups=1,
)

SMOKE = ModelConfig(
    name="mamba2-2.7b-smoke",
    family=SSM,
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    use_rope=False,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=32,
    ssm_conv_width=4,
    ssm_chunk=16,
    ssm_n_groups=1,
)

SPEC = ArchSpec(
    arch_id="mamba2-2.7b",
    full=FULL,
    smoke=SMOKE,
    source="arXiv:2405.21060; unverified",
    skip_shapes={},
)
