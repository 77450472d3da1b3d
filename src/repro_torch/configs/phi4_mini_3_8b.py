"""Phi-4-mini 3.8B [arXiv:2412.08905; hf] — dense, RoPE, SwiGLU, GQA(kv=8), 200k vocab."""
from repro_torch.config import ArchSpec, ModelConfig, DENSE, SWIGLU

FULL = ModelConfig(
    name="phi4-mini-3.8b",
    family=DENSE,
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    mlp_variant=SWIGLU,
    use_rope=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="phi4-mini-3.8b-smoke",
    family=DENSE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    mlp_variant=SWIGLU,
    use_rope=True,
)

SPEC = ArchSpec(
    arch_id="phi4-mini-3.8b",
    full=FULL,
    smoke=SMOKE,
    source="arXiv:2412.08905; hf",
    skip_shapes={"long_500k": "pure full-attention arch: quadratic attention at 524k "
                              "tokens has no sub-quadratic path (skip per assignment)"},
)
