"""OLMoE-1B-7B [arXiv:2409.02060; hf] — MoE, 64 experts top-8, d_ff=1024 per expert."""
from repro_torch.config import ArchSpec, ModelConfig, MOE, SWIGLU

FULL = ModelConfig(
    name="olmoe-1b-7b",
    family=MOE,
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    mlp_variant=SWIGLU,
    use_rope=True,
    n_experts=64,
    top_k=8,
)

SMOKE = ModelConfig(
    name="olmoe-1b-7b-smoke",
    family=MOE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab_size=256,
    mlp_variant=SWIGLU,
    use_rope=True,
    n_experts=8,
    top_k=2,
)

SPEC = ArchSpec(
    arch_id="olmoe-1b-7b",
    full=FULL,
    smoke=SMOKE,
    source="arXiv:2409.02060; hf",
    skip_shapes={"long_500k": "pure full-attention arch: quadratic attention at 524k "
                              "tokens has no sub-quadratic path (skip per assignment)"},
)
