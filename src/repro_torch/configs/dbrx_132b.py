"""DBRX-132B [hf:databricks/dbrx-base; unverified] — MoE, 16 experts top-4, fine-grained."""
from repro_torch.config import ArchSpec, ModelConfig, MOE, SWIGLU

FULL = ModelConfig(
    name="dbrx-132b",
    family=MOE,
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    mlp_variant=SWIGLU,
    use_rope=True,
    n_experts=16,
    top_k=4,
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke",
    family=MOE,
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    mlp_variant=SWIGLU,
    use_rope=True,
    n_experts=4,
    top_k=2,
)

SPEC = ArchSpec(
    arch_id="dbrx-132b",
    full=FULL,
    smoke=SMOKE,
    source="hf:databricks/dbrx-base; unverified",
    skip_shapes={"long_500k": "pure full-attention arch: quadratic attention at 524k "
                              "tokens has no sub-quadratic path (skip per assignment)"},
)
