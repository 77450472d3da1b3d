"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M; hf] — llama-arch small, GQA(kv=3), SwiGLU."""
from repro_torch.config import ArchSpec, ModelConfig, DENSE, SWIGLU

FULL = ModelConfig(
    name="smollm-135m",
    family=DENSE,
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    mlp_variant=SWIGLU,
    use_rope=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-135m-smoke",
    family=DENSE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    mlp_variant=SWIGLU,
    use_rope=True,
    tie_embeddings=True,
)

SPEC = ArchSpec(
    arch_id="smollm-135m",
    full=FULL,
    smoke=SMOKE,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
    skip_shapes={"long_500k": "pure full-attention arch: quadratic attention at 524k "
                              "tokens has no sub-quadratic path (skip per assignment)"},
)
