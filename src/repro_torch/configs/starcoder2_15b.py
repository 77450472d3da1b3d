"""StarCoder2-15B [arXiv:2402.19173; hf] — dense, GQA(kv=4), RoPE, GELU MLP."""
from repro_torch.config import ArchSpec, ModelConfig, DENSE, GELU

FULL = ModelConfig(
    name="starcoder2-15b",
    family=DENSE,
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    mlp_variant=GELU,
    use_rope=True,
)

SMOKE = ModelConfig(
    name="starcoder2-15b-smoke",
    family=DENSE,
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=384,
    vocab_size=256,
    mlp_variant=GELU,
    use_rope=True,
)

SPEC = ArchSpec(
    arch_id="starcoder2-15b",
    full=FULL,
    smoke=SMOKE,
    source="arXiv:2402.19173; hf",
    skip_shapes={"long_500k": "pure full-attention arch: quadratic attention at 524k "
                              "tokens has no sub-quadratic path (skip per assignment)"},
)
