"""StarCoder2-7B [arXiv:2402.19173; hf] — dense, GQA(kv=4), RoPE, GELU MLP."""
from repro_torch.config import ArchSpec, ModelConfig, DENSE, GELU

FULL = ModelConfig(
    name="starcoder2-7b",
    family=DENSE,
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    mlp_variant=GELU,
    use_rope=True,
)

SMOKE = ModelConfig(
    name="starcoder2-7b-smoke",
    family=DENSE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=256,
    mlp_variant=GELU,
    use_rope=True,
)

SPEC = ArchSpec(
    arch_id="starcoder2-7b",
    full=FULL,
    smoke=SMOKE,
    source="arXiv:2402.19173; hf",
    skip_shapes={"long_500k": "pure full-attention arch: quadratic attention at 524k "
                              "tokens has no sub-quadratic path (skip per assignment)"},
)
