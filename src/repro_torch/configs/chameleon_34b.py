"""Chameleon-34B [arXiv:2405.09818; unverified] — early-fusion VLM backbone.

Early fusion: VQ image tokens share the text vocabulary, so the modality
frontend stub is the identity on token ids (``input_specs()`` supplies
token ids mixing text + image codes). Backbone uses qk-norm per the paper.
"""
from repro_torch.config import ArchSpec, ModelConfig, DENSE, SWIGLU

FULL = ModelConfig(
    name="chameleon-34b",
    family=DENSE,
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    mlp_variant=SWIGLU,
    use_rope=True,
    qk_norm=True,
)

SMOKE = ModelConfig(
    name="chameleon-34b-smoke",
    family=DENSE,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=256,
    mlp_variant=SWIGLU,
    use_rope=True,
    qk_norm=True,
)

SPEC = ArchSpec(
    arch_id="chameleon-34b",
    full=FULL,
    smoke=SMOKE,
    source="arXiv:2405.09818; unverified",
    skip_shapes={"long_500k": "pure full-attention arch: quadratic attention at 524k "
                              "tokens has no sub-quadratic path (skip per assignment)"},
)
