"""Whisper-base [arXiv:2212.04356; unverified] — enc-dec; conv frontend is a STUB:
``input_specs()`` supplies precomputed frame embeddings (B, 1500, d_model)."""
from repro_torch.config import ArchSpec, ModelConfig, ENCDEC, GELU

FULL = ModelConfig(
    name="whisper-base",
    family=ENCDEC,
    n_layers=6,                # decoder layers
    n_enc_layers=6,
    enc_seq=1500,              # 30s audio -> 1500 frames after conv stub
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    mlp_variant=GELU,
    use_rope=False,            # whisper uses sinusoidal positions
    norm_kind="layer",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-base-smoke",
    family=ENCDEC,
    n_layers=2,
    n_enc_layers=2,
    enc_seq=32,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    mlp_variant=GELU,
    use_rope=False,
)

SPEC = ArchSpec(
    arch_id="whisper-base",
    full=FULL,
    smoke=SMOKE,
    source="arXiv:2212.04356; unverified",
    skip_shapes={"long_500k": "full-attention enc-dec: quadratic attention at 524k "
                              "tokens has no sub-quadratic path (skip per assignment)"},
)
