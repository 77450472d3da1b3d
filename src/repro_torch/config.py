"""Model configuration of the port: its own copy of the reference's
`ModelConfig`, `ShapeConfig`, `ArchSpec`, the family and MLP constants,
`SHAPES`, the training and carbon knobs (`OptimizerConfig`,
`TrainConfig`, `CarbonConfig`), `MeshConfig`, and the launchers'
``--key value`` parser (`parse_cli`) with its dotted-key overrides
(`apply_overrides`).

Plain frozen dataclasses, field for field as in the JAX package, so a
configuration reads the same on both sides, with one exception: the
reference's `TrainConfig.checkpoint_dir`, `checkpoint_every` and
`async_checkpoint` and `CarbonConfig.carbon_update_s`, `min_duty` and
`suspend_on_floor` are read by no code on either side, so the port
leaves them out (checkpoints go through `train.checkpoint` and
`core.elastic.ElasticJob`). Every architecture has a full `ModelConfig`
and a reduced smoke one in ``repro_torch.configs``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

# ---------------------------------------------------------------------------
# Model families
# ---------------------------------------------------------------------------

DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
ENCDEC = "encdec"

FAMILIES = (DENSE, MOE, SSM, HYBRID, ENCDEC)

# MLP variants
SWIGLU = "swiglu"  # 3-matrix, silu gate
GEGLU = "geglu"    # 3-matrix, gelu gate
GELU = "gelu"      # 2-matrix, gelu


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    mlp_variant: str = SWIGLU
    use_rope: bool = True
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    qk_norm: bool = False              # chameleon-style qk layernorm
    norm_kind: str = "rms"             # rms | layer (whisper)
    norm_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_n_groups: int = 1
    # --- hybrid (recurrentgemma) ---
    block_pattern: tuple = ()          # e.g. ("rec","rec","attn")
    local_window: int = 2048
    lru_width: int = 0                 # 0 -> d_model
    conv_width: int = 4                # temporal conv in recurrent block
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0                   # precomputed frame embeddings length
    # --- numerics ---
    dtype: str = "bfloat16"            # activation dtype
    param_dtype: str = "float32"       # master params
    logit_dtype: str = "float32"
    # --- lowering knobs (kept for field parity with the reference) ---
    scan_unroll: bool = False
    attn_impl: str = "auto"            # auto | ref
    ssm_impl: str = "auto"             # auto | ref: the SSD scan of a prefill
    seq_shard: bool = True
    cast_weights: bool = True          # run the layers on weights cast to dtype

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.family == HYBRID and not self.block_pattern:
            object.__setattr__(self, "block_pattern", ("rec", "rec", "attn"))
        if self.family == HYBRID and self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    # -- derived quantities -------------------------------------------------
    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        kvd = self.n_kv_heads * self.head_dim
        qd = self.n_heads * self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == SSM:
            di, ns = self.d_inner, self.ssm_state
            nh = self.ssm_n_heads
            # in_proj: d -> 2*di + 2*groups*state + nheads ; out_proj: di -> d
            per = d * (2 * di + 2 * self.ssm_n_groups * ns + nh) + di * d
            per += self.ssm_conv_width * (di + 2 * self.ssm_n_groups * ns)
            per += 2 * nh + di + 2 * d  # A, D, norm, layer norms
            return self.n_layers * per + emb + d
        attn = d * qd + 2 * d * kvd + qd * d + 2 * d  # q,k,v,o + norms
        if self.mlp_variant in (SWIGLU, GEGLU):
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.family == MOE:
            mlp = self.n_experts * mlp + d * self.n_experts  # experts + router
        per = attn + mlp + 2 * d
        if self.family == HYBRID:
            # recurrent block: in/out proj (2*d*lru), conv, gates (2*lru*lru branch)
            lw = self.lru_width
            rec = 2 * d * lw + lw * d + self.conv_width * lw + 2 * lw * lw + 3 * lw + 2 * d
            n_attn = sum(1 for i in range(self.n_layers)
                         if self.block_pattern[i % len(self.block_pattern)] == "attn")
            n_rec = self.n_layers - n_attn
            mlp_all = self.n_layers * (mlp + 2 * d)
            return n_attn * attn + n_rec * rec + mlp_all + emb + d
        total = self.n_layers * per + emb + d
        if self.family == ENCDEC:
            # encoder layers + decoder cross-attention
            total += self.n_enc_layers * per
            total += self.n_layers * (2 * d * kvd + d * qd + qd * d + d)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.family != MOE:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_mlp = 3 * d * f if self.mlp_variant in (SWIGLU, GEGLU) else 2 * d * f
        unused = (self.n_experts - self.top_k) * dense_mlp * self.n_layers
        return self.param_count() - unused


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------

TRAIN = "train"
PREFILL = "prefill"
DECODE = "decode"


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == DECODE:
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, TRAIN),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, PREFILL),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, DECODE),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, DECODE),
}


@dataclass(frozen=True)
class ArchSpec:
    """An architecture: full config, smoke config, applicable shapes."""

    arch_id: str
    full: ModelConfig
    smoke: ModelConfig
    source: str
    skip_shapes: Mapping[str, str] = field(default_factory=dict)  # name -> reason

    def shapes(self) -> list[ShapeConfig]:
        return [s for n, s in SHAPES.items() if n not in self.skip_shapes]


# ---------------------------------------------------------------------------
# Training / mesh / carbon configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    schedule: str = "cosine"           # cosine | linear | constant
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # gradient compression across the pod (pure-DP) axis
    compression: str = "none"          # none | int8 | topk
    topk_ratio: float = 0.05


@dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 1024
    global_batch: int = 8
    microbatch: int = 0                # 0 -> no grad accumulation
    steps: int = 100
    seed: int = 0
    remat: str = "none"                # none | full | dots
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    log_every: int = 10


@dataclass(frozen=True)
class MeshConfig:
    """A device mesh's axis sizes and names, as in the reference
    (`repro_torch.launch.mesh.make_mesh` builds it over the processes of
    a torch.distributed process group, one device each)."""
    data: int = 1
    model: int = 1
    pod: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.pod

    def axis_names(self) -> tuple:
        return ("pod", "data", "model") if self.pod > 1 else ("data", "model")

    def shape(self) -> tuple:
        return (self.pod, self.data, self.model) if self.pod > 1 else (self.data, self.model)


@dataclass(frozen=True)
class CarbonConfig:
    """Carbon Containers knobs (paper §3.1.1)."""

    target_rate: float = 100.0         # C_target, g·CO2e/hr
    epsilon: float = 0.05              # fraction of target (paper's ε threshold)
    policy: str = "energy"             # energy | performance  (paper §3.2.2/3.2.3)
    region: str = "NL"                 # carbon-intensity trace region
    interval_s: float = 300.0          # monitoring interval (paper: 5 min)


# ---------------------------------------------------------------------------
# CLI override helpers
# ---------------------------------------------------------------------------

def _coerce(val: str, like: Any) -> Any:
    if isinstance(like, bool):
        return val.lower() in ("1", "true", "yes", "on")
    if isinstance(like, int):
        return int(val)
    if isinstance(like, float):
        return float(val)
    if isinstance(like, tuple):
        return tuple(val.split(","))
    return val


def apply_overrides(cfg: Any, overrides: Mapping[str, str]) -> Any:
    """Return a copy of dataclass ``cfg`` with dotted-key overrides applied."""
    for key, val in overrides.items():
        parts = key.split(".")
        cfg = _apply_one(cfg, parts, val)
    return cfg


def _apply_one(cfg: Any, parts: Sequence[str], val: str) -> Any:
    name = parts[0]
    if not dataclasses.is_dataclass(cfg) or name not in {f.name for f in dataclasses.fields(cfg)}:
        raise KeyError(f"no config field {'.'.join(parts)!r} on {type(cfg).__name__}")
    cur = getattr(cfg, name)
    if len(parts) == 1:
        return dataclasses.replace(cfg, **{name: _coerce(val, cur)})
    return dataclasses.replace(cfg, **{name: _apply_one(cur, parts[1:], val)})


def parse_cli(argv: Sequence[str]) -> dict:
    """``--a.b v --flag true`` -> {'a.b': 'v', 'flag': 'true'}"""
    out: dict[str, str] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise SystemExit(f"unexpected arg {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
        elif i + 1 >= len(argv) or argv[i + 1].startswith("--"):
            val = "true"                   # bare flag
        else:
            i += 1
            val = argv[i]
        out[key] = val
        i += 1
    return out
