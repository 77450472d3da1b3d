"""Model facade (the reference's `src/repro/models/api.py`) for the
dense, ssm (Mamba-2) and hybrid (RecurrentGemma) families:

    m = get_model(cfg)
    params = m.init(seed, device="cuda")
    logits, cache = m.prefill(params, {"tokens": tokens}, pad_to=n)
    logits, cache = m.decode(params, cache, tokens)

The MoE and encoder-decoder families raise `NotImplementedError` naming
the ROADMAP item that brings them.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.config import DENSE, ENCDEC, HYBRID, MOE, SSM, ModelConfig
from repro_torch.models import mamba2, rglru, transformer
from repro_torch.models import params as PT

_FAMILY_MODULES = {DENSE: transformer, SSM: mamba2, HYBRID: rglru}
_LATER = {
    MOE: "ROADMAP.md Queue 1 item 13 (MoE and encoder-decoder families)",
    ENCDEC: "ROADMAP.md Queue 1 item 13 (MoE and encoder-decoder families)",
}


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family not in _FAMILY_MODULES:
            raise NotImplementedError(
                f"the {self.cfg.family!r} family is not ported yet "
                f"({_LATER[self.cfg.family]})")

    @property
    def mod(self):
        return _FAMILY_MODULES[self.cfg.family]

    # -- parameters ---------------------------------------------------------
    def specs(self):
        return self.mod.specs(self.cfg)

    def init(self, generator=None, device="cuda"):
        """Seeded parameters (`generator`: a torch.Generator or an int)."""
        return PT.init_params(self.specs(), generator, device)

    def param_count(self) -> int:
        return PT.param_count_tree(self.specs())

    def prepare(self, params):
        return self.mod.prepare(self.cfg, params)

    # -- compute ------------------------------------------------------------
    def prefill(self, params, batch, pad_to: int = 0):
        return self.mod.prefill(self.cfg, params, batch, pad_to=pad_to)

    def decode(self, params, cache, tokens):
        return self.mod.decode_step(self.cfg, params, cache, tokens)

    # -- caches --------------------------------------------------------------
    def cache_specs(self, batch: int, max_seq: int):
        return self.mod.cache_specs(self.cfg, batch, max_seq)

    def init_cache(self, batch: int, max_seq: int, device="cuda"):
        cache = PT.init_params(self.cache_specs(batch, max_seq), 0, device)
        cache["pos"] = 0
        return cache


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
