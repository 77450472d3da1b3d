"""Model facade (the reference's `src/repro/models/api.py`) for the
five families: dense and MoE (`transformer`), ssm (Mamba-2), hybrid
(RecurrentGemma) and encdec (Whisper):

    m = get_model(cfg)
    params = m.init(seed, device="cuda")     # or m.abstract(): meta tensors
    loss, metrics = m.loss(params, {"tokens": tokens, "labels": labels})
    logits, cache = m.prefill(params, {"tokens": tokens}, pad_to=n)
    logits, cache = m.decode(params, cache, tokens)

An encdec prefill and loss also take ``batch["frames"]`` (B, enc_seq,
d_model). `loss`, `prefill` and `decode` work for all five families,
on one device or on a mesh (``mesh=``: local shards of the parameters,
of the batch and of the cache; each family's ``_mesh_*`` functions run
the reference's GSPMD layouts with explicit collectives, their shared
pieces in `repro_torch.models.mesh_layers`). `pspecs`, `shardings`,
`cache_pspecs`, `cache_shardings` and `input_pspecs` lay the
parameters, the decode caches and the inputs out on a mesh by the
logical-axis rules (`repro_torch.models.sharding`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.config import (DECODE, DENSE, ENCDEC, HYBRID, MOE, PREFILL,
                                SSM, TRAIN, ModelConfig, ShapeConfig)
from repro_torch.models import encdec, mamba2, rglru, transformer
from repro_torch.models import params as PT
from repro_torch.models.sharding import logical_to_pspec

_FAMILY_MODULES = {
    DENSE: transformer,
    MOE: transformer,
    SSM: mamba2,
    HYBRID: rglru,
    ENCDEC: encdec,
}


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def mod(self):
        return _FAMILY_MODULES[self.cfg.family]

    # -- parameters ---------------------------------------------------------
    def specs(self):
        return self.mod.specs(self.cfg)

    def init(self, generator=None, device="cuda"):
        """Seeded parameters (`generator`: a torch.Generator or an int)."""
        return PT.init_params(self.specs(), generator, device)

    def abstract(self):
        """The parameters' shapes and dtypes on the meta device."""
        return PT.abstract_params(self.specs())

    def init_local(self, mesh, generator=None):
        """One device's parameter shards on `mesh`, drawn at their shapes
        (`params.init_local`; an abstract mesh's dry run)."""
        return PT.init_local(self.specs(), mesh, generator)

    def pspecs(self, mesh, overrides=None):
        return PT.param_pspecs(self.specs(), mesh, overrides)

    def shardings(self, mesh, overrides=None):
        return PT.param_shardings(self.specs(), mesh, overrides)

    def param_count(self) -> int:
        return PT.param_count_tree(self.specs())

    def unread(self, kind: str) -> tuple:
        """Path prefixes of the parameters a step of `kind` does not read
        (Whisper's decode step reads neither its encoder nor the
        cross-attention's key and value projections)."""
        return getattr(self.mod, "DECODE_UNREAD", ()) if kind == DECODE \
            else ()

    def prepare(self, params):
        return self.mod.prepare(self.cfg, params)

    # -- compute ------------------------------------------------------------
    def loss(self, params, batch, remat: str = "none", mesh=None):
        """(loss, metrics). On a mesh (`sharding.Mesh.for_batch` of the
        global batch), `params` and `batch` are this process's shards
        and the loss is its share: the losses of the processes that hold
        distinct batch rows add up to the global loss."""
        return self.mod.loss_fn(self.cfg, params, batch, remat=remat,
                                mesh=mesh)

    def prefill(self, params, batch, pad_to: int = 0, mesh=None):
        """(last-position logits, cache). On a mesh
        (`sharding.Mesh.for_batch` of the global prompts), `params` and
        `batch` (an encdec's frames too) are this process's shards; so
        are the logits, laid out ("batch", "tp"), and the cache
        (`cache_pspecs`; a KV cache also carries its global slot count
        ``max_seq``, which its local shape does not tell)."""
        return self.mod.prefill(self.cfg, params, batch, pad_to=pad_to,
                                mesh=mesh)

    def decode(self, params, cache, tokens, mesh=None):
        """(logits, cache) of one step; on a mesh, local shards as in
        `prefill` (the mesh `prefill` was given)."""
        return self.mod.decode_step(self.cfg, params, cache, tokens,
                                    mesh=mesh)

    # -- caches --------------------------------------------------------------
    def cache_specs(self, batch: int, max_seq: int):
        return self.mod.cache_specs(self.cfg, batch, max_seq)

    def abstract_cache(self, batch: int, max_seq: int):
        """The decode cache's shapes and dtypes on the meta device."""
        return PT.abstract_params(self.cache_specs(batch, max_seq))

    def init_cache(self, batch: int, max_seq: int, device="cuda"):
        cache = PT.init_params(self.cache_specs(batch, max_seq), 0, device)
        cache["pos"] = 0
        return cache

    def cache_pspecs(self, batch: int, max_seq: int, mesh, overrides=None):
        return PT.param_pspecs(self.cache_specs(batch, max_seq), mesh,
                               overrides)

    def cache_shardings(self, batch: int, max_seq: int, mesh,
                        overrides=None):
        return PT.param_shardings(self.cache_specs(batch, max_seq), mesh,
                                  overrides)

    # -- inputs ---------------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> dict:
        """Meta-tensor stand-ins for every model input of this shape: int32
        tokens (and labels for train); an encoder-decoder's train and
        prefill also take frames (B, enc_seq, d_model) in the activation
        dtype."""
        B, S = shape.global_batch, shape.seq_len
        tok = lambda *sh: torch.empty(sh, dtype=torch.int32, device="meta")  # noqa: E731
        if shape.kind == TRAIN:
            out = {"tokens": tok(B, S), "labels": tok(B, S)}
        elif shape.kind == PREFILL:
            out = {"tokens": tok(B, S)}
        elif shape.kind == DECODE:
            out = {"tokens": tok(B)}
        else:
            raise ValueError(shape.kind)
        if self.cfg.family == ENCDEC and shape.kind in (TRAIN, PREFILL):
            out["frames"] = torch.empty(
                (B, self.cfg.enc_seq, self.cfg.d_model),
                dtype=PT.DTYPES[self.cfg.dtype], device="meta")
        return out

    def input_axes(self, shape: ShapeConfig) -> dict:
        if shape.kind == TRAIN:
            out = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        elif shape.kind == PREFILL:
            out = {"tokens": ("batch", "seq")}
        else:
            out = {"tokens": ("batch",)}
        if self.cfg.family == ENCDEC and shape.kind in (TRAIN, PREFILL):
            out["frames"] = ("batch", "seq", None)
        return out

    def input_pspecs(self, shape: ShapeConfig, mesh, overrides=None) -> dict:
        specs = self.input_specs(shape)
        axes = self.input_axes(shape)
        return {k: logical_to_pspec(axes[k], specs[k].shape, mesh, overrides)
                for k in specs}


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
