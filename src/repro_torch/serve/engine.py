"""Batched serving engine: shared prefill + synchronized decode (the
reference's `src/repro/serve/engine.py`).

One prefill for the batch, then one decode step per new token with a
shared position counter. An encoder-decoder model is fed zero frames
(B, enc_seq, d_model) in the activation dtype, as the reference feeds
it; the frames are made before the prefill's timer starts. The carbon
layer throttles the engine through `duty`, a decode-rate cap: after
each step the engine sleeps so that decoding takes ``1 / duty`` of its
unthrottled time (vertical scaling for inference).

Timing ends in a device synchronisation, as the reference's ends in a
host read of the tokens. Greedy decoding is ``argmax`` (the first
maximum, as ``jnp.argmax``). Sampling draws with ``torch.multinomial``
from the softmax of the logits with the caller's generator: the same
distribution as ``jax.random.categorical``, not the same draws.

On a mesh (``mesh=``, a `sharding.Mesh`; one process a device, the
counterpart of the reference's jitted engine run on sharded parameters
under a mesh) every process of the mesh runs `generate` with the same
prompts: the parameters are this process's shards (`Model.shardings`),
the prompts are cut to its ("batch", "seq") slice, prefill and decode
run on local shards, and each step's logits are gathered whole (batch
and vocabulary) so that every process picks the same tokens. `stats`
count the whole batch's tokens.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.config import ENCDEC
from repro_torch.data.pipeline import shard_batch
from repro_torch.device import resolve_device
from repro_torch.models.api import Model
from repro_torch.models.params import DTYPES, flatten, tree_map, unflatten
from repro_torch.models.sharding import Mesh, NamedSharding, logical_to_pspec
from repro_torch.spans import span


@dataclass
class ServeEngine:
    model: Model
    params: Optional[dict] = None
    device: Union[str, torch.device] = "cuda"
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        self.device = resolve_device(self.mesh.device if self.mesh is not None
                                     else self.device)
        self.stats = {"prefill_tokens": 0, "decode_tokens": 0,
                      "prefill_s": 0.0, "decode_s": 0.0}
        self._prepared = (None, None)      # (params it came from, prepared)

    def load(self, seed=0):
        """Seeded parameters on the engine's device (`seed`: an int or a
        torch.Generator); on a mesh, this process's shards of them, each
        full leaf freed once its shard is taken."""
        params = self.model.init(seed, device=self.device)
        if self.mesh is not None:
            shardings = self.model.shardings(self.mesh)
            full = dict(flatten(params))
            del params
            sh = dict(flatten(shardings))
            params = unflatten(shardings, {p: sh[p].shard(full.pop(p))
                                           for p in list(full)})
        self.params = params
        return self

    def prepared_params(self) -> dict:
        """The parameters on the engine's device, cast once for serving."""
        src, prepared = self._prepared
        if src is not self.params:
            moved = tree_map(lambda t: t.to(self.device), self.params)
            self._prepared = (self.params, self.model.prepare(moved))
        return self._prepared[1]

    def prefill_batch(self, prompts) -> dict:
        """The prefill's inputs for prompts (B, S) on the engine's device:
        the tokens, and for an encoder-decoder zero frames (the frontend
        stub); on a mesh, this process's slice of them, as
        `data.pipeline.shard_batch` lays them out (the frames'
        ("batch", "seq", None): their rows)."""
        on_mesh = self.mesh is not None
        if on_mesh:
            tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long)
        else:
            tokens = torch.as_tensor(prompts, dtype=torch.long,
                                     device=self.device)
        batch = {"tokens": tokens}
        cfg = self.model.cfg
        if cfg.family == ENCDEC:
            batch["frames"] = torch.zeros(
                (tokens.shape[0], cfg.enc_seq, cfg.d_model),
                dtype=DTYPES[cfg.dtype], device=tokens.device)
        if on_mesh:
            return shard_batch(batch, self.mesh.for_batch(tokens.shape))
        return batch

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts, max_new_tokens: int, greedy: bool = True,
                 duty: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 eos_id: int = -1) -> dict:
        """prompts: (B, S) int -> generated (B, max_new_tokens) int32."""
        if self.params is None:
            raise RuntimeError("call load() first or pass params")
        params = self.prepared_params()
        batch = self.prefill_batch(prompts)
        B, S = np.shape(prompts)
        on_mesh = {}
        if self.mesh is not None:
            on_mesh["mesh"] = self.mesh.for_batch((B, S))
        self._sync()
        with span("serve.prefill"):
            t0 = time.perf_counter()
            logits, cache = self.model.prefill(params, batch,
                                               pad_to=S + max_new_tokens,
                                               **on_mesh)
            logits = self._whole(logits, B)
            self._sync()
            self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_tokens"] += B * S

        if generator is None and not greedy:
            generator = torch.Generator(device=self.device).manual_seed(0)
        out = np.zeros((B, max_new_tokens), np.int32)
        tok = torch.argmax(logits, -1)
        done = np.zeros((B,), bool)
        for i in range(max_new_tokens):
            out[:, i] = tok.cpu().numpy()
            if eos_id >= 0:
                done |= out[:, i] == eos_id
                if done.all():
                    out = out[:, :i + 1]
                    break
            with span("serve.decode"):
                t0 = time.perf_counter()
                logits, cache = self.model.decode(
                    params, cache, self._rows(tok, B), **on_mesh)
                logits = self._whole(logits, B)
                if greedy:
                    tok = torch.argmax(logits, -1)
                else:
                    probs = torch.softmax(logits.float(), -1)
                    tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
                self._sync()
                dt = time.perf_counter() - t0
            self.stats["decode_s"] += dt
            self.stats["decode_tokens"] += B
            if duty < 1.0:            # vertical scaling: decode-rate cap
                time.sleep(dt * (1.0 / max(duty, 1e-2) - 1.0))
        return {"tokens": out, "stats": dict(self.stats)}

    def _whole(self, logits, B: int):
        """The (B, V) logits whole: on a mesh, gathered from this
        process's ("batch", "tp") shard."""
        if self.mesh is None:
            return logits
        spec = logical_to_pspec(("batch", "tp"),
                                (B, self.model.cfg.vocab_size), self.mesh)
        return NamedSharding(self.mesh, spec).gather(logits)

    def _rows(self, tokens, B: int):
        """The next step's tokens (B,): on a mesh, this process's rows."""
        if self.mesh is None:
            return tokens
        spec = logical_to_pspec(("batch",), (B,), self.mesh)
        return NamedSharding(self.mesh, spec).shard(tokens)


def throughput_tokens_per_s(stats: dict) -> dict:
    return {
        "prefill_tok_s": stats["prefill_tokens"] / max(stats["prefill_s"], 1e-9),
        "decode_tok_s": stats["decode_tokens"] / max(stats["decode_s"], 1e-9),
    }
