"""The reference's side of `tests/test_torch_mesh_serve.py` and
`tests/test_torch_mesh_families.py`, run as a script in a process of
its own:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
        python tests/torch_mesh_reference.py OUT_DIR [families ARCH]

The reference's mesh paths (the MoE's ``shard_map``, the decode cache's
``kv_seq`` layout) run only under a JAX mesh of several devices, and JAX
fixes its CPU device count when it starts: the test process has already
started it with one device (`tests/conftest.py`), so this script starts
its own with four. It writes, as ``.npz`` files in OUT_DIR: the smoke
configs' PRNGKey(0) parameters (float32), which the port's ranks
(`tests/torch_mesh_ranks.py`) load; then, on the same inputs (made with
numpy from the seeds there), the reference's MoE layer, OLMoE's loss and
gradients, prefill and decode steps and its engine's tokens, each under
its mesh. With ``families ARCH`` (one process a family, run side by
side) it does the same for Mamba-2, RecurrentGemma or Whisper (Whisper
also with layer norms): the loss and gradients, prefill and decode
steps with the whole cache, and the engine's tokens, each under its
mesh. With ``argbytes MESH`` (eight devices:
``--xla_force_host_platform_device_count=8``) it compiles the
dry run's cells `R.ARGBYTES_CASES` at the smoke configs on the mesh
``2x4`` or ``2x2x2`` (`dryrun_lib.lower_and_compile`, remat "none": the
arguments do not depend on it) and writes each one's per-device
``argument_bytes`` to ``argbytes_MESH.json``; where the step does not
compile (OLMoE's expert-parallel ``shard_map`` under the hill-climber's
PURE_DP and SERVE_TP), the cell's arguments and shardings from the
reference's `build_cell`, compiled through a function that reads each.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from repro.configs import get_arch  # noqa: E402
from repro.models import moe as MOE  # noqa: E402
from repro.models.api import get_model  # noqa: E402
from repro.models.sharding import logical_to_pspec  # noqa: E402
from repro.serve.engine import ServeEngine  # noqa: E402


def _cfg(arch, **kw):
    return dataclasses.replace(get_arch(arch).smoke, dtype="float32", **kw)


def _mesh(name):
    shape = R.shape_of(name)
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, ("data", "model"))


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in leaves}


def _moe_layer(out, params, name, cf, B, tag):
    """`moe_apply` under the mesh; the kept mask of each (data, model)
    shard, read through `_dispatch_combine_local` with that shard's
    routing, expert range and capacity (the mesh path's arguments)."""
    cfg = _cfg(R.MOE_ARCH, capacity_factor=cf)
    p = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    x = R.moe_hidden(cfg, B, R.LAYER_S, 11)
    mesh = _mesh(name)
    with mesh:
        y, aux = jax.jit(lambda p, x: MOE.moe_apply(cfg, p, x))(
            p, jnp.asarray(x))
    n_data, n_model = R.shape_of(name)
    E, k, D = cfg.n_experts, cfg.top_k, cfg.d_model
    ep = not (B % n_data or E % n_model or D % n_data)
    if not ep:
        n_data, n_model = 1, 1
    rows = B // n_data
    T = rows * R.LAYER_S
    capacity = MOE._capacity(T, k, E, cf)
    keep = np.zeros((n_data, n_model, T, k), bool)
    for i in range(n_data):
        _, ids, _ = MOE._route(cfg, p["router"], jnp.asarray(
            x[i * rows:(i + 1) * rows].reshape(T, D)))
        for j in range(n_model):
            keep[i, j] = R.kept(lambda xs, w, j=j: MOE._dispatch_combine_local(
                cfg, jnp.asarray(xs), ids, jnp.asarray(w), j * E // n_model,
                E // n_model, capacity, lambda b: b)[0], k, T, D)
    np.savez(out / f"layer_{tag}.npz", y=np.asarray(y), keep=keep,
             lb=float(aux["lb_loss"]), drop=float(aux["router_dropped"]),
             capacity=capacity, expert_parallel=ep)


def _grads(out, params, name):
    model = get_model(_cfg(R.MOE_ARCH))
    batch = jax.tree.map(jnp.asarray, R.lm_batch(model.cfg, R.LOSS_B,
                                                 R.LOSS_S, 3))
    with _mesh(name):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss(p, b), has_aux=True))(params, batch)
    np.savez(out / f"ref_moe_grads_{name}.npz", loss=float(loss),
             lb_loss=float(metrics["lb_loss"]), **_flat(grads))


def _serve(out, params, arch, name, pad):
    """Jitted prefill and DECODE greedy steps under the mesh, with the
    parameters, cache, prompts and logits laid out as the reference's
    dry run lays them out (`launch/dryrun_lib.py`)."""
    model = get_model(_cfg(arch))
    B, V = R.SERVE_B, model.cfg.vocab_size
    mesh = _mesh(name)
    toks = R.prompts(model.cfg, B, R.PROMPT, 7)
    with mesh:
        p = jax.device_put(params, model.shardings(mesh))
        csh = model.cache_shardings(B, pad, mesh)
        lsh = NamedSharding(mesh, logical_to_pspec(("batch", "tp"), (B, V),
                                                   mesh))
        tsh = NamedSharding(mesh, logical_to_pspec(("batch", "seq"),
                                                   toks.shape, mesh))
        prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t},
                                                     pad_to=pad),
                          out_shardings=(lsh, csh))
        decode = jax.jit(lambda p, c, t: model.decode(p, c, t),
                         out_shardings=(lsh, csh))
        logits, cache = prefill(p, jax.device_put(jnp.asarray(toks), tsh))
        steps = [np.asarray(logits)]
        for _ in range(R.DECODE):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            logits, cache = decode(p, cache, tok)
            steps.append(np.asarray(logits))
    np.savez(out / f"ref_serve_{arch}_{name}_{pad}.npz",
             logits=np.stack(steps), k=np.asarray(cache["k"]),
             v=np.asarray(cache["v"]), pos=int(cache["pos"]))


def _engine(out, params, arch, name):
    model = get_model(_cfg(arch))
    with _mesh(name) as mesh:
        eng = ServeEngine(model, jax.device_put(params,
                                                model.shardings(mesh)))
        res = eng.generate(R.prompts(model.cfg, R.SERVE_B, R.PROMPT, 9),
                           R.ENGINE_NEW)
    np.savez(out / f"ref_engine_{arch}_{name}.npz", tokens=res["tokens"])


def _inputs(batch, mesh):
    """A batch laid out on `mesh` by its logical axes, as the dry run
    lays the inputs out (("batch", "seq"), frames ("batch", "seq",
    None))."""
    out = {}
    for k, v in batch.items():
        axes = ("batch", "seq", None)[:v.ndim]
        out[k] = jax.device_put(jnp.asarray(v), NamedSharding(
            mesh, logical_to_pspec(axes, v.shape, mesh)))
    return out


def _fam_cfg(key):
    if key == R.LAYER_NORM:
        return _cfg("whisper-base", norm_kind="layer")
    return _cfg(key)


def _fam_grads(out, params, key, name):
    """value_and_grad of the loss, jitted under the mesh, the parameters
    and the batch laid out on it."""
    model = get_model(_fam_cfg(key))
    batch = R.family_batch(model.cfg, R.LOSS_B, R.LOSS_S, 3)
    with _mesh(name) as mesh:
        p = jax.device_put(params, model.shardings(mesh))
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss(p, b), has_aux=True))(
            p, _inputs(batch, mesh))
    np.savez(out / f"ref_fam_grads_{key}_{name}.npz", loss=float(loss),
             **_flat(grads))


def _fam_serve(out, params, key, name, pad):
    """`_serve` of a family: the prompts (and frames) laid out on the
    mesh; every cache leaf but ``pos`` saved."""
    model = get_model(_fam_cfg(key))
    B, V = R.SERVE_B, model.cfg.vocab_size
    mesh = _mesh(name)
    with mesh:
        p = jax.device_put(params, model.shardings(mesh))
        csh = model.cache_shardings(B, pad, mesh)
        lsh = NamedSharding(mesh, logical_to_pspec(("batch", "tp"), (B, V),
                                                   mesh))
        prefill = jax.jit(lambda p, b: model.prefill(p, b, pad_to=pad),
                          out_shardings=(lsh, csh))
        decode = jax.jit(lambda p, c, t: model.decode(p, c, t),
                         out_shardings=(lsh, csh))
        logits, cache = prefill(p, _inputs(R.family_prompts(model.cfg),
                                           mesh))
        steps = [np.asarray(logits)]
        for _ in range(R.DECODE):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            logits, cache = decode(p, cache, tok)
            steps.append(np.asarray(logits))
    pos = int(cache.pop("pos"))
    np.savez(out / f"ref_fam_serve_{key}_{name}_{pad}.npz",
             logits=np.stack(steps), pos=pos, **_flat(cache))


def _fam_engine(out, params, key, name="2x2"):
    model = get_model(_fam_cfg(key))
    with _mesh(name) as mesh:
        eng = ServeEngine(model, jax.device_put(params,
                                                model.shardings(mesh)))
        res = eng.generate(R.prompts(model.cfg, R.SERVE_B, R.FAM_PROMPT, 9),
                           R.ENGINE_NEW)
    np.savez(out / f"ref_fam_engine_{key}.npz", tokens=res["tokens"])


def main_family(out: Path, arch: str):
    """The reference's results for one family (`arch`; Whisper also
    with layer norms). The O(1)-state families' prefill ignores pad_to,
    so they run at the first of `family_pads` only."""
    keys = (arch, R.LAYER_NORM) if arch == "whisper-base" else (arch,)
    params = {k: get_model(_fam_cfg(k)).init(jax.random.PRNGKey(0))
              for k in keys}
    for k, tree in params.items():
        np.savez(out / f"params_{k}.npz", **_flat(tree))
    (out / f"params_{arch}.done").write_text("")
    for k in keys:
        pads = R.family_pads(k)
        if _fam_cfg(k).family != "encdec":
            pads = pads[:1]
        for name in R.family_meshes(k):
            _fam_grads(out, params[k], k, name)
            for pad in pads:
                _fam_serve(out, params[k], k, name, pad)
        if k in R.FAMILY_ARCHS:
            _fam_engine(out, params[k], k)
    (out / f"reference_{arch}.done").write_text("")


def main(out: Path):
    if len(jax.devices()) < 4:
        raise SystemExit("needs XLA_FLAGS=--xla_force_host_platform_device_"
                         "count=4 set before JAX starts")
    params = {a: get_model(_cfg(a)).init(jax.random.PRNGKey(0))
              for a in R.SERVE_ARCHS}
    for arch, tree in params.items():
        np.savez(out / f"params_{arch}.npz", **_flat(tree))
    (out / "params.done").write_text("")
    moe = params[R.MOE_ARCH]
    for plan in (R.FOUR, R.TWO):
        for name in plan["layer"]:
            for cf in R.CFS:
                _moe_layer(out, moe, name, cf, R.LAYER_B, f"{name}_{cf}")
        for name in plan.get("odd", ()):
            _moe_layer(out, moe, name, R.CFS[0], R.LAYER_B_ODD,
                       f"{name}_odd")
        for name in plan.get("loss", ()):
            _grads(out, moe, name)
        for arch in (R.SERVE_ARCHS if "engine" in plan else (R.MOE_ARCH,)):
            for name in plan["serve"]:
                for pad in R.PADS:
                    _serve(out, params[arch], arch, name, pad)
            for name in plan.get("engine", ()):
                _engine(out, params[arch], arch, name)
    (out / "reference.done").write_text("")


def main_argbytes(out: Path, name: str):
    from repro.launch import dryrun_lib as DL
    from repro.launch import hlo_analysis as HLO
    shape, axes = R.ARGBYTES_MESHES[name]
    n = int(np.prod(shape))
    if len(jax.devices()) < n:
        raise SystemExit(f"needs XLA_FLAGS=--xla_force_host_platform_device_"
                         f"count={n} set before JAX starts")
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
    rules = R.reference_rule_sets()
    got = {}
    for arch, shape_name, rule in R.ARGBYTES_CASES:
        kw = dict(cfg=get_arch(arch).smoke, remat="none",
                  rules_override=rules[rule])
        try:
            compiled, _ = DL.lower_and_compile(arch, shape_name, mesh, **kw)
            how = "step"
        except ValueError as e:
            # OLMoE's expert-parallel shard_map does not compile under
            # PURE_DP or SERVE_TP: the cell's own arguments and shardings
            # (`build_cell`), compiled through a function that reads each
            # one
            _, args, in_sh, _, _ = DL.build_cell(arch, shape_name, mesh, **kw)
            with mesh:
                compiled = jax.jit(lambda *a: a, in_shardings=in_sh,
                                   out_shardings=in_sh).lower(*args).compile()
            how = f"arguments only; the step raises {e!r}"[:200]
        got[f"{arch}|{shape_name}|{rule}"] = {
            "argument_bytes": HLO.memory_stats(compiled)["argument_bytes"],
            "compiled": how}
    (out / f"argbytes_{name}.json").write_text(json.dumps(got))


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[2] == "argbytes":
        main_argbytes(Path(sys.argv[1]), sys.argv[3])
    elif len(sys.argv) > 2 and sys.argv[2] == "families":
        if len(jax.devices()) < 4:
            raise SystemExit("needs XLA_FLAGS=--xla_force_host_platform_"
                             "device_count=4 set before JAX starts")
        main_family(Path(sys.argv[1]), sys.argv[3])
    else:
        main(Path(sys.argv[1]))
