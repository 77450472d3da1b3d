"""What the two plain references share: the seeded weights and token
batches that the benchmark hands to both sides, the precision of a
reference run (float32, or the control's emulated fp8), AdamW, and the
comparisons that decide ``correct``.

Nothing here imports the program under test. The references take the
same parameter tree as the program (paths such as ``layers/attn/wq``,
each stacked over a leading layer axis) because the benchmark builds that
tree once from the seed and hands it to both sides; each family module
(`dense`, `ssm`) declares the tree's shapes and initial distributions in
its `layout`.
"""
from __future__ import annotations

import math
import statistics
import zlib

import torch

F32 = torch.float32
FP8_MAX = 448.0                       # largest float8_e4m3fn value


# ---------------------------------------------------------------------------
# Seeds
# ---------------------------------------------------------------------------

def sub_seed(seed: int, *salt) -> int:
    """A generator seed for one use of the run's seed: the run's seed and
    a salt (a leaf's path, a step's index) mixed into 63 bits."""
    h = zlib.crc32(repr(salt).encode())
    return (int(seed) * 1_000_003 + h) % (1 << 63)


def generator(device, seed: int, *salt) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *salt))
    return g


# ---------------------------------------------------------------------------
# Weights: one draw per stacked leaf, on the device
# ---------------------------------------------------------------------------

def init_leaf(path: str, spec: tuple, seed: int, device,
              dtype=F32) -> torch.Tensor:
    """The leaf at `path` of a layout (``(shape, init, scale)``), drawn
    on `device` from its own generator, so that any one leaf can be drawn
    again alone. Inits: zeros, ones, normal·scale, scaled (normal /
    sqrt(fan_in), fan_in the second-to-last dimension), ssm_a (log of
    U[1, 16), Mamba-2's A_log)."""
    shape, init, scale = spec
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    g = generator(device, seed, "param", path)
    if init == "ssm_a":
        u = torch.rand(shape, dtype=F32, device=device, generator=g)
        return torch.log(u.mul_(15.0).add_(1.0)).to(dtype)
    t = torch.randn(shape, dtype=F32, device=device, generator=g)
    if init == "scaled":
        t.div_(math.sqrt(shape[-2]))
    elif init == "normal":
        t.mul_(scale)
    else:
        raise ValueError(f"unknown init {init!r} of {path}")
    return t.to(dtype)


def init_params(layout: dict, seed: int, device, dtype=F32) -> dict:
    """{path: leaf} for every leaf of `layout`."""
    return {p: init_leaf(p, s, seed, device, dtype) for p, s in layout.items()}


def nest(flat: dict) -> dict:
    """{"a/b": t} -> {"a": {"b": t}}."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def flat(tree: dict, prefix: str = "") -> dict:
    """The inverse of `nest`."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, path))
        else:
            out[path] = v
    return out


# ---------------------------------------------------------------------------
# Token batches
# ---------------------------------------------------------------------------

def token_rows(seed: int, index: int, rows: int, length: int, vocab: int,
               device) -> torch.Tensor:
    """`rows` x `length` token ids, uniform over the vocabulary, drawn on
    `device` for draw number `index` of the run (int64)."""
    g = generator(device, seed, "tokens", index)
    return torch.randint(0, vocab, (rows, length), generator=g,
                         device=device, dtype=torch.int64)


def train_batch(seed: int, step: int, rows: int, seq: int, vocab: int,
                device) -> dict:
    """Step `step`'s batch: int32 tokens and next-token labels (rows,
    seq); every step's rows differ."""
    x = token_rows(seed, step, rows, seq + 1, vocab, device)
    return {"tokens": x[:, :-1].to(torch.int32).contiguous(),
            "labels": x[:, 1:].to(torch.int32).contiguous()}


# ---------------------------------------------------------------------------
# Precision of a reference run
# ---------------------------------------------------------------------------

def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude maps to 448, as fp8 training scales a tensor),
    back in float32; the gradient passes straight through."""
    with torch.no_grad():
        amax = t.detach().abs().max().float().clamp(min=1e-30)
        scale = amax / FP8_MAX
        q = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


PRECISIONS = {"float32": exact, "fp8": fp8}


def no_tf32():
    """The references run float32 matmuls as float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Leaves: one a layer of each stacked leaf
# ---------------------------------------------------------------------------

def leaf_norms(tree_flat: dict) -> dict:
    """{leaf: float64 norm}, a stacked leaf (its path under ``layers/``)
    split into one leaf a layer (``path[i]``)."""
    out = {}
    for path, t in tree_flat.items():
        if path.startswith("layers/"):
            rows = t.detach().reshape(t.shape[0], -1)
            for i in range(rows.shape[0]):
                out[f"{path}[{i}]"] = float(torch.linalg.vector_norm(
                    rows[i], dtype=torch.float64))
        else:
            out[path] = float(torch.linalg.vector_norm(
                t.detach().reshape(-1), dtype=torch.float64))
    return out


def change_norms(params_flat: dict, layout: dict, seed: int) -> dict:
    """{leaf: norm of (parameter now - its initial value)}, the initial
    value drawn again from the seed one leaf at a time."""
    out = {}
    for path, t in params_flat.items():
        t0 = init_leaf(path, layout[path], seed, t.device, F32)
        d = t.detach().float()
        if path.startswith("layers/"):
            for i in range(t.shape[0]):
                out[f"{path}[{i}]"] = float(torch.linalg.vector_norm(
                    (d[i] - t0[i]).reshape(-1), dtype=torch.float64))
        else:
            out[path] = float(torch.linalg.vector_norm(
                (d - t0).reshape(-1), dtype=torch.float64))
        del t0
    return out


def worst_leaf_gap(got: dict, want: dict, skip=()) -> float:
    """The largest |got - want| over the leaves not in `skip`, measured
    against the larger of the leaf's reference norm and the median
    leaf's."""
    med = statistics.median(want.values())
    gaps = [abs(got[leaf] - w) / max(abs(w), med, 1e-30)
            for leaf, w in want.items() if leaf not in skip]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def loss_gap(got: list, want: list) -> float:
    """The largest relative gap of one step's loss."""
    gaps = [abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want)]
    if len(got) != len(want) or not all(math.isfinite(g) for g in gaps):
        return math.inf
    return max(gaps)


def still_leaves(first_grad: dict, frac: float = 1e-3) -> set:
    """Leaves whose reference gradient is under `frac` of the median
    leaf's: AdamW moves them by round-off alone, so their change is not
    compared."""
    med = statistics.median(first_grad.values())
    return {k for k, v in first_grad.items() if v < frac * med}


# ---------------------------------------------------------------------------
# AdamW (decoupled weight decay, global-norm clipping), float32
# ---------------------------------------------------------------------------

def lr_at(opt: dict, step: int) -> float:
    """The learning rate of step `step` (0-based): linear warm-up over
    ``warmup_steps``, then constant."""
    w = opt["warmup_steps"]
    return opt["lr"] * (min(step / w, 1.0) if w > 0 else 1.0)


@torch.no_grad()
def adamw_step(opt: dict, step: int, leaves: list, m: list, v: list):
    """One AdamW step over `leaves` (tensors with ``.grad``): the grads
    clipped to ``grad_clip`` by their global norm, then
    m = b1 m + (1-b1) g, v = b2 v + (1-b2) g², p -= lr (m̂ / (sqrt(v̂) +
    eps) + wd p). Returns the global norm before clipping."""
    gnorm = math.sqrt(sum(float(torch.sum(p.grad.double() ** 2))
                          for p in leaves))
    scale = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9)) \
        if opt["grad_clip"] > 0 else 1.0
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    t = step + 1
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    lr = lr_at(opt, step)
    for p, mi, vi in zip(leaves, m, v):
        g = p.grad.float() * scale
        mi.mul_(b1).add_(g, alpha=1.0 - b1)
        vi.mul_(b2).add_(g * g, alpha=1.0 - b2)
        upd = (mi / bc1) / ((vi / bc2).sqrt_() + eps) + wd * p
        p.sub_(lr * upd)
        p.grad = None
    return gnorm
