"""Float64 arithmetic with one result on the card and on the CPU.

Discrete outcomes of the sweep hang on float comparisons: the planner's
argmax over nets, the deciders' budget tests, the `ceil` of a replica or
level need, and the elasticity and autoscaling greedies, which admit
levels while ``mandatory + cumsum(grams) <= budget``. A last-bit
difference between the card and the CPU can flip one of them. Two
PyTorch operations give different bits on the two devices, and this
module replaces them:

  - a tensor divided by a Python number: on the card PyTorch multiplies
    by the number's reciprocal (its kernel for a host-scalar divisor),
    which misses the true quotient in the last bit for some inputs.
    `divide(x, c)` divides by a 0-d tensor on x's device instead, the
    IEEE quotient that NumPy and the CPU compute.
  - `torch.cumsum` and `torch.sum` associate differently on the CPU (a
    sequential loop, a vectorized tree) and on the card (a parallel
    scan, a tree). `ordered_cumsum` and `ordered_sum` fix the order: a
    left fold within blocks of `BLOCK` elements, then a left fold over
    the block totals, each block's prefix added to its partial sums
    once. The folds are `cumsum` along dim 0 of a matrix with at least
    two columns, which both devices compute as one sequential loop per
    column (on the card PyTorch's outer-dimension scan kernel; a single
    column would go to a parallel scan instead). For up to `BLOCK`
    elements the result is NumPy's `np.cumsum` bit for bit.

The greedies' budget cut goes through `budget_admits`, which decides
``sum + cumsum <= budget`` as NumPy's left folds do at any length: past
`BLOCK` values it falls back to one left fold over all of them when the
block order lies within rounding of the budget.

Elementwise adds, subtracts, multiplies, IEEE divides of two tensors,
comparisons and selects are the same on both devices; each is its own
kernel in eager PyTorch, so nothing contracts a product and a sum.
"""
from __future__ import annotations

from functools import lru_cache

import torch

BLOCK = 1024
EPS = 2.0 ** -53        # float64 unit roundoff
refolds = 0             # budget_admits calls that formed the left fold


@lru_cache(maxsize=256)
def _scalar(c: float, dtype: torch.dtype, device: torch.device):
    return torch.full((), c, dtype=dtype, device=device)


def divide(x, c):
    """``x / c`` for a Python number `c`, the IEEE quotient on any device."""
    return x / _scalar(float(c), x.dtype, x.device)


def _fold0(x):
    """Sequential inclusive prefix sums down dim 0 of a 2-D tensor."""
    if x.shape[1] >= 2:
        return x.cumsum(0)
    pad = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
    return torch.cat((x, pad), dim=1).cumsum(0)[:, :1]


def _blocks(x):
    """(L, C) -> (BLOCK, nb * C): column b * C + c holds block b of
    column c, zero-padded past L."""
    L, C = x.shape
    nb = -(-L // BLOCK)
    pad = torch.zeros((nb * BLOCK - L, C), dtype=x.dtype, device=x.device)
    full = torch.cat((x, pad)).view(nb, BLOCK, C)
    return full.permute(1, 0, 2).reshape(BLOCK, nb * C), nb


def ordered_cumsum(x):
    """Inclusive prefix sums of a 1-D tensor in the fixed order."""
    L = x.shape[0]
    if L <= BLOCK:
        return _fold0(x.view(L, 1))[:, 0]
    local, nb = _blocks(x.view(L, 1))
    local = _fold0(local)                           # (BLOCK, nb)
    incl = ordered_cumsum(local[-1])                # block totals, folded
    excl = torch.cat((torch.zeros(1, dtype=x.dtype, device=x.device),
                      incl[:-1]))
    out = torch.cat((local[:, :1], local[:, 1:] + excl[None, 1:]), dim=1)
    return out.t().reshape(-1)[:L]


def ordered_sum(x):
    """Sum of a 1-D tensor, or column sums of an (L, C) tensor, in the
    fixed order (the last prefix sum of each column)."""
    if x.dim() == 1:
        return ordered_sum(x.view(-1, 1))[0]
    L, C = x.shape
    if L == 0:
        return torch.zeros(C, dtype=x.dtype, device=x.device)
    if L <= BLOCK:
        return _fold0(x)[-1]
    local, nb = _blocks(x)
    totals = _fold0(local)[-1].view(nb, C)          # per block and column
    return ordered_sum(totals)


def budget_admits(mand, gs, budget, live):
    """``live & (sum(mand) + cumsum(gs) <= budget)`` for non-negative 1-D
    `mand` and `gs` of one length L, decided as NumPy's left folds
    (``np.cumsum``) decide it, at any L.

    Up to `BLOCK` values `ordered_sum` and `ordered_cumsum` are those
    folds. Past it they associate in blocks, but any order of summing L
    non-negative values lands within (L - 1)·u of the exact sum
    (u = 2^-53), so wherever ``|total - budget| > 8·L·u·total`` the
    block order and the left fold decide alike. Only where a `live` entry
    lies inside that margin are both sums formed again as one left fold
    over all L values: L steps in sequence, and past `BLOCK` one host
    sync a call to test for it. Each such call adds one to `refolds`.
    """
    global refolds
    L = gs.shape[0]
    total = ordered_sum(mand) + ordered_cumsum(gs)
    if L > BLOCK:
        near = (total - budget).abs() <= (8.0 * L * EPS) * total
        if bool((live & near).any()):
            refolds += 1
            total = (_fold0(mand.view(L, 1))[-1, 0]
                     + _fold0(gs.view(L, 1))[:, 0])
    return live & (total <= budget)
