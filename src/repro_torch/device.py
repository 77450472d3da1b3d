"""Device policy of the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Without
a card the call raises; the CPU runs only when the caller asks for it.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' "
                         f"or 'cpu'")
    return dev
