"""Serving stack: the prefill/decode engine."""
from repro_torch.serve.engine import ServeEngine

__all__ = ["ServeEngine"]
