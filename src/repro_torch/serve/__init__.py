"""Serving stack: the prefill/decode engine and the carbon-aware request
scheduler."""
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import CarbonAwareScheduler, Request

__all__ = ["ServeEngine", "CarbonAwareScheduler", "Request"]
