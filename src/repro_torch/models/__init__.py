"""Model substrate of the port: the dense transformer, Mamba-2 and
RecurrentGemma, as plain functions on parameter dicts."""
from repro_torch.models.api import Model, get_model

__all__ = ["get_model", "Model"]
