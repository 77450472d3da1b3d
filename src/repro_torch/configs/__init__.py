"""Assigned architecture configs. ``get_arch(id)`` returns an ArchSpec."""
from repro_torch.configs.registry import ARCHS, get_arch, list_archs

__all__ = ["ARCHS", "get_arch", "list_archs"]
