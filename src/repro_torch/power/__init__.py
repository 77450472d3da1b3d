"""See the module docstrings; this subpackage mirrors `repro.power`."""
