"""See the module docstrings; this subpackage mirrors `repro.carbon`."""
