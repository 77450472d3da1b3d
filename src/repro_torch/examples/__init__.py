"""The reference's user entry points (`examples/*.py`) on the port.

Each runs as ``python -m repro_torch.examples.<name> [--device cpu]``
(default ``--device cuda``, which raises without a card), keeps the
reference's name and flags, prints the reference's lines, and has a
``main(argv)`` that returns its summary as a dict: `quickstart`,
`simulate_regions`, `elasticity_demo`, `traffic_demo`, `carbon_train`.
The reference's `carbon_serve` is `repro_torch.launch.carbon_serve`.
"""
