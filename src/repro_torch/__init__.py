"""PyTorch/CUDA port of the Carbon Containers fleet simulator.

A second package beside the JAX reference (`src/repro/`), with the same
subpackage layout and module names. It imports torch and numpy and
nothing of the reference: host-side modules it needs are its own copies.
Entry points take ``device=`` and default to ``"cuda"``; they raise when
no card is present unless the caller passes ``device="cpu"``.

The slice ported so far is the placed population sweep:
`repro_torch.core.spec.SweepSpec(...).run()` -> `sweep_population_torch`
-> `plan_torch` (capacity-aware region planner, CUDA admission kernel)
-> `FleetSimulatorTorch` (the epoch loop with the policy deciders).
"""
