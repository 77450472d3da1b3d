"""PyTorch/CUDA port of the Carbon Containers fleet simulator.

A second package beside the JAX reference (`src/repro/`), with the same
subpackage layout and module names. It imports torch and numpy and
nothing of the reference: host-side modules it needs are its own copies.
Entry points take ``device=`` and default to ``"cuda"``; they raise when
no card is present unless the caller passes ``device="cpu"``.

The placed population sweep is ported with its four layers:
`repro_torch.core.spec.SweepSpec(...).run()` -> `sweep_population_torch`
-> `plan_torch` (capacity-aware region planner, CUDA admission kernel,
retry carry of failed migrations) -> `simulate_elastic_torch` (the
elasticity layer's own epoch loop) -> `FleetSimulatorTorch` (the epoch
loop with the policy deciders, the traffic and energy steps folded in,
decisions on the observed carbon feed). `PlacementEngine.run` is the
placed fleet run. The Carbon Container controller (`core.policy`'s
scalar and batch decisions, `core.container`, `core.simulator.simulate`),
the scenario stress matrix (`energy.scenarios`) and the carbon-aware
serving loop (`launch.carbon_serve`) are host code copied from the
reference. Serving covers the dense, Mamba-2 and RecurrentGemma
families.
"""
