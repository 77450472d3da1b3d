"""Virtual energy supply layer (Ecovisor-style).

`supply` is a host numpy copy of `repro.energy.supply`: a per-region
energy supply (solar, a battery, the event-perturbed grid) turned into
two signals the demand side consumes, a per-region *virtual power cap*
fraction and the *effective* carbon intensity of the delivered mix.
`supply_torch` runs the same supply step on a device, folded into the
fleet scan. `scenarios` is the port's scenario stress matrix (import it
as `repro_torch.energy.scenarios`; it runs the sweep, which imports this
package).
"""
from repro_torch.energy.supply import (BatteryConfig, EnergyConfig,
                                       EnergySpec, GridEventConfig,
                                       SolarConfig, SupplyResult,
                                       event_matrices, simulate_supply,
                                       solar_series, supply_step_np)

__all__ = [
    "BatteryConfig", "EnergyConfig", "EnergySpec", "GridEventConfig",
    "SolarConfig", "SupplyResult", "event_matrices", "simulate_supply",
    "solar_series", "supply_step_np",
]
