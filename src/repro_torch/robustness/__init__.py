"""Signal-plane fault injection + graceful degradation.

Host numpy, copied from `repro.robustness`. A frozen, seeded
`FaultPlan` declares carbon-feed dropouts/staleness/noise windows,
power-telemetry gaps and migration failures; the degradation ladder in
`degrade` turns the true (T, R) region-intensity matrix into the
*observed* signal the controller sees. The sweep decides on the
observed signal and bills emissions at the true one.
"""
from repro_torch.robustness.faults import (CarbonFeedFaults, DegradeConfig,
                                     FaultPlan, MigrationFaults,
                                     PowerTelemetryFaults,
                                     carbon_fault_masks,
                                     migration_failure_mask,
                                     power_gap_vector)
from repro_torch.robustness.degrade import (ObservedSignal, budget_violations,
                                      observe_intensity)

__all__ = [
    "CarbonFeedFaults", "PowerTelemetryFaults", "MigrationFaults",
    "DegradeConfig", "FaultPlan", "carbon_fault_masks",
    "migration_failure_mask", "power_gap_vector", "ObservedSignal",
    "observe_intensity", "budget_violations",
]
