"""Region carbon statistics (paper Fig. 1: 27 regions, avg + CoV).

The port's own copy of the reference table (`repro.carbon.regions`):
annual average carbon intensity (g·CO₂e/kWh) and daily CoV per region.
The values must stay identical to the reference's, because the synthetic
traces are drawn from them and the tests compare both sides bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RegionStats:
    name: str
    avg: float      # g CO2e/kWh, annual average
    cov: float      # daily coefficient of variation (hourly readings)
    diurnal_phase_h: float = 14.0   # hour of minimum intensity (solar dip)


# ordered by increasing CoV (as the paper's Fig. 1 x-axis)
REGIONS: dict[str, RegionStats] = {r.name: r for r in [
    RegionStats("IS", 1.6, 0.010),
    RegionStats("NO", 26.0, 0.015),
    RegionStats("SE", 45.0, 0.018),
    RegionStats("PL", 760.0, 0.028),
    RegionStats("IN-WB", 820.0, 0.030),
    RegionStats("ZA", 830.0, 0.032),
    RegionStats("ID", 800.0, 0.035),
    RegionStats("KZ", 840.0, 0.040),
    RegionStats("XK", 836.0, 0.045),
    RegionStats("QC", 33.0, 0.052),
    RegionStats("FR", 85.0, 0.055),
    RegionStats("JP", 478.0, 0.060),
    RegionStats("SG", 470.0, 0.065),
    RegionStats("KR", 495.0, 0.070),
    RegionStats("TW", 560.0, 0.080),
    RegionStats("NZ", 120.0, 0.100),
    RegionStats("NL", 400.0, 0.110),
    RegionStats("TX", 410.0, 0.120),
    RegionStats("GB", 240.0, 0.155),
    RegionStats("DK", 160.0, 0.160),
    RegionStats("GR", 280.0, 0.165),
    RegionStats("ES", 175.0, 0.170),
    RegionStats("UY", 95.0, 0.180),
    RegionStats("PT", 185.0, 0.185),
    RegionStats("CL", 190.0, 0.200),
    RegionStats("CAISO", 230.0, 0.240),
    RegionStats("SA", 150.0, 0.350),
]}
