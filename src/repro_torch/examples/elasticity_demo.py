"""Per-container elasticity demo (the reference's
`examples/elasticity_demo.py`).

A fleet of containers, each with K discrete resource levels, scaled
every epoch by the CarbonScaler marginal-allocation greedy under a
fleet-wide gram budget shaped across the day by the forecaster's
now-vs-next-24h carbon ratio. Runs the oracle / forecast / persistence
ablation (host numpy, `core.elasticity.simulate_elastic`), then the
same layer composed with placement inside the fleet sweep on the
port's torch backend, on ``--device``.

    PYTHONPATH=src python -m repro_torch.examples.elasticity_demo
        [--containers 2000] [--days 10] [--budget-frac 0.6]
        [--sweep-traces 64] [--device cpu]
"""
import sys

import numpy as np

from repro_torch.carbon.traces import synth_trace
from repro_torch.config import parse_cli
from repro_torch.core.elasticity import ElasticityConfig, simulate_elastic
from repro_torch.device import resolve_device

INTERVAL_S = 3600.0
REGIONS = ("PL", "NL", "CAISO")


def main(argv=None) -> dict:
    args = parse_cli(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.get("device", "cuda"))
    n = int(args.get("containers", 2000))
    days = int(args.get("days", 10))
    frac = float(args.get("budget-frac", 0.6))
    n_sweep = int(args.get("sweep-traces", 64))
    T = 24 * days

    region_mat = np.stack([synth_trace(r, hours=T, seed=11)
                           for r in REGIONS], axis=1)
    rng = np.random.default_rng(7)
    phase = rng.uniform(0.0, 1.0, (1, n))
    base = 2.0 + np.sin(2 * np.pi * (np.arange(T)[:, None] / 24.0 + phase))
    eps = rng.normal(0.0, 0.3, (T, n))
    noise = np.zeros((T, n))
    for t in range(1, T):
        noise[t] = 0.9 * noise[t - 1] + eps[t]
    demand = np.abs(base + noise)
    codes = np.tile(np.arange(n, dtype=np.int32) % 3, (T, 1))
    carbon = region_mat[np.arange(T)[:, None], codes]
    print(f"fleet: {n:,} containers x {T} hourly epochs, "
          f"K=4 levels, regions {REGIONS}")

    def mk(mode, budget, shape=False):
        return ElasticityConfig(
            k_levels=4, unit_capacity=1.0, base_w=50.0, peak_w=200.0,
            max_step=4, budget_g_per_epoch=budget, forecast=mode,
            shape_budget=shape)
    free = simulate_elastic(demand, carbon, mk("oracle", None), INTERVAL_S)
    budget = frac * free.est_emissions_g / T
    print(f"budget: {budget:,.0f} g/epoch shaped "
          f"({frac:.0%} of the uncapped oracle estimate)")

    print(f"\n{'forecaster':>12} {'kg CO2':>10} {'g/unit work':>12} "
          f"{'served':>8} {'deferred':>9} {'cap viol':>9}")
    cpw, summaries = {}, {}
    for mode in ("oracle", "forecast", "persistence"):
        s = simulate_elastic(demand, carbon, mk(mode, budget, True),
                             INTERVAL_S).summary()
        summaries[mode] = s
        cpw[mode] = (s["elastic_emissions_g"]
                     / max(s["elastic_served_work"], 1e-12))
        print(f"{mode:>12} {s['elastic_emissions_g'] / 1e3:>10.1f} "
              f"{cpw[mode]:>12.5f} {s['elastic_served_frac']:>7.1%} "
              f"{s['elastic_deferred_work']:>9.0f} "
              f"{s['elastic_cap_violations']:>9d}")
    saves = 1 - cpw["forecast"] / cpw["persistence"]
    bound = 1 - cpw["oracle"] / cpw["persistence"]
    print(f"\nforecast saves {saves:.2%} carbon per unit work vs persistence "
          f"(oracle bound {bound:.2%}): knowing the diurnal shape moves "
          f"the budget into green hours")

    # the same layer composed with placement inside the sweep
    from repro_torch.carbon.intensity import TraceProvider
    from repro_torch.cluster.placement import PlacementConfig
    from repro_torch.cluster.slices import paper_family
    from repro_torch.core.policy import CarbonContainerPolicy
    from repro_torch.core.simulator import SimConfig
    from repro_torch.core.spec import SweepSpec
    from repro_torch.workload.azure_like import sample_population

    fam = paper_family()
    traces = [t.util for t in sample_population(n_sweep, days=1, seed=5)]
    provs = [TraceProvider.for_region(r, hours=24, seed=1) for r in REGIONS]
    ec = ElasticityConfig(k_levels=4, unit_capacity=0.3,
                          budget_g_per_epoch=150.0, forecast="forecast",
                          shape_budget=True)
    pols = {"carbon_containers":
            lambda: CarbonContainerPolicy(variant="energy")}
    print(f"\nplaced sweep with elasticity ({n_sweep} traces, torch backend "
          f"on {device.type}):")
    rows = SweepSpec(policies=pols, family=fam, traces=traces,
                     targets=[40.0], sim=SimConfig(target_rate=0.0),
                     backend="torch",
                     placement=PlacementConfig(capacity=n_sweep,
                                               min_dwell=6),
                     regions=provs, region_names=REGIONS, elasticity=ec,
                     device=device).run()
    r = rows[0]
    print(f"  {'torch':>6}: carbon_rate={r['carbon_rate_mean']:.2f} "
          f"served={r['elastic_served_frac']:.1%} "
          f"level_epochs={r['elastic_level_epochs']} "
          f"cap_viol={r['elastic_cap_violations']}")
    return {"budget_g_per_epoch": budget, "ablation": summaries,
            "carbon_per_work": cpw, "forecast_saving": saves,
            "oracle_bound": bound, "sweep_rows": list(rows)}


if __name__ == "__main__":
    main()
