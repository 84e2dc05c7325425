"""Device fleet emulation plane: trace-driven availability, capability
heterogeneity sampling, and participant-selection policies.

Three modules, one scenario surface:

* :mod:`~repro_torch.fleet.traces` — seeded, JSON-serializable availability
  traces (diurnal / Weibull-session / flaky-link / uniform) and the
  single trace-event API (`install_fleet`) every protocol simulation
  drives membership from;
* :mod:`~repro_torch.fleet.devices` — capability tiers (`DeviceProfile`) and
  weighted-mix cluster sampling (`sample_cluster`);
* :mod:`~repro_torch.fleet.selection` — participant-selection policies
  (`random` / REFL-style `refl` / Apodotiko-style `score`) fed by the
  Task Scheduler's Alg. 3 consumption counters, plus the
  contribution-balance metric (`balance_summary` / `gini`).

One `FleetTrace` drives `simulate_fedoptima` and all six baselines, so
every scenario comparison runs over an identical device population.

A copy of the JAX package's ``fleet`` package, with its exports.
"""
from .devices import (DEFAULT_TIERS, DeviceProfile, TIERS,
                      heterogeneous_cluster, parse_tiers, sample_cluster,
                      tier_counts)
from .selection import (POLICIES, RandomSelection, ScoreSelection,
                        SelectionContext, SelectionPolicy,
                        StalenessSelection, balance_summary, gini,
                        make_selection_policy)
from .traces import (DEFAULT_INTERVAL, FleetTrace, GENERATORS, diurnal_trace,
                     flaky_trace, install_fleet, make_trace, resolve_fleet,
                     uniform_trace, weibull_sessions_trace)

__all__ = [
    "DEFAULT_INTERVAL", "DEFAULT_TIERS", "DeviceProfile", "FleetTrace",
    "GENERATORS", "POLICIES", "RandomSelection", "ScoreSelection",
    "SelectionContext", "SelectionPolicy", "StalenessSelection", "TIERS",
    "balance_summary", "diurnal_trace", "flaky_trace", "gini",
    "heterogeneous_cluster", "install_fleet", "make_selection_policy",
    "make_trace", "parse_tiers", "resolve_fleet", "sample_cluster",
    "tier_counts", "uniform_trace", "weibull_sessions_trace",
]
