"""Parameter sweeps over the port's fleet simulator.

grid    — sweep points and the named grids (paper / quick / matrix /
          stress / mixed / beyond / endurance / sensitivity / hostcache)
runner  — groups points into (composition, mode, length, wear) fleets,
          all of them in one kernel launch; the evaluation matrix and
          its fleet-vs-loop benchmark
report  — baseline normalization, geomeans, lifetime and sensitivity
          tables, bootstrap CIs
store   — the `BENCH_torch_*.json` result store and the artifact checks
cli     — `python -m repro_torch.sweep.cli --grid paper`

Exports what the reference's `repro.sweep` exports, and the store's two
checks. The runner's are lazy (PEP 562), as there: importing the package
does not load the kernels' wrappers.
"""
from repro_torch.sweep.grid import (GRIDS, SweepPoint, expand_grid,
                                    matrix_grid, mixed_grid, named_grid,
                                    paper_grid, quick_grid, stress_grid)
from repro_torch.sweep.report import (bootstrap_ci, geomean,
                                      normalize_points,
                                      normalize_to_baseline, policy_geomeans,
                                      policy_geomeans_ci)
from repro_torch.sweep.store import (check_hostcache_sweep,
                                     check_step_throughput, list_benches,
                                     load_bench, save_bench)

_LAZY = {"run_sweep": "repro_torch.sweep.runner",
         "run_matrix": "repro_torch.sweep.runner",
         "bench_fleet_vs_loop": "repro_torch.sweep.runner"}

__all__ = ["GRIDS", "SweepPoint", "expand_grid", "matrix_grid",
           "mixed_grid", "named_grid", "paper_grid", "quick_grid",
           "stress_grid", "geomean", "normalize_points",
           "normalize_to_baseline", "policy_geomeans", "bootstrap_ci",
           "policy_geomeans_ci", "list_benches", "load_bench", "save_bench",
           "check_step_throughput", "check_hostcache_sweep", "run_sweep",
           "run_matrix", "bench_fleet_vs_loop"]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
