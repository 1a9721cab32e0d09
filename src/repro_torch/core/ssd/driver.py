"""Experiment driver for the simulator: the paper's evaluation constants
and the single-cell reference path — port of the reference package's
`core/ssd/driver.py`.

The paper's matrix is 11 MSR-like workloads x {bursty, daily} x
{baseline, ips, ips_agc, coop}, reporting mean write latency and write
amplification normalized to baseline. `eval_cell` runs one cell through
`sim.run_trace` (on a card one `ssd_step` launch); `eval_matrix` runs the
same cells through the fleet (`sweep.runner.run_matrix`, one launch for
all of them).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

from repro_torch.core.ssd.sim import flush_cache, run_trace, summarize
from repro_torch.workloads import TRACES, make_trace, truncate_trace

__all__ = ["DEFAULT_SCALE", "LOGICAL_SPACE_CAP", "agc_waste_from_stats",
           "eval_cell", "eval_matrix"]

# default evaluation scale: 1/128 of the paper's 384 GB drive => 3 GB SSD,
# 32 MB SLC cache; cache-to-writeset ratios preserved (DESIGN.md §2)
DEFAULT_SCALE = 128

LOGICAL_SPACE_CAP = 1 << 16  # compressed logical space (carry budget)


def agc_waste_from_stats(st) -> float:
    """AGC early-migration waste: pages migrated in advance that get
    invalidated before they would have been GC'd, proportional to the
    workload's overwrite pressure (calibration in DESIGN.md §2)."""
    overwrite_pressure = st.write_ratio * (1.0 - st.seq_prob)
    return float(min(0.15 * overwrite_pressure + 0.02, 0.2))


def _agc_waste_p(name: str) -> float:
    return agc_waste_from_stats(TRACES[name])


def eval_cell(cfg, name: str, policy: str, mode: str, seed: int = 0, *,
              max_ops: Optional[int] = None,
              device="cuda") -> Dict[str, float]:
    """One cell of the evaluation matrix through `sim.run_trace`;
    `max_ops` truncates the trace as the sweep runner truncates it."""
    n_logical = min(cfg.total_pages, LOGICAL_SPACE_CAP)
    trace = make_trace(name, n_logical, mode=mode, seed=seed,
                       capacity_pages=cfg.total_pages)
    if max_ops is not None:
        trace = truncate_trace(trace, max_ops)
    latency, state = run_trace(cfg, policy, trace,
                               closed_loop=(mode == "bursty"),
                               n_logical=n_logical,
                               waste_p=_agc_waste_p(name), device=device)
    if mode == "daily":
        state = flush_cache(cfg, state, policy)
    summ = summarize(latency, trace["is_write"], state)
    out = {k: float(v) for k, v in summ.items()}
    out["n_ops"] = trace["n_ops"]
    return out


def eval_matrix(cfg, *, policies=("baseline", "ips", "ips_agc"),
                modes=("bursty", "daily"),
                names: Optional[Iterable[str]] = None, seed: int = 0,
                device="cuda"):
    """Full evaluation matrix on the batched fleet path.

    Same keys/values as looping `eval_cell` over the cells (the fleet and
    single-cell paths are bit-for-bit equivalent), but every cell runs in
    the fleet's one launch."""
    # lazy: the sweep runner imports this module
    from repro_torch.sweep.runner import run_matrix
    return run_matrix(cfg, policies=tuple(policies), modes=tuple(modes),
                      names=names, seed=seed, device=device)
