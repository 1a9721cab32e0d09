"""Sweep-grid definition: the cell is a `SweepPoint`, grids are lists.

Port of the reference package's `sweep/grid.py` for the grids whose
cells the port runs: `paper`, `quick` and `beyond`. A point pins one
simulated cell: workload trace, access mode, policy, RNG seed,
write-volume repeat factor (paper Fig. 12a) and cache-size fraction
(Fig. 12b) — plus the cell's declared normalization `baseline`. Its
`key` is the reference's, so results of the two packages pair up by
key. The reference's other point knobs (pinned waste_p, idle threshold,
boost fraction, endurance, host tier) belong to later slices.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Iterable, Optional, Sequence

__all__ = ["SweepPoint", "expand_grid", "paper_grid", "quick_grid",
           "beyond_grid", "named_grid", "GRIDS"]


@dataclass(frozen=True)
class SweepPoint:
    trace: str
    mode: str                      # "bursty" | "daily"
    policy: str                    # any name in policies.registry
    seed: int = 0
    repeat: int = 1                # write-volume multiplier (Fig. 12a)
    cache_frac: float = 1.0        # scales SLC regions (Fig. 12b)
    # declared normalization policy — metadata, not cell identity
    baseline: str = field(default="baseline", compare=False)

    @property
    def key(self) -> str:
        """Result-store key: `trace/mode/policy[&qualifiers]`."""
        quals = []
        if self.seed:
            quals.append(f"seed={self.seed}")
        if self.repeat != 1:
            quals.append(f"rep={self.repeat}")
        if self.cache_frac != 1.0:
            quals.append(f"cache={self.cache_frac:g}")
        base = f"{self.trace}/{self.mode}/{self.policy}"
        return base + (f"&{','.join(quals)}" if quals else "")

    def baseline_point(self) -> "SweepPoint":
        """The cell this point normalizes against."""
        return replace(self, policy=self.baseline)


def expand_grid(traces: Optional[Iterable[str]] = None,
                modes: Sequence[str] = ("bursty", "daily"),
                policies: Sequence[str] = ("baseline", "ips", "ips_agc"),
                seeds: Sequence[int] = (0,),
                repeats: Sequence[int] = (1,),
                cache_fracs: Sequence[float] = (1.0,),
                baseline: str = "baseline") -> list[SweepPoint]:
    """Full cartesian product — traces x modes x policies x seeds x
    repeats x cache fractions. traces=None means all 11 MSR-like
    traces."""
    if traces is None:
        from repro_torch.workloads import TRACE_NAMES
        traces = TRACE_NAMES
    return [SweepPoint(trace=t, mode=m, policy=p, seed=s, repeat=r,
                       cache_frac=c, baseline=baseline)
            for t, m, p, s, r, c in itertools.product(
                traces, modes, policies, seeds, repeats, cache_fracs)]


def paper_grid() -> list[SweepPoint]:
    """Everything behind Figs. 9-12 in one grid (102 cells):

    * headline matrix, all four policies (Figs. 9-11)
    * write-volume sweep: hm_0 bursty, baseline and coop, repeats 2/4/7
      (Fig. 12a)
    * cache-size sensitivity: hm_0/proj_0 daily at 0.5x/2x cache
      (Fig. 12b analogue)
    """
    pts = expand_grid(policies=("baseline", "ips", "ips_agc", "coop"))
    pts += expand_grid(traces=("hm_0",), modes=("bursty",),
                       policies=("baseline", "coop"), repeats=(2, 4, 7))
    pts += expand_grid(traces=("hm_0", "proj_0"), modes=("daily",),
                       policies=("baseline", "ips_agc"),
                       cache_fracs=(0.5, 2.0))
    return pts


def quick_grid() -> list[SweepPoint]:
    """2-trace smoke grid: both modes, baseline + ips."""
    return expand_grid(traces=("hm_0", "hm_1"),
                       policies=("baseline", "ips"))


def beyond_grid() -> list[SweepPoint]:
    """Beyond-paper compositions, each against its declared baseline:
    `dyn_slc` vs `baseline`, `ips_lazy` vs `coop`."""
    traces = ("hm_0", "hm_1", "proj_0")
    pts = expand_grid(traces=traces, policies=("baseline", "dyn_slc"))
    pts += expand_grid(traces=traces, policies=("coop", "ips_lazy"),
                       baseline="coop")
    return pts


GRIDS = {"paper": paper_grid, "quick": quick_grid, "beyond": beyond_grid}


def named_grid(name: str) -> list[SweepPoint]:
    try:
        return GRIDS[name]()
    except KeyError:
        raise ValueError(f"unknown grid {name!r}; choose from {sorted(GRIDS)}")
