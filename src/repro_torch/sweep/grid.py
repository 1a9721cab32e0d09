"""Sweep-grid definition: the cell is a `SweepPoint`, grids are lists.

Port of the reference package's `sweep/grid.py`: every grid (`paper`,
`quick`, `matrix`, `stress`, `mixed`, `beyond`, `endurance`,
`sensitivity`, `hostcache`). A point pins one simulated cell: workload
spec, access mode, policy, RNG seed, write-volume repeat factor (paper
Fig. 12a), cache-size fraction (Fig. 12b), an optional idle-threshold
override, pinned AGC waste probability, cap_boost scaling, endurance
knobs and the host-tier cache in front of the device — plus the cell's
declared normalization `baseline`. Its `key` is the reference's, so
results of the two packages pair up by key.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Iterable, Optional, Sequence

from repro_torch.core.ssd.endurance.spec import EnduranceSpec
from repro_torch.hostcache.spec import HostCacheSpec

__all__ = ["SweepPoint", "expand_grid", "matrix_grid", "paper_grid",
           "quick_grid", "stress_grid", "mixed_grid", "beyond_grid",
           "endurance_grid", "sensitivity_grid", "hostcache_grid",
           "named_grid", "GRIDS"]


@dataclass(frozen=True)
class SweepPoint:
    trace: str
    mode: str                      # "bursty" | "daily"
    policy: str                    # any name in policies.registry
    seed: int = 0
    repeat: int = 1                # write-volume multiplier (Fig. 12a)
    cache_frac: float = 1.0        # scales SLC regions (Fig. 12b)
    idle_threshold_ms: Optional[float] = None
    waste_p: Optional[float] = None  # None -> per-trace calibration
    cap_boost_frac: Optional[float] = None  # scales the adaptive
    #                                allocation's cap_boost
    # endurance-model knobs; None disables wear tracking unless the
    # policy's composition requires it (the runner then attaches defaults)
    endurance: Optional[EnduranceSpec] = None
    # the host-tier block cache in front of the device; None: none
    hostcache: Optional[HostCacheSpec] = None
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
        if self.idle_threshold_ms is not None:
            quals.append(f"idle={self.idle_threshold_ms:g}")
        if self.cap_boost_frac is not None:
            quals.append(f"boost={self.cap_boost_frac:g}")
        if self.endurance is not None:
            quals.append(f"endur={self.endurance.tag}")
        if self.hostcache is not None:
            quals.append(f"hc={self.hostcache.tag}")
        base = f"{self.trace}/{self.mode}/{self.policy}"
        return base + (f"&{','.join(quals)}" if quals else "")

    def baseline_point(self) -> "SweepPoint":
        """The cell this point normalizes against: the declared baseline
        policy, everything else the same but a pinned `waste_p`."""
        return replace(self, policy=self.baseline, waste_p=None)


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


def matrix_grid(policies=("baseline", "ips", "ips_agc"),
                seeds=(0,)) -> list[SweepPoint]:
    """The paper's headline matrix: 11 traces x {bursty, daily} x
    policies (Figs. 9-11)."""
    return expand_grid(policies=policies, seeds=seeds)


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


def stress_grid() -> list[SweepPoint]:
    """Beyond-MSR stress matrix: the parametric scenario generators
    across both modes — skewed overwrites, duty cycles, write bursts and
    sustained cache overrun."""
    return expand_grid(
        traces=("gc_pressure", "zipf_hot", "read_burst", "diurnal"),
        policies=("baseline", "ips", "ips_agc"))


def mixed_grid() -> list[SweepPoint]:
    """Multi-tenant colocation: the tenant_mix scenario across seeds, all
    four policies — the seed axis feeds the bootstrap CIs
    (`report.policy_geomeans_ci`)."""
    return expand_grid(traces=("tenant_mix",), modes=("daily",),
                       policies=("baseline", "ips", "ips_agc", "coop"),
                       seeds=(0, 1, 2))


def beyond_grid() -> list[SweepPoint]:
    """Beyond-paper compositions, each against its declared baseline:
    `dyn_slc` vs `baseline`, `ips_lazy` vs `coop`."""
    traces = ("hm_0", "hm_1", "proj_0")
    pts = expand_grid(traces=traces, policies=("baseline", "dyn_slc"))
    pts += expand_grid(traces=traces, policies=("coop", "ips_lazy"),
                       baseline="coop")
    return pts


def endurance_grid() -> list[SweepPoint]:
    """Wear / reliability / lifetime evaluation. Every cell tracks
    endurance with one pinned knob set: `w_rp=4`, `rp_budget=2`,
    `cycle_budget=15`, `read_penalty_ms=0.05`. `ips_raro` normalizes
    against `ips`, `base_wl` and the rest against `baseline`."""
    e = EnduranceSpec(w_rp=4.0, w_erase=1.0, cycle_budget=15.0,
                      rp_budget=2.0, read_penalty_ms=0.05)
    traces = ("hm_0", "hm_1", "proj_0")
    pts = expand_grid(traces=traces, policies=("baseline", "ips",
                                               "base_wl"))
    pts += expand_grid(traces=traces, policies=("ips_raro",),
                       baseline="ips")
    return [replace(p, endurance=e) for p in pts]


def sensitivity_grid() -> list[SweepPoint]:
    """Per-mechanism sensitivity around the `ips` composition: every
    registered policy whose spec differs from ips on exactly ONE axis,
    each normalized against ips."""
    from repro_torch.core.ssd.policies.registry import get_spec, policy_names
    center = "ips"
    cspec = get_spec(center)
    axes = ("allocation", "trigger", "mechanism", "idle")
    neighbors = sorted(
        name for name in policy_names()
        if sum(getattr(get_spec(name), a) != getattr(cspec, a)
               for a in axes) == 1)
    return expand_grid(traces=("hm_0", "hm_1", "proj_0"),
                       policies=(center, *neighbors), baseline=center)


def hostcache_grid() -> list[SweepPoint]:
    """Host-tier cache hierarchy: the diurnal flush-burst scenario under
    all four paper policies, crossed with the host-cache axis — off (the
    device-only cell every host cell's columns normalize against),
    write-back under both flush schedulers (watermark bursts, idle-gap
    draining), write-through and write-around — in both access modes.
    The flush axis exists only for write-back (wt/wa hold no dirty
    lines), so wt/wa carry the inert default."""
    hcs = (None,
           HostCacheSpec(mode="wb", flush="watermark"),
           HostCacheSpec(mode="wb", flush="idle"),
           HostCacheSpec(mode="wt"),
           HostCacheSpec(mode="wa"))
    pts = expand_grid(traces=("flush_burst",),
                      policies=("baseline", "ips", "ips_agc", "coop"))
    return [replace(p, hostcache=hc) for p in pts for hc in hcs]


GRIDS = {"paper": paper_grid, "quick": quick_grid, "matrix": matrix_grid,
         "stress": stress_grid, "mixed": mixed_grid, "beyond": beyond_grid,
         "endurance": endurance_grid, "sensitivity": sensitivity_grid,
         "hostcache": hostcache_grid}


def named_grid(name: str) -> list[SweepPoint]:
    try:
        return GRIDS[name]()
    except KeyError:
        raise ValueError(f"unknown grid {name!r}; choose from {sorted(GRIDS)}")
