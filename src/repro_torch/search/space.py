"""Search candidate space: policy compositions x per-cell knob ranges.

A copy of the reference package's `search/space.py` on the port's
registry and sweep points. A `Candidate` is one point the autotuner can
evaluate: a registered policy name plus overrides of the per-cell knobs
(cache size fraction, idle threshold, adaptive `cap_boost` fraction,
endurance gate budgets / hysteresis, a host-tier cache). All candidates
of one round run in ONE sweep (`tune.evaluate_candidates`): on a card one
`ssd_step` launch, whatever their compositions; only the kernel
specialisations a composition, mode, form and probe need are new work
(`ssd_step.ops.specialisations`).

The candidate universe spans the registered policies and, optionally, the
whole physically valid composition frontier (`iter_valid_specs`):
`register_space()` auto-registers the unregistered valid compositions
under stable 4-letter codes (`x_<alloc><trigger><mech><idle>`, e.g.
`x_sega` = static+exhaustion+reprogram_gated+agc) so every spec has a
sweepable name.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

from repro_torch.sweep.grid import SweepPoint

if TYPE_CHECKING:                                     # typing only
    from repro_torch.core.ssd.endurance.spec import EnduranceSpec
    from repro_torch.hostcache.spec import HostCacheSpec

__all__ = ["Candidate", "auto_name", "register_space", "build_space",
           "group_key", "group_candidates", "SPACES"]

# per-axis single-letter codes for auto-registered composition names
# (mechanism uses 'g' for the gated variant: initials alone collide)
_AXIS_CODES = {
    "allocation": {"static": "s", "dual": "d", "adaptive": "a",
                   "wear_min": "w"},
    "trigger": {"watermark": "w", "idle_gap": "i", "exhaustion": "e"},
    "mechanism": {"migrate": "m", "reprogram": "r", "reprogram_gated": "g"},
    "idle": {"none": "n", "greedy": "g", "agc": "a"},
}


@dataclass(frozen=True)
class Candidate:
    """One autotuning candidate: a policy plus traced-knob overrides.

    Hashable (score-table / survivor-set key). `endurance=None` means the
    tuner's scoring `EnduranceSpec` applies (so lifetime objectives exist
    for every cell); a candidate carrying its own spec — e.g. a gate
    budget/hysteresis point for `ips_raro` — keeps it."""
    policy: str
    cache_frac: float = 1.0
    idle_threshold_ms: Optional[float] = None
    cap_boost_frac: Optional[float] = None
    endurance: Optional["EnduranceSpec"] = None
    # host-tier cache spec (DESIGN.md §14) — unlike the float knobs this
    # splits the sweep's group (a host tier pass of its own), so `full`
    # keeps the host-cache axis small
    hostcache: Optional["HostCacheSpec"] = None

    @property
    def label(self) -> str:
        """Compact display/report key, e.g. `ips_agc@cache=0.5`."""
        quals = []
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
        return self.policy + (f"@{','.join(quals)}" if quals else "")

    def point(self, trace: str, mode: str, seed: int = 0,
              endurance: Optional["EnduranceSpec"] = None) -> SweepPoint:
        """The sweep cell evaluating this candidate on one workload.

        `endurance` is the tuner's scoring default, used only when the
        candidate does not pin its own; the cell's declared normalization
        baseline comes from the registry."""
        from repro_torch.core.ssd.policies.registry import baseline_of
        e = self.endurance if self.endurance is not None else endurance
        return SweepPoint(
            trace=trace, mode=mode, policy=self.policy,
            seed=seed, cache_frac=self.cache_frac,
            idle_threshold_ms=self.idle_threshold_ms,
            cap_boost_frac=self.cap_boost_frac, endurance=e,
            hostcache=self.hostcache,
            baseline=baseline_of(self.policy))

    def to_json(self) -> Dict:
        """JSON-ready record for BENCH_search.json."""
        return {"policy": self.policy, "cache_frac": self.cache_frac,
                "idle_threshold_ms": self.idle_threshold_ms,
                "cap_boost_frac": self.cap_boost_frac,
                "endurance": (None if self.endurance is None
                              else self.endurance.tag),
                "hostcache": (None if self.hostcache is None
                              else self.hostcache.tag),
                "label": self.label}


def auto_name(spec) -> str:
    """Stable short name for an unregistered composition (module doc)."""
    return "x_" + "".join(_AXIS_CODES[axis][getattr(spec, axis)]
                          for axis in ("allocation", "trigger",
                                       "mechanism", "idle"))


def register_space(include_auto: bool = True) -> Tuple[str, ...]:
    """Policy names spanning the valid composition space.

    Every valid spec resolves to its registered name when one exists;
    with `include_auto`, the unregistered remainder is registered under
    `auto_name` codes (declared baseline: the paper baseline). Idempotent.
    """
    from repro_torch.core.ssd.policies import registry
    from repro_torch.core.ssd.policies.spec import iter_valid_specs
    known = {registry.get_spec(n): n for n in registry.policy_names()}
    names: List[str] = []
    for spec in iter_valid_specs():
        if spec in known:
            names.append(known[spec])
            continue
        if not include_auto:
            continue
        name = auto_name(spec)
        if name not in registry.policy_names():
            registry.register(
                name, spec,
                doc=f"search: auto-registered composition "
                    f"{spec.composition}")
        names.append(name)
    return tuple(names)


def group_key(cand: Candidate):
    """Group identity of a candidate under the tuner, as the reference
    keys it: its mechanism composition (modes split at schedule level)
    and its host-cache spec. Endurance presence cannot differ between
    tuner cells: every scoring cell carries endurance knobs (the
    candidate's own or the tuner's scoring default), so a candidate's
    own `endurance` being None is a knob-only difference, not a group
    split."""
    from repro_torch.core.ssd.policies.registry import get_spec
    return (get_spec(cand.policy), cand.hostcache)


def group_candidates(cands: Sequence[Candidate]) -> Dict[tuple, list]:
    """Candidates bucketed by `group_key` (reports)."""
    groups: Dict[tuple, list] = {}
    for c in cands:
        groups.setdefault(group_key(c), []).append(c)
    return groups


def _knob_variants(policy: str, *, cache_fracs: Sequence[float],
                   idle_thrs: Sequence[float],
                   boost_fracs: Sequence[float],
                   gate_budgets: Sequence[float],
                   gate_hysteresis: Sequence[float],
                   hostcaches: Sequence[str] = ()) -> List[Candidate]:
    """Default + one-knob-at-a-time variants around it (the sensitivity-
    style axis walk: knob interactions are the *tuner's* job across
    rounds, not the space's to pre-enumerate)."""
    from repro_torch.core.ssd.endurance.spec import EnduranceSpec
    from repro_torch.core.ssd.policies.registry import get_spec
    spec = get_spec(policy)
    out = [Candidate(policy)]
    out += [Candidate(policy, cache_frac=f) for f in cache_fracs
            if f != 1.0]
    # the idle threshold only matters to compositions that consume
    # device-idle budget (migrate / dual reclaim / gated fallback); AGC
    # fills from the raw per-plane gap, so it does not qualify alone
    uses_idle = (spec.mechanism in ("migrate", "reprogram_gated")
                 or (spec.allocation == "dual" and spec.idle != "none"))
    if uses_idle:
        out += [Candidate(policy, idle_threshold_ms=t) for t in idle_thrs]
    if spec.allocation == "adaptive":
        out += [Candidate(policy, cap_boost_frac=b) for b in boost_fracs]
    if spec.mechanism == "reprogram_gated":
        # live-gate scoring knobs: stress weight / budgets in the
        # endurance-grid regime so the gate actually trips in-trace
        out += [Candidate(policy, endurance=EnduranceSpec(
                    w_rp=4.0, w_erase=1.0, cycle_budget=15.0,
                    rp_budget=b, rp_hysteresis=h))
                for b in gate_budgets for h in gate_hysteresis]
    if hostcaches:
        # each spec string is a HostCacheSpec.parse recipe; each distinct
        # spec splits a sweep group (DESIGN.md §14), so presets keep this
        # axis short
        from repro_torch.hostcache.spec import HostCacheSpec
        out += [Candidate(policy, hostcache=HostCacheSpec.parse(s))
                for s in hostcaches]
    return out


def build_space(budget: str) -> List[Candidate]:
    """Named candidate spaces (the `--search <budget>` presets).

    * smoke — 3 compositions, one knob axis: the CI-sized space.
    * quick — every registered non-reference policy with a one-knob walk
      (the space of the reference's committed BENCH_search.json).
    * full  — quick plus the auto-registered remainder of the valid
      composition frontier and a wider knob walk.

    Reference policies (those that ARE their own declared baseline, e.g.
    the paper baseline) are excluded: their normalized objectives are
    identically 1.0 — they are the datum, not a candidate.
    """
    from repro_torch.core.ssd.policies.registry import baseline_of
    try:
        preset = SPACES[budget]
    except KeyError:
        raise ValueError(
            f"unknown search budget {budget!r}; choose from "
            f"{sorted(SPACES)}")
    policies = (register_space(include_auto=preset["auto"])
                if preset["policies"] is None else preset["policies"])
    cands: List[Candidate] = []
    for policy in policies:
        if baseline_of(policy) == policy:
            continue
        cands.extend(_knob_variants(policy, **preset["knobs"]))
    return list(dict.fromkeys(cands))


SPACES: Dict[str, Dict] = {
    "smoke": {
        "policies": ("ips", "ips_agc", "dyn_slc"), "auto": False,
        "knobs": {"cache_fracs": (0.5,), "idle_thrs": (),
                  "boost_fracs": (0.5,), "gate_budgets": (),
                  "gate_hysteresis": ()}},
    "quick": {
        "policies": None, "auto": False,
        "knobs": {"cache_fracs": (0.5, 2.0), "idle_thrs": (2.0,),
                  "boost_fracs": (0.5, 2.0), "gate_budgets": (2.0, 4.0),
                  "gate_hysteresis": (0.0, 1.0)}},
    "full": {
        "policies": None, "auto": True,
        "knobs": {"cache_fracs": (0.25, 0.5, 2.0, 4.0),
                  "idle_thrs": (1.0, 2.0, 10.0),
                  "boost_fracs": (0.25, 0.5, 2.0, 4.0),
                  "gate_budgets": (1.0, 2.0, 4.0, 8.0),
                  "gate_hysteresis": (0.0, 0.5, 1.0),
                  "hostcaches": ("mode=wb,flush=watermark",
                                 "mode=wb,flush=idle")}},
}
