"""Policy composition spec: four orthogonal mechanism axes.

A cache-management policy is a *static* composition of mechanisms
(DESIGN.md §8); each axis picks one mechanism, and the engine
(`policies.engine`) assembles the specialized scan step from the selected
fragments. The spec — not the policy *name* — is the compilation key:
two registered names with identical compositions share one compiled scan.

Axes (values are the registered mechanism names):

  allocation  — how SLC-mode cache capacity is provisioned
      "static"    one fixed basic region (Turbo-Write, IPS)
      "dual"      small basic/IPS region + large traditional region (coop)
      "adaptive"  static basic region that unlocks `cap_boost` extra pages
                  (borrowed TLC blocks in SLC mode) while occupancy sits at
                  or above the pressure watermark — dynamic SLC sizing
      "wear_min"  static capacity, wear-aware placement: each SLC program
                  lands in the coldest wear bucket of the plane's region
                  instead of the sequential fill position (pick-coldest-
                  free-block wear leveling; requires endurance tracking,
                  DESIGN.md §9)
  trigger     — what starts reclamation of the tracked region
      "watermark"  occupancy >= 7/8 of capacity escalates reclamation onto
                   the critical path (bounded overrun, paper Fig. 7)
      "idle_gap"   reclamation only ever consumes device-idle budget
      "exhaustion" no proactive reclamation; a full region converts host
                   writes into the reclamation mechanism itself (IPS)
  mechanism   — how pages leave the cache
      "migrate"    read SLC + program TLC + erase (traditional GC)
      "reprogram"  in-place density switch (the paper's IPS primitive)
      "reprogram_gated"  reliability-gated reprogram (RARO-style,
                   DESIGN.md §9): in-place conversion is allowed only
                   while the plane's reprogram budget
                   (`EnduranceParams.rp_budget`) lasts; an exhausted
                   region falls back to idle-gap migration + erase and
                   overflow host writes go TLC-direct (requires
                   endurance tracking)
  idle        — what runs in idle time beyond triggered reclamation
      "none"       nothing (lazy policies)
      "greedy"     triggered reclamation may consume any gap, block-at-a-
                   time, non-interruptible (baseline semantics)
      "agc"        interruptible page-granularity Active GC fill of
                   reprogram slots (paper §IV.C)

This module is pure Python: specs are importable anywhere,
including the sweep grid.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["PolicySpec", "ALLOCATION_AXIS", "TRIGGER_AXIS",
           "MECHANISM_AXIS", "IDLE_AXIS", "validate_spec",
           "tracked_region", "requires_endurance", "iter_valid_specs"]

ALLOCATION_AXIS = ("static", "dual", "adaptive", "wear_min")
TRIGGER_AXIS = ("watermark", "idle_gap", "exhaustion")
MECHANISM_AXIS = ("migrate", "reprogram", "reprogram_gated")
IDLE_AXIS = ("none", "greedy", "agc")


@dataclass(frozen=True, order=True)
class PolicySpec:
    """One point in the mechanism-composition space.

    Hashable and orderable: used directly as a jit static argument and as
    the sweep runner's compilation-group key."""
    allocation: str
    trigger: str
    mechanism: str
    idle: str

    @property
    def composition(self) -> str:
        """Human-readable composition tag (BENCH metadata, progress)."""
        return (f"{self.allocation}+{self.trigger}+{self.mechanism}"
                f"+{self.idle}")


def validate_spec(spec: PolicySpec) -> None:
    """Reject compositions outside each axis or physically inconsistent.

    The constraints mirror hardware reality, not implementation limits:
    AGC fills *reprogram* slots, so it needs the reprogram mechanism;
    exhaustion-triggered reclamation IS the reprogram conversion; migrate
    reclamation needs a proactive trigger or it would never run before the
    end-of-workload flush.
    """
    for axis, valid in (("allocation", ALLOCATION_AXIS),
                        ("trigger", TRIGGER_AXIS),
                        ("mechanism", MECHANISM_AXIS),
                        ("idle", IDLE_AXIS)):
        val = getattr(spec, axis)
        if val not in valid:
            raise ValueError(
                f"unknown {axis} mechanism {val!r}; valid: {valid}")
    if (spec.mechanism in ("reprogram", "reprogram_gated")
            and spec.trigger != "exhaustion"):
        raise ValueError(
            f"{spec.composition}: the reprogram mechanism is exhaustion-"
            "triggered by construction (host writes convert in place); "
            "watermark/idle_gap triggers apply to migrate reclamation")
    if spec.mechanism == "migrate" and spec.trigger == "exhaustion":
        raise ValueError(
            f"{spec.composition}: exhaustion cannot trigger migration — "
            "a full region has no idle budget to migrate into; use "
            "watermark or idle_gap")
    if spec.mechanism == "migrate" and spec.idle == "none":
        raise ValueError(
            f"{spec.composition}: migrate reclamation runs inside the "
            "idle scheduler; idle \"none\" would leave the trigger dead "
            "and the cache unreclaimed until flush — use \"greedy\"")
    if spec.idle == "greedy" and spec.mechanism != "migrate":
        raise ValueError(
            f"{spec.composition}: \"greedy\" describes how triggered "
            "migrate reclamation consumes gaps; with the reprogram "
            "mechanism it would be a dead axis value behaving exactly "
            "like \"none\" — say \"none\" (or \"agc\")")
    if spec.idle == "agc" and spec.mechanism not in ("reprogram",
                                                     "reprogram_gated"):
        raise ValueError(
            f"{spec.composition}: AGC fills reprogram slots and therefore "
            "requires the reprogram mechanism")
    if spec.allocation == "dual" and spec.mechanism != "reprogram":
        raise ValueError(
            f"{spec.composition}: the dual-region allocation reclaims the "
            "traditional region by reprogramming into the IPS region "
            "(paper §IV.D); it requires the (ungated) reprogram mechanism")
    if spec.allocation == "adaptive" and spec.mechanism != "migrate":
        raise ValueError(
            f"{spec.composition}: adaptive sizing piggybacks on watermark "
            "state and migrate reclamation; reprogram-based adaptive "
            "sizing is not modeled")


def iter_valid_specs() -> tuple:
    """Every composition that passes `validate_spec`, in axis order — the
    full physically-consistent policy space (the search engine's candidate
    universe, DESIGN.md §10). Pure enumeration: 4*3*3*3 = 108 raw points,
    of which the constraints admit a small frontier."""
    import itertools
    out = []
    for axes in itertools.product(ALLOCATION_AXIS, TRIGGER_AXIS,
                                  MECHANISM_AXIS, IDLE_AXIS):
        spec = PolicySpec(*axes)
        try:
            validate_spec(spec)
        except ValueError:
            continue
        out.append(spec)
    return tuple(out)


def tracked_region(spec: PolicySpec) -> Optional[str]:
    """Which cache region keeps exact valid-page residency tracking.

    Migratable regions must be tracked (migration volume = valid pages);
    IPS regions carry no reclamation debt, so nothing is tracked for
    static/adaptive reprogram policies. The *gated* reprogram mechanism
    tracks its basic region: once the reprogram budget is exhausted the
    region's valid data must migrate out (and flush at end of workload)
    exactly like a traditional cache. Returns "basic", "trad" or None —
    also the end-of-workload flush rule (sim.flush_cache).
    """
    if spec.mechanism in ("migrate", "reprogram_gated"):
        return "basic"
    if spec.allocation == "dual":
        return "trad"
    return None


def requires_endurance(spec: PolicySpec) -> bool:
    """Compositions that only make sense with wear tracking enabled: the
    reliability gate reads reprogram wear, wear-aware placement reads
    bucket wear. The sweep runner auto-attaches default `EnduranceSpec`
    knobs to cells of such policies; `engine.build_step` rejects them
    without `CellParams.endurance`."""
    return (spec.mechanism == "reprogram_gated"
            or spec.allocation == "wear_min")
