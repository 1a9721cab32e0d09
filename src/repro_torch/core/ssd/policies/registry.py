"""Policy registry: names -> mechanism compositions (+ metadata).

The four paper schemes and the beyond-paper compositions are data, not
code: registering a policy is one `register(...)` call naming a
`PolicySpec`. Every layer above the engine — `sim.run_trace`,
`fleet.run_fleet`, `sweep.runner`/`cli`, `driver` — resolves policy names
here, so adding a cache-management idea never touches the simulator step.

Each entry declares its normalization `baseline`: the registered policy a
cell of this policy divides by in reports (the paper normalizes everything
to Turbo-Write "baseline"; `ips_lazy` instead declares `coop`, isolating
exactly the value of coop's idle work).

Pure Python by design, like `policies.spec`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.core.ssd.policies.spec import PolicySpec, validate_spec

__all__ = ["PolicyEntry", "register", "get_entry", "get_spec",
           "resolve_spec", "baseline_of", "policy_names",
           "PAPER_POLICIES"]


@dataclass(frozen=True)
class PolicyEntry:
    name: str
    spec: PolicySpec
    baseline: str = "baseline"   # registered policy this one normalizes to
    doc: str = ""


_REGISTRY: Dict[str, PolicyEntry] = {}


def register(name: str, spec: PolicySpec, *, baseline: str = "baseline",
             doc: str = "", overwrite: bool = False) -> PolicyEntry:
    """Register a named policy. Validates the composition up front so a
    bad spec fails at import/registration time, not inside a run."""
    validate_spec(spec)
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"policy {name!r} already registered "
                         f"({_REGISTRY[name].spec.composition}); pass "
                         "overwrite=True to replace it")
    if baseline != name and baseline not in _REGISTRY:
        raise ValueError(
            f"policy {name!r} declares baseline {baseline!r}, which is "
            "not registered (register the baseline first)")
    entry = PolicyEntry(name=name, spec=spec, baseline=baseline, doc=doc)
    _REGISTRY[name] = entry
    return entry


def get_entry(name: str) -> PolicyEntry:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; registered: "
                         f"{','.join(policy_names())}") from None


def get_spec(name: str) -> PolicySpec:
    return get_entry(name).spec


def resolve_spec(policy) -> PolicySpec:
    """Accept a registered name or a raw PolicySpec (validated)."""
    if isinstance(policy, PolicySpec):
        validate_spec(policy)
        return policy
    return get_spec(policy)


def baseline_of(name: str) -> str:
    return get_entry(name).baseline


def policy_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


# ---------------------------------------------------------------------------
# The paper's four schemes (sim.py module docstring describes each; the
# composition is the normative definition).
# ---------------------------------------------------------------------------

register("baseline", PolicySpec("static", "watermark", "migrate", "greedy"),
         doc="Turbo-Write static SLC cache; watermark-pressure migration "
             "to TLC with bounded write-stalling overrun (paper Fig. 7).")
register("ips", PolicySpec("static", "exhaustion", "reprogram", "none"),
         doc="In-place Switch: SLC exhaustion converts host writes into "
             "in-place reprogram writes; no idle work (paper §IV.B).")
register("ips_agc", PolicySpec("static", "exhaustion", "reprogram", "agc"),
         doc="IPS + interruptible Active GC: idle gaps pre-fill reprogram "
             "slots from GC-victim blocks (paper §IV.C).")
register("coop", PolicySpec("dual", "exhaustion", "reprogram", "agc"),
         doc="Cooperative dual-region cache: idle reclaims the traditional "
             "region by reprogramming into the IPS region (paper §IV.D).")

PAPER_POLICIES = ("baseline", "ips", "ips_agc", "coop")

# ---------------------------------------------------------------------------
# Beyond-paper compositions: proof that the axes compose. Each is
# one registration — no simulator code.
# ---------------------------------------------------------------------------

register("dyn_slc", PolicySpec("adaptive", "watermark", "migrate", "greedy"),
         doc="Watermark-adaptive SLC sizing: crossing the pressure "
             "watermark unlocks cap_boost extra SLC pages (TLC blocks "
             "borrowed in SLC mode, cf. dynamic Turbo-Write); reclamation "
             "and flush behave like baseline. cap_boost is a traced "
             "CellParams knob — sizing sweeps never recompile.")
register("ips_lazy", PolicySpec("dual", "exhaustion", "reprogram", "none"),
         baseline="coop",
         doc="coop minus all idle work: the dual-region layout absorbs "
             "writes until both regions exhaust, then host writes "
             "reprogram in place; the traditional region is only "
             "reclaimed by the end-of-workload flush. Normalizes against "
             "coop — the ratio is exactly the value of coop's idle "
             "reclamation.")

# ---------------------------------------------------------------------------
# Endurance-aware compositions (DESIGN.md §9): wear tracking is auto-
# enabled for these (policies.spec.requires_endurance); the sweep runner
# attaches default EnduranceSpec knobs when a grid does not pin its own.
# ---------------------------------------------------------------------------

register("ips_raro",
         PolicySpec("static", "exhaustion", "reprogram_gated", "none"),
         baseline="ips",
         doc="Reliability-gated IPS (RARO-style conversion gating): "
             "in-place reprogram is allowed only while the plane's "
             "per-page reprogram count stays under "
             "EnduranceParams.rp_budget; an exhausted region falls back "
             "to idle-gap migration + erase, and overflow host writes go "
             "TLC-direct. Residency is tracked for migration accounting "
             "only — cache reads keep ips's conservative TLC-speed model "
             "so the declared-baseline ratio isolates the gate. "
             "Normalizes against ips — the ratio is the latency/WAF "
             "price of the lifetime guarantee.")
register("base_wl",
         PolicySpec("wear_min", "watermark", "migrate", "greedy"),
         doc="Turbo-Write baseline + wear-aware allocation: each SLC "
             "program lands in the coldest wear bucket of the plane's "
             "region instead of the sequential fill position. Latencies "
             "and WAF are bit-identical to baseline; only the wear skew "
             "(BENCH cycle_skew column) improves.")
