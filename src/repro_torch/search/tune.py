"""Policy autotuner: successive halving to a Pareto front — a copy of
the reference package's `search/tune.py` on the port's sweep runner.

Each round evaluates every surviving candidate on that round's workload
budget in ONE `run_sweep` call: on a card one launch of the `ssd_step`
kernel for every cell of the round (and one of `host_tier` when a
candidate carries a host cache). The reference counts the fleet programs
a round compiles (`fleet.compile_count`); nothing is compiled per shape
here, so a round records instead how many kernel specialisations it
needed for the first time in the process (`ssd_step.ops.
specialisations`) — zero for a round that only refines knobs or
workloads, as the reference's compile count is for knob-only rounds.

Objectives are the repo's normalization currency: per candidate, the
geomean over the round's (trace, mode) cells of

  * `lat` — mean write latency vs the candidate's declared baseline (min)
  * `waf` — paper write amplification vs the same baseline (min)
  * `tbw` — projected TBW vs the same baseline (max; every scoring cell
    carries the tuner's `EnduranceSpec`, so lifetime exists even for
    wear-oblivious compositions — observation only for them)

Pruning between rounds keeps the best `keep_frac` by the scalar pruning
metric (`lat`, ties broken deterministically); the final round's
survivors are reduced to their non-dominated set (`pareto_front`).
Candidate order, pruning and the front are pure functions of the
scores, and the scores are deterministic per seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.search.space import Candidate
from repro_torch.telemetry.spans import span

__all__ = ["SCHEDULES", "TuneResult", "evaluate_candidates", "prune",
           "specialisations",
           "pareto_front", "successive_halving", "default_score_endurance"]

PRUNE_METRIC = "lat"


# per-budget round schedules, the reference's (trace specs resolve
# through repro_torch.workloads: MSR names and registered scenario names —
# the search-found adversarial scenario among them). Later rounds widen
# the workload budget; the final round adds the scenario stressors.
# `cell_bucket` keys the reference's compiled shapes; the port has none.
SCHEDULES: Dict[str, Dict] = {
    "smoke": {
        "rounds": [
            {"traces": ("hm_0",), "modes": ("daily",), "max_ops": 4096},
            {"traces": ("hm_0", "hm_1"), "modes": ("daily",),
             "max_ops": 4096},
        ],
        "keep_frac": 0.5, "min_keep": 2, "cell_bucket": 4,
        "scenario": {"iters": 2, "pop": 4, "max_ops": 8192}},
    "quick": {
        "rounds": [
            {"traces": ("hm_0", "prxy_0"), "modes": ("bursty", "daily"),
             "max_ops": 32768},
            {"traces": ("hm_0", "prxy_0", "proj_0", "hm_1"),
             "modes": ("bursty", "daily"), "max_ops": 32768},
            {"traces": ("hm_0", "prxy_0", "proj_0", "hm_1",
                        "gc_pressure", "adv_ips_base"),
             "modes": ("bursty", "daily"), "max_ops": None},
        ],
        "keep_frac": 0.5, "min_keep": 4, "cell_bucket": 8,
        "scenario": {"iters": 5, "pop": 8, "max_ops": 49152}},
    "full": {
        "rounds": [
            {"traces": ("hm_0", "prxy_0"), "modes": ("bursty", "daily"),
             "max_ops": 16384},
            {"traces": ("hm_0", "prxy_0", "proj_0", "hm_1", "mds_0"),
             "modes": ("bursty", "daily"), "max_ops": 32768},
            {"traces": ("hm_0", "prxy_0", "proj_0", "hm_1", "mds_0",
                        "src1_2", "usr_0", "stg_0"),
             "modes": ("bursty", "daily"), "max_ops": None},
            {"traces": ("hm_0", "prxy_0", "proj_0", "hm_1", "mds_0",
                        "src1_2", "usr_0", "stg_0", "gc_pressure",
                        "zipf_hot", "adv_ips_base"),
             "modes": ("bursty", "daily"), "max_ops": None},
        ],
        "keep_frac": 0.5, "min_keep": 6, "cell_bucket": 8,
        "scenario": {"iters": 10, "pop": 12, "max_ops": 131072}},
}


def default_score_endurance():
    """The tuner's scoring `EnduranceSpec`: endurance-grid magnitudes
    (reprogram stress 4x an erase, small cycle budget) so TBW projections
    are live inside truncated traces, while the gate stays inert
    (`rp_budget` default) and reads unpenalized — latency/WAF of wear-
    oblivious compositions are untouched (DESIGN.md §9 observation
    contract)."""
    from repro_torch.core.ssd.endurance.spec import EnduranceSpec
    return EnduranceSpec(w_rp=4.0, w_erase=1.0, cycle_budget=15.0)


@dataclass
class TuneResult:
    """Everything the search produced, JSON-ready via `to_json`."""
    front: List[Tuple[Candidate, Dict]]      # non-dominated, lat-sorted
    scores: Dict[Candidate, Dict]            # final-round scores
    rounds: List[Dict]                       # per-round metadata
    round_scores: List[Dict[Candidate, Dict]] = field(repr=False,
                                                      default_factory=list)
    survivors: List[Candidate] = field(default_factory=list)

    def to_json(self) -> Dict:
        return {
            "front": [c.to_json() | s for c, s in self.front],
            "scores": {c.label: s for c, s in self.scores.items()},
            "rounds": self.rounds,
            "survivors": [c.label for c in self.survivors],
        }


def evaluate_candidates(cfg, candidates: Sequence[Candidate], *,
                        traces: Sequence[str], modes: Sequence[str],
                        seed: int = 0, max_ops: Optional[int] = None,
                        trace_cache=None, score_endurance=None,
                        progress=None, device="cuda"
                        ) -> Tuple[Dict[Candidate, Dict], Dict]:
    """Score every candidate on (traces x modes) in one batched sweep.

    Returns ({candidate: {"lat", "waf", "tbw", "n"}}, eval_meta). The
    sweep includes each cell's declared-baseline partner (same knobs) so
    normalization never silently drops cells."""
    from repro_torch.sweep.runner import run_sweep
    if score_endurance is None:
        score_endurance = default_score_endurance()

    cells: Dict[tuple, object] = {}
    for cand in candidates:
        for tr in traces:
            for mode in modes:
                cells[(cand, tr, mode)] = cand.point(
                    tr, mode, seed=seed, endurance=score_endurance)
    aux = {pt.baseline_point() for pt in cells.values()
           if pt.policy != pt.baseline}
    points = list(dict.fromkeys(
        [*cells.values(), *sorted(aux, key=lambda p: p.key)]))

    timings: List[Dict] = []
    results = run_sweep(cfg, points, max_ops=max_ops, progress=progress,
                        trace_cache=trace_cache, timings=timings,
                        device=device)

    from repro_torch.sweep.report import geomean
    scores: Dict[Candidate, Dict] = {}
    for cand in candidates:
        lat, waf, tbw = [], [], []
        for tr in traces:
            for mode in modes:
                pt = cells[(cand, tr, mode)]
                val = results[pt]
                base = (val if pt.policy == pt.baseline
                        else results[pt.baseline_point()])
                lat.append(val["mean_write_latency_ms"]
                           / max(base["mean_write_latency_ms"], 1e-12))
                waf.append(val["wa_paper"] / max(base["wa_paper"], 1e-12))
                if "tbw_proj_gb" in val and "tbw_proj_gb" in base:
                    tbw.append(val["tbw_proj_gb"]
                               / max(base["tbw_proj_gb"], 1e-12))
        scores[cand] = {"lat": geomean(lat), "waf": geomean(waf),
                        "tbw": geomean(tbw) if tbw else None,
                        "n": len(lat)}
    # one fleet group a (composition, mode, length, wear, host cache);
    # over several ranks a group's cells may sit on more than one
    groups = {(t["composition"], t["mode"], t["t_len"], t["endurance"],
               t["hostcache"]) for t in timings}
    meta = {"cells": len(points), "groups": len(groups),
            "group_timings": timings}
    return scores, meta


def specialisations() -> int:
    """The kernel specialisations needed so far: this process's, or in a
    process group the union of every rank's (a group runs each cell of a
    round once, as one process does, so the union grows as one
    process's count would). Every rank calls it."""
    from repro_torch.distributed import group as dgroup
    from repro_torch.kernels.ssd_step import ops as ssd_step
    keys = ssd_step.specialisation_keys()
    if dgroup.world_size() > 1:
        keys = frozenset().union(*dgroup.all_gather_objects(keys))
    return len(keys)


def _prune_key(item: Tuple[Candidate, Dict]):
    cand, s = item
    tbw = s["tbw"] if s["tbw"] is not None else 1.0
    return (s[PRUNE_METRIC], s["waf"], -tbw, cand.label)


def prune(scores: Dict[Candidate, Dict], keep: int) -> List[Candidate]:
    """Best `keep` candidates by the scalar pruning metric (latency ratio;
    deterministic tie-break on WAF, TBW, label). Sorting on the metric is
    what guarantees a dropped candidate can never dominate a survivor on
    it (tests/test_search.py asserts the property on real rounds)."""
    ranked = sorted(scores.items(), key=_prune_key)
    return [cand for cand, _ in ranked[:keep]]


def _dominates(a: Dict, b: Dict) -> bool:
    """a dominates b: no worse on every objective, better on one
    (lat/waf minimized, tbw maximized; a missing tbw scores 1.0 — the
    by-definition ratio of an observation-only cell pair)."""
    at = a["tbw"] if a["tbw"] is not None else 1.0
    bt = b["tbw"] if b["tbw"] is not None else 1.0
    no_worse = (a["lat"] <= b["lat"] and a["waf"] <= b["waf"]
                and at >= bt)
    better = a["lat"] < b["lat"] or a["waf"] < b["waf"] or at > bt
    return no_worse and better


def pareto_front(scores: Dict[Candidate, Dict]
                 ) -> List[Tuple[Candidate, Dict]]:
    """Non-dominated candidates over (lat, waf, tbw), each objective a
    ratio vs the candidate's declared baseline, sorted by the pruning
    key (deterministic)."""
    items = sorted(scores.items(), key=_prune_key)
    return [(c, s) for c, s in items
            if not any(_dominates(s2, s) for c2, s2 in items if c2 != c)]


def successive_halving(cfg, candidates: Sequence[Candidate],
                       schedule: Sequence[Dict], *, seed: int = 0,
                       keep_frac: float = 0.5, min_keep: int = 2,
                       trace_cache=None, score_endurance=None,
                       progress=None, device="cuda") -> TuneResult:
    """Prune candidates across widening workload budgets, then report the
    final survivors' Pareto front.

    `schedule` is a list of round dicts ({"traces", "modes", "max_ops"},
    see SCHEDULES); each round evaluates the survivors on its budget,
    records {survivors, cells, groups, compiles, wall_s} — `compiles`
    the kernel specialisations the round needed first
    (`specialisations`) — and keeps `max(min_keep, ceil(n *
    keep_frac))` of them, except after the last round, whose scores feed
    `pareto_front` instead."""
    survivors = list(dict.fromkeys(candidates))
    rounds_meta: List[Dict] = []
    round_scores: List[Dict[Candidate, Dict]] = []
    scores: Dict[Candidate, Dict] = {}
    for rnd, stage in enumerate(schedule):
        n_in = len(survivors)
        compiles0 = specialisations()
        with span("search.round", "search", round=rnd,
                  candidates=n_in) as rec:
            scores, meta = evaluate_candidates(
                cfg, survivors, traces=stage["traces"],
                modes=stage["modes"],
                seed=seed, max_ops=stage.get("max_ops"),
                trace_cache=trace_cache, score_endurance=score_endurance,
                progress=progress, device=device)
            rec["args"]["compiles"] = specialisations() - compiles0
        wall_s = rec["dur_s"]
        round_scores.append(scores)
        if rnd < len(schedule) - 1:
            keep = min(n_in, max(min_keep,
                                 math.ceil(n_in * keep_frac)))
            survivors = prune(scores, keep)
        best = min(scores.items(), key=_prune_key)
        rounds_meta.append({
            "round": rnd, "traces": list(stage["traces"]),
            "modes": list(stage["modes"]),
            "max_ops": stage.get("max_ops"),
            "candidates": n_in, "survivors": len(survivors),
            "cells": meta["cells"], "groups": meta["groups"],
            "compiles": rec["args"]["compiles"],
            "wall_s": round(wall_s, 3),
            "best": best[0].label,
            "best_lat": round(best[1]["lat"], 4)})
        if progress:
            progress(f"round {rnd}: {n_in} candidate(s) -> "
                     f"{len(survivors)} survivor(s), "
                     f"{rounds_meta[-1]['compiles']} new specialisation(s), "
                     f"{wall_s:.1f}s")
    return TuneResult(front=pareto_front(scores), scores=scores,
                      rounds=rounds_meta, round_scores=round_scores,
                      survivors=survivors)
