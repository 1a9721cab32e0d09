"""Scenario search: find workloads that maximize policy separation — a
copy of the reference package's `search/scenario.py` on the port's fleet.

The dual of policy tuning: hold two policies fixed and search the
*workload* space — `TraceStats`, the synthesizer's parameter vector —
for statistics where their ranking diverges most from the MSR-suite
consensus. Each iteration perturbs the incumbent stats into a small
population, synthesizes every member through `synthesize_stats`, and
evaluates all of them under both policies in ONE `fleet.run_fleets` call
(on a card one `ssd_step` launch); every synthesized trace is truncated
to a fixed op budget, as in the reference. In a process group the
population is padded to a multiple of the ranks (the last member
replayed) and each rank evaluates its contiguous slice
(`fleet.shard_cells`); every rank gets every member's scores.

The separation metric is the per-trace latency ratio lat_a / lat_b. The
MSR reference ratio is computed through the same evaluator on the 11
published `TraceStats` (same op budget, same synthesizer), so "the
ranking flips" means exactly: the found ratio sits on the other side of
1.0 from the MSR geomean under identical measurement.

Deterministic per seed: one `np.random.default_rng(seed)` stream drives
all perturbations; synthesis RNG is keyed on (label, seed) as always.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.workloads.synth import TRACES, TraceStats, synthesize_stats

__all__ = ["evaluate_stats", "msr_reference", "perturb_stats",
           "separation_search", "DEFAULT_SCEN_OPS"]

# fixed op budget per synthesized trace: uniform (C, T) shapes across
# iterations (must stay <= ir.PAD_OPS so truncation, not padding, decides)
DEFAULT_SCEN_OPS = 49152


def evaluate_stats(cfg, stats_list: Sequence[TraceStats],
                   policies: Sequence[str], *, mode: str = "daily",
                   seed: int = 0, max_ops: int = DEFAULT_SCEN_OPS,
                   label: str = "scenario_search", device="cuda"
                   ) -> Dict[str, Dict[str, np.ndarray]]:
    """Latency/WAF of every (stats, policy) pair: one fleet per policy,
    all in one `run_fleets` call.

    Returns {policy: {"lat": (n,), "waf": (n,)}}. In a group of several
    ranks the cell axis is padded to a multiple of their count and
    sharded; in one process nothing is padded. `label` keys the
    synthesis RNG stream (with `seed`): a search meant to graduate into
    a registered generator evaluates under that generator's label, so
    the committed scenario is the same realization the search scored."""
    from repro_torch.core.ssd import fleet
    from repro_torch.core.ssd.driver import (LOGICAL_SPACE_CAP,
                                             agc_waste_from_stats)
    from repro_torch.core.ssd.policies.registry import get_spec
    from repro_torch.core.ssd.sim import default_params
    from repro_torch.distributed import group as dgroup
    from repro_torch.workloads import ir

    if max_ops > ir.PAD_OPS:
        raise ValueError(f"max_ops {max_ops} exceeds PAD_OPS {ir.PAD_OPS}: "
                         "synthesized traces would lose shape stability")
    n_logical = min(cfg.total_pages, LOGICAL_SPACE_CAP)
    traces, wastes = [], []
    for st in stats_list:
        req = synthesize_stats(st, n_logical, seed, cfg.total_pages,
                               label=label)
        tr = ir.trace_from_requests(req, mode, n_logical,
                                    "search:scenario")
        traces.append(ir.truncate_ops(tr.compile(), max_ops))
        wastes.append(agc_waste_from_stats(st))
    n = len(traces)
    sharded = dgroup.world_size() > 1
    if sharded:
        pad = (-n) % fleet.cell_quantum()
        mine = fleet.shard_cells(np.arange(n + pad))
        traces = [(traces + [traces[-1]] * pad)[i] for i in mine]
        wastes = [(wastes + [wastes[-1]] * pad)[i] for i in mine]
    ops = fleet.stack_ops(traces, device=device)
    groups = [fleet.FleetGroup(
        policy, ops, fleet.stack_params(
            [default_params(cfg, policy, w, device=device)
             for w in wastes]), closed_loop=(mode == "bursty"))
        for policy in policies]
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for policy, g, (latency, states) in zip(
            policies, groups, fleet.run_fleets(cfg, groups,
                                               n_logical=n_logical,
                                               trim_pads=True)):
        if mode == "daily":
            states = fleet.flush_fleet(cfg, states, get_spec(policy))
        summ = fleet.summarize_fleet(latency, ops["is_write"], states,
                                     params=g.params, cfg=cfg)
        out[policy] = {
            "lat": summ["mean_write_latency_ms"].cpu().numpy(),
            "waf": summ["wa_paper"].cpu().numpy()}
    if sharded:
        parts = dgroup.all_gather_objects(out)
        out = {p: {k: np.concatenate([part[p][k] for part in parts])[:n]
                   for k in ("lat", "waf")} for p in out}
    return out


def msr_reference(cfg, policy_a: str, policy_b: str, *,
                  mode: str = "daily", seed: int = 0,
                  max_ops: int = DEFAULT_SCEN_OPS, device="cuda") -> Dict:
    """The MSR-suite consensus ranking of the pair, measured through the
    scenario evaluator itself (same synthesizer, same op budget) so found
    scenarios compare against an identically-measured reference."""
    from repro_torch.sweep.report import geomean
    stats = [TRACES[name] for name in TRACES]
    res = evaluate_stats(cfg, stats, (policy_a, policy_b), mode=mode,
                         seed=seed, max_ops=max_ops, device=device)
    ratios = res[policy_a]["lat"] / np.maximum(res[policy_b]["lat"], 1e-12)
    return {"ratios": {name: float(r) for name, r in zip(TRACES, ratios)},
            "geomean": geomean(ratios)}


def perturb_stats(st: TraceStats, rng: np.random.Generator) -> TraceStats:
    """One multiplicative/additive jitter of every searched field.

    `n_requests` stays fixed — it (with the op budget) pins the stacked
    trace shape; volume pressure is searched via request size and the
    working set instead."""
    def jitter(v, lo, hi, scale=0.35):
        return float(np.clip(v * np.exp(rng.normal(0.0, scale)), lo, hi))

    idle_every = int(np.clip(
        round(jitter(st.idle_every, 200, 2 * st.n_requests)),
        200, 2 * st.n_requests))
    return TraceStats(
        n_requests=st.n_requests,
        write_ratio=float(np.clip(st.write_ratio + rng.normal(0.0, 0.12),
                                  0.05, 0.99)),
        mean_req_pages=jitter(st.mean_req_pages, 1.0, 12.0),
        seq_prob=float(np.clip(st.seq_prob + rng.normal(0.0, 0.15),
                               0.0, 0.95)),
        working_set_frac=jitter(st.working_set_frac, 0.002, 0.3),
        skew=jitter(st.skew, 0.25, 8.0),
        interarrival_ms=jitter(st.interarrival_ms, 0.05, 5.0),
        idle_every=idle_every,
        # seed a zero incumbent at 1 ms so the multiplicative jitter has
        # something to scale, but never re-floor a live sub-1ms value:
        # idle-starved regimes must stay reachable and refinable
        idle_ms=jitter(st.idle_ms if st.idle_ms > 0 else 1.0,
                       0.0, 2500.0),
    )


def separation_search(cfg, policy_a: str = "ips", policy_b: str = "coop",
                      *, seed: int = 0, iters: int = 5, pop: int = 8,
                      mode: str = "daily", max_ops: int = DEFAULT_SCEN_OPS,
                      center: Optional[TraceStats] = None,
                      label: str = "scenario_search",
                      progress=None, device="cuda") -> Dict:
    """Hill-climb `TraceStats` toward maximum ranking separation.

    Pushes the latency ratio lat_a/lat_b *away* from the MSR-geomean side
    of 1.0: if the suite says a beats b (geomean < 1), the search hunts a
    regime where a loses (ratio > 1), and vice versa. Returns a JSON-ready
    record: the reference, the best stats found, the per-iteration
    trajectory and whether the ranking actually flipped."""
    rng = np.random.default_rng(seed)
    ref = msr_reference(cfg, policy_a, policy_b, mode=mode, seed=seed,
                        max_ops=max_ops, device=device)
    direction = 1.0 if ref["geomean"] <= 1.0 else -1.0

    best = center if center is not None else TRACES["hm_0"]
    res = evaluate_stats(cfg, [best], (policy_a, policy_b), mode=mode,
                         seed=seed, max_ops=max_ops, label=label,
                         device=device)
    best_ratio = float(res[policy_a]["lat"][0]
                       / max(res[policy_b]["lat"][0], 1e-12))
    history: List[Dict] = []
    for it in range(iters):
        cands = [best] + [perturb_stats(best, rng) for _ in range(pop - 1)]
        res = evaluate_stats(cfg, cands, (policy_a, policy_b), mode=mode,
                             seed=seed, max_ops=max_ops, label=label,
                             device=device)
        ratios = (res[policy_a]["lat"]
                  / np.maximum(res[policy_b]["lat"], 1e-12))
        idx = int(np.argmax(direction * ratios))
        if direction * ratios[idx] >= direction * best_ratio:
            best, best_ratio = cands[idx], float(ratios[idx])
        history.append({"iter": it, "best_ratio": round(best_ratio, 4)})
        if progress:
            progress(f"scenario iter {it}: ratio {policy_a}/{policy_b} "
                     f"= {best_ratio:.3f} (msr geomean "
                     f"{ref['geomean']:.3f})")
    flipped = ((best_ratio - 1.0) * (ref["geomean"] - 1.0) < 0)
    return {"policy_a": policy_a, "policy_b": policy_b,
            "mode": mode, "max_ops": max_ops, "seed": seed,
            "msr_geomean": ref["geomean"], "msr_ratios": ref["ratios"],
            "best_ratio": best_ratio, "flipped": bool(flipped),
            "best_stats": dataclasses.asdict(best),
            "history": history}
