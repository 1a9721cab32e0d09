"""Reporting: baseline normalization, geomeans, lifetime, host-tier and
sensitivity tables, bootstrap CIs, the search's tables — numpy copies of
the reference package's `sweep/report.py`.

The paper reports every policy metric normalized per (workload, mode) to
the Turbo-Write baseline; the geometric mean aggregates the ratios.
`bootstrap_ci` draws exactly what the reference draws for the same seed.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, Mapping

import numpy as np

__all__ = ["geomean", "normalize_to_baseline", "normalize_points",
           "policy_geomeans", "endurance_summary", "hostcache_summary",
           "sensitivity_deltas", "bootstrap_ci", "policy_geomeans_ci",
           "search_rounds_table", "search_front_table", "throughput_table"]


def geomean(values) -> float:
    vals = np.asarray(list(values), dtype=np.float64)
    vals = np.maximum(vals, 1e-12)
    return float(np.exp(np.mean(np.log(vals))))


def _split_key(key: str):
    """`trace/mode/policy[&quals]` -> (trace, mode, policy, quals)."""
    base, _, quals = key.partition("&")
    trace, mode, policy = base.split("/")
    return trace, mode, policy, quals


def normalize_to_baseline(results: Mapping[str, Dict], metric: str
                          ) -> Dict[str, float]:
    """Per (workload, mode, qualifiers): metric[policy] / metric[baseline].

    Keys are `trace/mode/policy[&quals]`; a cell normalizes against the
    baseline cell with identical trace/mode/qualifiers, so e.g. a 0.5x
    cache-size ips_agc cell divides by the 0.5x cache-size baseline."""
    out = {}
    for key, val in results.items():
        trace, mode, policy, quals = _split_key(key)
        if policy == "baseline":
            continue
        base_key = f"{trace}/{mode}/baseline" + (f"&{quals}" if quals else "")
        base = results.get(base_key)
        if base is None:
            continue
        out[key] = val[metric] / max(base[metric], 1e-12)
    return out


def normalize_points(results: Mapping, metric: str) -> Dict:
    """Normalize each point against its `baseline_point()`. Reference
    cells (policy == declared baseline) are skipped."""
    out = {}
    for point, val in results.items():
        if point.policy == point.baseline or metric not in val:
            continue
        base = results.get(point.baseline_point())
        if base is None or metric not in base:
            continue
        out[point] = val[metric] / max(base[metric], 1e-12)
    return out


def policy_geomeans(results: Mapping, metrics=("mean_write_latency_ms",
                                               "wa_paper")) -> Dict:
    """Geomean of baseline-normalized metrics per (mode, policy) over the
    unqualified headline cells (the paper's summary numbers). Returns
    {(mode, policy): {metric: geomean_ratio, "n": count}}."""
    agg: Dict = {}
    for metric in metrics:
        for point, ratio in normalize_points(results, metric).items():
            if (point.seed, point.repeat, point.cache_frac,
                    point.idle_threshold_ms) != (0, 1, 1.0, None):
                continue
            if point.hostcache is not None:
                continue        # host-tier cells report via hostcache_summary
            agg.setdefault((point.mode, point.policy), {}).setdefault(
                metric, []).append(ratio)
    return {k: {m: geomean(v) for m, v in d.items()}
            | {"n": max(len(v) for v in d.values())}
            for k, d in agg.items()}


def endurance_summary(results: Mapping) -> Dict:
    """Per-(mode, policy) lifetime / wear-leveling columns (DESIGN.md §9)
    over cells that carried endurance metrics:

    * `tbw_ratio` — geomean of the TBW projection normalized against each
      cell's declared baseline (None for reference cells);
    * `eol_ratio` — likewise for the end-of-life step, over cell pairs
      where BOTH sides reached EOL inside the trace (an `eol_op` of -1
      means the budget was never exhausted — not comparable as a ratio);
    * `cycle_skew` / `eff_cycles_max` — raw means (max/mean bucket-cycle
      skew: wear-leveling quality; worst-block cycles: lifetime driver);
    * `eol_frac` — fraction of cells whose worst bucket hit the cycle
      budget inside the trace.
    """
    tbw = normalize_points(results, "tbw_proj_gb")
    agg: Dict = {}
    for point, val in results.items():
        if "tbw_proj_gb" not in val:
            continue
        d = agg.setdefault((point.mode, point.policy),
                           {"tbw": [], "eol": [], "skew": [], "cyc": [],
                            "eol_hit": [], "is_ref": True})
        if point.policy != point.baseline:
            d["is_ref"] = False         # normalizes against someone else
        if point in tbw:
            d["tbw"].append(tbw[point])
            base = results[point.baseline_point()]
            if val["eol_op"] >= 0 and base.get("eol_op", -1) >= 0:
                d["eol"].append(val["eol_op"] / base["eol_op"])
        d["skew"].append(val["cycle_skew"])
        d["cyc"].append(val["eff_cycles_max"])
        d["eol_hit"].append(val["eol_op"] >= 0)
    return {k: {"tbw_ratio": geomean(d["tbw"]) if d["tbw"] else None,
                "eol_ratio": geomean(d["eol"]) if d["eol"] else None,
                "cycle_skew": float(np.mean(d["skew"])),
                "eff_cycles_max": float(np.mean(d["cyc"])),
                "eol_frac": float(np.mean(d["eol_hit"])),
                "is_ref": d["is_ref"],
                "n": len(d["skew"])}
            for k, d in agg.items()}


def hostcache_summary(results: Mapping) -> Dict:
    """Per-(mode, policy, host-cache tag) host-tier columns over cells
    that carried a host cache: `host_hit_rate` and `host_dev_write_frac`
    (means over cells), and `lat_vs_off` / `wa_vs_off`, the geomean of
    the cell's latency / paper WAF against the same trace/mode/policy
    cell with `hostcache=None` — the host tier's value end to end."""
    agg: Dict = {}
    for point, val in results.items():
        if point.hostcache is None or "host_hit_rate" not in val:
            continue
        off = results.get(replace(point, hostcache=None))
        d = agg.setdefault((point.mode, point.policy, point.hostcache.tag),
                           {"hit": [], "devw": [], "lat": [], "wa": []})
        d["hit"].append(val["host_hit_rate"])
        d["devw"].append(val["host_dev_write_frac"])
        if off is not None:
            d["lat"].append(val["mean_write_latency_ms"]
                            / max(off["mean_write_latency_ms"], 1e-12))
            d["wa"].append(val["wa_paper"] / max(off["wa_paper"], 1e-12))
    return {k: {"host_hit_rate": float(np.mean(d["hit"])),
                "host_dev_write_frac": float(np.mean(d["devw"])),
                "lat_vs_off": geomean(d["lat"]) if d["lat"] else None,
                "wa_vs_off": geomean(d["wa"]) if d["wa"] else None,
                "n": len(d["hit"])}
            for k, d in agg.items()}


def sensitivity_deltas(results: Mapping, center: str = "ips",
                       metrics=("mean_write_latency_ms", "wa_paper")
                       ) -> Dict:
    """Per-axis deltas around `center` (the `sensitivity` grid's report):
    for every policy in `results` differing from the center's composition
    on exactly one axis, the geomean of its center-normalized metrics per
    (axis, policy, mode). The axis attribution is recomputed from the
    registry, so the table stays honest if compositions change."""
    from repro_torch.core.ssd.policies.registry import get_spec
    cspec = get_spec(center)
    axes = ("allocation", "trigger", "mechanism", "idle")
    agg: Dict = {}
    for metric in metrics:
        for point, ratio in normalize_points(results, metric).items():
            if point.baseline != center:
                continue
            spec = get_spec(point.policy)
            diff = [a for a in axes
                    if getattr(spec, a) != getattr(cspec, a)]
            if len(diff) != 1:
                continue
            key = (diff[0], f"{getattr(cspec, diff[0])}->"
                   f"{getattr(spec, diff[0])}", point.policy, point.mode)
            agg.setdefault(key, {}).setdefault(metric, []).append(ratio)
    return {k: {m: geomean(v) for m, v in d.items()}
            | {"n": max(len(v) for v in d.values())}
            for k, d in agg.items()}


def bootstrap_ci(values, *, n_boot: int = 1000, alpha: float = 0.05,
                 seed: int = 0):
    """Percentile-bootstrap CI for the geomean of `values`.

    Resamples the per-cell ratios with replacement; returns (lo, hi) at
    the (alpha/2, 1-alpha/2) quantiles. Deterministic (fixed RNG seed) so
    BENCH_*.json artifacts are reproducible run-to-run."""
    vals = np.maximum(np.asarray(list(values), np.float64), 1e-12)
    if vals.size == 0:
        return float("nan"), float("nan")
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, vals.size, (n_boot, vals.size))
    gms = np.exp(np.log(vals)[idx].mean(axis=1))
    lo, hi = np.quantile(gms, [alpha / 2, 1 - alpha / 2])
    return float(lo), float(hi)


def policy_geomeans_ci(results: Mapping,
                       metrics=("mean_write_latency_ms", "wa_paper"), *,
                       n_boot: int = 1000, alpha: float = 0.05) -> Dict:
    """Seed-pooled geomeans with bootstrap CIs (ROADMAP seed/variance
    item). Unlike `policy_geomeans` (headline seed-0 cells only), this
    pools every seed at default repeat/cache/idle and resamples the
    per-(trace, seed) baseline-normalized ratios, so `--seeds 0,1,2,...`
    sweeps report how tight the normalized summary actually is.

    Returns {(mode, policy): {metric: {"geomean", "lo", "hi"},
                              "n": cells, "n_seeds": distinct seeds}}."""
    agg: Dict = {}
    seeds: Dict = {}
    for metric in metrics:
        norm = normalize_points(results, metric)
        for point, ratio in norm.items():
            if (point.repeat, point.cache_frac,
                    point.idle_threshold_ms) != (1, 1.0, None):
                continue
            if point.hostcache is not None:
                continue        # host-tier cells report via hostcache_summary
            key = (point.mode, point.policy)
            agg.setdefault(key, {}).setdefault(metric, []).append(ratio)
            seeds.setdefault(key, set()).add(point.seed)
    out: Dict = {}
    for key, d in agg.items():
        out[key] = {}
        for metric, vals in d.items():
            lo, hi = bootstrap_ci(vals, n_boot=n_boot, alpha=alpha)
            out[key][metric] = {"geomean": geomean(vals),
                                "lo": lo, "hi": hi}
        out[key]["n"] = max(len(v) for v in d.values())
        out[key]["n_seeds"] = len(seeds[key])
    return out


def search_rounds_table(rounds) -> str:
    """Successive-halving round summary (the search artifact's `rounds`):
    survivors, batched cells and groups, new kernel specialisations and
    wall seconds per round."""
    lines = [f"{'round':>5} {'cands':>6}{'keep':>6}{'cells':>7}"
             f"{'groups':>7}{'compiles':>9}{'wall_s':>8}  best"]
    for r in rounds:
        lines.append(
            f"{r['round']:>5} {r['candidates']:>6}{r['survivors']:>6}"
            f"{r['cells']:>7}{r['groups']:>7}{r['compiles']:>9}"
            f"{r['wall_s']:>8.1f}  {r['best']} ({r['best_lat']:.3f})")
    return "\n".join(lines)


def search_front_table(front) -> str:
    """Pareto-front table (the search artifact's `front`): each
    candidate's objectives as ratios vs its declared baseline (lat/waf
    lower is better, tbw higher)."""
    lines = [f"{'candidate':<34}{'lat':>8}{'waf':>8}{'tbw':>8}{'n':>4}"]
    for f in front:
        tbw = f.get("tbw")
        lines.append(f"{f['label']:<34}{f['lat']:>8.3f}{f['waf']:>8.3f}"
                     f"{(f'{tbw:.3f}' if tbw is not None else 'n/a'):>8}"
                     f"{f['n']:>4}")
    return "\n".join(lines)


def throughput_table(group_timings) -> str:
    """Per-group throughput: scanned vs padded length, packed flag, the
    kernel's time and ops/s over the padded length."""
    lines = [f"{'group':<34}{'cells':>6}{'t_len':>9}{'t_scan':>9}"
             f"{'packed':>7}{'kernel_ms':>11}{'Mops/s':>9}"]
    for g in group_timings:
        kms = g.get("kernel_ms")
        lines.append(
            f"{g['composition'] + '/' + g['mode']:<34}{g['cells']:>6}"
            f"{g['t_len']:>9}{g['t_scan']:>9}{str(bool(g['packed'])):>7}"
            f"{'-' if kms is None else f'{kms:.3f}':>11}"
            f"{g['ops_per_s'] / 1e6:>9.3f}")
    return "\n".join(lines)
