"""Reporting: baseline normalization + geomean aggregation — port of the
part of the reference package's `sweep/report.py` the paper sweep uses.

The paper reports every policy metric normalized per (workload, mode) to
the Turbo-Write baseline; the geometric mean aggregates the ratios.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

__all__ = ["geomean", "normalize_points", "policy_geomeans",
           "throughput_table"]


def geomean(values) -> float:
    vals = np.asarray(list(values), dtype=np.float64)
    vals = np.maximum(vals, 1e-12)
    return float(np.exp(np.mean(np.log(vals))))


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
            if (point.seed, point.repeat, point.cache_frac) != (0, 1, 1.0):
                continue
            agg.setdefault((point.mode, point.policy), {}).setdefault(
                metric, []).append(ratio)
    return {k: {m: geomean(v) for m, v in d.items()}
            | {"n": max(len(v) for v in d.values())}
            for k, d in agg.items()}


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
