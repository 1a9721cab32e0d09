"""Timeline analysis: per-window series and cliff detection (numpy-only).

Copy of the reference package's `telemetry/timeline.py`. It consumes the
`WindowedTimeline` the port's probe (`telemetry.probe`) leaves in
`SimState.timeline` and turns it into the per-window series the paper's
time-resolved phenomena are read from — windowed mean/p50/p99 write
latency, SLC-cache occupancy and free-cache fraction, windowed write
amplification from the counter deltas, idle consumption, and (when
endurance was on) wear drift — plus the cliff detector: the SLC-cache
performance cliff (PAPER.md Figs. 2-4) is the largest *sustained* jump
of windowed write latency over the cell's own steady-state level,
reported with time-to-cliff and a post-cliff recovery slope.

Percentiles are recovered from the probe's log-bucket histogram by
geometric interpolation inside the straddling bucket — resolution is one
half-octave bucket (LAT_EDGES_MS), plenty for cliff-scale effects (the
cliff is a >=2x jump by definition).

numpy only at import: the counter-index map (`CTR`) and the bucket edges
come in lazily, so cliff detection is unit-testable on plain arrays.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["timeline_to_numpy", "cell_timeline", "series", "percentile",
           "detect_cliff", "CLIFF_RATIO", "CLIFF_SUSTAIN"]

CLIFF_RATIO = 2.0       # sustained latency ratio vs steady state
CLIFF_SUSTAIN = 2       # consecutive windows the jump must hold


def timeline_to_numpy(tl) -> Dict[str, np.ndarray]:
    """WindowedTimeline (single-cell or fleet-stacked, numpy or torch
    leaves) -> plain numpy dict of named series. The optional `wear_peak` field is omitted when
    statically absent. Fleet-stacked timelines keep their leading cell
    axis; slice one cell out with `cell_timeline`."""
    return {k: _as_numpy(v) for k, v in zip(type(tl)._fields, tl)
            if v is not None}


def _as_numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):                 # a torch tensor
        return v.detach().cpu().numpy()
    return np.asarray(v)


def cell_timeline(tl_np: Dict[str, np.ndarray], i: int
                  ) -> Dict[str, np.ndarray]:
    """Slice cell `i` out of a fleet-stacked numpy timeline dict."""
    return {k: v[i] for k, v in tl_np.items()}


def percentile(hist: np.ndarray, edges: Sequence[float], q: float
               ) -> np.ndarray:
    """Per-window q-th percentile (q in [0,1]) from log-bucket histograms.

    hist: (W, B) counts with B == len(edges) + 1 (bucket b covers
    [edges[b-1], edges[b])). Returns (W,) estimates via geometric
    interpolation inside the straddling bucket; NaN for empty windows.
    The open-ended outer buckets clamp to their finite edge."""
    hist = np.asarray(hist, np.float64)
    edges = np.asarray(edges, np.float64)
    total = hist.sum(axis=1)
    cum = np.cumsum(hist, axis=1)
    target = q * total
    # first bucket whose cumulative count reaches the target
    b = np.argmax(cum >= target[:, None], axis=1)
    lo = np.where(b > 0, edges[np.maximum(b - 1, 0)], edges[0] / 2.0)
    hi = np.where(b < edges.size, edges[np.minimum(b, edges.size - 1)],
                  edges[-1] * 2.0)
    prev = np.take_along_axis(
        np.concatenate([np.zeros((hist.shape[0], 1)), cum], axis=1),
        b[:, None], axis=1)[:, 0]
    in_bucket = np.take_along_axis(hist, b[:, None], axis=1)[:, 0]
    frac = np.divide(target - prev, in_bucket,
                     out=np.zeros_like(target), where=in_bucket > 0)
    est = lo * (hi / lo) ** np.clip(frac, 0.0, 1.0)
    return np.where(total > 0, est, np.nan)


def _win_list(arr, ndigits: int = 5) -> List:
    """JSON-ready per-window list: floats rounded, NaN -> None."""
    out = []
    for v in np.asarray(arr, np.float64):
        out.append(None if not np.isfinite(v) else round(float(v), ndigits))
    return out


def series(tl_cell: Dict[str, np.ndarray], *,
           cliff_ratio: float = CLIFF_RATIO,
           cliff_sustain: int = CLIFF_SUSTAIN) -> Dict:
    """One cell's raw timeline accumulators -> JSON-ready per-window
    series + detected cliff (the reference's schema).

    Trailing all-pad windows are trimmed; windowed WAF follows the
    paper's definition (1 + (mig + rp_trad + agc_waste)/host) on the
    window's own counter deltas, None where the window hosted no
    writes."""
    from repro_torch.core.ssd.policies.state import CTR    # lazy: torch
    from repro_torch.telemetry.probe import LAT_EDGES_MS

    ops = np.asarray(tl_cell["ops"], np.float64)
    n_win = int(np.max(np.nonzero(ops > 0)[0])) + 1 if np.any(ops > 0) else 0
    sl = slice(0, n_win)
    writes = np.asarray(tl_cell["writes"], np.float64)[sl]
    lat_sum = np.asarray(tl_cell["lat_sum"], np.float64)[sl]
    hist = np.asarray(tl_cell["lat_hist"], np.float64)[sl]
    occ = np.asarray(tl_cell["occ_sum"], np.float64)[sl]
    ctr = np.asarray(tl_cell["ctr"], np.float64)[sl]
    ops = ops[sl]

    with np.errstate(invalid="ignore", divide="ignore"):
        lat_mean = np.where(writes > 0, lat_sum / np.maximum(writes, 1),
                            np.nan)
        occ_mean = np.where(ops > 0, occ / np.maximum(ops, 1), np.nan)
    host = ctr[:, CTR["host_w"]]
    extra = (ctr[:, CTR["mig_w"]] + ctr[:, CTR["rp_trad"]]
             + ctr[:, CTR["agc_waste"]])
    waf = np.where(host > 0, 1.0 + extra / np.maximum(host, 1), np.nan)

    window_ops = int(np.asarray(tl_cell["window_ops"]))
    t_end = np.asarray(tl_cell["t_last"], np.float64)[sl]
    cliff = detect_cliff(lat_mean, writes, window_ops=window_ops,
                         t_end=t_end, min_ratio=cliff_ratio,
                         sustain=cliff_sustain)
    out = {
        "window_ops": window_ops,
        "n_windows": n_win,
        "ops": _win_list(ops, 0),
        "writes": _win_list(writes, 0),
        "lat_mean_ms": _win_list(lat_mean),
        "lat_p50_ms": _win_list(percentile(hist, LAT_EDGES_MS, 0.50)),
        "lat_p99_ms": _win_list(percentile(hist, LAT_EDGES_MS, 0.99)),
        "occ_frac": _win_list(occ_mean),
        "free_frac": _win_list(1.0 - occ_mean),
        "waf": _win_list(waf),
        "idle_ms": _win_list(np.asarray(tl_cell["idle_ms"],
                                        np.float64)[sl], 3),
        "t_end_ms": _win_list(t_end, 3),
        "host_w": _win_list(host, 0),
        "slc_w": _win_list(ctr[:, CTR["slc_w"]], 0),
        "tlc_w": _win_list(ctr[:, CTR["tlc_w"]], 0),
        "rp_w": _win_list(ctr[:, CTR["rp_host"]] + ctr[:, CTR["rp_agc"]]
                          + ctr[:, CTR["rp_trad"]], 0),
        "mig_w": _win_list(ctr[:, CTR["mig_w"]], 0),
        "erases": _win_list(ctr[:, CTR["erases"]], 0),
        "cliff": cliff,
    }
    if "wear_peak" in tl_cell:
        out["wear_peak"] = _win_list(
            np.asarray(tl_cell["wear_peak"], np.float64)[sl], 3)
    return out


def detect_cliff(lat: np.ndarray, writes: np.ndarray, *,
                 window_ops: Optional[int] = None,
                 t_end: Optional[np.ndarray] = None,
                 min_ratio: float = CLIFF_RATIO,
                 sustain: int = CLIFF_SUSTAIN) -> Dict:
    """Find the performance cliff in a windowed latency series.

    The cliff is the onset of the largest *sustained* jump: a run of
    >= `sustain` consecutive write-carrying windows whose mean latency
    is >= `min_ratio` x the cell's steady-state level. Steady state is
    the cell's own cheap-operation floor — the median of the earliest
    quarter of write-carrying windows, clamped from above by the 25th
    percentile of all of them, so a cliff arbitrarily early in the trace
    cannot inflate its own reference level.

    Returns {"detected", "window", "ratio", "steady_lat_ms",
    "time_to_cliff_ops", "time_to_cliff_ms", "recovery_slope"}; the
    recovery slope is the least-squares slope of the latency *ratio*
    per window from the cliff onward (negative == recovering toward
    steady state). time_to_cliff_ms needs `t_end` (arrival-time replay —
    the daily mode; in closed-loop bursty runs only the op-indexed
    distance is meaningful)."""
    lat = np.asarray(lat, np.float64)
    writes = np.asarray(writes, np.float64)
    none = {"detected": False, "window": None, "ratio": None,
            "steady_lat_ms": None, "time_to_cliff_ops": None,
            "time_to_cliff_ms": None, "recovery_slope": None}
    valid = np.where((writes > 0) & np.isfinite(lat))[0]
    if valid.size < max(sustain + 1, 3):
        return none
    lat_v = lat[valid]
    head = lat_v[:max(2, valid.size // 4)]
    steady = float(min(np.median(head), np.percentile(lat_v, 25)))
    if steady <= 0:
        return none
    ratio = lat_v / steady

    # sustained runs of >= min_ratio windows (indices into `valid`)
    runs, start = [], None
    for i, r in enumerate(ratio):
        if r >= min_ratio and start is None:
            start = i
        elif r < min_ratio and start is not None:
            runs.append((start, i))
            start = None
    if start is not None:
        runs.append((start, ratio.size))
    runs = [(a, b) for a, b in runs if b - a >= sustain]
    if not runs:
        return {**none, "steady_lat_ms": round(steady, 5)}
    a, b = max(runs, key=lambda ab: float(np.mean(ratio[ab[0]:ab[1]])))
    onset = int(valid[a])

    slope = None
    post = ratio[a:]
    if post.size >= 3:
        slope = float(np.polyfit(np.arange(post.size), post, 1)[0])
    return {
        "detected": True,
        "window": onset,
        "ratio": round(float(np.mean(ratio[a:b])), 4),
        "steady_lat_ms": round(steady, 5),
        "time_to_cliff_ops": (onset * int(window_ops)
                              if window_ops else None),
        "time_to_cliff_ms": (round(float(t_end[max(onset - 1, 0)]), 3)
                             if t_end is not None else None),
        "recovery_slope": None if slope is None else round(slope, 5),
    }
