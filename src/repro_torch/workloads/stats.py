"""Stats extractor: fit a `TraceStats` from any Trace.

Port of the reference package's `workloads/stats.py`: a numpy copy.

Closes the loop between real inputs and the synthesizer: any Trace —
parsed from disk, generator output, mixer output — is reduced to the same
summary-statistic vector the MSR synthesizer consumes, and
`synthesize_like` feeds the fit straight back through it. That validates
the synthetic path against real inputs (round-trip tests in
tests/test_workloads.py: stats fitted from a synthesized trace recover the
requested `TraceStats` within tolerance) and gives every non-MSR workload
the per-trace calibration the driver needs (e.g. the AGC waste constant,
which is a function of write ratio and sequentiality — DESIGN.md §2).

Estimators invert the synthesizer's own sampling scheme:

  * request boundaries come from `req_id` edges; write ratio, request
    size and interarrival are direct request-level moments.
  * seq_prob counts requests that continue the previous request's end
    cursor (mod the synthesizer's wrap window).
  * the working set is a robust address-range estimate (1%/99% request-lba
    quantiles), as a fraction of drive capacity.
  * skew inverts the power-law sampler `idx = floor(ws * u^skew)`, whose
    median satisfies `median/ws = 0.5^skew`.
  * idle structure splits request gaps at `IDLE_OUTLIER x` the median gap:
    outliers are idle windows (period + mean excess), the rest is the
    arrival process.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.workloads.ir import Trace
from repro_torch.workloads.synth import TraceStats, synthesize_stats

__all__ = ["fit_stats", "synthesize_like", "request_view"]

IDLE_OUTLIER = 20.0             # gap > 20x median gap => idle window


def request_view(trace: Trace):
    """Collapse page-level ops back to request granularity.

    Returns (arrival_ms, lba, pages, is_write) request-level arrays."""
    if trace.n_ops == 0:
        z = np.zeros(0)
        return z, z.astype(np.int64), z.astype(np.int64), z.astype(bool)
    starts = np.r_[0, np.flatnonzero(np.diff(trace.req_id)) + 1]
    pages = np.diff(np.r_[starts, trace.n_ops])
    return (trace.arrival_ms[starts].astype(np.float64),
            trace.lba[starts].astype(np.int64), pages,
            trace.is_write[starts] == 1)


def fit_stats(trace: Trace, total_logical_pages: int,
              capacity_pages: Optional[int] = None, *,
              windows: Optional[int] = None):
    """Fit the synthesizer's `TraceStats` from any Trace.

    `windows=N` splits the trace into N equal request-count slices and
    fits each independently, returning a tuple of N `TraceStats` — the
    phase-drift view of a non-stationary workload (a diurnal trace's day
    slices fit write-heavy bursty stats, its night slices read-mostly
    idle ones). Feed the sequence to `synth.synthesize_phases` to replay
    the drift as a synthetic twin. `windows=None` (default) fits the
    whole trace as one phase and returns a single `TraceStats`, exactly
    as before."""
    arrival, lba, pages, is_write = request_view(trace)
    if windows is None:
        return _fit_from_requests(arrival, lba, pages, is_write,
                                  total_logical_pages, capacity_pages)
    if windows < 1:
        raise ValueError(f"windows wants a positive count, got {windows}")
    bounds = np.linspace(0, len(arrival), windows + 1).astype(np.int64)
    return tuple(
        _fit_from_requests(arrival[a:b], lba[a:b], pages[a:b],
                           is_write[a:b], total_logical_pages,
                           capacity_pages)
        for a, b in zip(bounds[:-1], bounds[1:]))


def _fit_from_requests(arrival, lba, pages, is_write,
                       total_logical_pages: int,
                       capacity_pages: Optional[int]) -> TraceStats:
    """One-phase estimator over request-level arrays (module docstring)."""
    n = len(arrival)
    if n == 0:
        return TraceStats(0, 0.0, 1.0, 0.0, 0.0, 1.0, 1.0, 1, 0.0)
    cap = capacity_pages or total_logical_pages

    # sequentiality: requests continuing the previous end cursor
    if n > 1:
        cursor = (lba[:-1] + pages[:-1]) % max(total_logical_pages - 16, 1)
        seq_prob = float((lba[1:] == cursor).mean())
    else:
        seq_prob = 0.0

    # working set: robust request-lba range, as a capacity fraction
    lo, hi = np.quantile(lba, [0.01, 0.99])
    ws = max(float(hi - lo), 1.0)
    ws_frac = min(ws / cap, 1.0)

    # skew: median of the power-law sampler idx = floor(ws * u^skew)
    # satisfies (median/ws) = 0.5^skew => skew = log2(ws/median)
    offs = np.clip(lba - lo, 1.0, None)
    med = float(np.median(offs))
    skew = float(np.clip(np.log2(max(ws / med, 1.0 + 1e-9)), 0.25, 8.0))

    # arrival process vs idle structure
    gaps = np.diff(arrival)
    if len(gaps) and gaps.max() > 0:
        med_gap = max(float(np.median(gaps)), 1e-6)
        idle_mask = gaps > IDLE_OUTLIER * med_gap
        busy = gaps[~idle_mask]
        interarrival = float(busy.mean()) if len(busy) else med_gap
        n_idle = int(idle_mask.sum())
        if n_idle:
            # period from inter-event spacing where possible: unbiased even
            # when the period does not divide the request count
            idle_idx = np.flatnonzero(idle_mask)
            if len(idle_idx) >= 2:
                idle_every = max(int(np.median(np.diff(idle_idx))), 2)
            else:
                idle_every = max(int(round(n / n_idle)), 2)
            idle_ms = float((gaps[idle_mask] - interarrival).mean())
        else:
            idle_every, idle_ms = 2 * n, 0.0
    else:
        interarrival, idle_every, idle_ms = 0.0, 2 * n, 0.0

    return TraceStats(
        n_requests=n,
        write_ratio=float(is_write.mean()),
        mean_req_pages=float(pages.mean()),
        seq_prob=seq_prob,
        working_set_frac=ws_frac,
        skew=skew,
        interarrival_ms=interarrival,
        idle_every=idle_every,
        idle_ms=idle_ms,
    )


def synthesize_like(trace: Trace, total_logical_pages: int,
                    capacity_pages: Optional[int] = None, seed: int = 0,
                    label: str = "fitted"):
    """Round-trip: fit stats from `trace` and re-synthesize through the
    MSR machinery — a synthetic twin of any real input."""
    st = fit_stats(trace, total_logical_pages, capacity_pages)
    from repro_torch.workloads import ir
    req = synthesize_stats(st, total_logical_pages, seed, capacity_pages,
                           label=label)
    return ir.trace_from_requests(req, "daily", total_logical_pages,
                                  f"synth_like:{trace.source}")
