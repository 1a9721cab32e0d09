"""Statistical trace synthesizer: MSR-Cambridge-like workloads.

The MSR Cambridge server traces (Narayanan et al., EuroSys'09) are not
redistributable in this offline container, so each of the 11 traces the
paper evaluates (Fig. 5/9-12) is *synthesized* from published per-trace
statistics: write ratio, request size, sequentiality, working-set size,
overwrite skew, and idle structure. Absolute values therefore differ from
the paper; the normalized (vs-baseline) latency/WA behaviour — which is
what we validate — is driven by cache-to-writeset ratios and idle structure,
which are preserved. Declared in DESIGN.md §2.

A numpy copy of the reference package's `workloads/synth.py`,
`synthesize_stats` and `synthesize_phases` included (the scenario
generators and `stats.synthesize_like` call them): the 11 MSR traces
compile to tensors
identical to the reference's (tests/test_torch_ssd.py), so the
port's sweep reproduces the committed `BENCH_sweep_paper.json`.

Two access modes (paper §III):
  * bursty — the trace volume rewritten as back-to-back sequential 32 KB
    writes, arrival times collapsed (no idle at all).
  * daily  — original arrival process with explicit idle gaps.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.workloads import ir

__all__ = ["TraceStats", "TRACES", "TRACE_NAMES", "synthesize",
           "synthesize_stats", "synthesize_phases", "synth_trace",
           "make_trace"]


@dataclass(frozen=True)
class TraceStats:
    n_requests: int
    write_ratio: float
    mean_req_pages: float       # 4 KB pages per request
    seq_prob: float
    working_set_frac: float     # of total logical pages
    skew: float                 # overwrite skew (higher = hotter hot set)
    interarrival_ms: float
    idle_every: int             # insert an idle gap every N requests
    idle_ms: float


# Qualitative parameters per MSR trace (synthetic; see module docstring).
# Idle structure is calibrated against the DEFAULT_SCALE=128 drive (64 SLC
# pages/plane => full reclamation ~224 ms/plane, full AGC generation
# ~393 ms/plane): the writes accumulated between idle gaps are ~1x the SLC
# cache for most traces (the paper's steady daily regime), while stg_0 and
# wdev_0 deliberately starve idle (3.1x / 1.8x cache per interval) — they
# are the paper's two IPS/agc latency exceptions (Fig. 11).
# Volumes are 4.7x-13x the SLC cache (bursty cliff + reprogram cycling are
# exercised); daily idle supply is ~70% of reclamation demand for most
# traces (baseline reclaims the rest under pressure, conflicting with host
# writes — the paper's Fig. 9b regime), except hm_1/proj_4 (tiny writes,
# cache never pressured) and stg_0/wdev_0 (idle-starved + high arrival
# rate: the paper's IPS/agc latency exceptions, Fig. 11).
TRACES: Dict[str, TraceStats] = {
    "hm_0":   TraceStats(30000, 0.64, 2.0, 0.45, 0.020, 1.2, 0.5, 10000, 250.0),
    "hm_1":   TraceStats(12000, 0.05, 2.0, 0.50, 0.010, 1.1, 0.8, 3000, 300.0),
    "mds_0":  TraceStats(24000, 0.88, 3.0, 0.40, 0.030, 1.3, 0.5, 8000, 400.0),
    "prn_0":  TraceStats(26000, 0.89, 4.0, 0.55, 0.050, 1.2, 0.5, 9000, 590.0),
    "proj_0": TraceStats(30000, 0.88, 4.0, 0.60, 0.060, 1.1, 0.4, 10000, 670.0),
    "proj_4": TraceStats(12000, 0.07, 3.0, 0.60, 0.015, 1.1, 0.8, 3000, 300.0),
    "prxy_0": TraceStats(36000, 0.97, 1.2, 0.20, 0.004, 1.8, 0.4, 9000, 200.0),
    "src1_2": TraceStats(28000, 0.75, 4.0, 0.55, 0.050, 1.2, 0.5, 9000, 535.0),
    "stg_0":  TraceStats(26000, 0.85, 3.0, 0.50, 0.040, 1.2, 0.125, 50000, 0.0),
    "usr_0":  TraceStats(26000, 0.60, 3.0, 0.45, 0.035, 1.3, 0.6, 8500, 300.0),
    "wdev_0": TraceStats(24000, 0.80, 2.0, 0.35, 0.015, 1.5, 0.11, 50000, 0.0),
}

TRACE_NAMES = tuple(TRACES)


def _zipf_like(rng, n, size, skew):
    """Power-law page choice over [0, n): low indexes are hot."""
    u = rng.random(size)
    idx = np.floor(n * u ** skew).astype(np.int64)
    return np.clip(idx, 0, n - 1)


def synthesize_stats(st: TraceStats, total_logical_pages: int,
                     seed: int = 0, capacity_pages: int | None = None,
                     label: str = "stats") -> Dict:
    """Request-level synthetic trace from an arbitrary `TraceStats`.

    Working sets are a fraction of the *drive capacity* (capacity_pages),
    independent of the compressed logical address window used to bound the
    simulator's page-table state. `label` seeds the RNG stream (together
    with `seed`), so distinct workloads with identical stats decorrelate."""
    # stable across processes (unlike hash(), which PYTHONHASHSEED
    # randomizes): BENCH_*.json numbers must be reproducible run-to-run
    rng = np.random.default_rng(
        zlib.crc32(f"{label}/{seed}".encode()) % (2 ** 31))
    n = st.n_requests
    cap = capacity_pages or total_logical_pages
    ws = max(int(cap * st.working_set_frac), 1024)
    ws = min(ws, int(total_logical_pages * 0.9))
    base = rng.integers(0, max(total_logical_pages - ws, 1))

    is_write = rng.random(n) < st.write_ratio
    sizes = np.clip(rng.poisson(st.mean_req_pages, n), 1, 16)
    seq = rng.random(n) < st.seq_prob
    rand_targets = base + _zipf_like(rng, ws, n, st.skew)

    lba = np.empty(n, np.int64)
    cursor = base
    for i in range(n):
        if seq[i]:
            lba[i] = cursor
        else:
            lba[i] = rand_targets[i]
        cursor = (lba[i] + sizes[i]) % (total_logical_pages - 16)

    gaps = rng.exponential(st.interarrival_ms, n)
    idle_mask = (np.arange(n) % st.idle_every) == st.idle_every - 1
    gaps = gaps + idle_mask * st.idle_ms
    arrival = np.cumsum(gaps) - gaps[0]
    return {"arrival_ms": arrival, "lba": lba, "pages": sizes,
            "is_write": is_write}


def synthesize(name: str, total_logical_pages: int, seed: int = 0,
               capacity_pages: int | None = None) -> Dict:
    """Request-level synthetic trace for one named MSR-like workload."""
    return synthesize_stats(TRACES[name], total_logical_pages, seed,
                            capacity_pages, label=name)


def _repeat_requests(req: Dict, repeat: int) -> Dict:
    """Tile a request-level trace back-to-back (paper Fig. 12a: "total
    write size is varied ... by running workload repeatedly")."""
    span = (req["arrival_ms"][-1] + 1.0) if len(req["arrival_ms"]) else 1.0
    return {
        "arrival_ms": np.concatenate(
            [req["arrival_ms"] + i * span for i in range(repeat)]),
        "lba": np.tile(req["lba"], repeat),
        "pages": np.tile(req["pages"], repeat),
        "is_write": np.tile(req["is_write"], repeat),
    }


def synthesize_phases(stats_seq, total_logical_pages: int, seed: int = 0,
                      capacity_pages: int | None = None,
                      label: str = "phases") -> Dict:
    """Concatenate per-phase syntheses into one request-level trace.

    Each `TraceStats` in `stats_seq` synthesizes one phase (RNG stream
    `{label}.{i}`, so phases decorrelate even with identical stats) and
    phases tile along the arrival axis with cumulative span offsets —
    the `_repeat_requests` scheme, but with the stats free to drift
    between phases. Pair with `stats.fit_stats(trace, windows=N)`: the
    fitted phase sequence replays a non-stationary workload's drift
    (e.g. the diurnal write-burst/idle alternation the `flush_burst`
    scenario is built from)."""
    stats_seq = list(stats_seq)
    if not stats_seq:
        raise ValueError("synthesize_phases wants at least one TraceStats")
    parts, offset = [], 0.0
    for i, st in enumerate(stats_seq):
        req = synthesize_stats(st, total_logical_pages, seed,
                               capacity_pages, label=f"{label}.{i}")
        arrival = req["arrival_ms"] + offset
        if len(arrival):
            offset = float(arrival[-1]) + 1.0
        parts.append({**req, "arrival_ms": arrival})
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def synth_trace(name: str, total_logical_pages: int, mode: str = "daily",
                seed: int = 0, capacity_pages: int | None = None,
                repeat: int = 1) -> ir.Trace:
    """Named MSR-like workload as a Trace IR record.

    Repeat happens at *request* level before page expansion — exactly the
    seed pipeline — so compiled tensors stay bit-identical to it."""
    req = synthesize(name, total_logical_pages, seed, capacity_pages)
    if repeat > 1:
        req = _repeat_requests(req, repeat)
    src = f"synth:{name}/seed={seed}" + (f"/rep={repeat}" if repeat > 1
                                         else "")
    return ir.trace_from_requests(req, mode, total_logical_pages, src)


def make_trace(name: str, total_logical_pages: int, mode: str = "daily",
               seed: int = 0, capacity_pages: int | None = None,
               repeat: int = 1) -> Dict:
    """Compiled (padded) op tensors for one named MSR-like workload.

    Padding goes through `ir.pad_ops`, whose identical-tail contract is
    load-bearing for the pad-tail trimming and the fixed-point replay
    (`sim.replay_pads`, and the `ssd_step` kernel's in-kernel replay)."""
    return synth_trace(name, total_logical_pages, mode, seed,
                       capacity_pages, repeat).compile()
