"""The telemetry probe on torch tensors: windowed timelines of the
simulator's per-op recurrence.

Port of the reference package's `telemetry/probe.py`. There the probe is
a trailing `SimState` carry that rides the `lax.scan`: each op emits a
narrow row (occupancy fraction, idle claim, and — with wear — the
serviced plane's wear cycles) beside the step's cumulative counter
vector, and `windowed*` reduce the rows to per-window series after the
scan. Here the recurrence runs in the `ssd_step` kernel (or its plain
version), which emits the same observation-only values straight into
`ProbeRows`:

* `head` (..., t_scan, 2): per scanned op `occ_pages` (the running
  float32 sum of the op's change in cache-resident pages) and
  `max(idle_claim, 0)`; `from_rows` turns `occ_pages` into the
  reference's occupancy fraction `occ_pages / max(cap_pages, 1)`, 0 on
  pads (the same IEEE division, off the kernel's stepping thread);
* `snap` (..., W, C): the cumulative counter vector at every window
  boundary op `min((w+1)*wo - 1, t_len - 1)`, those in the replayed pad
  tail included (the tail's fixed point stands in for every later
  boundary);
* `wear_peak` (..., W): with wear, the serviced plane's effective P/E
  cycles at each boundary op; None otherwise.

`_assemble` turns those into a `WindowedTimeline`, exactly as the
reference's does: ops/writes/latency sums, last arrivals and the
write-latency histogram come from the latency output and the op inputs,
the counter series from boundary differences (telescoping: the windows
sum to the final counters exactly). Every function takes leading batch
dimensions (a fleet's cells).

Summation order. The reference's three float window sums (`lat_sum`,
`occ_sum`, `idle_ms`) are `jnp.pad(x).reshape(W, wo).sum(axis=1)` as
XLA compiles them on the CPU: each window's ops in runs of 32 summed
left to right, the run sums again in runs of 32, and so on, each level
left to right (found on inputs that tell the orders apart,
tests/test_torch_telemetry.py pins it). `window_sum` reproduces that
order with float32 elementwise adds, so the port's sums are the
reference's bit for bit whenever `wo % 32 == 0`; for other window sizes
the reference's order is not known and the port's agree to rounding.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["TimelineState", "WindowedTimeline", "ProbeRows",
           "LAT_EDGES_MS", "N_LAT_BUCKETS", "init_timeline", "accumulate",
           "windowed", "windowed_prefix", "windowed_segments",
           "from_rows", "cap_pages", "tail_windows", "bounds", "n_windows",
           "window_sum", "ROW_OCC", "ROW_IDLE", "ROW_WEAR", "SUM_RUN"]

# static histogram bucket edges (ms), quarter-decade-ish log spacing from
# below the cheapest write (SLC program 0.5 ms) to far past any realistic
# queueing delay; bucket b covers [edges[b-1], edges[b]) — the
# reference's own expression, so the float32 edges are bit-equal
LAT_EDGES_MS = np.array([0.25 * 2.0 ** (k / 2.0) for k in range(28)],
                        dtype=np.float32)          # 0.25 .. ~2896 ms
N_LAT_BUCKETS = LAT_EDGES_MS.size + 1

# emitted-row head layout: occupancy fraction, idle claim, then — only
# under endurance tracking — the serviced plane's wear cycles
ROW_OCC, ROW_IDLE, ROW_WEAR = 0, 1, 2

SUM_RUN = 32        # the run length of the reference's window sums


class TimelineState(NamedTuple):
    """The probe's carry in the plain version's per-op executor: the one
    accumulator that needs sequential integration."""
    window_ops: torch.Tensor    # () i32 — ops per window
    occ_pages: torch.Tensor     # () f32 — running pages resident in the
    #                             SLC cache (basic + traditional regions)


class WindowedTimeline(NamedTuple):
    """Per-window series. Shapes (..., W) / (..., W, B) / (..., W, C)."""
    window_ops: torch.Tensor    # (...) i32 — ops per window
    ops: torch.Tensor           # (..., W) f32 — non-pad ops per window
    writes: torch.Tensor        # (..., W) f32 — host writes per window
    lat_sum: torch.Tensor       # (..., W) f32 — sum of write latencies
    lat_hist: torch.Tensor      # (..., W, B) f32 — write-latency histogram
    occ_sum: torch.Tensor       # (..., W) f32 — sum of occupancy fracs
    idle_ms: torch.Tensor       # (..., W) f32 — idle budget claimed
    t_last: torch.Tensor        # (..., W) f32 — last arrival time seen
    ctr: torch.Tensor           # (..., W, C) f32 — per-window counter deltas
    wear_peak: Optional[torch.Tensor] = None   # (..., W) f32 — the
    #                             serviced plane's peak effective cycles;
    #                             None unless endurance tracking is on


class ProbeRows(NamedTuple):
    """What the `ssd_step` kernel (or its plain version) emits with the
    probe on, per cell: see the module docstring."""
    head: torch.Tensor          # (..., t_scan, 2) f32 — occ_pages, idle
    snap: torch.Tensor          # (..., W, C) f32
    wear_peak: Optional[torch.Tensor] = None   # (..., W) f32


def n_windows(t_len: int, window_ops: int) -> int:
    """Window count for a padded trace length."""
    if window_ops <= 0:
        raise ValueError(f"window_ops must be positive, got {window_ops}")
    return max(1, math.ceil(t_len / window_ops))


def bounds(t_len: int, window_ops: int) -> list:
    """Each window's boundary op: min((w+1)*wo - 1, t_len - 1)."""
    wo = int(window_ops)
    return [min((w + 1) * wo - 1, t_len - 1)
            for w in range(n_windows(t_len, wo))]


def cap_pages(params, n_planes: int) -> torch.Tensor:
    """A cell's (or a fleet's (C,)) total cache capacity in pages, as the
    reference's probe forms it: (basic + boost + traditional) per plane,
    as float32, times the planes."""
    return ((params.cap_basic + params.cap_boost + params.cap_trad)
            .to(torch.float32) * n_planes)


def init_timeline(window_ops: int, device="cuda") -> TimelineState:
    """Fresh probe carry for `window_ops`-sized windows."""
    return TimelineState(
        window_ops=torch.tensor(int(window_ops), dtype=torch.int32,
                                device=device),
        occ_pages=torch.zeros((), dtype=torch.float32, device=device))


def accumulate(tl: TimelineState, *, is_pad, counters, occ_delta,
               cap_pages, idle_claim, wear=None):
    """One op's contribution: returns (updated carry, (row, counters)).

    Observation only — it reads what the step computed. `is_pad`: pad
    predicate; `counters`: the step's new (cumulative) counter vector;
    `occ_delta`: the op's change in cache-resident pages on the serviced
    plane; `cap_pages`: total cache capacity in pages (all planes);
    `idle_claim`: the device idle budget the serviced plane consumed;
    `wear`: the serviced plane's effective P/E cycles (appends a head
    column)."""
    occ_pages = tl.occ_pages + occ_delta
    occ_frac = occ_pages / torch.clamp_min(cap_pages, 1.0)
    cols = [torch.where(is_pad, 0.0, occ_frac),
            torch.clamp_min(idle_claim, 0.0)]
    if wear is not None:
        cols.append(wear)
    new_tl = TimelineState(window_ops=tl.window_ops, occ_pages=occ_pages)
    return new_tl, (torch.stack(cols), counters)


def window_sum(x: torch.Tensor, window_ops: int) -> torch.Tensor:
    """(..., W * wo) float32 -> (..., W) window sums in the reference's
    compiled order: runs of SUM_RUN summed left to right, level by
    level (see the module docstring)."""
    x = x.reshape(*x.shape[:-1], -1, int(window_ops))
    while True:
        n = x.shape[-1]
        if n > SUM_RUN:
            x = torch.nn.functional.pad(x, (0, (-n) % SUM_RUN))
            x = x.reshape(*x.shape[:-1], -1, SUM_RUN)
        acc = x[..., 0]
        for j in range(1, x.shape[-1]):
            acc = acc + x[..., j]
        if n <= SUM_RUN:
            return acc
        x = acc


def _pad_to(x: torch.Tensor, n: int, value=0.0) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]), value=value)


def _assemble(occ_col, idle_col, snap, latency, is_write, arrival, *,
              window_ops: int, t_len: int,
              wear_bound=None) -> WindowedTimeline:
    """The window assembly every path shares, as the reference's.

    occ_col/idle_col: (..., T) per-op head columns (occupancy fraction
    with pads zeroed, clamped idle claim); snap: (..., W, C) cumulative
    counter snapshots at the window boundaries; latency/is_write/
    arrival: the full (..., T) op-aligned arrays."""
    wo = int(window_ops)
    w_cnt = n_windows(t_len, wo)
    full = w_cnt * wo
    lead = latency.shape[:-1]
    dev = latency.device

    def win(x, red="sum"):
        x = _pad_to(x.to(torch.float32), full)
        if red == "sum":
            return window_sum(x, wo)
        return x.reshape(*lead, w_cnt, wo).amax(dim=-1)

    live = (is_write >= 0).to(torch.float32)        # pads are < 0
    wf = (is_write == 1).to(torch.float32)
    prev = torch.cat([torch.zeros_like(snap[..., :1, :]), snap[..., :-1, :]],
                     dim=-2)

    edges = torch.as_tensor(LAT_EDGES_MS, device=dev)
    bucket = torch.searchsorted(edges, latency.contiguous(), right=True)
    win_idx = torch.arange(t_len, device=dev) // wo
    n_cells = int(np.prod(lead)) if lead else 1
    base = (torch.arange(n_cells, device=dev) * (w_cnt * N_LAT_BUCKETS)
            ).reshape(*lead, 1) if lead else 0
    idx = (base + win_idx * N_LAT_BUCKETS + bucket).reshape(-1)
    hist = torch.zeros(n_cells * w_cnt * N_LAT_BUCKETS, dtype=torch.float32,
                       device=dev).index_add_(0, idx, wf.reshape(-1))
    return WindowedTimeline(
        window_ops=torch.full(lead, wo, dtype=torch.int32, device=dev),
        ops=win(live),
        writes=win(wf),
        lat_sum=win(wf * latency),
        lat_hist=hist.reshape(*lead, w_cnt, N_LAT_BUCKETS),
        occ_sum=win(occ_col),
        idle_ms=win(idle_col),
        t_last=win(live * arrival, "max"),
        ctr=snap - prev,
        wear_peak=wear_bound,
    )


def windowed(rows, latency, is_write, arrival, *, window_ops: int,
             t_len: int, endurance: bool = False) -> WindowedTimeline:
    """Stacked per-op rows — the (head (..., T, 2|3), counters (..., T,
    C)) pair `accumulate` emits over the whole padded trace — ->
    per-window series."""
    head, ctr_rows = rows
    idx = torch.as_tensor(bounds(t_len, window_ops), device=head.device)
    return _assemble(
        head[..., ROW_OCC], head[..., ROW_IDLE],
        ctr_rows.index_select(-2, idx), latency, is_write, arrival,
        window_ops=window_ops, t_len=t_len,
        wear_bound=(head[..., ROW_WEAR].index_select(-1, idx)
                    if endurance else None))


def tail_windows(t_len: int, t_scan: int, window_ops: int):
    """Split of the window boundaries around the scanned/replayed seam:
    windows 0..w0-1 end inside the scanned prefix [0, t_scan); windows
    w0..W-1 end among the replayed tail pads.

    Returns (w0, counts) — `counts[j]` is how many tail pads separate
    tail-window j's boundary from the previous boundary (the first
    counts from `t_scan - 1`), so `sum(counts) == t_len - t_scan`."""
    bnd = bounds(t_len, window_ops)
    w0 = sum(1 for b in bnd if b < t_scan)
    counts, prev = [], t_scan - 1
    for b in bnd[w0:]:
        counts.append(b - prev)
        prev = b
    return w0, counts


def _snapshots(rows_ctr, idx, tail_ctr):
    snap = rows_ctr.index_select(
        -2, torch.as_tensor(idx, dtype=torch.long, device=rows_ctr.device))
    if tail_ctr is not None and tail_ctr.shape[-2]:
        snap = torch.cat([snap, tail_ctr], dim=-2)
    return snap


def windowed_prefix(head, ctr_rows, tail_ctr, latency, is_write, arrival,
                    *, window_ops: int, t_len: int,
                    t_scan: int) -> WindowedTimeline:
    """Per-op probe rows over a trimmed prefix + replayed-tail counter
    snapshots -> the same series `windowed` builds over the full padded
    trace, bit for bit.

    head/ctr_rows: the (..., t_scan, ...) rows of the scanned prefix;
    tail_ctr: (..., W - w0, C) snapshots at the tail boundaries
    (`sim.replay_pads_windowed`); latency/is_write/arrival: full
    (..., t_len) arrays, the tail rebuilt from the pad contract. Tail
    pads add literal zeros to every window sum, and their head columns
    are 0.0 by definition."""
    w0, _ = tail_windows(t_len, t_scan, window_ops)
    snap = _snapshots(ctr_rows, bounds(t_len, window_ops)[:w0], tail_ctr)
    return _assemble(
        _pad_to(head[..., ROW_OCC], t_len), _pad_to(head[..., ROW_IDLE], t_len),
        snap, latency, is_write, arrival, window_ops=window_ops,
        t_len=t_len)


def windowed_segments(occ_col, idle_col, seg_ctr, tail_ctr, latency,
                      is_write, arrival, *, window_ops: int, t_len: int,
                      t_scan: int, seg_lanes: int) -> WindowedTimeline:
    """Segment-executor rows -> per-window series, bit for bit the per-op
    path's. The segment executor's counters exist once per K-lane
    segment, so every window boundary must land on a segment end:
    `window_ops % seg_lanes == 0`. occ_col/idle_col: the (..., t_scan)
    head columns rebuilt from the per-lane outputs; seg_ctr: (..., S, C)
    counters after each segment."""
    wo = int(window_ops)
    if wo % seg_lanes:
        raise ValueError(
            f"segment telemetry needs window_ops % {seg_lanes} == 0 "
            f"(window boundaries must land on segment ends), got {wo}")
    w0, _ = tail_windows(t_len, t_scan, wo)
    idx = [(b + 1) // seg_lanes - 1 for b in bounds(t_len, wo)[:w0]]
    snap = _snapshots(seg_ctr, idx, tail_ctr)
    return _assemble(
        _pad_to(occ_col, t_len), _pad_to(idle_col, t_len), snap, latency,
        is_write, arrival, window_ops=wo, t_len=t_len)


def from_rows(rows: ProbeRows, latency, is_write, arrival, *,
              cap_pages, window_ops: int, t_len: int) -> WindowedTimeline:
    """The kernel's `ProbeRows` (or its plain version's) -> the
    `WindowedTimeline`; latency/is_write/arrival over the full (...,
    t_len) padded trace (the tail rebuilt from the pad contract),
    `cap_pages` each cell's capacity (`cap_pages()`)."""
    t_scan = rows.head.shape[-2]
    cap = torch.clamp_min(torch.as_tensor(cap_pages), 1.0)
    occ = torch.where(is_write[..., :t_scan] < 0, 0.0,
                      rows.head[..., ROW_OCC] / cap[..., None])
    return _assemble(
        _pad_to(occ, t_len), _pad_to(rows.head[..., ROW_IDLE], t_len),
        rows.snap, latency, is_write, arrival, window_ops=window_ops,
        t_len=t_len, wear_bound=rows.wear_peak)
