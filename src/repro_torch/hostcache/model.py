"""Host-cache state, knobs and telemetry reduction on tensors
(DESIGN.md §14).

Port of the reference package's `hostcache/model.py`. `HCState` rides
`SimState.hostcache` through the trailing-`None` contract (like `wear`
and `timeline`): absent, the device carry keeps its layout bit for bit;
present, it is the host tier's set-associative state. `HCParams` rides
`CellParams.hostcache` the same way: the float knobs of a
`HostCacheSpec`. Leaves are 0-d (one cell) or carry a leading cell axis
(a fleet), as every other carry of the port.

`host_windows` is the telescoping reduction of the reference applied to
the host tier: one cumulative host-counter row per trace op, window
boundaries gathered, per-window deltas as differences of snapshots, so
the windows of a counter sum to its final value exactly.

One float site of the reference's compiled tier step: the dirty
fraction `dirty_n / lines` divides by a constant of the static spec, and
XLA turns that into `dirty_n * float32(1 / lines)` (found at 96 x 8,
100 x 3 and 24 x 5, where the two differ;
`tests/test_torch_hostcache.py::test_dirty_fraction_site`). `dirty_frac`
does the same here and in the `host_tier` kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.hostcache.spec import HostCacheSpec

__all__ = ["H_CTR", "HCParams", "HCState", "HostWindows", "as_hc_params",
           "dirty_frac", "host_summary", "host_windows", "init_hc",
           "lines_inv"]

_I32, _F32 = torch.int32, torch.float32

# host-tier counter vector (cumulative f32, exact integer values):
#   hits       — live ops whose lba was resident (read or write)
#   read_hits  — reads served from the host tier
#   write_hits — writes that found their line resident
#   absorbed   — live ops fully served at host latency (no device op):
#                read hits always; write hits/allocates in wb mode
#   absorbed_w — the write subset of `absorbed`
#   dev_ops    — live ops that issued a device op (miss or pass-through);
#                absorbed + dev_ops == live trace ops, exactly
#   flush_w    — dirty lines written back by scheduled flush bursts
#   evict_w    — dirty victims written back on eviction
H_CTR = {name: i for i, name in enumerate(
    ["hits", "read_hits", "write_hits", "absorbed", "absorbed_w",
     "dev_ops", "flush_w", "evict_w"])}


class HCParams(NamedTuple):
    """Float knobs of one HostCacheSpec (CellParams.hostcache): 0-d f32
    tensors, or (C,) for a fleet."""
    promote_n: torch.Tensor     # Nth-access insert threshold
    wm_hi: torch.Tensor         # dirty fraction arming flush bursts
    wm_lo: torch.Tensor         # dirty fraction disarming them
    hit_ms: torch.Tensor        # host hit latency
    flush_gap_ms: torch.Tensor  # arrival gap opening an idle flush


def as_hc_params(spec: HostCacheSpec, device="cuda") -> HCParams:
    return HCParams(*(torch.tensor(getattr(spec, f), dtype=_F32,
                                   device=device)
                      for f in HCParams._fields))


class HostWindows(NamedTuple):
    """Per-window host-tier series (..., W): counter leaves are exact
    per-window deltas, `dirty_frac` the boundary snapshot, `dev_lat_ms`
    the summed device-visible sub-op latency of the window."""
    window_ops: torch.Tensor    # (...) i32
    hits: torch.Tensor
    absorbed: torch.Tensor
    dev_ops: torch.Tensor
    flush_w: torch.Tensor
    evict_w: torch.Tensor
    dirty_frac: torch.Tensor
    dev_lat_ms: torch.Tensor


class HCState(NamedTuple):
    """The host tier's state (SimState.hostcache): (S, W) line arrays,
    sets indexed by `lba % S`, LRU by per-line age stamps (victim =
    first argmin age; invalid lines hold age 0 and the tick starts at 1,
    so they always lose)."""
    tag: torch.Tensor          # (S, W) i32 — resident lba, -1 invalid
    dirty: torch.Tensor        # (S, W) i32 — host copy newer than device
    age: torch.Tensor          # (S, W) i32 — tick at last touch (LRU)
    shadow_tag: torch.Tensor   # (S,) i32 — promotion-filter candidate lba
    shadow_cnt: torch.Tensor   # (S,) i32 — its observed access count
    tick: torch.Tensor         # () i32 — live-op clock (starts at 0)
    dirty_n: torch.Tensor      # () i32 — total dirty lines
    flushing: torch.Tensor     # () i32 — watermark burst latch
    fcur: torch.Tensor         # () i32 — round-robin flush set cursor
    prev_t: torch.Tensor       # () f32 — last live arrival (idle flush)
    hctr: torch.Tensor         # (len(H_CTR),) f32 — see H_CTR
    dev_lat_ms: torch.Tensor   # () f32 — cumulative device-visible
    #                            sub-op latency
    hwin: Optional[HostWindows] = None  # the windows, when the run had
    #                            the telemetry probe on; None otherwise


def init_hc(spec: HostCacheSpec, n_cells: Optional[int] = None,
            device="cuda") -> HCState:
    """A fresh host tier for one cell, or `n_cells` with a leading cell
    axis."""
    lead = () if n_cells is None else (n_cells,)
    s, w = spec.sets, spec.ways

    def full(shape, v, dtype):
        return torch.full(lead + shape, v, dtype=dtype, device=device)

    return HCState(
        tag=full((s, w), -1, _I32), dirty=full((s, w), 0, _I32),
        age=full((s, w), 0, _I32), shadow_tag=full((s,), -1, _I32),
        shadow_cnt=full((s,), 0, _I32), tick=full((), 0, _I32),
        dirty_n=full((), 0, _I32), flushing=full((), 0, _I32),
        fcur=full((), 0, _I32), prev_t=full((), 0.0, _F32),
        hctr=full((len(H_CTR),), 0.0, _F32),
        dev_lat_ms=full((), 0.0, _F32))


def lines_inv(spec: HostCacheSpec) -> float:
    """float32(1 / lines): what the compiled reference multiplies the
    dirty line count by (the module docstring)."""
    return float(np.float32(1.0) / np.float32(spec.lines))


def dirty_frac(dirty_n: torch.Tensor, spec: HostCacheSpec) -> torch.Tensor:
    """The dirty-line fraction of the host row, as the compiled reference
    forms it."""
    return dirty_n.to(_F32) * lines_inv(spec)


def host_windows(hrows, *, window_ops: int, t_len: int) -> HostWindows:
    """(..., T, len(H_CTR) + 2) host rows — the cumulative counters, the
    dirty fraction and the cumulative device-visible latency after each
    trace op — to per-window series, by boundary snapshots and their
    differences (summing a counter over windows gives its final value
    exactly)."""
    wo = int(window_ops)
    n_win = -(-t_len // wo)
    bound = torch.clamp_max((torch.arange(n_win, device=hrows.device) + 1)
                            * wo - 1, t_len - 1)
    snap = hrows.index_select(-2, bound)
    prev = torch.cat([torch.zeros_like(snap[..., :1, :]), snap[..., :-1, :]],
                     dim=-2)
    delta = snap - prev
    n = len(H_CTR)
    return HostWindows(
        window_ops=torch.full(hrows.shape[:-2], wo, dtype=_I32,
                              device=hrows.device),
        hits=delta[..., H_CTR["hits"]],
        absorbed=delta[..., H_CTR["absorbed"]],
        dev_ops=delta[..., H_CTR["dev_ops"]],
        flush_w=delta[..., H_CTR["flush_w"]],
        evict_w=delta[..., H_CTR["evict_w"]],
        dirty_frac=snap[..., n],
        dev_lat_ms=delta[..., n + 1])


def host_summary(hc: HCState, host_w, n_trace_writes) -> dict:
    """Host-tier metrics merged into `sim.summarize` for a run that
    carried a host cache (one cell or a fleet). `host_w` is the device
    counter CTR["host_w"]: every write the device saw (pass-throughs,
    eviction write-backs, flush bursts); `host_dev_write_frac` below 1.0
    is the host tier absorbing write traffic."""
    h = hc.hctr

    def ctr(name):
        return h[..., H_CTR[name]]

    live = ctr("absorbed") + ctr("dev_ops")
    return {
        "host_hit_rate": ctr("hits") / torch.clamp_min(live, 1.0),
        "host_absorbed": ctr("absorbed"),
        "host_absorbed_w": ctr("absorbed_w"),
        "host_dev_ops": ctr("dev_ops"),
        "host_flush_w": ctr("flush_w"),
        "host_evict_w": ctr("evict_w"),
        "host_dev_write_frac": host_w / torch.clamp_min(
            torch.as_tensor(n_trace_writes, dtype=_F32,
                            device=host_w.device), 1.0),
        "host_dev_lat_ms": hc.dev_lat_ms,
    }
