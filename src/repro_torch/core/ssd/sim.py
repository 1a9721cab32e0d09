"""Workload-driven hybrid-SSD simulator for one cell — port of the
reference package's `core/ssd/sim.py`.

A policy is a static composition of mechanisms (`policies.registry`);
the per-op recurrence is the engine's core. On a CUDA device every run
goes through the `ssd_step` kernel (one launch); on the CPU through the
kernel's plain version. Modes: closed_loop=True is the paper's bursty
scenario (no idle, latency = program time + conflicts); closed_loop=False
replays arrival times (daily scenario, queueing + idle work modeled).

Pad tails. Traces are padded with identical tail ops (`ir.pad_ops`):
constant arrival, lba 0, is_write -1. The step is a deterministic
function of (state, op), so once one pad leaves the reduced carry
unchanged every further pad would too. `run_trace` and `run_compressed`
therefore scan only the live prefix and replay the tail to that exact
fixed point (`replay_pads`); pads emit latency 0.0 and write their
residency entry back unchanged, so the result equals scanning every op.
A run that tracks wear (`CellParams.endurance`) steps every padded op,
as the reference's does, and has no compressed path.

Telemetry: `timeline_ops` turns the probe on (the kernel's probe form, or
its plain version) and the final state's `timeline` carries the
`telemetry.probe.WindowedTimeline` over the padded trace — the scanned
prefix's rows, the replayed tail's boundary snapshots
(`replay_pads_windowed`) and the pad contract's zeros for the rest, the
same windows the reference's full-length scan produces.

Host tier: `run_trace(hostcache=spec)` puts the host-tier block cache in
front of the device (`hostcache.pipeline`): every padded op through the
tier, each with its K device sub-ops — on the CPU the composed step, op
by op; on a card the `host_tier` kernel's pass, then its sub-op stream
through `ssd_step` (`fleet.run_fleets`). The final state carries
`hostcache`, and with the probe on its host windows.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ssd.policies.engine import Reduced
from repro_torch.core.ssd.policies.registry import resolve_spec
from repro_torch.core.ssd.policies.spec import tracked_region
from repro_torch.core.ssd.policies.state import (CTR, CellParams, SimState,
                                                 ceil_div, default_cell,
                                                 init_state, map_state)
from repro_torch.kernels.ssd_step import ops as ssd_step
from repro_torch.telemetry import probe

__all__ = ["default_params", "run_trace", "replay_pads",
           "replay_pads_windowed", "run_compressed", "flush_cache",
           "summarize", "as_ops", "scan_len"]

_F32 = torch.float32


def default_params(cfg, policy, waste_p: float = 0.0, endurance=None, *,
                   device="cuda") -> CellParams:
    """CellParams matching the static config for one policy;
    `endurance` (an `EnduranceSpec`) turns wear tracking on, and
    compositions that require it get the default knobs."""
    return default_cell(cfg, resolve_spec(policy), waste_p, endurance,
                        device=device)


def as_ops(trace, device="cuda") -> dict:
    """The op arrays of one padded trace as tensors (f32, i32, i32)."""
    return {"arrival_ms": torch.as_tensor(
                np.asarray(trace["arrival_ms"], np.float32), device=device),
            "lba": torch.as_tensor(np.asarray(trace["lba"], np.int32),
                                   device=device),
            "is_write": torch.as_tensor(
                np.asarray(trace["is_write"], np.int32), device=device)}


def scan_len(trace) -> int:
    """How many leading ops must be scanned: the live prefix when the
    rest is an `ir.pad_ops` tail of identical pads, else every op."""
    is_write = np.asarray(trace["is_write"])
    live = np.nonzero(is_write >= 0)[0]
    n_live = int(live[-1]) + 1 if live.size else 0
    arrival = np.asarray(trace["arrival_ms"], np.float32)[n_live:]
    lba = np.asarray(trace["lba"])[n_live:]
    if arrival.size and (np.any(arrival != arrival[0]) or np.any(lba != 0)):
        return len(is_write)
    return n_live


def _one(x):
    return x.reshape(1, *x.shape)


def run_trace(cfg, policy, trace, *, closed_loop: bool, n_logical: int,
              waste_p: float = 0.0, params: CellParams | None = None,
              packed: bool = False, timeline_ops: int | None = None,
              hostcache=None, device="cuda"):
    """Simulate one padded trace. Returns (per-op latency (T,), final
    SimState; its `wear` when `params.endurance` is set). `packed`
    carries the integer plane fields as int16 (gate on
    `policies.state.can_pack`); results are identical. `timeline_ops`
    attaches the telemetry probe with that many ops a window: the final
    state's `timeline` is then the `WindowedTimeline`; every other leaf
    is what the run gives without it. `hostcache` (a `HostCacheSpec`)
    puts the host tier in front of the device: the final state then
    carries `hostcache` (with its host windows when the probe is on);
    None keeps the device-only run, bit for bit."""
    if params is None:
        params = default_params(cfg, policy, waste_p, device=device)
    if hostcache is not None:
        return _run_trace_hostcache(cfg, policy, trace, closed_loop,
                                    n_logical, params, timeline_ops,
                                    hostcache, device)
    endurance = params.endurance is not None
    t_len = len(trace["lba"])
    n_scan = t_len if endurance else scan_len(trace)
    ops = as_ops({k: np.asarray(trace[k])[:n_scan]
                  for k in ("arrival_ms", "lba", "is_write")}, device)
    pad_t = torch.as_tensor(
        np.asarray(trace["arrival_ms"], np.float32)[n_scan:n_scan + 1],
        device=device)
    lat, final = ssd_step.run_stream(
        cfg, policy, {k: v.reshape(1, n_scan, 1) for k, v in ops.items()},
        init_state(cfg, n_logical, packed=packed, n_cells=1,
                   endurance=endurance, device=device),
        closed_loop=closed_loop, params=map_state(_one, params),
        n_pad=t_len - n_scan, pad_t=pad_t if n_scan < t_len else None,
        window_ops=timeline_ops)
    latency = torch.cat([lat.reshape(-1),
                         torch.zeros(t_len - n_scan, dtype=_F32,
                                     device=lat.device)])
    final = map_state(lambda x: x[0], final)
    if timeline_ops is not None:
        full = as_ops(trace, device)
        final = final._replace(timeline=probe.from_rows(
            final.timeline, latency, full["is_write"], full["arrival_ms"],
            cap_pages=probe.cap_pages(params, cfg.num_planes),
            window_ops=timeline_ops, t_len=t_len))
    return latency, final


def _run_trace_hostcache(cfg, policy, trace, closed_loop, n_logical,
                         params, timeline_ops, spec, device):
    """`run_trace` with the host tier: every padded op, no pad trim (the
    reference's tier runs the whole padded trace)."""
    from repro_torch.hostcache.model import as_hc_params, host_windows
    from repro_torch.hostcache.pipeline import build_tier_step
    if params.hostcache is None:
        params = params._replace(hostcache=as_hc_params(spec, device))
    ops = as_ops(trace, device)
    t_len = ops["lba"].shape[0]
    if torch.device(device).type != "cpu":
        from repro_torch.core.ssd.fleet import FleetGroup, run_fleets
        (lat, final), = run_fleets(
            cfg, [FleetGroup(policy, {k: v[None] for k, v in ops.items()},
                             map_state(_one, params), closed_loop,
                             hostcache=spec)],
            n_logical=n_logical, timeline_ops=timeline_ops)
        return lat[0], map_state(lambda x: x[0], final)
    step = build_tier_step(cfg, policy, spec, closed_loop=closed_loop,
                           params=params)
    state = init_state(cfg, n_logical, endurance=params.endurance is not None,
                       timeline=timeline_ops, hostcache=spec, device=device)
    lat, heads, ctrs, hrows = [], [], [], []
    for i in range(t_len):
        state, out = step(state, {k: v[i] for k, v in ops.items()})
        if timeline_ops is not None:
            out, (row, ctr), hrow = out
            heads.append(row)
            ctrs.append(ctr)
            hrows.append(hrow)
        lat.append(out)
    latency = torch.stack(lat)
    if timeline_ops is None:
        return latency, state
    timeline = probe.windowed(
        (torch.stack(heads), torch.stack(ctrs)), latency, ops["is_write"],
        ops["arrival_ms"], window_ops=timeline_ops, t_len=t_len,
        endurance=False)
    hw = host_windows(torch.stack(hrows), window_ops=timeline_ops,
                      t_len=t_len)
    return latency, state._replace(
        timeline=timeline, hostcache=state.hostcache._replace(hwin=hw))


def _tree_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def replay_pads(core, red: Reduced, old0, ep0, pad_t, n_pad: int):
    """Apply the trimmed all-pad tail to convergence.

    The tail ops are identical (arrival `pad_t`, lba 0, is_write -1) and
    the core is a deterministic function of (carry, op), so once one
    application leaves the carry unchanged every remaining one would
    too: the loop stops at that exact fixed point and still equals
    applying all `n_pad` pads. (Pads are not no-ops before it: migrate
    overrun reclamation drains an above-watermark plane a batch per
    pad.)"""
    return replay_pads_windowed(core, red, old0, ep0, pad_t, [n_pad])[0]


def replay_pads_windowed(core, red: Reduced, old0, ep0, pad_t, counts):
    """`replay_pads` that also snapshots the cumulative counters at the
    telemetry windows' boundaries inside the tail. `counts` (from
    `probe.tail_windows`) partitions the tail: after the first counts[0]
    pads the first boundary's counters are read, and so on. Returns
    (final Reduced, (len(counts), C) snapshots). Once the carry reaches
    its fixed point every later pad is the identity, so every later
    snapshot is the final counters — the values a full per-op scan
    reaches at those op indices."""
    dev = red.busy.device
    op = {"arrival_ms": torch.as_tensor(pad_t, dtype=_F32, device=dev),
          "lba": torch.zeros((), dtype=torch.int32, device=dev),
          "is_write": torch.full((), -1, dtype=torch.int32, device=dev)}
    changed, snaps = True, []
    for cnt in counts:
        i = 0
        while i < cnt and changed:
            red_n, _ = core(red, op, old0, ep0)
            changed = not _tree_equal(red_n, red)
            red, i = red_n, i + 1
        snaps.append(red.counters)
    if not snaps:
        return red, torch.zeros((0, len(CTR)), dtype=_F32, device=dev)
    return red, torch.stack(snaps)


def run_compressed(cfg, policy, comp, *, closed_loop: bool, n_logical: int,
                   waste_p: float = 0.0, params: CellParams | None = None,
                   packed: bool = False, timeline_ops: int | None = None,
                   device="cuda"):
    """Simulate one compressed trace (`workloads.compress.compress_ops`):
    the (S, K) segment stream, then the pad tail. Returns (per-op latency
    over the original padded length, final SimState) — identical to
    `run_trace` on the uncompressed trace, leaf for leaf. Runs that
    track wear have no compressed path, as in the reference.
    `timeline_ops` attaches the probe, as for `run_trace`; the window
    size must be a multiple of the segment's K lanes (the reference's
    segment telemetry reads its counters at segment ends)."""
    if params is None:
        params = default_params(cfg, policy, waste_p, device=device)
    if params.endurance is not None:
        raise ValueError("no compressed path for endurance runs; "
                         "use run_trace")
    if params.hostcache is not None:
        raise ValueError("no compressed path for host-cache runs; the "
                         "host tier rewrites the device op stream — use "
                         "run_trace")
    if timeline_ops is not None:
        lanes = next(iter(comp.segs.values())).shape[1]
        if int(timeline_ops) % lanes:
            raise ValueError(
                f"segment telemetry needs window_ops % {lanes} == 0; "
                f"got {timeline_ops}")
    segs = {k: torch.as_tensor(v, device=device).unsqueeze(0)
            for k, v in comp.segs.items()}
    lat, final = ssd_step.run_stream(
        cfg, policy, segs,
        init_state(cfg, n_logical, packed=packed, n_cells=1, device=device),
        closed_loop=closed_loop, params=map_state(_one, params),
        n_pad=comp.n_pad,
        pad_t=torch.tensor([comp.pad_t], dtype=_F32, device=device),
        window_ops=timeline_ops)
    latency = torch.cat([lat.reshape(-1),
                         torch.zeros(comp.n_pad, dtype=_F32,
                                     device=lat.device)])
    final = map_state(lambda x: x[0], final)
    if timeline_ops is not None:
        # the full-length op arrays, the tail from the pad contract
        is_write = torch.cat([
            segs["is_write"].reshape(-1),
            torch.full((comp.n_pad,), -1, dtype=torch.int32, device=device)])
        arrival = torch.cat([
            segs["arrival_ms"].reshape(-1),
            torch.full((comp.n_pad,), float(comp.pad_t), dtype=_F32,
                       device=device)])
        final = final._replace(timeline=probe.from_rows(
            final.timeline, latency, is_write, arrival,
            cap_pages=probe.cap_pages(params, cfg.num_planes),
            window_ops=timeline_ops, t_len=comp.t_len))
    return latency, final


def flush_cache(cfg, state: SimState, policy="baseline") -> SimState:
    """End-of-workload flush (paper §III/V): data remaining in the
    migratable region (`policies.tracked_region`) is migrated to TLC and
    its blocks erased. Analytic; works on one cell or a fleet."""
    region = tracked_region(resolve_spec(policy))
    if region is None:
        return state
    ctr = state.counters.clone()
    mig = state.valid_mig.to(torch.int64).sum(-1).to(_F32)
    used = state.trad_used if region == "trad" else state.slc_used
    blocks = ceil_div(used.to(torch.int64), cfg.pages_per_slc_block).sum(-1)
    ctr[..., CTR["mig_w"]] += mig
    ctr[..., CTR["erases"]] += blocks.to(_F32)
    return state._replace(counters=ctr)


def summarize(latency, is_write, state: SimState, *,
              cell: CellParams | None = None, cfg=None) -> dict:
    """Write-latency stats + write amplification from counters, for one
    cell ((T,) latency) or a fleet ((C, T)). The mean's float32 sum is
    accumulated in float64 and rounded once, so it does not depend on
    the reduction order of the device. When the run carried wear and the
    caller passes its `CellParams` and config, the lifetime metrics of
    `endurance.model.wear_summary` join the summary; a run that carried
    a host cache (`state.hostcache`) adds `hostcache.model.host_summary`
    the same way."""
    is_w = torch.as_tensor(is_write, device=latency.device) == 1
    lat_w = torch.where(is_w, latency, 0.0)
    n_w = torch.clamp_min(is_w.sum(-1), 1)
    mean_lat = lat_w.sum(-1, dtype=torch.float64).to(_F32) / n_w.to(_F32)
    c = state.counters

    def ctr(name):
        return c[..., CTR[name]]

    host = torch.clamp_min(ctr("host_w"), 1.0)
    extra_paper = ctr("mig_w") + ctr("rp_trad") + ctr("agc_waste")
    extra_raw = ctr("mig_w") + ctr("rp_trad") + ctr("rp_agc")
    wear_metrics = {}
    if (state.wear is not None and cell is not None
            and cell.endurance is not None and cfg is not None):
        from repro_torch.core.ssd.endurance.model import wear_summary
        wear_metrics = wear_summary(state.wear, cell.endurance,
                                    cell.cap_basic, cell.cap_trad,
                                    cfg.page_bytes, ctr("host_w"))
    host_metrics = {}
    if state.hostcache is not None:
        from repro_torch.hostcache.model import host_summary
        host_metrics = host_summary(state.hostcache, ctr("host_w"),
                                    is_w.sum(-1).to(_F32))
    return wear_metrics | host_metrics | {
        "mean_write_latency_ms": mean_lat,
        "wa_paper": 1.0 + extra_paper / host,
        "wa_raw": 1.0 + extra_raw / host,
        "slc_writes": ctr("slc_w"),
        "tlc_writes": ctr("tlc_w"),
        "reprogram_host": ctr("rp_host"),
        "reprogram_agc": ctr("rp_agc"),
        "reprogram_trad": ctr("rp_trad"),
        "migrations": ctr("mig_w"),
        "erases": ctr("erases"),
        "host_pages": ctr("host_w"),
        "conflict_ms": ctr("conflict_ms"),
    }
