"""Fleet sweep runner: batch sweep points into fleets — port of the
reference package's `sweep/runner.py`.

Points are grouped by what selects a different kernel specialisation or
stacked shape: (mechanism composition, mode, padded trace length, wear
tracking, host-cache spec). The composition is the policy's
`PolicySpec`, not its name, so two names with one composition share a
group. Every group is one `FleetGroup` with per-cell `CellParams`, and
all of them go to ONE `fleet.run_fleets` call — on a CUDA device one
launch of the `ssd_step` kernel, one block a cell, the longest cells
first, every cell of the grid side by side, the wear form's cells among
them; the host-cache groups' cells first go through the host tier, all
of them in one launch of the `host_tier` kernel, and their device
sub-op streams join that `ssd_step` launch. Groups that track wear or
carry a host cache step every padded op (no pad trim, as the reference's
fleet; host groups carry unpacked plane fields, as there).

Traces come from the workload engine through its content-addressed
cache (`workloads.TraceCache`): a point's `trace` may be an MSR name, a
scenario name or a trace-file path. The AGC waste calibration of a
scenario or file is fitted from its daily trace (`workloads.fit_stats`),
as the reference's runner fits it.

The launch and each group's summary are queued first; the results are
copied to the host afterwards, group by group. Per-group timings — the
host time of building the group's fleet (`dispatch_s`) and of copying
its results back (`block_s`), both measured through `telemetry.spans`,
and the group's device time from the kernel's per-block timers — are
appended to `timings`.

`timeline_ops` turns the telemetry probe on for the whole launch (the
kernel's probe form): each point's per-window series come back through
`timelines` as the reference's runner returns them.

Ranks: inside a `torch.distributed` group of W ranks every rank calls
`run_sweep` with the same points; the point list is padded to a
multiple of W (`fleet.cell_quantum()`; the last point replayed),
each rank runs its contiguous slice (`fleet.shard_cells`) as above — one
`ssd_step` launch a rank — and the results, gathered as host objects,
come back on every rank in the points' order with the pads dropped. In
one process nothing is padded.

`run_matrix` is the evaluation matrix in `driver.eval_matrix`'s keys;
`bench_fleet_vs_loop` times it against a loop of single cells (the
CLI's `--bench`).
"""
from __future__ import annotations

import warnings
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import workloads
from repro_torch.core.ssd import fleet
from repro_torch.core.ssd.driver import (LOGICAL_SPACE_CAP, _agc_waste_p,
                                         agc_waste_from_stats)
from repro_torch.core.ssd.endurance.spec import EnduranceSpec
from repro_torch.core.ssd.policies.registry import get_spec
from repro_torch.core.ssd.policies.spec import requires_endurance
from repro_torch.core.ssd.policies.state import can_pack, map_state
from repro_torch.core.ssd.sim import default_params
from repro_torch.distributed import group as dgroup
from repro_torch.kernels.host_tier import ops as host_tier
from repro_torch.kernels.ssd_step import ops as ssd_step
from repro_torch.sweep.grid import SweepPoint
from repro_torch.telemetry import timeline as tmod
from repro_torch.telemetry.spans import span

__all__ = ["run_sweep", "run_matrix", "bench_fleet_vs_loop"]


def _n_logical(cfg) -> int:
    return min(cfg.total_pages, LOGICAL_SPACE_CAP)


def _endurance_of(point: SweepPoint):
    """The point's endurance knobs: its own, or the defaults when its
    composition requires wear tracking, else None."""
    if point.endurance is not None:
        return point.endurance
    if requires_endurance(get_spec(point.policy)):
        return EnduranceSpec()
    return None


def _cell_params(cfg, point: SweepPoint, waste_p: float):
    """Per-point CellParams on the host, in the reference's order and
    with its int() truncations: the waste probability, the cache_frac
    scaling, the idle-threshold override, the cap_boost scaling, the
    endurance knobs and the host-cache knobs."""
    p = default_params(cfg, point.policy, waste_p, _endurance_of(point),
                       device="cpu")

    def i32(v):
        return torch.tensor(v, dtype=torch.int32)

    if point.cache_frac != 1.0:
        p = p._replace(
            cap_basic=i32(max(int(int(p.cap_basic) * point.cache_frac), 4)),
            cap_trad=i32(int(int(p.cap_trad) * point.cache_frac)),
            cap_boost=i32(int(int(p.cap_boost) * point.cache_frac)))
    if point.idle_threshold_ms is not None:
        p = p._replace(idle_thr=torch.tensor(point.idle_threshold_ms,
                                             dtype=torch.float32))
    if point.cap_boost_frac is not None:
        p = p._replace(cap_boost=i32(int(int(p.cap_boost)
                                         * point.cap_boost_frac)))
    if point.hostcache is not None:
        from repro_torch.hostcache.model import as_hc_params
        p = p._replace(hostcache=as_hc_params(point.hostcache,
                                              device="cpu"))
    return p


def run_sweep(cfg, points: Sequence[SweepPoint], *,
              max_ops: Optional[int] = None, device="cuda",
              progress=None, timings: Optional[List[Dict]] = None,
              trace_cache: Optional[workloads.TraceCache] = None,
              timeline_ops: Optional[int] = None,
              timelines: Optional[Dict] = None
              ) -> Dict[SweepPoint, Dict[str, float]]:
    """Run every sweep point batched; returns {point: metrics}.

    In a process group of W > 1 ranks (every rank calls it with the same
    points) each rank runs its slice of the points padded to a multiple
    of W and every rank gets every point's metrics,
    in the points' order; `timings` then gets every rank's groups, each
    entry with its `rank`, and `timelines` every point's.

    `max_ops` truncates traces (smoke runs). `progress` is an optional
    callable(str) for per-group status lines. `trace_cache` supplies the
    compiled-trace cache (a fresh one, memory and disk, otherwise).
    `timings`, if given, gets one dict per group: policies, mode,
    composition, endurance, cells, t_len, t_scan, packed,
    dispatch_s (host clock, building the group's fleet),
    launch_s (host clock of the one shared call and the summaries),
    block_s (host clock, copying the group's results back),
    launch_ms (CUDA events around the one `ssd_step` launch, the same in
    every group; None on the CPU), tier_ms (CUDA events around the one
    `host_tier` launch, in every group when the grid has host cells;
    None otherwise), hostcache (the group's spec tag, or None),
    k_slots (the device sub-ops a trace op issues: 2 + flush_per_op for
    a host group, else 1), kernel_ms (the group's device time: its
    latest block end minus its earliest block start), max_cell_ops and
    ns_per_op (its longest cell's stepped ops, scanned and pads
    replayed, and device ns per op), cycles and wait_cycles (the clock64
    cycles that cell's recurrence took in all and waited on its op ring)
    — None on the CPU — and ops_per_s over the padded
    length, per kernel time on the card and per call time on the
    CPU.

    Every group that does not track wear scans only its shared live
    prefix and replays the identical pad tail to its exact fixed point;
    every group carries int16 plane fields whenever every cell's caps
    provably fit (`policies.state.can_pack`) — the reference runner's
    defaults. Results are identical either way.

    `timeline_ops` attaches the telemetry probe to every group with that
    window size; pass a dict as `timelines` to receive each point's
    per-window accumulators ({point: numpy timeline dict}, feed to
    `telemetry.timeline.series`). The probe only observes: the results
    are the same with it on."""
    points = list(points)
    n_ranks = dgroup.world_size()
    kw = dict(max_ops=max_ops, device=device, progress=progress,
              trace_cache=trace_cache, timeline_ops=timeline_ops)
    if n_ranks == 1 or not points:
        return _run_points(cfg, points, timelines=timelines,
                           timings=timings, **kw)
    pad = (-len(points)) % fleet.cell_quantum()
    padded = points + [points[-1]] * pad
    mine = [padded[i] for i in fleet.shard_cells(np.arange(len(padded)))]
    local_tl = {} if timelines is not None else None
    local_timings = [] if timings is not None else None
    res = _run_points(cfg, mine, timelines=local_tl, timings=local_timings,
                      **kw)
    merged, merged_tl = {}, {}
    for r, (r_res, r_tl, r_timings) in enumerate(dgroup.all_gather_objects(
            (res, local_tl, local_timings))):
        merged.update(r_res)
        merged_tl.update(r_tl or {})
        if timings is not None:
            timings.extend(dict(t, rank=r) for t in r_timings)
    if timelines is not None:
        timelines.update({pt: merged_tl[pt] for pt in points})
    return {pt: merged[pt] for pt in points}


def _run_points(cfg, points: Sequence[SweepPoint], *,
                max_ops: Optional[int] = None, device="cuda",
                progress=None, timings: Optional[List[Dict]] = None,
                trace_cache: Optional[workloads.TraceCache] = None,
                timeline_ops: Optional[int] = None,
                timelines: Optional[Dict] = None
                ) -> Dict[SweepPoint, Dict[str, float]]:
    """`run_sweep` in this process, on every point given."""
    n_logical = _n_logical(cfg)
    device = torch.device(device)
    cache = (trace_cache if trace_cache is not None
             else workloads.TraceCache())

    def cell_trace(pt: SweepPoint) -> dict:
        tr = workloads.build_ops(
            pt.trace, n_logical, mode=pt.mode, seed=pt.seed,
            capacity_pages=cfg.total_pages, repeat=pt.repeat, cache=cache)
        if max_ops is not None:
            tr = workloads.truncate_trace(tr, max_ops)
        return tr

    # AGC waste calibration: published stats for MSR names, stats fitted
    # on the daily variant for scenario and file specs (one fit a recipe)
    fitted_waste: Dict[tuple, float] = {}

    def cell_waste(pt: SweepPoint) -> float:
        if pt.waste_p is not None:
            return pt.waste_p
        if get_spec(pt.policy).idle != "agc":
            return 0.0
        if pt.trace in workloads.TRACES:
            return _agc_waste_p(pt.trace)
        key = (pt.trace, pt.seed, pt.repeat)
        if key not in fitted_waste:
            ops = workloads.build_ops(
                pt.trace, n_logical, mode="daily", seed=pt.seed,
                capacity_pages=cfg.total_pages, repeat=pt.repeat,
                cache=cache)
            st = workloads.fit_stats(
                workloads.ir.trace_from_ops(ops, source=pt.trace),
                n_logical, cfg.total_pages)
            fitted_waste[key] = agc_waste_from_stats(st)
        return fitted_waste[key]

    groups: Dict[tuple, list] = defaultdict(list)
    for pt in points:
        groups[(get_spec(pt.policy), pt.mode,
                len(cell_trace(pt)["arrival_ms"]),
                _endurance_of(pt) is not None, pt.hostcache)].append(pt)

    # ---- phase 1: build every group's fleet, then one launch for all ----
    pending, fleets = [], []
    for (spec, mode, t_len, endur, hc), pts in sorted(
            groups.items(), key=lambda kv: (kv[0][:4], str(kv[0][4]))):
        names = ",".join(sorted({p.policy for p in pts}))
        if timeline_ops is not None and endur:
            warnings.warn(
                f"sweep group {names}/{mode}: timeline requested on an "
                "endurance group — wear tracking has no trimmed fast path, "
                "so its cells step every padded op (the kernel's wear "
                "form)", RuntimeWarning, stacklevel=2)
        if progress:
            progress(f"fleet {names}/{mode}: {len(pts)} cells x {t_len} "
                     f"ops on {device}")
        with span("sweep.dispatch", "sweep", group=names, mode=mode,
                  cells=len(pts), t_len=t_len) as rec:
            cell_traces = [cell_trace(p) for p in pts]
            params = [_cell_params(cfg, p, cell_waste(p)) for p in pts]
            pack_grp = hc is None and all(can_pack(cfg, n_logical, p)
                                          for p in params)
            ops = fleet.stack_ops(cell_traces, device=device)
            stacked = map_state(lambda x: x.to(device),
                                fleet.stack_params(params))
            fleets.append(fleet.FleetGroup(spec, ops, stacked,
                                           closed_loop=(mode == "bursty"),
                                           packed=pack_grp, hostcache=hc))
            t_scan = (t_len if endur or hc is not None
                      else fleet._trim_len(np.stack(
                          [t["is_write"] for t in cell_traces])))
        pending.append({
            "pts": pts, "n_ops": [t["n_ops"] for t in cell_traces],
            "names": names, "mode": mode, "spec": spec, "t_len": t_len,
            "endurance": endur, "hostcache": hc, "packed": pack_grp,
            "dispatch_s": rec["dur_s"], "t_scan": t_scan})
    n_cells = sum(len(g["pts"]) for g in pending)
    timer = (torch.zeros((n_cells, len(ssd_step.TIMER_COLUMNS)),
                         dtype=torch.int64, device=device)
             if device.type == "cuda" else None)
    n_launch = len(ssd_step.events)
    n_tier = len(host_tier.events)
    with span("sweep.launch", "sweep", groups=len(pending),
              cells=n_cells, timeline_ops=timeline_ops) as rec:
        runs = fleet.run_fleets(cfg, fleets, n_logical=n_logical,
                                trim_pads=True, timer=timer,
                                timeline_ops=timeline_ops)
        for grp, fl, (latency, states) in zip(pending, fleets, runs):
            if grp["mode"] == "daily":
                states = fleet.flush_fleet(cfg, states, grp["spec"])
            grp["summ"] = fleet.summarize_fleet(latency, fl.ops["is_write"],
                                                states, params=fl.params,
                                                cfg=cfg)
            grp["tl"] = states.timeline
    launch_s = rec["dur_s"]
    events = ssd_step.events[n_launch:]
    tier_events = host_tier.events[n_tier:]

    # ---- phase 2: copy each group's results to the host, oldest first ----
    results: Dict[SweepPoint, Dict[str, float]] = {}
    cols = {c: i for i, c in enumerate(ssd_step.TIMER_COLUMNS)}
    blocks = timer.cpu().numpy() if timer is not None else None
    launch_ms = (sum(s.elapsed_time(e) for s, e in events)
                 if events else None)
    tier_ms = (sum(s.elapsed_time(e) for s, e in tier_events)
               if tier_events else None)
    padded_total = sum(len(g["pts"]) * g["t_len"] for g in pending)
    row = 0
    for grp in pending:
        with span("sweep.block", "sweep", group=grp["names"],
                  mode=grp["mode"]) as rec:
            summ = {k: v.cpu().numpy() for k, v in grp["summ"].items()}
            if timelines is not None and grp["tl"] is not None:
                tl_np = tmod.timeline_to_numpy(grp["tl"])
                for i, pt in enumerate(grp["pts"]):
                    timelines[pt] = tmod.cell_timeline(tl_np, i)
        for i, pt in enumerate(grp["pts"]):
            out = {k: float(v[i]) for k, v in summ.items()}
            out["n_ops"] = int(grp["n_ops"][i])
            results[pt] = out
        cells = len(grp["pts"])
        rows = (blocks[row:row + cells] if blocks is not None else None)
        row += cells
        if timings is None:
            continue
        entry = {
            "policies": grp["names"], "mode": grp["mode"],
            "composition": grp["spec"].composition,
            "endurance": grp["endurance"],
            "hostcache": (None if grp["hostcache"] is None
                          else grp["hostcache"].tag),
            "k_slots": (1 if grp["hostcache"] is None
                        else 2 + grp["hostcache"].flush_per_op),
            "cells": cells,
            "t_len": grp["t_len"], "t_scan": grp["t_scan"],
            "packed": grp["packed"], "dispatch_s": grp["dispatch_s"],
            "launch_s": launch_s, "block_s": rec["dur_s"],
            "launch_ms": launch_ms, "tier_ms": tier_ms,
            "kernel_ms": None, "max_cell_ops": None, "ns_per_op": None,
            "cycles": None, "wait_cycles": None}
        if rows is not None:
            # the group's device time: its latest block end minus its
            # earliest block start (%globaltimer, ns)
            entry["kernel_ms"] = float(
                rows[:, cols["end_ns"]].max()
                - rows[:, cols["start_ns"]].min()) / 1e6
            stepped = (rows[:, cols["scanned_ops"]]
                       + rows[:, cols["pads_replayed"]])
            longest = int(np.argmax(stepped))
            entry["max_cell_ops"] = int(stepped[longest])
            entry["ns_per_op"] = float(
                rows[longest, cols["end_ns"]]
                - rows[longest, cols["start_ns"]]) / max(
                    int(stepped[longest]), 1)
            entry["cycles"] = int(rows[longest, cols["cycles"]])
            entry["wait_cycles"] = int(rows[longest, cols["wait_cycles"]])
            # ops/s credits the full padded length each cell covers, as
            # the reference's runner counts it
            entry["ops_per_s"] = cells * grp["t_len"] / max(
                entry["kernel_ms"] / 1e3, 1e-9)
        else:
            # the CPU runs every group in the one call: its rate is the
            # call's, over all groups' padded ops
            entry["ops_per_s"] = padded_total / max(launch_s, 1e-9)
        timings.append(entry)
    return results


def run_matrix(cfg, *, policies: Sequence[str] = ("baseline", "ips",
                                                  "ips_agc"),
               modes: Sequence[str] = ("bursty", "daily"),
               names: Optional[Iterable[str]] = None, seed: int = 0,
               max_ops: Optional[int] = None,
               trace_cache: Optional[workloads.TraceCache] = None,
               device="cuda") -> Dict[str, Dict]:
    """Fleet-backed evaluation matrix in `driver.eval_matrix` key format
    (`trace/mode/policy`), the points in the reference's order."""
    names = tuple(names or workloads.TRACE_NAMES)
    points = [SweepPoint(trace=n, mode=m, policy=p, seed=seed)
              for m in modes for n in names for p in policies]
    res = run_sweep(cfg, points, max_ops=max_ops, trace_cache=trace_cache,
                    device=device)
    return {f"{pt.trace}/{pt.mode}/{pt.policy}": v for pt, v in res.items()}


def bench_fleet_vs_loop(cfg, *, policies=("baseline", "ips", "ips_agc"),
                        modes=("bursty", "daily"),
                        names: Optional[Iterable[str]] = None,
                        progress=None, max_ops: Optional[int] = None,
                        device="cuda") -> Dict:
    """Wall-clock the fleet matrix against a loop of `driver.eval_cell`
    over identical cells; verifies per-cell metric equivalence.

    On a card the fleet is one `ssd_step` launch for every cell and the
    loop one launch a cell (`sim.run_trace`); on the CPU both run the
    kernel's plain version. `max_ops` truncates both sides' traces (a
    smoke run). Returns a JSON-ready dict (feed to `store.save_bench`)."""
    from repro_torch.core.ssd.driver import eval_cell
    names = tuple(names or workloads.TRACE_NAMES)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))

    # memory-only cache: the published speedup must be hermetic, not a
    # function of whatever the disk cache happens to hold from prior runs
    cache = workloads.TraceCache(use_disk=False)
    with span("bench.fleet", "bench") as rec:
        fleet_res = run_matrix(cfg, policies=policies, modes=modes,
                               names=names, trace_cache=cache,
                               max_ops=max_ops, device=device)
        sync()
    fleet_s = rec["dur_s"]

    with span("bench.loop", "bench") as rec:
        loop_res = {}
        for mode in modes:
            for name in names:
                for policy in policies:
                    if progress:
                        progress(f"loop {name}/{mode}/{policy}")
                    loop_res[f"{name}/{mode}/{policy}"] = eval_cell(
                        cfg, name, policy, mode, max_ops=max_ops,
                        device=device)
        sync()
    loop_s = rec["dur_s"]

    max_rel = 0.0
    for key, ref in loop_res.items():
        got = fleet_res[key]
        for metric, rv in ref.items():
            rel = abs(got[metric] - rv) / max(abs(rv), 1e-9)
            max_rel = max(max_rel, rel)
    return {
        "n_cells": len(loop_res),
        "policies": list(policies), "modes": list(modes),
        "names": list(names),
        "loop_wall_s": round(loop_s, 3),
        "fleet_wall_s": round(fleet_s, 3),
        "speedup": round(loop_s / max(fleet_s, 1e-9), 3),
        "max_rel_diff": max_rel,
        "trace_cache": cache.stats(),
        "results": fleet_res,
    }
