"""The host tier composed with the device: port of the reference
package's `hostcache/pipeline.py`.

Per trace op the host tier decides hit / miss / insert / evict / flush
from its own set-associative state, then the *unmodified* policy core
runs a fixed stream of K = 2 + flush_per_op device sub-ops:

    slot 0        — the trace op itself, or a pad when the tier absorbed
                    it (read hit; write hit or allocate in write-back)
    slot 1        — the eviction write-back of a dirty LRU victim, or a
                    pad
    slots 2..K-1  — scheduled dirty-flush writes (watermark burst or
                    idle gap), or pads

A pad (is_write -1, lba 0, the trace op's arrival) is the core's no-op
with latency 0. Host-absorbed ops are served at `hit_ms`; the device's
idle accounting sees only the device-visible ops.

Nothing the tier decides reads the device: its lookup, promotion, victim
and dirty bookkeeping read only `HCState`, the idle-gap flush the tier's
own `prev_t`, the watermark `dirty_n`. The device's output reaches only
the trace op's latency, the device-visible latency sum and the probe.
So the port has two routes to the same result:

* `build_tier_step` — the plain version: one function per trace op, the
  tier (`kernels/host_tier/ref.tier_op`), then its K sub-ops through the
  engine's core in slot order. `sim.run_trace` takes it on the CPU.
* the pass route (`stream_job`, `assemble`) — the whole trace through
  the tier first (`host_tier.ops.tier_pass`: the `host_tier` kernel on a
  card, one launch for every host cell of a grid), its (C, T*K) sub-op
  stream through `ssd_step.run_streams` as a per-op job (K = 1, no pad
  trim: the reference's tier runs over the whole padded trace), then
  the assembly here, in torch. `fleet.run_fleets` takes it, and
  `sim.run_trace` on a card.

Float sites, each pinned against the reference's compiled step
(tests/test_torch_hostcache.py):

* `dev_lat_ms` is the running float32 sum `dev + sum_k(lat_k)` over live
  slots, the K slots summed left to right first (`slot_sum`), then added
  to the total; the total runs strictly in trace order (`running_sum`:
  numpy's sequential float32 accumulate, never `torch.cumsum`).
* The probe sees, per trace op, the trace op's pad flag, the counters
  after all K slots, the op's summed occupancy change and ONLY slot 0's
  idle claim (a flush or write-back's claim while slot 0 is a pad is
  dropped, as there); its windows run with `endurance=False`. On the
  pass route the `ssd_step` kernel's probe form runs at K x window_ops
  sub-ops a window, so its boundaries fall on the last slot of the
  trace op `min((w+1)*wo - 1, T - 1)`; `assemble` takes slot K-1's
  running occupancy and slot 0's idle column.
* The dirty fraction multiplies by float32(1 / lines)
  (`hostcache.model.dirty_frac`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ssd.policies.engine import (_build_core, reduced_of,
                                                  with_reduced)
from repro_torch.core.ssd.policies.registry import resolve_spec
from repro_torch.core.ssd.policies.state import (CellParams, SimState,
                                                 init_state)
from repro_torch.hostcache.model import host_windows, init_hc
from repro_torch.hostcache.spec import HostCacheSpec
from repro_torch.kernels.host_tier.ref import TierJob, n_slots, tier_op
from repro_torch.kernels.ssd_step.ops import StreamJob
from repro_torch.telemetry import probe

__all__ = ["build_tier_step", "slot_sum", "running_sum", "tier_job",
           "stream_job", "assemble"]

_F32 = torch.float32


def slot_sum(lat_k: torch.Tensor, kind_k: torch.Tensor) -> torch.Tensor:
    """(..., K) sub-op latencies -> (...,) their sum over live slots, left
    to right in float32, as the compiled reference sums them."""
    m = torch.where(kind_k >= 0, lat_k, 0.0)
    acc = m[..., 0]
    for k in range(1, m.shape[-1]):
        acc = acc + m[..., k]
    return acc


def running_sum(start: torch.Tensor, incr: torch.Tensor) -> torch.Tensor:
    """(C,) start + (C, T) increments -> (C, T) running float32 totals,
    added strictly in trace order (numpy's accumulate is sequential; a
    device's cumsum is not)."""
    s = np.concatenate([start.detach().cpu().numpy().astype(np.float32)
                        .reshape(-1, 1),
                        incr.detach().cpu().numpy().astype(np.float32)],
                       axis=1)
    out = np.add.accumulate(s, axis=1, dtype=np.float32)[:, 1:]
    return torch.from_numpy(np.ascontiguousarray(out)).to(incr.device)


def build_tier_step(cfg, policy, hc_spec: HostCacheSpec, *,
                    closed_loop: bool, params: CellParams):
    """The composed per-op step for one cell: `step(state, op) -> (state,
    latency)` over a SimState that carries `hostcache`; a state carrying
    a `TimelineState` gets the probe: `(state, (latency, (row, counters),
    host row))`, the host row the cumulative host counters, the dirty
    fraction and the cumulative device-visible latency. The residency
    maps are updated in place, as `engine.build_step` updates them."""
    if params.hostcache is None:
        raise ValueError("build_tier_step needs CellParams.hostcache "
                         "(model.as_hc_params of the spec)")
    spec = resolve_spec(policy)
    core = _build_core(cfg, spec, closed_loop=closed_loop, params=params)
    hcp = params.hostcache
    cap_tot = probe.cap_pages(params, cfg.num_planes)
    k_slots = n_slots(hc_spec)

    def step(state: SimState, op):
        hc, sub, absorbed, row = tier_op(hc_spec, state.hostcache, op, hcp,
                                         closed_loop=closed_loop)
        red, wear = reduced_of(state), state.wear
        lat_k, occ_k, idle_k = [], [], []
        for k in range(k_slots):
            slba = sub["lba"][k]
            red, out = core(red, {key: v[k] for key, v in sub.items()},
                            state.loc[slba], state.loc_ep[slba], wear=wear)
            state.loc[slba] = out.loc_val
            state.loc_ep[slba] = out.loc_ep_val
            wear = out.wear
            lat_k.append(out.latency)
            occ_k.append(out.occ_delta)
            idle_k.append(out.idle_claim)
        lat_k = torch.stack(lat_k)
        latency = torch.where(absorbed, hcp.hit_ms, lat_k[0])
        dev_lat = hc.dev_lat_ms + slot_sum(lat_k, sub["is_write"])
        hc = hc._replace(dev_lat_ms=dev_lat)
        new_state = with_reduced(red, state.loc, state.loc_ep, wear)
        new_state = new_state._replace(hostcache=hc)
        if state.timeline is None:
            return new_state, latency
        # the occupancy changes are integer-valued: exact in any order
        tl, prow = probe.accumulate(
            state.timeline, is_pad=op["is_write"] < 0,
            counters=red.counters, occ_delta=torch.stack(occ_k).sum(),
            cap_pages=cap_tot, idle_claim=idle_k[0], wear=None)
        hrow = torch.cat([row, dev_lat[None]])
        return new_state._replace(timeline=tl), (latency, prow, hrow)

    return step


def tier_job(group, rows: bool) -> TierJob:
    """The tier pass's job for one host-cache `fleet.FleetGroup`."""
    c_cnt = group.ops["lba"].shape[0]
    ops = {k: group.ops[k].to(torch.int32 if k != "arrival_ms" else _F32)
           .contiguous() for k in ("arrival_ms", "lba", "is_write")}
    return TierJob(group.hostcache, ops, group.params.hostcache,
                   init_hc(group.hostcache, c_cnt,
                           device=ops["lba"].device),
                   group.closed_loop, rows)


def stream_job(cfg, group, tier_out, n_logical: int, timeline_ops=None):
    """The `ssd_step` job of one host group: each cell's (T*K) sub-op
    stream as a per-op stream (K = 1), no pad tail, the probe (if on) at
    K sub-ops per trace op a window."""
    c_cnt, n_sub = tier_out.sub["lba"].shape
    endurance = group.params.endurance is not None
    state0 = init_state(cfg, n_logical, n_cells=c_cnt, endurance=endurance,
                        device=group.ops["lba"].device)
    segs = {k: v.reshape(c_cnt, n_sub, 1) for k, v in tier_out.sub.items()}
    window = (None if timeline_ops is None
              else int(timeline_ops) * n_slots(group.hostcache))
    return StreamJob(resolve_spec(group.policy), segs, state0,
                     group.closed_loop, group.params, 0, None, window)


def assemble(cfg, group, tier_out, lat, final: SimState,
             timeline_ops=None):
    """One host group's results from its tier pass and its sub-op
    stream's run: (latency (C, T), final SimState with `hostcache`, and
    with the probe on `timeline` and the host windows)."""
    c_cnt, t_len = group.ops["lba"].shape
    k_slots = n_slots(group.hostcache)
    lat_k = lat.reshape(c_cnt, t_len, k_slots)
    kinds = tier_out.sub["is_write"].reshape(c_cnt, t_len, k_slots)
    hcp = group.params.hostcache
    latency = torch.where(tier_out.absorbed, hcp.hit_ms[:, None],
                          lat_k[..., 0])
    dev_cum = running_sum(tier_out.hc.dev_lat_ms, slot_sum(lat_k, kinds))
    hc = tier_out.hc._replace(
        dev_lat_ms=(dev_cum[:, -1] if t_len else tier_out.hc.dev_lat_ms))
    timeline = None
    if timeline_ops is not None:
        rows = final.timeline
        head = rows.head.reshape(c_cnt, t_len, k_slots, 2)
        trace_head = torch.stack([head[:, :, -1, probe.ROW_OCC],
                                  head[:, :, 0, probe.ROW_IDLE]], dim=-1)
        timeline = probe.from_rows(
            probe.ProbeRows(trace_head, rows.snap), latency,
            group.ops["is_write"], group.ops["arrival_ms"],
            cap_pages=probe.cap_pages(group.params, cfg.num_planes),
            window_ops=timeline_ops, t_len=t_len)
        hc = hc._replace(hwin=host_windows(
            torch.cat([tier_out.rows, dev_cum[..., None]], dim=-1),
            window_ops=timeline_ops, t_len=t_len))
    return latency, final._replace(timeline=timeline, hostcache=hc)
