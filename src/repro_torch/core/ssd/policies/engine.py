"""Policy engine: the per-op core assembled from a mechanism composition
(`PolicySpec`), and the two executors built on it.

Port of the reference package's `policies/engine.py`. The fragments are
selected *statically* from the spec (Python `if`s), exactly as the
reference selects them at trace time, and run in its canonical order:

  1. triggered migrate reclamation        (mechanism == "migrate")
  1b. gated-reprogram fallback migration  (mechanism == "reprogram_gated")
  2. dual-region traditional reclamation  (allocation dual, idle != none)
  3. AGC slot fill                        (idle == "agc")
  4. generation completion                (mechanism == reprogram*)
  5. destination selection + service + bookkeeping (shared)

Endurance tracking is orthogonal to the composition: when
`CellParams.endurance` is set, every fragment and the shared section also
book P/E events into the wear carry (`SimState.wear`), reads pay the
retention penalty, `wear_min` places SLC programs in the coldest bucket,
the gated mechanism's reliability gate is live, and the `eol_op` clock
runs (the reference's `engine.py:245-267, 354-450`). Its float sites
round as the reference's compiler rounds them (`endurance.model`).

`_build_core` is the plain version of the per-op core: 0-d tensors, one
op at a time, every float rounded where the reference rounds it. It is
what the `ssd_step` CUDA kernel computes, and the kernel's plain version
(`kernels/ssd_step/ref.py`) runs it in a Python loop:

* `build_step` — the per-op executor: gather `loc[lba]`/`loc_ep[lba]`,
  run the core, write the residency entries back.
* `build_segment_step` — the (S, K) executor: one residency gather per
  segment, the core lane by lane with intra-segment hazards forwarded
  through `src`, one duplicate-free scatter through `scat_lba`.

Both executors update the residency maps of the state they are given in
place (a Python loop that copied a 192 KB map per op would spend its
time copying); the reduced carry stays functional. Wear rides the
per-op executor only: the segment executor refuses a wear carry, as the
reference's does.

The telemetry probe is observation only: the core also returns the op's
change in cache-resident pages on the serviced plane (`occ_delta`), the
idle budget it claimed (`idle_claim`) and, with wear, the plane's peak
effective cycles (`max_cycles`) — the reference's `engine.py:458-464` —
and nothing feeds back. The per-op executor turns them into the probe's
row when the state carries a `TimelineState`; the segment executor emits
them per lane with `emit_probe`. Off, both emit what they emit today.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.ssd.endurance.model import (WearState, bucket_cycles,
                                                  coldest_bucket,
                                                  plane_cycles, row_sum,
                                                  trad_cycles)
from repro_torch.core.ssd.policies import idle as idle_mod
from repro_torch.core.ssd.policies import reclaim
from repro_torch.core.ssd.policies.allocation import ALLOCATIONS
from repro_torch.core.ssd.policies.registry import resolve_spec
from repro_torch.core.ssd.policies.spec import (PolicySpec,
                                                requires_endurance,
                                                tracked_region)
from repro_torch.core.ssd.policies.state import (CTR, CellParams,
                                                 SimState, fma32)
from repro_torch.telemetry import probe

__all__ = ["StepCtx", "Reduced", "CoreOut", "build_step",
           "build_segment_step", "reduced_of", "with_reduced",
           "core_constants", "check_composition"]

_I8, _I16, _I32, _F32 = torch.int8, torch.int16, torch.int32, torch.float32


class StepCtx:
    """Mutable per-op execution context shared by mechanism fragments:
    the op's predicates, the local plane's state scalars (fragments
    mutate these), the step's counter copy and conflict accumulator, the
    idle budgets, the per-cell knobs and the composition's constants."""
    __slots__ = (
        "is_write", "is_pad",
        "slc_used", "rp_done", "trad_used", "valid_mig", "epoch_p",
        "ctr", "conflict",
        "dev_budget", "full_gap",
        "cap_basic", "cap_trad", "cap_boost", "waste_p",
        "c_mig", "c_agc", "c_trad_rp", "erase_ms", "ppb_slc",
        "inv_c_mig", "inv_c_agc", "inv_c_trad_rp",
        # wear tracking: track_wear is a Python bool; the pe_*/erase* rows
        # are the local plane's wear, mutated by fragments like plane
        # state; gate_ok/fallback_on are the gated mechanism's gate
        "track_wear", "inv_buckets", "pe_slc_p", "pe_rp_p", "pe_tlc_p",
        "erase_p", "pe_trad_p", "erase_trad_p", "gate_ok", "fallback_on",
    )


class Reduced(NamedTuple):
    """The core's carry: `SimState` minus the O(n_logical) residency
    maps — everything the per-op recurrence threads sequentially."""
    busy: torch.Tensor          # (P,) f32
    slc_used: torch.Tensor      # (P,) i32|i16
    rp_done: torch.Tensor       # (P,) i32|i16
    trad_used: torch.Tensor     # (P,) i32|i16
    valid_mig: torch.Tensor     # (P,) i32|i16
    epoch: torch.Tensor         # (P,) i32|i16
    counters: torch.Tensor      # (10,) f32
    prev_t: torch.Tensor        # () f32
    idle_cum: torch.Tensor      # () f32
    idle_seen: torch.Tensor     # (P,) f32


class CoreOut(NamedTuple):
    latency: torch.Tensor       # () f32 — 0 for pads
    loc_val: torch.Tensor       # () i8  — residency value for op's lba
    loc_ep_val: torch.Tensor    # () i16 — epoch stamp for op's lba
    wear: object = None         # the updated WearState, or None
    # observation-only extras for the telemetry probe
    occ_delta: torch.Tensor = None   # () f32 — resident pages after - before
    idle_claim: torch.Tensor = None  # () f32 — idle budget claimed
    max_cycles: torch.Tensor = None  # () f32 — the plane's peak cycles
    #                                  (wear only)


def core_constants(cfg) -> dict:
    """The composition-independent cost constants, as Python doubles.
    Each is rounded once to float32 where it meets a float32 tensor —
    the rounding the reference's weak-typed Python floats get. The
    `inv_*` entries are what the reference's compiler divides by instead
    (XLA's algebraic simplifier turns `x / c` for a constant `c` into `x
    * (1 / c)`, the reciprocal rounded to float32), exact float32
    values."""
    t_ = cfg.timing
    k = {"c_mig": t_.slc_read_ms + t_.tlc_write_ms,      # SLC -> TLC
         "c_agc": t_.tlc_read_ms + t_.reprogram_ms,      # AGC fill
         "c_trad_rp": t_.slc_read_ms + t_.reprogram_ms,  # trad -> IPS
         "erase_ms": t_.erase_ms}
    for name in ("c_mig", "c_agc", "c_trad_rp"):
        k["inv_" + name] = float(np.float32(1.0) / np.float32(k[name]))
    k["inv_buckets"] = float(np.float32(1.0)
                             / np.float32(cfg.wear_buckets))
    return k


def check_composition(spec: PolicySpec, params: CellParams) -> None:
    """Refuse a composition that needs wear tracking without it."""
    if requires_endurance(spec) and params.endurance is None:
        raise ValueError(
            f"{spec.composition} requires endurance tracking: pass "
            "CellParams.endurance (default_cell attaches the default "
            "EnduranceSpec knobs for such compositions)")


def _build_core(cfg, spec: PolicySpec, *, closed_loop: bool,
                params: CellParams):
    """The whole per-op computation as a function of the reduced carry.

    Returns `core(red, op, old_raw, old_ep, wear=None) -> (Reduced,
    CoreOut)`; `op` holds 0-d `arrival_ms` f32, `lba` i32, `is_write`
    i32; `old_raw`/`old_ep` are the op's residency entries (i8, i16);
    `wear` is the cell's WearState when `params.endurance` is set."""
    check_composition(spec, params)
    t_ = cfg.timing
    p_total = cfg.num_planes
    alloc = ALLOCATIONS[spec.allocation]
    dual = alloc.dual
    gated = spec.mechanism == "reprogram_gated"
    use_rp = spec.mechanism in ("reprogram", "reprogram_gated")
    run_migrate = spec.mechanism == "migrate"
    run_dual_reclaim = dual and spec.idle != "none"
    run_agc = spec.idle == "agc"
    pressure = spec.trigger == "watermark"
    tracked = tracked_region(spec)
    consts = core_constants(cfg)
    endur = params.endurance
    use_endurance = endur is not None
    n_buckets = cfg.wear_buckets
    # gated regions keep ips's conservative read model: cache hits read at
    # TLC speed (residency is tracked for migration accounting only)
    hit_read_ms = t_.tlc_read_ms if gated else t_.slc_read_ms

    def core(red: Reduced, op, old_raw, old_ep, wear: WearState = None):
        t, lba, kind = op["arrival_ms"], op["lba"], op["is_write"]
        plane = lba % p_total
        # integer plane state may be carried packed (int16) — compute in
        # int32 (exact for both widths) and cast back at the write
        dt_i = red.slc_used.dtype

        ctx = StepCtx()
        ctx.is_pad = kind < 0
        ctx.is_write = kind == 1
        busy_p = red.busy[plane]
        ctx.ctr = red.counters.clone()
        ctx.slc_used = red.slc_used[plane].to(_I32)
        ctx.rp_done = red.rp_done[plane].to(_I32)
        ctx.trad_used = red.trad_used[plane].to(_I32)
        ctx.valid_mig = red.valid_mig[plane].to(_I32)
        ctx.epoch_p = red.epoch[plane].to(_I32)
        ctx.conflict = torch.zeros((), dtype=_F32, device=busy_p.device)
        ctx.cap_basic, ctx.cap_trad = params.cap_basic, params.cap_trad
        ctx.cap_boost, ctx.waste_p = params.cap_boost, params.waste_p
        ctx.c_mig, ctx.c_agc = consts["c_mig"], consts["c_agc"]
        ctx.c_trad_rp, ctx.erase_ms = consts["c_trad_rp"], consts["erase_ms"]
        ctx.inv_c_mig, ctx.inv_c_agc = consts["inv_c_mig"], consts["inv_c_agc"]
        ctx.inv_c_trad_rp = consts["inv_c_trad_rp"]
        ctx.ppb_slc = cfg.pages_per_slc_block
        ctx.track_wear = use_endurance
        if use_endurance:
            ctx.inv_buckets = consts["inv_buckets"]
            ctx.pe_slc_p = wear.pe_slc[plane]
            ctx.pe_rp_p = wear.pe_rp[plane]
            ctx.pe_tlc_p = wear.pe_tlc[plane]
            ctx.erase_p = wear.erase[plane]
            ctx.pe_trad_p = wear.pe_trad[plane]
            ctx.erase_trad_p = wear.erase_trad[plane]
            if gated:
                # RARO-style reliability gate: the plane's per-page average
                # reprogram count against the budget; the hysteresis band
                # [rp_budget - rp_hysteresis, rp_budget) pre-arms the
                # migrate fallback while conversion is still allowed
                rp_count = row_sum(ctx.pe_rp_p) / torch.clamp_min(
                    params.cap_basic.to(_F32), 1.0)
                ctx.gate_ok = rp_count < endur.rp_budget
                ctx.fallback_on = (rp_count
                                   >= endur.rp_budget - endur.rp_hysteresis)

        # 1. idle work on this plane, lazily applied for [busy_p, t):
        # inter-arrival gaps above the threshold accumulate as device
        # idle that every plane may consume when next touched
        idle_cum = red.idle_cum
        idle_seen_p = red.idle_seen[plane]
        if not closed_loop:
            gap = torch.clamp_min(t - red.prev_t, 0.0)
            idle_cum = idle_cum + torch.where(
                (gap > params.idle_thr) & ~ctx.is_pad, gap, 0.0)
            ctx.dev_budget = torch.where(ctx.is_pad, 0.0,
                                         idle_cum - idle_seen_p)
            ctx.full_gap = torch.where(ctx.is_pad, 0.0,
                                       torch.clamp_min(t - busy_p, 0.0))
            if run_migrate:
                reclaim.migrate_reclaim(ctx, alloc, pressure=pressure)
            if gated:
                reclaim.gated_fallback_reclaim(ctx)
            if run_dual_reclaim:
                reclaim.dual_reclaim(ctx)
            if run_agc:
                idle_mod.agc_fill(ctx, dual=dual, gated=gated)

        # generation completion: fully reprogrammed region -> fresh layer
        if use_rp:
            reclaim.generation_completion(ctx)

        # 2. service the op
        is_write, is_pad, conflict = ctx.is_write, ctx.is_pad, ctx.conflict
        slc_used, rp_done = ctx.slc_used, ctx.rp_done
        trad_used, valid_mig, epoch_p = (ctx.trad_used, ctx.valid_mig,
                                         ctx.epoch_p)
        if closed_loop:
            wait = torch.zeros((), dtype=_F32, device=busy_p.device)
            start = busy_p + conflict
        else:
            wait = torch.clamp_min(busy_p - t, 0.0)
            start = t + wait + conflict

        old = old_raw.to(_I32)
        old_clip = torch.clamp(old, 0, p_total - 1)
        # epoch may have been bumped this step (erase) for the local plane
        epoch_eff = torch.where(old_clip == plane, epoch_p,
                                red.epoch[old_clip].to(_I32))
        old_ok = (old >= 0) & (old_ep == epoch_eff.to(_I16))

        to_slc = is_write & (slc_used < alloc.eff_cap(ctx))
        if dual:
            to_trad = is_write & ~to_slc & (trad_used < params.cap_trad)
        else:
            to_trad = torch.zeros_like(to_slc)
        if use_rp:
            rp_avail = 2 * slc_used - rp_done
            to_rp = is_write & ~to_slc & ~to_trad & (rp_avail > 0)
            if gated:
                # budget-exhausted blocks take no more reprogram stress
                to_rp = to_rp & ctx.gate_ok
        else:
            to_rp = torch.zeros_like(to_slc)
        to_tlc = is_write & ~to_slc & ~to_trad & ~to_rp

        prog_t = torch.where(to_slc | to_trad, t_.slc_write_ms,
                             torch.where(to_rp, t_.reprogram_ms,
                                         t_.tlc_write_ms))
        read_t = torch.where(old_ok, hit_read_ms, t_.tlc_read_ms)
        if use_endurance:
            # retention read cost: aged blocks need read-retry, ramping to
            # read_penalty_ms at the cycle budget (worst of the plane's
            # basic and traditional regions)
            aged = torch.maximum(
                plane_cycles(ctx.pe_slc_p, ctx.pe_rp_p, ctx.erase_p, endur,
                             params.cap_basic, dual=dual),
                trad_cycles(ctx.pe_trad_p, ctx.erase_trad_p, endur,
                            params.cap_trad))
            age = torch.clamp(
                aged / torch.clamp_min(endur.cycle_budget, 1e-9), 0.0, 1.0)
            read_t = fma32(endur.read_penalty_ms, age, read_t)
        service = torch.where(is_write, prog_t, read_t)
        service = torch.where(is_pad, 0.0, service)
        latency = torch.where(is_pad, 0.0, wait + conflict + service)
        busy_new = torch.where(is_pad, busy_p, start + service)

        # wear placement: a basic-region program lands in the sequential
        # fill position's bucket (the coldest under wear-aware
        # allocation); reprogram stress at the conversion position
        if use_endurance:
            if alloc.wear_aware:
                bkt_slc = coldest_bucket(ctx.pe_slc_p, ctx.pe_rp_p, endur)
            else:
                bkt_slc = torch.clamp(
                    slc_used * n_buckets
                    // torch.clamp_min(params.cap_basic, 1),
                    0, n_buckets - 1)
            bkt_rp = torch.clamp(
                rp_done * n_buckets // torch.clamp_min(2 * slc_used, 1),
                0, n_buckets - 1)

        # bookkeeping
        slc_used = slc_used + to_slc.to(_I32)
        trad_used = trad_used + to_trad.to(_I32)
        rp_done = rp_done + to_rp.to(_I32)

        # residency tracking covers exactly the migratable region
        if tracked == "basic":
            track_new = to_slc | to_rp
        elif tracked == "trad":
            track_new = to_trad
        else:
            track_new = torch.zeros_like(to_slc)
        # invalidate previous cached copy (only on real writes)
        valid_dec = (is_write & old_ok).to(_I32)

        ctr = ctx.ctr
        ctr[CTR["host_w"]] += is_write.to(_F32)
        ctr[CTR["slc_w"]] += (to_slc | to_trad).to(_F32)
        ctr[CTR["tlc_w"]] += to_tlc.to(_F32)
        ctr[CTR["rp_host"]] += to_rp.to(_F32)
        ctr[CTR["conflict_ms"]] += torch.where(is_write, conflict, 0.0)

        # mapping update: writes set the new location; reads/pads keep it
        loc_val = torch.where(is_write,
                              torch.where(track_new, plane, -1),
                              old).to(_I8)
        loc_ep_val = torch.where(is_write & track_new, epoch_p.to(_I16),
                                 old_ep)

        wear_new = max_cycles = None
        if use_endurance:
            pe_slc_new = ctx.pe_slc_p.clone()
            pe_slc_new[bkt_slc] += torch.where(to_slc, 1.0, 0.0)
            pe_rp_new = ctx.pe_rp_p.clone()
            pe_rp_new[bkt_rp] += torch.where(to_rp, 1.0, 0.0)
            pe_tlc_new = ctx.pe_tlc_p + torch.where(to_tlc, 1.0, 0.0)
            pe_trad_new = ctx.pe_trad_p + torch.where(to_trad, 1.0, 0.0)
            ops_seen = wear.ops_seen + torch.where(is_pad, 0.0, 1.0)
            max_cycles = torch.maximum(
                bucket_cycles(pe_slc_new, pe_rp_new, ctx.erase_p, endur,
                              params.cap_basic).max(),
                trad_cycles(pe_trad_new, ctx.erase_trad_p, endur,
                            params.cap_trad))
            tripped = max_cycles >= endur.cycle_budget
            rows = {"pe_slc": pe_slc_new, "pe_rp": pe_rp_new,
                    "pe_tlc": pe_tlc_new, "erase": ctx.erase_p,
                    "pe_trad": pe_trad_new, "erase_trad": ctx.erase_trad_p}
            leaves = {}
            for name, row in rows.items():
                leaves[name] = getattr(wear, name).clone()
                leaves[name][plane] = row
            wear_new = WearState(
                **leaves, ops_seen=ops_seen,
                eol_op=torch.where((wear.eol_op < 0) & tripped & ~is_pad,
                                   ops_seen, wear.eol_op))

        # observation-only extras for the telemetry probe
        occ_delta = ((slc_used + trad_used)
                     - (red.slc_used[plane].to(_I32)
                        + red.trad_used[plane].to(_I32))).to(_F32)
        idle_claim = torch.where(is_pad, 0.0, idle_cum - idle_seen_p)

        busy = red.busy.clone()
        busy[plane] = torch.where(is_pad, busy_p, busy_new)
        slc = red.slc_used.clone()
        slc[plane] = slc_used.to(dt_i)
        rpd = red.rp_done.clone()
        rpd[plane] = rp_done.to(dt_i)
        trad = red.trad_used.clone()
        trad[plane] = trad_used.to(dt_i)
        vm = red.valid_mig.clone()
        vm[plane] = valid_mig.to(dt_i)
        vm[old_clip] += (-valid_dec).to(dt_i)
        vm[plane] += torch.where(track_new, 1, 0).to(dt_i)
        ep = red.epoch.clone()
        ep[plane] = epoch_p.to(dt_i)
        seen = red.idle_seen.clone()
        seen[plane] = torch.where(is_pad, idle_seen_p, idle_cum)
        new_red = Reduced(
            busy=busy, slc_used=slc, rp_done=rpd, trad_used=trad,
            valid_mig=vm, epoch=ep, counters=ctr,
            prev_t=torch.where(is_pad, red.prev_t, t),
            idle_cum=idle_cum, idle_seen=seen)
        return new_red, CoreOut(latency=latency, loc_val=loc_val,
                                loc_ep_val=loc_ep_val, wear=wear_new,
                                occ_delta=occ_delta, idle_claim=idle_claim,
                                max_cycles=max_cycles)

    return core


def reduced_of(state: SimState) -> Reduced:
    """The reduced carry view of a SimState (shared leaves, no copy)."""
    return Reduced(busy=state.busy, slc_used=state.slc_used,
                   rp_done=state.rp_done, trad_used=state.trad_used,
                   valid_mig=state.valid_mig, epoch=state.epoch,
                   counters=state.counters, prev_t=state.prev_t,
                   idle_cum=state.idle_cum, idle_seen=state.idle_seen)


def with_reduced(red: Reduced, loc, loc_ep, wear=None,
                 timeline=None) -> SimState:
    """Reassemble a SimState from a reduced carry, residency maps, the
    wear carry (None without endurance) and the timeline (None with the
    probe off)."""
    return SimState(busy=red.busy, slc_used=red.slc_used,
                    rp_done=red.rp_done, trad_used=red.trad_used,
                    valid_mig=red.valid_mig, epoch=red.epoch, loc=loc,
                    loc_ep=loc_ep, counters=red.counters,
                    prev_t=red.prev_t, idle_cum=red.idle_cum,
                    idle_seen=red.idle_seen, wear=wear, timeline=timeline)


def build_step(cfg, policy, *, closed_loop: bool, params: CellParams):
    """The per-op executor specialized to (composition, mode):
    `step(state, op) -> (state, latency)`. The residency maps of `state`
    are updated in place; the wear carry rides along when
    `params.endurance` is set. A state that carries a
    `telemetry.probe.TimelineState` gets the probe: the step then
    returns `(state, (latency, (row, counters)))`, the row being
    `probe.accumulate`'s — occupancy fraction, clamped idle claim and,
    with wear, the plane's peak cycles."""
    spec = resolve_spec(policy)
    core = _build_core(cfg, spec, closed_loop=closed_loop, params=params)
    use_endurance = params.endurance is not None
    cap_tot = probe.cap_pages(params, cfg.num_planes)

    def step(state: SimState, op):
        lba = op["lba"]
        red, out = core(reduced_of(state), op, state.loc[lba],
                        state.loc_ep[lba], wear=state.wear)
        state.loc[lba] = out.loc_val
        state.loc_ep[lba] = out.loc_ep_val
        new_state = with_reduced(red, state.loc, state.loc_ep, out.wear)
        if state.timeline is None:
            return new_state, out.latency
        tl, row = probe.accumulate(
            state.timeline, is_pad=op["is_write"] < 0,
            counters=red.counters, occ_delta=out.occ_delta,
            cap_pages=cap_tot, idle_claim=out.idle_claim,
            wear=out.max_cycles if use_endurance else None)
        return new_state._replace(timeline=tl), (out.latency, row)

    return step


def build_segment_step(cfg, policy, *, closed_loop: bool,
                       params: CellParams, emit_probe: bool = False):
    """The compressed-segment executor: `seg_step((red, loc, loc_ep),
    seg) -> ((red, loc, loc_ep), latency (K,))` for one segment of K
    consecutive ops from `workloads.compress` — `arrival_ms`/`lba`/
    `is_write` plus the hazard plan `src`/`scat_lba`. `loc`/`loc_ep` are
    updated in place.

    Every value a lane consumes equals what the per-op executor would
    have gathered after its predecessor's write-back, so the two
    executors agree bit for bit. With `emit_probe` the step emits
    `(latency (K,), occ_delta (K,), idle_claim (K,), counters (K, C))`:
    each lane's probe extras and the cumulative counters after it (the
    last row is the reference's per-segment snapshot)."""
    spec = resolve_spec(policy)
    if params.endurance is not None:
        raise ValueError("the segment executor does not carry wear state; "
                         "run endurance cells through the per-op step")
    core = _build_core(cfg, spec, closed_loop=closed_loop, params=params)

    def seg_step(carry, seg):
        red, loc, loc_ep = carry
        lba_k = seg["lba"]
        k = lba_k.shape[0]
        n_logical = loc.shape[0]
        old_k = loc[lba_k]                       # (K,) i8 — one gather
        old_ep_k = loc_ep[lba_k]                 # (K,) i16
        buf_loc = torch.zeros(k, dtype=_I8, device=loc.device)
        buf_ep = torch.zeros(k, dtype=_I16, device=loc.device)
        lat, occ, idle, ctr = [], [], [], []
        for i in range(k):
            src = seg["src"][i]
            use_buf = src >= 0
            s = torch.clamp(src, 0, k - 1)
            old = torch.where(use_buf, buf_loc[s], old_k[i])
            old_ep = torch.where(use_buf, buf_ep[s], old_ep_k[i])
            red, out = core(
                red, {"arrival_ms": seg["arrival_ms"][i], "lba": lba_k[i],
                      "is_write": seg["is_write"][i]}, old, old_ep)
            buf_loc[i] = out.loc_val
            buf_ep[i] = out.loc_ep_val
            lat.append(out.latency)
            if emit_probe:
                occ.append(out.occ_delta)
                idle.append(out.idle_claim)
                ctr.append(red.counters)
        # one duplicate-free scatter: only each lba's final lane carries
        # its real lba; superseded lanes hold a sentinel and drop
        scat = seg["scat_lba"]
        keep = (scat >= 0) & (scat < n_logical)
        loc[scat[keep]] = buf_loc[keep]
        loc_ep[scat[keep]] = buf_ep[keep]
        if emit_probe:
            return (red, loc, loc_ep), (torch.stack(lat), torch.stack(occ),
                                        torch.stack(idle), torch.stack(ctr))
        return (red, loc, loc_ep), torch.stack(lat)

    return seg_step
