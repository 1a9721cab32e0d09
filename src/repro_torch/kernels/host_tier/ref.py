"""Plain version of the `host_tier` kernel: the host half of the
reference's composed tier step (`hostcache/pipeline.py::build_tier_step`),
one trace op at a time in torch.

`tier_op` is one trace op's decisions from the host tier's own state —
lookup, promotion filter, insert and victim, absorption, the line-array
update, flush scheduling — and the K = 2 + flush_per_op device-visible
sub-ops they issue, in the reference's slot order: slot 0 the trace op
(or a pad when the tier absorbed it), slot 1 the eviction write-back (or
a pad), slots 2..K-1 the flush writes (or pads). A pad carries the trace
op's arrival, lba 0 and is_write -1. Nothing here reads the device: the
tier is a function of the trace and the spec. `tier_pass_ref` runs a
fleet's whole traces through it, cell after cell — what the kernel
computes in one launch — and the wrapper (`ops.tier_pass`) takes it for
tensors on the CPU.

Ties and order follow the reference exactly: the first hit way
(`argmax`), the first oldest way as the victim (invalid lines hold age
0), the flush slot's first oldest dirty way (clean ways masked with
2^31 - 1), distinct flush sets visited round robin, the `nth` filter
comparing float(count) >= promote_n, the watermark latch recomputed on
every op (pads too), the idle flush off in closed-loop mode, a write hit
invalidating its line in write-around mode, and the dirty fraction
multiplied by float32(1 / lines) (`hostcache.model.dirty_frac`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.hostcache.model import (H_CTR, HCParams, HCState,
                                         dirty_frac)
from repro_torch.hostcache.spec import HostCacheSpec

__all__ = ["TierJob", "TierOut", "tier_op", "tier_pass_ref", "n_slots"]

_I32, _F32 = torch.int32, torch.float32
_INT_BIG = 2**31 - 1


def n_slots(spec: HostCacheSpec) -> int:
    """K: the device sub-op slots a trace op issues."""
    return 2 + spec.flush_per_op


class TierJob(NamedTuple):
    """One fleet of host cells sharing a spec and a mode: `ops` (C, T)
    `arrival_ms` f32, `lba` i32, `is_write` i32; `params` HCParams of
    (C,) tensors; `hc0` HCState with a leading cell axis. `rows` asks
    for the per-op host rows (the telemetry probe's)."""
    spec: HostCacheSpec
    ops: dict
    params: HCParams
    hc0: HCState
    closed_loop: bool
    rows: bool = False


class TierOut(NamedTuple):
    """What the tier pass gives for one job: the device-visible sub-op
    stream `sub` ((C, T*K) `arrival_ms`, `lba`, `is_write`), `absorbed`
    (C, T) bool, `rows` (C, T, len(H_CTR) + 1) — the cumulative host
    counters and the dirty fraction after each op — or None, and the
    final HCState (`dev_lat_ms` as it came in: the device's share)."""
    sub: dict
    absorbed: torch.Tensor
    rows: Optional[torch.Tensor]
    hc: HCState


def tier_op(spec: HostCacheSpec, hc: HCState, op: dict, hcp: HCParams, *,
            closed_loop: bool):
    """One trace op through one cell's host tier. `op` holds 0-d
    `arrival_ms` f32, `lba` i32, `is_write` i32. Returns (new HCState,
    sub-ops {(K,) arrival_ms, lba, is_write}, absorbed, the host row
    (len(H_CTR) + 1,))."""
    t, lba, kind = op["arrival_ms"], op["lba"], op["is_write"]
    s_n, w_n, n_flush = spec.sets, spec.ways, spec.flush_per_op
    dev = lba.device
    w_idx = torch.arange(w_n, dtype=_I32, device=dev)
    is_pad = kind < 0
    live = ~is_pad
    is_write = kind == 1
    is_read = live & ~is_write

    # ---- lookup ----
    si = lba % s_n
    set_tags, set_dirty, set_age = hc.tag[si], hc.dirty[si], hc.age[si]
    match = (set_tags == lba) & live
    hit = match.any()
    way = torch.argmax(match.to(_I32))          # the first hit way
    tick = hc.tick + live.to(_I32)

    # ---- promotion filter (miss-insert gate) ----
    shadow_tag, shadow_cnt = hc.shadow_tag, hc.shadow_cnt
    if spec.promote == "always":
        promote_ok = live
    else:
        cnt = torch.where(shadow_tag[si] == lba, shadow_cnt[si] + 1,
                          torch.ones_like(shadow_cnt[si]))
        promote_ok = cnt.to(_F32) >= hcp.promote_n
        upd = live & ~hit                       # the filter sees misses
        shadow_tag = shadow_tag.clone()
        shadow_cnt = shadow_cnt.clone()
        shadow_tag[si] = torch.where(upd, lba, shadow_tag[si])
        shadow_cnt[si] = torch.where(upd, cnt, shadow_cnt[si])

    # ---- allocate on miss, victim ----
    want_insert = (is_read & ~hit) if spec.mode == "wa" else (live & ~hit)
    do_insert = want_insert & promote_ok
    vic = torch.argmin(set_age)                 # the first oldest way
    vic_tag = set_tags[vic]
    vic_dirty = (set_dirty[vic] > 0) & (vic_tag >= 0)
    evict_wb = do_insert & vic_dirty            # wb mode only

    # ---- absorption ----
    absorbed_w = (is_write & (hit | do_insert) if spec.mode == "wb"
                  else torch.zeros_like(hit))
    absorbed_r = is_read & hit
    absorbed = absorbed_r | absorbed_w

    # ---- the set's row ----
    hit_mask = (w_idx == way) & hit
    ins_mask = (w_idx == vic) & do_insert
    tag_row = set_tags
    age_row = torch.where(hit_mask, tick, set_age)
    dirty_row = set_dirty
    d_delta = torch.zeros((), dtype=_I32, device=dev)
    if spec.mode == "wa":
        inval = hit_mask & is_write             # superseded by the write
        tag_row = torch.where(inval, -1, tag_row)
        age_row = torch.where(inval, 0, age_row)
    if spec.mode == "wb":
        newly_dirty = is_write & hit & (set_dirty[way] == 0)
        dirty_row = torch.where(hit_mask & is_write, 1, dirty_row)
        d_delta = d_delta + newly_dirty.to(_I32)
    tag_row = torch.where(ins_mask, lba, tag_row)
    age_row = torch.where(ins_mask, tick, age_row)
    if spec.mode == "wb":
        ins_dirty = is_write & do_insert
        dirty_row = torch.where(ins_mask, ins_dirty.to(_I32), dirty_row)
        d_delta = d_delta + ins_dirty.to(_I32) - evict_wb.to(_I32)
    else:
        dirty_row = torch.where(ins_mask, 0, dirty_row)
    tag, dirty, age = hc.tag.clone(), hc.dirty.clone(), hc.age.clone()
    tag[si], dirty[si], age[si] = tag_row, dirty_row, age_row
    dirty_n = hc.dirty_n + d_delta

    # ---- flush scheduling (only write-back holds dirty lines) ----
    flushing = hc.flushing
    if spec.mode == "wb" and spec.flush == "watermark":
        lines = float(spec.lines)
        df = dirty_n.to(_F32)
        flushing = torch.where(
            df >= hcp.wm_hi * lines, torch.ones_like(flushing),
            torch.where(df <= hcp.wm_lo * lines, torch.zeros_like(flushing),
                        flushing))
        flush_on = (flushing == 1) & live
    elif spec.mode == "wb" and not closed_loop:
        gap = torch.clamp_min(t - hc.prev_t, 0.0)
        flush_on = live & (gap > hcp.flush_gap_ms) & (dirty_n > 0)
    else:
        flush_on = torch.zeros_like(live)
    f_idx = torch.arange(n_flush, dtype=_I32, device=dev)
    flush_sets = (hc.fcur + f_idx) % s_n        # distinct sets
    frows_d = dirty[flush_sets.long()]          # (F, W)
    has_dirty = (frows_d > 0).any(dim=1)
    fway = torch.argmin(torch.where(frows_d > 0, age[flush_sets.long()],
                                    _INT_BIG), dim=1)
    do_flush = flush_on & has_dirty
    flush_tag = tag[flush_sets.long(), fway]
    dirty[flush_sets.long(), fway] = torch.where(
        do_flush, 0, dirty[flush_sets.long(), fway])
    n_flushed = do_flush.to(_I32).sum().to(_I32)
    dirty_n = dirty_n - n_flushed
    fcur = torch.where(flush_on, (hc.fcur + n_flush) % s_n, hc.fcur)

    # ---- the device-visible sub-ops (pads are the core's no-ops) ----
    pad = torch.full((), -1, dtype=_I32, device=dev)
    zero = torch.zeros((), dtype=_I32, device=dev)
    k_slots = n_slots(spec)
    sub = {
        "arrival_ms": t.to(_F32).expand(k_slots).clone(),
        "lba": torch.cat([torch.stack([torch.where(absorbed, zero, lba),
                                       torch.where(evict_wb, vic_tag, zero)]),
                          torch.where(do_flush, flush_tag, zero)]),
        "is_write": torch.cat([
            torch.stack([torch.where(absorbed, pad, kind.to(_I32)),
                         torch.where(evict_wb, 1, pad)]),
            torch.where(do_flush, 1, pad)]),
    }
    hctr = hc.hctr + torch.cat([               # order == H_CTR
        torch.stack([hit, absorbed_r, hit & is_write, absorbed, absorbed_w,
                     live & ~absorbed]).to(_F32),
        n_flushed.to(_F32)[None], evict_wb.to(_F32)[None]])
    new = HCState(tag=tag, dirty=dirty, age=age, shadow_tag=shadow_tag,
                  shadow_cnt=shadow_cnt, tick=tick, dirty_n=dirty_n,
                  flushing=flushing, fcur=fcur,
                  prev_t=torch.where(live, t, hc.prev_t), hctr=hctr,
                  dev_lat_ms=hc.dev_lat_ms, hwin=hc.hwin)
    row = torch.cat([hctr, dirty_frac(dirty_n, spec)[None]])
    return new, sub, absorbed, row


def tier_pass_ref(job: TierJob) -> TierOut:
    """A fleet's traces through the host tier, cell by cell, op by op."""
    ops, spec = job.ops, job.spec
    c_cnt, t_len = ops["lba"].shape
    k_slots = n_slots(spec)
    dev = ops["lba"].device
    subs = {k: torch.empty((c_cnt, t_len * k_slots), dtype=dt, device=dev)
            for k, dt in (("arrival_ms", _F32), ("lba", _I32),
                          ("is_write", _I32))}
    absorbed = torch.empty((c_cnt, t_len), dtype=torch.bool, device=dev)
    rows = (torch.empty((c_cnt, t_len, len(H_CTR) + 1), dtype=_F32,
                        device=dev) if job.rows else None)
    finals = []
    for c in range(c_cnt):
        hc = HCState(*(None if x is None else x[c] for x in job.hc0))
        hcp = HCParams(*(x[c] for x in job.params))
        for i in range(t_len):
            op = {k: ops[k][c, i] for k in ("arrival_ms", "lba", "is_write")}
            hc, sub, absorbed[c, i], row = tier_op(
                spec, hc, op, hcp, closed_loop=job.closed_loop)
            for k in subs:
                subs[k][c, i * k_slots:(i + 1) * k_slots] = sub[k]
            if rows is not None:
                rows[c, i] = row
        finals.append(hc)
    final = HCState(*(None if xs[0] is None else torch.stack(xs)
                      for xs in zip(*finals)))
    return TierOut(sub=subs, absorbed=absorbed, rows=rows, hc=final)
