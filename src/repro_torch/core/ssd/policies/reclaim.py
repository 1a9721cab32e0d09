"""Reclamation fragments: how (and when) pages leave the cache.

Port of the reference package's `policies/reclaim.py`. Fragments mutate
the engine's `StepCtx` in place, on 0-d tensors, in the reference's op
order, so every float result rounds exactly as the reference's does.
`ctx.ctr` is the step's private copy of the counter vector. Python-float
constants (`ctx.c_mig`, ...) enter each op as weak scalars, rounded once
to float32 — the reference's rounding. Where the reference's compiler
fuses `budget - n * c` into one FMA, `fma32` rounds it once too; the
other products round on their own, as there. A quotient by one of those
constants, `budget / c`, the reference's compiler turns into `budget *
float32(1 / c)`: the port multiplies by `ctx.inv_c_*` likewise. With
`ctx.track_wear` each fragment also books its P/E events into the local
plane's wear row (`ctx.pe_*_p`, `ctx.erase*_p`).
"""
from __future__ import annotations

import torch

from repro_torch.core.ssd.policies.state import (CTR, OVERRUN_PAGES,
                                                 WATERMARK_DEN,
                                                 WATERMARK_NUM, ceil_div,
                                                 fma32)

__all__ = ["migrate_reclaim", "dual_reclaim", "generation_completion",
           "gated_fallback_reclaim", "MIGRATE_FIELDS",
           "DUAL_RECLAIM_FIELDS", "REPROGRAM_FIELDS", "GATED_FIELDS"]

MIGRATE_FIELDS = ("slc_used", "valid_mig", "epoch", "counters")
DUAL_RECLAIM_FIELDS = ("slc_used", "rp_done", "trad_used", "valid_mig",
                       "epoch", "counters")
REPROGRAM_FIELDS = ("slc_used", "rp_done", "counters")
GATED_FIELDS = ("slc_used", "rp_done", "valid_mig", "epoch", "counters",
                "wear")

_I32, _F32 = torch.int32, torch.float32


def migrate_reclaim(ctx, alloc, *, pressure: bool) -> None:
    """Migrate-to-TLC reclamation of the tracked basic region.

    trigger="watermark" (`pressure=True`): at/above 7/8 occupancy the
    reclamation may use the whole per-plane gap plus a bounded OVERRUN
    into the arriving write (paper Fig. 7), but only while that keeps the
    cache writable. trigger="idle_gap": only accumulated device-idle
    budget, never stalling a write."""
    eff = alloc.eff_cap(ctx)
    if pressure:
        above_wm = ctx.slc_used >= (WATERMARK_NUM * eff // WATERMARK_DEN)
        overrun_allow = torch.where(ctx.slc_used < eff,
                                    OVERRUN_PAGES * ctx.c_mig, 0.0)
        budget = torch.where(above_wm, ctx.full_gap + overrun_allow,
                             ctx.dev_budget)
    else:
        budget = ctx.dev_budget
    mig = torch.minimum(ctx.valid_mig, (budget * ctx.inv_c_mig).to(_I32))
    ctx.valid_mig = ctx.valid_mig - mig
    used_ms = mig.to(_F32) * ctx.c_mig
    budget = fma32(-mig.to(_F32), ctx.c_mig, budget)    # fused there
    ctx.ctr[CTR["mig_w"]] += mig.to(_F32)
    blocks = ceil_div(ctx.slc_used, ctx.ppb_slc)
    erase_ms_total = blocks.to(_F32) * ctx.erase_ms
    can_erase = ((ctx.valid_mig == 0) & (ctx.slc_used > 0)
                 & (budget >= erase_ms_total))
    ctx.ctr[CTR["erases"]] += torch.where(can_erase, blocks, 0).to(_F32)
    if ctx.track_wear:
        # migrations program TLC pages; the erase cycles the region blocks
        ctx.pe_tlc_p = ctx.pe_tlc_p + mig.to(_F32)
        ctx.erase_p = ctx.erase_p + torch.where(can_erase, 1.0, 0.0)
    ctx.epoch_p = ctx.epoch_p + can_erase.to(_I32)
    ctx.slc_used = torch.where(can_erase, 0, ctx.slc_used)
    used_ms = used_ms + torch.where(can_erase, erase_ms_total, 0.0)
    if pressure:
        # overrun beyond the real gap stalls the arriving write
        ctx.conflict = ctx.conflict + torch.where(
            above_wm & ctx.is_write,
            torch.clamp_min(used_ms - ctx.full_gap, 0.0), 0.0)


def dual_reclaim(ctx) -> None:
    """Dual-allocation idle reclamation of the traditional region:
    (1) reprogram valid pages into the IPS region's free slots, (2) spill
    the overflow to free TLC, (3) erase clean blocks. Device-idle budget
    only."""
    budget = ctx.dev_budget
    # (1) traditional -> IPS region via reprogram (no TLC write)
    rp_avail = 2 * ctx.slc_used - ctx.rp_done
    ops1 = torch.minimum(torch.minimum(ctx.valid_mig, rp_avail),
                         (budget * ctx.inv_c_trad_rp).to(_I32))
    ctx.rp_done = ctx.rp_done + ops1
    ctx.valid_mig = ctx.valid_mig - ops1
    budget = fma32(-ops1.to(_F32), ctx.c_trad_rp, budget)
    ctx.ctr[CTR["rp_trad"]] += ops1.to(_F32)
    if ctx.track_wear:
        # batched reprogram fills spread page-granularly over the region
        ctx.pe_rp_p = ctx.pe_rp_p + ops1.to(_F32) * ctx.inv_buckets
    # (2) overflow: remaining trad valid pages -> free TLC
    rp_avail = 2 * ctx.slc_used - ctx.rp_done
    ops2 = torch.minimum(
        torch.where(rp_avail == 0, ctx.valid_mig, 0),
        (budget * ctx.inv_c_mig).to(_I32))
    ctx.valid_mig = ctx.valid_mig - ops2
    budget = fma32(-ops2.to(_F32), ctx.c_mig, budget)
    ctx.ctr[CTR["mig_w"]] += ops2.to(_F32)
    if ctx.track_wear:
        ctx.pe_tlc_p = ctx.pe_tlc_p + ops2.to(_F32)
    # (3) erase clean traditional blocks
    blocks = ceil_div(ctx.trad_used, ctx.ppb_slc)
    can_erase = ((ctx.valid_mig == 0) & (ctx.trad_used > 0)
                 & (budget >= blocks.to(_F32) * ctx.erase_ms))
    ctx.ctr[CTR["erases"]] += torch.where(can_erase, blocks, 0).to(_F32)
    if ctx.track_wear:
        # the traditional region's own blocks cycle, not the IPS region's
        ctx.erase_trad_p = ctx.erase_trad_p + torch.where(can_erase, 1.0,
                                                          0.0)
    ctx.epoch_p = ctx.epoch_p + can_erase.to(_I32)
    ctx.trad_used = torch.where(can_erase, 0, ctx.trad_used)


def gated_fallback_reclaim(ctx) -> None:
    """Reliability-gated reprogram: once the plane's reprogram count
    enters the gate's hysteresis band (`ctx.fallback_on`) the region is
    also reclaimed like a traditional cache — valid pages migrate to TLC
    and a watermark-full clean region is erased — on device-idle budget
    only, never stalling a write."""
    budget = torch.where(ctx.fallback_on, ctx.dev_budget, 0.0)
    mig = torch.minimum(ctx.valid_mig, (budget * ctx.inv_c_mig).to(_I32))
    ctx.valid_mig = ctx.valid_mig - mig
    budget = fma32(-mig.to(_F32), ctx.c_mig, budget)
    ctx.ctr[CTR["mig_w"]] += mig.to(_F32)
    blocks = ceil_div(ctx.slc_used, ctx.ppb_slc)
    # erase only a watermark-full region: an early erase costs a full
    # region P/E cycle for a handful of freed pages
    full_enough = ctx.slc_used >= (WATERMARK_NUM * ctx.cap_basic
                                   // WATERMARK_DEN)
    can_erase = ((ctx.valid_mig == 0) & full_enough
                 & (budget >= blocks.to(_F32) * ctx.erase_ms))
    ctx.ctr[CTR["erases"]] += torch.where(can_erase, blocks, 0).to(_F32)
    if ctx.track_wear:
        ctx.pe_tlc_p = ctx.pe_tlc_p + mig.to(_F32)
        ctx.erase_p = ctx.erase_p + torch.where(can_erase, 1.0, 0.0)
    ctx.epoch_p = ctx.epoch_p + can_erase.to(_I32)
    ctx.slc_used = torch.where(can_erase, 0, ctx.slc_used)
    ctx.rp_done = torch.where(can_erase, 0, ctx.rp_done)


def generation_completion(ctx) -> None:
    """Reprogram mechanism: a fully reprogrammed region (2 slots per used
    SLC page consumed) densified in place — it yields a fresh SLC layer."""
    fresh = (ctx.slc_used > 0) & (ctx.rp_done >= 2 * ctx.slc_used)
    ctx.slc_used = torch.where(fresh, 0, ctx.slc_used)
    ctx.rp_done = torch.where(fresh, 0, ctx.rp_done)
