"""Idle-scheduler fragments: work that runs in idle time beyond triggered
reclamation.

Port of the reference package's `policies/idle.py`. "none" and "greedy"
contribute no fragment of their own; only AGC adds an idle activity.
"""
from __future__ import annotations

import torch

from repro_torch.core.ssd.policies.state import CTR, fma32

__all__ = ["agc_fill", "AGC_FIELDS"]

AGC_FIELDS = ("slc_used", "rp_done", "valid_mig", "counters")


def agc_fill(ctx, *, dual: bool, gated: bool = False) -> None:
    """Interruptible Active GC fill of remaining reprogram slots (last
    resort for dual allocation, primary idle mechanism for ips_agc).
    Interruptible at page granularity => safe to run in ANY per-plane
    gap; an arriving write waits at most half an op. Under the gated
    reprogram mechanism AGC respects the same reliability gate as host
    conversions."""
    agc_budget = ctx.full_gap
    rp_avail = 2 * ctx.slc_used - ctx.rp_done
    if dual:
        rp_avail = torch.where(ctx.valid_mig == 0, rp_avail, 0)
    if gated:
        rp_avail = torch.where(ctx.gate_ok, rp_avail, 0)
    # `agc_budget / c_agc` as the reference's compiler computes it
    ops = torch.minimum(rp_avail,
                        (agc_budget * ctx.inv_c_agc).to(torch.int32))
    ctx.rp_done = ctx.rp_done + ops
    opsf = ops.to(torch.float32)
    ctx.ctr[CTR["rp_agc"]] += opsf
    # one rounding: the reference's compiler fuses this multiply-add
    ctx.ctr[CTR["agc_waste"]] = fma32(opsf, ctx.waste_p,
                                      ctx.ctr[CTR["agc_waste"]])
    if ctx.track_wear:
        # page-granular fills spread evenly over the region's buckets
        ctx.pe_rp_p = ctx.pe_rp_p + opsf * ctx.inv_buckets
    # interruptible at page granularity: at most half an op
    agc_active = (2 * ctx.slc_used - ctx.rp_done) > 0
    ctx.conflict = ctx.conflict + torch.where(agc_active & ctx.is_write,
                                              ctx.c_agc * 0.5, 0.0)
