"""Cache-reclamation policies — the four schemes of the paper, adapted.

Copy of the reference's `repro/core/tiercache/policy.py`: the port
imports nothing of the reference package.

| Paper scheme | KV-cache behaviour here |
|---|---|
| BASELINE (Turbo-Write) | when the hot window fills, migrate it wholesale to the dense tier through a staging copy: 2x write traffic, one stall event (reclamation on the critical path) |
| IPS | when the hot window fills, in-place-switch half the window: 1x traffic, stall event but smaller burst (reprogram at "TLC speed" on the critical path) |
| IPS_AGC | in-place-switch one page per decode step in the background whenever at least one full page is hot: no stalls, traffic amortized (AGC valid-page migration, interruptible) |
| COOP | IPS_AGC with an enlarged hot window (traditional SLC region) and a 2-page background budget; sync IPS fallback if the window still fills |
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class Policy(enum.IntEnum):
    BASELINE = 0
    IPS = 1
    IPS_AGC = 2
    COOP = 3


@dataclass(frozen=True)
class PolicyPlan:
    """Static per-step repack plan (shapes must be trace-static)."""
    sync_pages: int        # pages moved when the sync trigger fires
    sync_at_occ: int       # hot occupancy (tokens) that fires the sync path
    bg_pages: int          # background pages moved whenever available
    staging_copy: bool     # baseline migrates through a staging buffer (2x)
    hot_window_mult: int   # window enlargement factor (COOP traditional region)


def plan_for(policy: Policy, hot_window: int, page_tokens: int) -> PolicyPlan:
    pages = hot_window // page_tokens
    if policy == Policy.BASELINE:
        return PolicyPlan(sync_pages=pages, sync_at_occ=hot_window,
                          bg_pages=0, staging_copy=True, hot_window_mult=1)
    if policy == Policy.IPS:
        return PolicyPlan(sync_pages=max(pages // 2, 1),
                          sync_at_occ=hot_window,
                          bg_pages=0, staging_copy=False, hot_window_mult=1)
    if policy == Policy.IPS_AGC:
        return PolicyPlan(sync_pages=max(pages // 2, 1),
                          sync_at_occ=hot_window,
                          bg_pages=1, staging_copy=False, hot_window_mult=1)
    if policy == Policy.COOP:
        return PolicyPlan(sync_pages=max(pages // 2, 1),
                          sync_at_occ=hot_window,
                          bg_pages=2, staging_copy=False, hot_window_mult=4)
    raise ValueError(policy)
