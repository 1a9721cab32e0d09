"""Allocation mechanisms: how SLC-mode cache capacity is provisioned.

Port of the reference package's `policies/allocation.py`. A mechanism
contributes the default per-plane region capacities for `CellParams`,
the *effective* basic-region capacity as a function of the live step
context (0-d tensors), and the state fields it relies on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from repro_torch.core.ssd.policies.state import WATERMARK_DEN, WATERMARK_NUM

__all__ = ["AllocationMech", "ALLOCATIONS"]


@dataclass(frozen=True)
class AllocationMech:
    """One allocation mechanism (see module docstring for the contract)."""
    name: str
    dual: bool                       # has a traditional second region
    state_fields: Tuple[str, ...]
    default_caps: Callable           # cfg -> (cap_basic, cap_trad, cap_boost)
    eff_cap: Callable                # ctx -> effective basic capacity
    wear_aware: bool = False         # place SLC programs in the coldest
    #                                  wear bucket (needs wear tracking)


def _static_caps(cfg):
    return cfg.slc_cap_pages, 0, 0


def _dual_caps(cfg):
    return cfg.coop_ips_pages, cfg.coop_trad_pages, 0


def _adaptive_caps(cfg):
    # default boost: double the static region under pressure
    return cfg.slc_cap_pages, 0, cfg.slc_cap_pages


def _fixed_cap(ctx):
    return ctx.cap_basic


def _adaptive_cap(ctx):
    """Dynamic SLC sizing: at/above the pressure watermark the plane
    unlocks `cap_boost` extra pages; an erase resets occupancy below the
    watermark and re-locks them."""
    above = ctx.slc_used >= (WATERMARK_NUM * ctx.cap_basic // WATERMARK_DEN)
    return torch.where(above, ctx.cap_basic + ctx.cap_boost, ctx.cap_basic)


ALLOCATIONS = {
    "static": AllocationMech(
        name="static", dual=False, state_fields=("slc_used",),
        default_caps=_static_caps, eff_cap=_fixed_cap),
    "dual": AllocationMech(
        name="dual", dual=True, state_fields=("slc_used", "trad_used"),
        default_caps=_dual_caps, eff_cap=_fixed_cap),
    "adaptive": AllocationMech(
        name="adaptive", dual=False, state_fields=("slc_used",),
        default_caps=_adaptive_caps, eff_cap=_adaptive_cap),
    "wear_min": AllocationMech(
        name="wear_min", dual=False, state_fields=("slc_used", "wear"),
        default_caps=_static_caps, eff_cap=_fixed_cap, wear_aware=True),
}
