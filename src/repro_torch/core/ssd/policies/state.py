"""Simulator state and per-cell parameters as tensors.

Port of the reference package's `policies/state.py`. `SimState` carries
the union of the state fields every mechanism may use, so fleets of
different policies share one carry layout. The narrow types are kept
exactly: `loc` int8, `loc_ep` int16, the five integer plane fields
int32 — or int16 when the state is *packed* (`init_state(packed=True)`,
gated by `can_pack`) — and `epoch` wrapping mod 2^16 in the packed
layout, congruent with the int16 `loc_ep` stamps it is compared against.

`SimState.wear` is the reference's optional trailing wear carry
(`endurance.model.WearState`): None unless the cell tracks endurance
(`CellParams.endurance` set), so a run without it keeps the seed layout.
`SimState.timeline`, after it as in the reference, is the telemetry
probe's: None with the probe off; the plain version's per-op executor
carries a `telemetry.probe.TimelineState` in it, the kernel leaves its
`ProbeRows` there, and the simulator's entry points replace either with
the `WindowedTimeline`. `SimState.hostcache`, last, is the host tier's
carry (`hostcache.model.HCState`), None unless the cell has a host cache
in front of it (`CellParams.hostcache` set). Leaves are 0-d (one cell)
or carry a leading cell axis (a fleet); `map_state` maps a function over
the tensor leaves, the nested carries' included.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CellParams", "SimState", "CTR", "init_state", "default_cell",
           "can_pack", "map_state", "WATERMARK_NUM",
           "WATERMARK_DEN", "OVERRUN_PAGES", "ceil_div", "fma32"]

# block-granularity reclamation model: pressure watermark + per-op overrun
WATERMARK_NUM, WATERMARK_DEN = 7, 8
OVERRUN_PAGES = 4               # one reclamation batch an arriving write may
#                                 stall behind (paper Fig. 7)


class CellParams(NamedTuple):
    """Per-cell simulation knobs (0-d tensors, or (C,) for a fleet)."""
    cap_basic: torch.Tensor   # i32 — SLC pages/plane in the basic/IPS region
    cap_trad: torch.Tensor    # i32 — dual-allocation traditional pages/plane
    idle_thr: torch.Tensor    # f32 — device-idle gap threshold (ms)
    waste_p: torch.Tensor     # f32 — AGC early-migration waste probability
    cap_boost: torch.Tensor   # i32 — adaptive allocation: extra SLC pages
    #                           unlocked above the watermark (0 otherwise)
    endurance: object = None  # endurance.model.EnduranceParams, or None:
    #                           wear tracking off
    hostcache: object = None  # hostcache.model.HCParams, or None: no host
    #                           cache in front of the device


class SimState(NamedTuple):
    busy: torch.Tensor        # (P,) f32 — plane free time
    slc_used: torch.Tensor    # (P,) i32|i16 — pages in current basic/IPS region
    rp_done: torch.Tensor     # (P,) i32|i16 — reprogram writes into that region
    trad_used: torch.Tensor   # (P,) i32|i16 — dual-alloc traditional pages
    valid_mig: torch.Tensor   # (P,) i32|i16 — valid pages in migratable region
    epoch: torch.Tensor       # (P,) i32|i16
    loc: torch.Tensor         # (N,) i8 — plane holding lba in cache, or -1
    loc_ep: torch.Tensor      # (N,) i16 — epoch at write (wraps)
    counters: torch.Tensor    # (10,) f32, see CTR
    prev_t: torch.Tensor      # () f32 — last arrival (device-level idle)
    idle_cum: torch.Tensor    # () f32 — cumulative usable device idle
    idle_seen: torch.Tensor   # (P,) f32 — idle_cum consumed per plane
    wear: object = None       # endurance.model.WearState, or None
    timeline: object = None   # telemetry.probe.TimelineState /
    #                           ProbeRows / WindowedTimeline, or None
    hostcache: object = None  # hostcache.model.HCState, or None


CTR = {name: i for i, name in enumerate(
    ["host_w", "slc_w", "tlc_w", "rp_host", "rp_agc", "rp_trad",
     "mig_w", "erases", "agc_waste", "conflict_ms"])}

INT16_MAX = 32767


def ceil_div(a, b):
    return (a + b - 1) // b


def fma32(a, b, c):
    """`a * b + c` on float32 with ONE rounding (a fused multiply-add).

    The reference's compiler (XLA on the CPU) contracts some of the
    core's multiply-adds into FMA instructions, so the port must round
    those once where the reference does (ROADMAP §C). PyTorch has no FMA
    op: the product is formed exactly in float64 (24 + 24 significant
    bits), the sum's float64 rounding error recovered exactly
    (Knuth's TwoSum), and the one case where rounding float64 -> float32
    could then differ from a single rounding — the float64 sum lying
    exactly halfway between two float32 values — is settled by the
    error's sign. `b` may be a Python float (rounded to float32 first, as
    a weak scalar is)."""
    a64 = a.to(torch.float64)
    b64 = torch.as_tensor(b, dtype=torch.float32,
                          device=a.device).to(torch.float64)
    c64 = c.to(torch.float64)
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    toward = torch.where(s > r64, torch.inf, -torch.inf).to(torch.float32)
    other = torch.nextafter(r, toward)
    halfway = (r64 + other.to(torch.float64)) * 0.5 == s
    beyond = (err != 0) & ((err > 0) == (s > r64))
    return torch.where(halfway & beyond, other, r)


def can_pack(cfg, n_logical: int, params: CellParams) -> bool:
    """True when every integer plane field provably fits int16, so
    `init_state(packed=True)` is exact (host-side check on one cell's
    caps). Bounds as in the reference: `slc_used <= cap_basic +
    cap_boost`, `rp_done <= 2 * slc_used`, `trad_used <= cap_trad`,
    `valid_mig <= ceil(n_logical / P)`; `epoch` wraps."""
    cap_basic = int(params.cap_basic)
    cap_trad = int(params.cap_trad)
    cap_boost = int(params.cap_boost)
    bound = max(2 * (cap_basic + cap_boost), cap_trad,
                ceil_div(n_logical, cfg.num_planes))
    return bound <= INT16_MAX


def init_state(cfg, n_logical: int, *, packed: bool = False,
               n_cells: int | None = None, endurance: bool = False,
               timeline: int | None = None, hostcache=None,
               device="cuda") -> SimState:
    """Fresh carry for one cell, or for `n_cells` cells with a leading
    cell axis. `packed` carries the integer plane fields as int16 (gate
    on `can_pack`); results are identical either way. `endurance`
    attaches a zero `WearState`; `timeline` (ops per window, or None) a
    fresh probe carry, `telemetry.probe.TimelineState`; `hostcache` (a
    `HostCacheSpec`, or None) an empty host tier of its geometry."""
    p = cfg.num_planes
    dt_i = torch.int16 if packed else torch.int32
    lead = () if n_cells is None else (n_cells,)

    def zeros(shape, dtype):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    wear = None
    if endurance:
        from repro_torch.core.ssd.endurance.model import init_wear
        wear = init_wear(cfg, n_cells, device=device)
    tl = None
    if timeline:
        from repro_torch.telemetry.probe import init_timeline
        tl = init_timeline(timeline, device=device)
        if n_cells is not None:
            tl = type(tl)(*(x.expand(n_cells).clone() for x in tl))
    hc = None
    if hostcache is not None:
        from repro_torch.hostcache.model import init_hc
        hc = init_hc(hostcache, n_cells, device=device)
    return SimState(
        busy=zeros((p,), torch.float32),
        slc_used=zeros((p,), dt_i),
        rp_done=zeros((p,), dt_i),
        trad_used=zeros((p,), dt_i),
        valid_mig=zeros((p,), dt_i),
        epoch=zeros((p,), dt_i),
        loc=torch.full(lead + (n_logical,), -1, dtype=torch.int8,
                       device=device),
        loc_ep=zeros((n_logical,), torch.int16),
        counters=zeros((len(CTR),), torch.float32),
        prev_t=zeros((), torch.float32),
        idle_cum=zeros((), torch.float32),
        idle_seen=zeros((p,), torch.float32),
        wear=wear,
        timeline=tl,
        hostcache=hc,
    )


def map_state(fn, *states):
    """The `SimState` (or `CellParams`) whose every tensor leaf is
    `fn(*leaves)` of the matching leaves of `states`; the wear carry,
    the timeline (or the endurance knobs) mapped leaf by leaf, None stays
    None."""
    def one(*xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], tuple):
            return type(xs[0])(*(one(*ys) for ys in zip(*xs)))
        return fn(*xs)
    return type(states[0])(*(one(*xs) for xs in zip(*states)))


def default_cell(cfg, spec, waste_p: float = 0.0, endurance=None, *,
                 device="cuda") -> CellParams:
    """CellParams matching the static config for one composition (the
    per-name defaults come from the allocation mechanism). `endurance`
    (an `EnduranceSpec`) turns wear tracking on; compositions that
    require it get the default `EnduranceSpec` when it is None."""
    from repro_torch.core.ssd.endurance.model import as_params
    from repro_torch.core.ssd.endurance.spec import EnduranceSpec
    from repro_torch.core.ssd.policies.allocation import ALLOCATIONS
    from repro_torch.core.ssd.policies.spec import requires_endurance
    if endurance is None and requires_endurance(spec):
        endurance = EnduranceSpec()
    cap_basic, cap_trad, cap_boost = \
        ALLOCATIONS[spec.allocation].default_caps(cfg)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return CellParams(cap_basic=i32(cap_basic), cap_trad=i32(cap_trad),
                      idle_thr=f32(cfg.idle_threshold_ms),
                      waste_p=f32(waste_p), cap_boost=i32(cap_boost),
                      endurance=None if endurance is None
                      else as_params(endurance, device=device))
