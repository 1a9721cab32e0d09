"""Endurance state and reliability math on tensors (DESIGN.md §9).

Port of the reference package's `core/ssd/endurance/model.py`. Wear is
carried beside the simulator state as `WearState`: per-plane,
per-wear-bucket P/E counters (`cfg.wear_buckets` buckets stand in for
the blocks of a plane's cache region), present only when the cell's
`CellParams.endurance` is set. Effective P/E cycles of a bucket:

    cycles[p, b] = (w_slc*pe_slc[p,b] + w_rp*pe_rp[p,b]) / (cap/B)
                   + w_erase * erase[p]

Every float here rounds where the reference rounds it as it runs. The
reference's per-op core is compiled (XLA on the CPU), and there the
compiler fuses some of these multiply-adds and sums a plane's buckets
in its own order; the functions the core calls (`bucket_cycles`,
`plane_cycles`, `trad_cycles`, `coldest_bucket`) follow that, each site
pinned by `tests/test_torch_endurance.py::WEAR_SITES`:

* a plane's bucket sums run left to right (`row_sum`);
* `w_slc*pe_slc + w_rp*pe_rp` is one FMA, `fma(w_slc, pe_slc, w_rp*pe_rp)`
  — in `plane_cycles` of a dual composition `fma(w_rp, S_rp, w_slc*S_slc)`;
* `... / cap + w_erase * erase` is fused in `plane_cycles` and
  `trad_cycles`, not in `bucket_cycles`.

`wear_summary` runs after the run, op by op as the reference's summary
does (nothing fused); its mean sums in float64 and rounds once.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.ssd.endurance.spec import EnduranceSpec
from repro_torch.core.ssd.policies.state import fma32

__all__ = ["EnduranceParams", "WearState", "as_params", "init_wear",
           "row_sum", "bucket_cycles", "plane_cycles", "trad_cycles",
           "coldest_bucket", "wear_summary"]

_F32 = torch.float32


class EnduranceParams(NamedTuple):
    """Per-cell endurance knobs (see `EnduranceSpec`): 0-d f32 tensors,
    or (C,) for a fleet."""
    w_slc: torch.Tensor
    w_tlc: torch.Tensor
    w_rp: torch.Tensor
    w_erase: torch.Tensor
    cycle_budget: torch.Tensor
    rp_budget: torch.Tensor
    read_penalty_ms: torch.Tensor
    rp_hysteresis: torch.Tensor


class WearState(NamedTuple):
    """Per-plane wear (B = cfg.wear_buckets); a leading cell axis for a
    fleet. The dual allocation's traditional region is tracked per plane
    (`pe_trad`/`erase_trad`), apart from the basic region's buckets."""
    pe_slc: torch.Tensor      # (P, B) f32 — basic-region SLC program events
    pe_rp: torch.Tensor       # (P, B) f32 — reprogram events
    pe_tlc: torch.Tensor      # (P,) f32 — TLC program events (GC + direct)
    erase: torch.Tensor       # (P,) f32 — basic-region erase events
    pe_trad: torch.Tensor     # (P,) f32 — traditional-region SLC programs
    erase_trad: torch.Tensor  # (P,) f32 — traditional-region erase events
    ops_seen: torch.Tensor    # () f32 — non-pad ops processed (EOL clock)
    eol_op: torch.Tensor      # () f32 — first op past cycle_budget, or -1


def as_params(spec: EnduranceSpec, device="cuda") -> EnduranceParams:
    return EnduranceParams(*(torch.tensor(getattr(spec, f), dtype=_F32,
                                          device=device)
                             for f in EnduranceParams._fields))


def init_wear(cfg, n_cells: int | None = None, device="cuda") -> WearState:
    p, b = cfg.num_planes, cfg.wear_buckets
    lead = () if n_cells is None else (n_cells,)

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=_F32, device=device)

    return WearState(pe_slc=zeros(p, b), pe_rp=zeros(p, b), pe_tlc=zeros(p),
                     erase=zeros(p), pe_trad=zeros(p), erase_trad=zeros(p),
                     ops_seen=zeros(),
                     eol_op=torch.full(lead, -1.0, dtype=_F32,
                                       device=device))


def row_sum(row: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in float32, left to right (the order the
    reference's compiled core reduces a plane's buckets in)."""
    acc = row[..., 0]
    for i in range(1, row.shape[-1]):
        acc = acc + row[..., i]
    return acc


def _cap(cap) -> torch.Tensor:
    return torch.clamp_min(torch.as_tensor(cap).to(_F32), 1.0)


def bucket_cycles(pe_slc, pe_rp, erase, endur: EnduranceParams, cap_basic):
    """Effective P/E cycles per wear bucket of a (B,) row with a 0-d
    `erase`, as the compiled core's end-of-life check rounds them."""
    b = pe_slc.shape[-1]
    per_bucket = torch.clamp_min(_cap(cap_basic) / b, 1.0)
    return (fma32(endur.w_slc, pe_slc, endur.w_rp * pe_rp) / per_bucket
            + endur.w_erase * erase)


def plane_cycles(pe_slc_row, pe_rp_row, erase_p, endur: EnduranceParams,
                 cap_basic, *, dual: bool):
    """Region-average effective cycles of one plane's basic region (the
    retention read penalty's input)."""
    s_slc, s_rp = row_sum(pe_slc_row), row_sum(pe_rp_row)
    if dual:
        a = fma32(endur.w_rp, s_rp, endur.w_slc * s_slc)
    else:
        a = fma32(endur.w_slc, s_slc, endur.w_rp * s_rp)
    return fma32(endur.w_erase, erase_p, a / _cap(cap_basic))


def trad_cycles(pe_trad, erase_trad, endur: EnduranceParams, cap_trad):
    """Per-block effective cycles of the dual allocation's traditional
    region (zero for the other allocations: its counters never move)."""
    return fma32(endur.w_erase, erase_trad,
                 endur.w_slc * pe_trad / _cap(cap_trad))


def coldest_bucket(pe_slc_row, pe_rp_row, endur: EnduranceParams):
    """`wear_min`'s placement: the first bucket of least weighted wear."""
    return torch.argmin(fma32(endur.w_slc, pe_slc_row,
                              endur.w_rp * pe_rp_row)).to(torch.int32)


def wear_summary(wear: WearState, endur: EnduranceParams, cap_basic,
                 cap_trad, page_bytes: int, host_pages) -> dict:
    """Lifetime / wear-leveling metrics from a final `WearState`, for one
    cell or a fleet (leading C axis on every leaf and knob):

    * `eff_cycles_max` — worst cache block: max over the basic region's
      buckets and the traditional region's planes;
    * `eff_cycles_mean` / `cycle_skew` — mean and max/mean over the
      basic region's buckets;
    * `tbw_proj_gb` — host GB written, projected to the point where the
      worst block exhausts `cycle_budget`;
    * `eol_op` — op index at which the worst block crossed the budget
      (-1: not reached).

    Each product and quotient rounds on its own, as the reference's
    op-by-op summary does; the sums (integer multiples of 1/B) and the
    mean accumulate in float64 and round once."""
    def k(x):                     # a knob against (..., P, B) or (..., P)
        return torch.as_tensor(x).to(_F32)[..., None, None]

    def k1(x):
        return torch.as_tensor(x).to(_F32)[..., None]

    b = wear.pe_slc.shape[-1]
    per_bucket = torch.clamp_min(_cap(cap_basic) / b, 1.0)[..., None, None]
    cyc = ((k(endur.w_slc) * wear.pe_slc + k(endur.w_rp) * wear.pe_rp)
           / per_bucket + k(endur.w_erase) * wear.erase[..., None])
    trad = (k1(endur.w_slc) * wear.pe_trad / _cap(cap_trad)[..., None]
            + k1(endur.w_erase) * wear.erase_trad)
    basic_max = cyc.amax(dim=(-2, -1))
    cyc_mean = cyc.to(torch.float64).mean(dim=(-2, -1)).to(_F32)
    cyc_max = torch.maximum(basic_max, trad.amax(dim=-1))
    host_gb = torch.as_tensor(host_pages).to(_F32) * (page_bytes
                                                      / 1024.0 ** 3)

    def total(x, dims):
        return x.to(torch.float64).sum(dim=dims).to(_F32)

    return {
        "eff_cycles_max": cyc_max,
        "eff_cycles_mean": cyc_mean,
        "cycle_skew": basic_max / torch.clamp_min(cyc_mean, 1e-9),
        "tbw_proj_gb": host_gb * endur.cycle_budget
        / torch.clamp_min(cyc_max, 1e-6),
        "eol_op": wear.eol_op,
        "pe_slc_total": total(wear.pe_slc, (-2, -1)),
        "pe_rp_total": total(wear.pe_rp, (-2, -1)),
        "pe_tlc_total": total(wear.pe_tlc, (-1,)),
        "pe_trad_total": total(wear.pe_trad, (-1,)),
        "erase_events": total(wear.erase, (-1,))
        + total(wear.erase_trad, (-1,)),
    }
