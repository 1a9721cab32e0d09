"""Endurance model knobs: the pure-Python half of the endurance engine.

A verbatim copy of the reference package's `core/ssd/endurance/spec.py`
(pure Python; `endurance.model.as_params` turns it into tensors).

`EnduranceSpec` is the hashable, jax-free description of one wear /
reliability configuration (DESIGN.md §9). It plays the same layering role
as `policies.spec`: sweep grids and the CLI carry it around, and
`endurance.model.as_params` converts it into the `EnduranceParams`
leaves of `CellParams`.

Semantics of the knobs (how they map to the paper / RARO, DESIGN.md §9):

  w_slc / w_tlc / w_rp — per-operation wear weights. A reprogram is the
      paper's extra program stress on an already-programmed SLC block
      (§IV.B): IPS trades migration traffic for it, so `w_rp > w_slc`
      makes the trade visible. All-zero weights (`EnduranceSpec.zero()`)
      make endurance tracking observation-free: latencies and every legacy
      state field stay bit-identical to a run without the model.
  w_erase — P/E cycles charged per region erase (the classic cycle
      marker; IPS generations never erase, which is exactly its wear win).
  cycle_budget — effective P/E cycles an SLC-mode block endures before
      end-of-life; drives the TBW projection, the EOL step and the
      retention read penalty ramp.
  rp_budget — reprogram passes a block tolerates before its reliability
      margin is gone (RARO's conversion gate): the `reprogram_gated`
      mechanism stops converting in place and falls back to migration
      once a plane's average per-page reprogram count crosses this.
  rp_hysteresis — width of the gate's early-warning band below
      `rp_budget`: once a plane's reprogram count enters
      [rp_budget - rp_hysteresis, rp_budget), the idle-gap migrate
      fallback already starts draining the region while in-place
      conversion is still allowed, so the write path does not flip
      abruptly from reprogram to TLC-direct against a full, undrained
      region at the budget boundary (gate thrash). 0 (the default)
      keeps the PR 4 single-threshold gate bit-identically: fallback
      and conversion switch at the same instant.
  read_penalty_ms — retention-derived read-cost penalty at end-of-life:
      reads on a plane pay `read_penalty_ms * min(cycles/budget, 1)`
      extra (read-retry as blocks age). Zero keeps reads untouched.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

__all__ = ["EnduranceSpec"]


@dataclass(frozen=True)
class EnduranceSpec:
    """One wear/reliability configuration (hashable; sweep-cell metadata)."""
    w_slc: float = 1.0
    w_tlc: float = 1.0
    w_rp: float = 2.5
    w_erase: float = 1.0
    cycle_budget: float = 30000.0
    rp_budget: float = 1e9
    read_penalty_ms: float = 0.0
    rp_hysteresis: float = 0.0

    @classmethod
    def zero(cls) -> "EnduranceSpec":
        """Observation-only tracking: zero wear weights, no read penalty —
        the bit-identity configuration (ci_check's zero-wear gate)."""
        return cls(w_slc=0.0, w_tlc=0.0, w_rp=0.0, w_erase=0.0,
                   read_penalty_ms=0.0)

    @classmethod
    def parse(cls, text: str) -> "EnduranceSpec":
        """Build from a CLI knob string: `k=v[,k=v...]` over the field
        names (empty string -> defaults). Unknown keys raise."""
        spec = cls()
        if not text.strip():
            return spec
        valid = {f.name for f in fields(cls)}
        updates = {}
        for item in text.split(","):
            key, sep, val = item.partition("=")
            key = key.strip()
            try:
                fval = float(val)
            except ValueError:
                fval = None
            if not sep or key not in valid or fval is None:
                raise ValueError(
                    f"bad --endurance knob {item!r}; expected k=v with k in "
                    f"{sorted(valid)} and a numeric v")
            updates[key] = fval
        return replace(spec, **updates)

    @property
    def tag(self) -> str:
        """Compact result-store qualifier (SweepPoint.key)."""
        parts = [f"rp{self.rp_budget:g}", f"w{self.w_rp:g}",
                 f"b{self.cycle_budget:g}"]
        if self.read_penalty_ms:
            parts.append(f"p{self.read_penalty_ms:g}")
        if self.rp_hysteresis:
            parts.append(f"h{self.rp_hysteresis:g}")
        return ":".join(parts)
