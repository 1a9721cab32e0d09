"""Host-cache axis set: the static spec that keys the host tier
(DESIGN.md §14).

A verbatim copy of the reference package's `hostcache/spec.py` (pure
Python; `hostcache.model.as_hc_params` turns its float knobs into
tensors). In the reference the first six fields select code paths and
fix array shapes of the compiled tier step; in the port they are read at
run time from each cell's descriptor by the `host_tier` kernel (one
launch serves every spec of a grid), and only group a sweep's cells.

The "off" axis value is the *absence* of a spec: `SweepPoint.hostcache
= None` keeps `SimState.hostcache`/`CellParams.hostcache` absent (the
trailing-`None` contract), so the off path is the device-only run, bit
for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

__all__ = ["HostCacheSpec", "MODES", "PROMOTES", "FLUSHES"]

MODES = ("wb", "wt", "wa")          # write-back / write-through / write-around
PROMOTES = ("always", "nth")
FLUSHES = ("watermark", "idle")


@dataclass(frozen=True)
class HostCacheSpec:
    """Host block-cache axis set. All-defaults == a write-back,
    watermark-flushed, always-promote 128x8 cache (1024 page lines)."""
    mode: str = "wb"          # static — write policy (see MODES)
    promote: str = "always"   # static — miss-insert policy (see PROMOTES)
    flush: str = "watermark"  # static — dirty-flush scheduling (see FLUSHES)
    sets: int = 128           # static — set count (lba % sets indexes)
    ways: int = 8             # static — associativity (per-set LRU)
    flush_per_op: int = 2     # static — flush write slots per trace op
    promote_n: float = 2.0    # traced — insert on the Nth access (promote=nth)
    wm_hi: float = 0.75       # traced — dirty fraction arming the flush burst
    wm_lo: float = 0.5        # traced — dirty fraction disarming it
    hit_ms: float = 0.002     # traced — host (DRAM-tier) hit latency
    flush_gap_ms: float = 5.0  # traced — arrival gap opening an idle flush

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"hostcache mode {self.mode!r} not in {MODES} "
                             "(off == omit the spec entirely)")
        if self.promote not in PROMOTES:
            raise ValueError(
                f"hostcache promote {self.promote!r} not in {PROMOTES}")
        if self.flush not in FLUSHES:
            raise ValueError(
                f"hostcache flush {self.flush!r} not in {FLUSHES}")
        if self.sets < 1 or self.ways < 1 or self.flush_per_op < 1:
            raise ValueError("hostcache sets/ways/flush_per_op must be >= 1")
        if self.flush_per_op >= self.sets:
            # flush slots walk distinct sets round-robin; a slot count
            # reaching the set count would alias two slots to one set
            raise ValueError("hostcache needs flush_per_op < sets")

    @property
    def lines(self) -> int:
        return self.sets * self.ways

    @classmethod
    def parse(cls, text: str) -> "HostCacheSpec":
        """Spec from a `k=v,k=v` list (the `--hostcache` argument); the
        empty string gives the defaults."""
        spec = cls()
        if not text:
            return spec
        ftypes = {f.name: f.type for f in fields(cls)}
        updates = {}
        for item in text.split(","):
            key, sep, val = item.partition("=")
            key = key.strip()
            if not sep or key not in ftypes:
                raise ValueError(
                    f"bad --hostcache knob {item!r}; expected k=v with "
                    f"k in {sorted(ftypes)}")
            try:
                updates[key] = (val.strip() if ftypes[key] == "str"
                                else int(val) if ftypes[key] == "int"
                                else float(val))
            except ValueError:
                raise ValueError(f"bad --hostcache value {item!r}") from None
        return replace(spec, **updates)

    @property
    def tag(self) -> str:
        """Compact qualifier for SweepPoint keys / candidate labels:
        mode:flush plus any non-default knobs."""
        parts = [self.mode, self.flush]
        if self.promote == "nth":
            parts.append(f"p{self.promote_n:g}")
        if (self.sets, self.ways) != (128, 8):
            parts.append(f"{self.sets}x{self.ways}")
        if (self.wm_hi, self.wm_lo) != (0.75, 0.5):
            parts.append(f"wm{self.wm_hi:g}-{self.wm_lo:g}")
        if self.flush_per_op != 2:
            parts.append(f"f{self.flush_per_op}")
        if self.flush_gap_ms != 5.0:
            parts.append(f"g{self.flush_gap_ms:g}")
        if self.hit_ms != 0.002:
            parts.append(f"h{self.hit_ms:g}")
        return ":".join(parts)
