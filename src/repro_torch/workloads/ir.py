"""Trace IR: provenance-carrying page-level op records + transforms.

Port of the reference package's `workloads/ir.py`: a numpy copy,
value and dtype identical, of the Trace IR and its transforms.

The `Trace` record is the single currency of the workload engine: every
producer (MSR synthesizer, file parsers, scenario generators, the
multi-tenant mixer) emits one, and every consumer (simulator, fleet, sweep)
receives its `compile()`d op tensors. A Trace holds *unpadded* page-level
ops in the simulator's array contract —

    arrival_ms f32, lba i32 (page units), is_write i8 (1 write / 0 read),
    req_id i32

— plus provenance: a `source` string identifying the producer and a
`history` tuple listing every transform applied since. Padding no-ops
(is_write == -1) exist only in compiled tensors, never inside the IR.

Equivalence contract (DESIGN.md §7): `requests_to_ops` is a pure
refactoring split of the seed `workloads._to_ops` — expansion
(`from_requests`), bursty rewrite (`bursty_requests`) and padding
(`compile`/`pad_ops`) preserve array contents and dtypes bit-for-bit, so
the 11 MSR traces produce identical tensors through the IR and all
`BENCH_*` trajectories stay comparable (enforced by tests/test_workloads.py
against a vendored copy of the seed implementation).

Transforms are composable and cheap (numpy, no copies beyond the arrays
they rewrite); each returns a new Trace with the operation appended to
`history`, so any compiled tensor can be traced back to its recipe.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Sequence

import numpy as np

__all__ = ["PAD_OPS", "Trace", "from_requests", "bursty_requests",
           "requests_to_ops", "trace_from_requests", "trace_from_ops",
           "concat", "pad_ops", "repad_ops", "truncate_ops"]

PAD_OPS = 1 << 17               # fixed op count => one simulator compile

MODES = ("bursty", "daily")


@dataclass(frozen=True)
class Trace:
    """Unpadded page-level op record with provenance."""
    arrival_ms: np.ndarray      # (n,) f32, nondecreasing
    lba: np.ndarray             # (n,) i32, page units
    is_write: np.ndarray        # (n,) i8 — 1 write / 0 read (no padding)
    req_id: np.ndarray          # (n,) i32 — host request each page belongs to
    n_reqs: int                 # host request count
    source: str                 # producer tag, e.g. "synth:hm_0/seed=0"
    history: tuple = ()         # transform log, e.g. ("truncate(8192)",)

    @property
    def n_ops(self) -> int:
        return len(self.arrival_ms)

    def _derived(self, op: str, **changes) -> "Trace":
        return replace(self, history=self.history + (op,), **changes)

    # -- composable transforms ------------------------------------------

    def truncate(self, max_ops: int) -> "Trace":
        """First `max_ops` page ops (smoke runs / tests)."""
        if self.n_ops <= max_ops:
            return self
        rid = self.req_id[:max_ops]
        return self._derived(
            f"truncate({max_ops})",
            arrival_ms=self.arrival_ms[:max_ops], lba=self.lba[:max_ops],
            is_write=self.is_write[:max_ops], req_id=rid,
            n_reqs=int(rid.max()) + 1 if max_ops else 0)

    def scale_rate(self, factor: float) -> "Trace":
        """Speed the arrival process up by `factor` (>1 = more pressure:
        the same ops land in 1/factor of the wall time, shrinking idle)."""
        if factor <= 0:
            raise ValueError(f"rate factor must be positive, got {factor}")
        return self._derived(
            f"scale_rate({factor:g})",
            arrival_ms=(self.arrival_ms / np.float32(factor))
            .astype(np.float32))

    def shift_write_ratio(self, target: float, seed: int = 0) -> "Trace":
        """Flip whole requests read<->write until the page-level write
        ratio is ~`target`; direction flips at request granularity keep
        multi-page requests coherent."""
        if not 0.0 <= target <= 1.0:
            raise ValueError(f"write ratio must be in [0,1], got {target}")
        rng = np.random.default_rng(seed)
        is_w = self.is_write.copy()
        cur = float((is_w == 1).mean()) if self.n_ops else 0.0
        make_writes = target > cur
        # candidate requests currently in the majority-losing direction
        donor_mask = (is_w == 0) if make_writes else (is_w == 1)
        donor_reqs = np.unique(self.req_id[donor_mask])
        rng.shuffle(donor_reqs)
        pages_per = np.bincount(self.req_id, minlength=self.n_reqs)
        need = abs(target - cur) * self.n_ops
        moved, flip = 0.0, []
        for rid in donor_reqs:
            if moved >= need:
                break
            flip.append(rid)
            moved += pages_per[rid]
        if flip:
            sel = np.isin(self.req_id, np.asarray(flip))
            is_w[sel] = np.int8(1 if make_writes else 0)
        return self._derived(f"shift_write_ratio({target:g},seed={seed})",
                             is_write=is_w)

    def remap(self, total_logical_pages: int, base: int = 0) -> "Trace":
        """Clip/remap addresses into `[base, base + total_logical_pages)`
        (e.g. onto the simulator's `LOGICAL_SPACE_CAP` window, or a
        tenant's partition of it)."""
        lba = (self.lba.astype(np.int64) % total_logical_pages) + base
        return self._derived(
            f"remap({total_logical_pages},base={base})",
            lba=lba.astype(np.int32))

    def repeat(self, k: int) -> "Trace":
        """Re-run the workload back-to-back k times (paper Fig. 12a)."""
        if k <= 1:
            return self
        span = np.float64(self.arrival_ms[-1]) + 1.0 if self.n_ops else 1.0
        arrival = np.concatenate(
            [self.arrival_ms.astype(np.float64) + i * span
             for i in range(k)]).astype(np.float32)
        return self._derived(
            f"repeat({k})",
            arrival_ms=arrival, lba=np.tile(self.lba, k),
            is_write=np.tile(self.is_write, k),
            req_id=np.concatenate(
                [self.req_id + np.int32(i * self.n_reqs) for i in range(k)]),
            n_reqs=self.n_reqs * k)

    def to_bursty(self, total_logical_pages: int) -> "Trace":
        """Rewrite as the paper's bursty scenario: the trace's write volume
        as back-to-back sequential 32 KB (8-page) writes, no idle at all."""
        n_write_pages = int((self.is_write == 1).sum())
        req = bursty_requests(n_write_pages, total_logical_pages)
        out = from_requests(req, total_logical_pages, self.source)
        return replace(out, history=self.history + ("to_bursty",))

    # -- compilation to simulator op tensors ----------------------------

    def compile(self) -> Dict:
        """Padded op dict for `sim.run_trace` / `fleet.stack_ops` —
        identical layout, values and dtypes to the seed `_to_ops`."""
        return pad_ops({
            "arrival_ms": self.arrival_ms, "lba": self.lba,
            "is_write": self.is_write, "req_id": self.req_id,
            "n_ops": self.n_ops, "n_reqs": self.n_reqs,
        })


def from_requests(reqs: Dict, total_logical_pages: int, source: str,
                  history: tuple = ()) -> Trace:
    """Expand a request-level trace (arrival_ms, lba, pages, is_write) to a
    page-level Trace. Bit-identical to the expansion half of the seed
    `workloads._to_ops`."""
    counts = np.asarray(reqs["pages"], np.int64)
    o = int(counts.sum())
    arrival = np.repeat(reqs["arrival_ms"], counts).astype(np.float32)
    # NB: keep offs integer even when the trace is empty — a float64 empty
    # array would silently promote the lba arithmetic below to float.
    offs = (np.concatenate([np.arange(c) for c in counts]) if o
            else np.zeros(0, np.int64))
    lba = (np.repeat(np.asarray(reqs["lba"], np.int64), counts) + offs)
    lba = (lba % total_logical_pages).astype(np.int32)
    is_write = np.repeat(reqs["is_write"], counts).astype(np.int8)
    req_id = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    return Trace(arrival, lba, is_write, req_id, len(counts), source,
                 history)


def bursty_requests(n_write_pages: int, total_logical_pages: int) -> Dict:
    """Request-level bursty rewrite: sequential 32KB (8-page) writes of the
    given total volume, arrival accelerated to zero gaps (paper §III)."""
    total_pages = max(int(n_write_pages), 8)
    n_req = total_pages // 8
    lba = (np.arange(n_req) * 8) % (total_logical_pages - 8)
    return {"arrival_ms": np.zeros(n_req), "lba": lba,
            "pages": np.full(n_req, 8), "is_write": np.ones(n_req, bool)}


def trace_from_requests(req: Dict, mode: str, total_logical_pages: int,
                        source: str) -> Trace:
    """Request dict -> mode-resolved page-level Trace (the seed `_to_ops`
    pipeline minus padding)."""
    if mode == "bursty":
        total = int(np.asarray(req["pages"])[
            np.asarray(req["is_write"], bool)].sum())
        req = bursty_requests(total, total_logical_pages)
        source = f"{source}/bursty"
    elif mode != "daily":
        raise ValueError(mode)
    return from_requests(req, total_logical_pages, source)


def requests_to_ops(req: Dict, mode: str, total_logical_pages: int) -> Dict:
    """The seed `workloads._to_ops`, reassembled from IR pieces: expand a
    request-level trace to padded page-level op tensors."""
    return trace_from_requests(req, mode, total_logical_pages,
                               "requests").compile()


def trace_from_ops(ops: Dict, source: str = "ops") -> Trace:
    """Lift a compiled (padded) op dict back into the IR, stripping
    padding. Inverse of `Trace.compile` up to provenance."""
    n = int(ops["n_ops"])
    return Trace(
        arrival_ms=np.asarray(ops["arrival_ms"][:n], np.float32),
        lba=np.asarray(ops["lba"][:n], np.int32),
        is_write=np.asarray(ops["is_write"][:n], np.int8),
        req_id=np.asarray(ops["req_id"][:n], np.int32),
        n_reqs=int(ops["n_reqs"]), source=source, history=("from_ops",))


def concat(a: Trace, b: Trace, gap_ms: float = 0.0) -> Trace:
    """Run `b` after `a` (with an optional idle gap between them)."""
    start = (np.float64(a.arrival_ms[-1]) if a.n_ops else 0.0) + gap_ms
    return Trace(
        arrival_ms=np.concatenate(
            [a.arrival_ms,
             (b.arrival_ms.astype(np.float64) + start).astype(np.float32)]),
        lba=np.concatenate([a.lba, b.lba]),
        is_write=np.concatenate([a.is_write, b.is_write]),
        req_id=np.concatenate([a.req_id,
                               b.req_id + np.int32(a.n_reqs)]),
        n_reqs=a.n_reqs + b.n_reqs,
        source=f"concat({a.source},{b.source})",
        history=(f"concat(gap={gap_ms:g})",))


def pad_ops(ops: Dict) -> Dict:
    """Pad unpadded op arrays to a PAD_OPS multiple with padding no-ops
    (is_write = -1). Bit-identical to the padding half of the seed
    `_to_ops`.

    Contract (load-bearing for `workloads.compress` and the fleet's
    pad-tail trimming, DESIGN.md §12): pads are appended at the tail
    ONLY, and every pad op is *identical* — constant arrival (the last
    real arrival), lba 0, is_write -1, req_id -1. `repad_ops` extends
    with the same fill. Identical tail ops are what make the trimmed
    tail replayable to an exact fixed point instead of scanned."""
    o = int(ops["n_ops"])
    arrival = np.asarray(ops["arrival_ms"], np.float32)
    target = max(PAD_OPS, ((o + PAD_OPS - 1) // PAD_OPS) * PAD_OPS)
    pad = target - o
    last_t = arrival[-1] if o else 0.0
    return {
        "arrival_ms": np.concatenate([arrival, np.full(pad, last_t,
                                                       np.float32)]),
        "lba": np.concatenate([np.asarray(ops["lba"], np.int32),
                               np.zeros(pad, np.int32)]),
        "is_write": np.concatenate([np.asarray(ops["is_write"], np.int8),
                                    np.full(pad, -1, np.int8)]),
        "req_id": np.concatenate([np.asarray(ops["req_id"], np.int32),
                                  np.full(pad, -1, np.int32)]),
        "n_ops": o,
        "n_reqs": int(ops["n_reqs"]),
    }


def repad_ops(trace: Dict, target: int) -> Dict:
    """Extend a padded trace's arrays to `target` ops with padding no-ops
    (group alignment for `fleet.stack_ops`)."""
    cur = len(trace["arrival_ms"])
    if cur == target:
        return trace
    pad = target - cur
    last_t = trace["arrival_ms"][-1] if cur else np.float32(0.0)
    return {
        "arrival_ms": np.concatenate(
            [trace["arrival_ms"], np.full(pad, last_t, np.float32)]),
        "lba": np.concatenate([trace["lba"], np.zeros(pad, np.int32)]),
        "is_write": np.concatenate(
            [trace["is_write"], np.full(pad, -1, np.int8)]),
        "req_id": np.concatenate(
            [trace["req_id"], np.full(pad, -1, np.int32)]),
        "n_ops": trace["n_ops"],
        "n_reqs": trace["n_reqs"],
    }


def truncate_ops(trace: Dict, max_ops: int) -> Dict:
    """Cut a padded trace to its first `max_ops` ops (smoke runs / tests).

    Keeps the op-array contract (no re-padding: max_ops becomes the padded
    length) and clips `n_ops` accordingly."""
    out = {k: (v[:max_ops] if isinstance(v, np.ndarray) else v)
           for k, v in trace.items()}
    out["n_ops"] = min(trace["n_ops"], max_ops)
    return out
