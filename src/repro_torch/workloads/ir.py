"""Trace IR: page-level op records and the padding contract with the
simulator.

A numpy copy of the part of the reference package's `workloads/ir.py`
that the paper sweep uses: request expansion (`from_requests`), the
bursty rewrite, and the `pad_ops` / `repad_ops` / `truncate_ops`
contract. Compiled op dicts hold

    arrival_ms f32, lba i32 (page units), is_write i8 (1 write / 0 read,
    -1 padding), req_id i32, plus the scalars n_ops / n_reqs

and are identical, value and dtype, to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

__all__ = ["PAD_OPS", "Trace", "from_requests", "bursty_requests",
           "trace_from_requests", "pad_ops", "repad_ops", "truncate_ops"]

PAD_OPS = 1 << 17               # padded lengths are multiples of this


@dataclass(frozen=True)
class Trace:
    """Unpadded page-level op record with provenance."""
    arrival_ms: np.ndarray      # (n,) f32, nondecreasing
    lba: np.ndarray             # (n,) i32, page units
    is_write: np.ndarray        # (n,) i8 — 1 write / 0 read (no padding)
    req_id: np.ndarray          # (n,) i32 — host request each page belongs to
    n_reqs: int                 # host request count
    source: str                 # producer tag, e.g. "synth:hm_0/seed=0"

    @property
    def n_ops(self) -> int:
        return len(self.arrival_ms)

    def compile(self) -> Dict:
        """Padded op dict for `sim.run_trace` / `fleet.stack_ops`."""
        return pad_ops({
            "arrival_ms": self.arrival_ms, "lba": self.lba,
            "is_write": self.is_write, "req_id": self.req_id,
            "n_ops": self.n_ops, "n_reqs": self.n_reqs,
        })


def from_requests(reqs: Dict, total_logical_pages: int,
                  source: str) -> Trace:
    """Expand a request-level trace (arrival_ms, lba, pages, is_write) to a
    page-level Trace."""
    counts = np.asarray(reqs["pages"], np.int64)
    o = int(counts.sum())
    arrival = np.repeat(reqs["arrival_ms"], counts).astype(np.float32)
    # keep offs integer even when the trace is empty — a float64 empty
    # array would promote the lba arithmetic below to float
    offs = (np.concatenate([np.arange(c) for c in counts]) if o
            else np.zeros(0, np.int64))
    lba = (np.repeat(np.asarray(reqs["lba"], np.int64), counts) + offs)
    lba = (lba % total_logical_pages).astype(np.int32)
    is_write = np.repeat(reqs["is_write"], counts).astype(np.int8)
    req_id = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    return Trace(arrival, lba, is_write, req_id, len(counts), source)


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
    """Request dict -> mode-resolved page-level Trace (unpadded)."""
    if mode == "bursty":
        total = int(np.asarray(req["pages"])[
            np.asarray(req["is_write"], bool)].sum())
        req = bursty_requests(total, total_logical_pages)
        source = f"{source}/bursty"
    elif mode != "daily":
        raise ValueError(mode)
    return from_requests(req, total_logical_pages, source)


def pad_ops(ops: Dict) -> Dict:
    """Pad unpadded op arrays to a PAD_OPS multiple with padding no-ops
    (is_write = -1).

    Contract (load-bearing for `workloads.compress`, the fleet's pad-tail
    trimming and the kernel's in-kernel tail replay): pads are appended
    at the tail ONLY, and every pad op is *identical* — constant arrival
    (the last real arrival), lba 0, is_write -1, req_id -1."""
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
