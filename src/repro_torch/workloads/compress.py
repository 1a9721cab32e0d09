"""Event compression: the host-side trace transform feeding the
compressed-segment executor (`policies.engine.build_segment_step` and
the `ssd_step` kernel). A numpy copy of the reference package's
`workloads/compress.py`; the plans it emits are identical array for
array.

* **Pad tail.** `ir.pad_ops` pads every trace to a `PAD_OPS` multiple
  with *identical* tail ops (constant arrival, lba 0, is_write -1). The
  step is a deterministic function of (state, op), so a run of identical
  ops reaches a fixed point the moment one application leaves the state
  unchanged. `compress_ops` drops the tail from the scanned stream and
  keeps `n_pad`/`pad_t`, so `sim.replay_pads` (or the kernel, in-kernel)
  re-applies it to convergence; pads emit latency exactly 0.0, so the
  trimmed latency array extends with literal zeros.

* **Per-op residency traffic.** `compress_ops` reshapes the trimmed
  stream into `(S, K)` segments of K consecutive ops and resolves the
  intra-segment data hazards on the host:

    - `src[s, i]` — the lane j < i whose residency *output* lane i must
      consume (the segment's most recent earlier access of the same
      lba), or -1 when the segment-start gather is still current.
    - `scat_lba[s, i]` — the lane's lba if it is the segment's *final*
      access of that lba, else an out-of-range sentinel the executor's
      scatter drops. One duplicate-free scatter per segment.

Compression is policy-independent (the hazard plan depends only on the
op stream), so one `CompressedOps` serves every (composition, mode).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["CompressedOps", "SEG_LANES", "TRIM_QUANTUM", "n_live_ops",
           "compress_ops"]

# lanes per segment: enough that the per-segment residency gather/scatter
# amortizes to noise, small enough that the (K,) forwarding buffer stays
# register-friendly for the fused kernel's lane loop
SEG_LANES = 32
# trimmed lengths round up to this many ops (a SEG_LANES multiple), so
# traces with drifting live counts share compiled (S, K) shapes the same
# way ir.PAD_OPS buckets the padded length
TRIM_QUANTUM = 8192
# out-of-range scatter sentinel for superseded lanes (kept positive, as
# the reference's is: a negative index would wrap instead of dropping)
_DROP = np.int32(1 << 30)


class CompressedOps(NamedTuple):
    """One padded trace, compressed for the segment executor. `segs` are
    host numpy — `sim.run_compressed` moves them to the device."""
    segs: dict            # (S, K) arrays: arrival_ms f32, lba i32,
    #                       is_write i32, src i32, scat_lba i32
    t_len: int            # original padded length T
    t_trim: int           # scanned length S * K (TRIM_QUANTUM multiple)
    n_pad: int            # T - t_trim identical tail pads, replayed
    pad_t: float          # the tail pads' constant arrival_ms
    fill: float           # live ops / scanned lanes (diagnostic)


def n_live_ops(is_write: np.ndarray) -> int:
    """Ops before the pad tail (pads are `is_write < 0`, tail-only by the
    `ir.pad_ops` contract — enforced here, not assumed)."""
    is_write = np.asarray(is_write)
    live = is_write >= 0
    n_live = int(np.max(np.nonzero(live)[0])) + 1 if live.any() else 0
    if live[:n_live].sum() != n_live:
        raise ValueError("pads must form a contiguous tail (ir.pad_ops "
                         "contract); found interior pad ops")
    return n_live


def compress_ops(trace, *, lanes: int = SEG_LANES,
                 quantum: int = TRIM_QUANTUM) -> CompressedOps:
    """Compress one padded trace (dict of host arrays) into segment form.

    The scanned prefix is the live ops rounded up to `quantum` (the
    in-prefix pads execute as ordinary ops — exactness over trimming
    aggressiveness); the all-pad tail beyond it is recorded as a
    (count, arrival) pair for fixed-point replay."""
    if quantum % lanes:
        raise ValueError(f"quantum {quantum} must be a multiple of "
                         f"lanes {lanes}")
    arrival = np.asarray(trace["arrival_ms"], np.float32)
    lba = np.asarray(trace["lba"], np.int32)
    is_write = np.asarray(trace["is_write"], np.int32)
    t_len = int(lba.shape[0])
    n_live = n_live_ops(is_write)
    t_trim = min(-(-max(n_live, 1) // quantum) * quantum, t_len)
    n_pad = t_len - t_trim
    pad_t = float(arrival[t_trim]) if n_pad else 0.0

    lba_s = lba[:t_trim]
    n = t_trim
    seg = np.arange(n, dtype=np.int64) // lanes
    # stable sort by (segment, lba): equal keys keep trace order, so each
    # sorted neighbour pair with an equal key is one intra-segment hazard
    # edge (consecutive accesses of one lba inside one segment)
    key = seg * (int(lba_s.max(initial=0)) + 1) + lba_s
    order = np.argsort(key, kind="stable")
    key_o = key[order]
    dup = key_o[1:] == key_o[:-1]

    src = np.full(n, -1, np.int32)
    src[order[1:][dup]] = (order[:-1][dup] % lanes).astype(np.int32)
    final = np.ones(n, bool)
    final[order[:-1][dup]] = False      # a later same-lba lane supersedes

    s_cnt = n // lanes
    segs = {
        "arrival_ms": arrival[:n].reshape(s_cnt, lanes),
        "lba": lba_s.reshape(s_cnt, lanes),
        "is_write": is_write[:n].reshape(s_cnt, lanes),
        "src": src.reshape(s_cnt, lanes),
        "scat_lba": np.where(final, lba_s, _DROP).reshape(s_cnt, lanes),
    }
    return CompressedOps(segs=segs, t_len=t_len, t_trim=t_trim,
                         n_pad=n_pad, pad_t=pad_t,
                         fill=n_live / max(n, 1))
