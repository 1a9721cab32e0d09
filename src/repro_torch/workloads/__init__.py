"""Workload engine of the port: the 11 published-stats MSR-like traces,
the padding contract and event compression, as numpy copies of the
reference package's modules (scenario generators, trace-file parsers and
the on-disk trace cache are not ported yet).

  ir        — page-level op records and the pad/truncate/repad contract
  synth     — MSR-Cambridge-like statistical synthesizer
  compress  — pad-tail trimming and (S, K) hazard-resolved segments
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.workloads import ir
from repro_torch.workloads.compress import (SEG_LANES, TRIM_QUANTUM,
                                            CompressedOps, compress_ops)
from repro_torch.workloads.ir import PAD_OPS
from repro_torch.workloads.synth import (TRACE_NAMES, TRACES, TraceStats,
                                         make_trace)

__all__ = ["PAD_OPS", "TraceStats", "TRACES", "TRACE_NAMES",
           "CompressedOps", "compress_ops", "SEG_LANES", "TRIM_QUANTUM",
           "build_ops", "make_trace", "truncate_trace"]

truncate_trace = ir.truncate_ops


def build_ops(spec: str, total_logical_pages: int, *, mode: str = "daily",
              seed: int = 0, capacity_pages: Optional[int] = None,
              repeat: int = 1) -> Dict:
    """Compiled (padded) op arrays for a workload spec. The port knows
    the 11 MSR trace names; other spec kinds are not ported yet."""
    if spec not in TRACES:
        raise ValueError(f"unknown workload spec {spec!r}; the port knows "
                         f"the MSR traces {', '.join(TRACE_NAMES)}")
    return make_trace(spec, total_logical_pages, mode=mode, seed=seed,
                      capacity_pages=capacity_pages, repeat=repeat)
