"""Compat shim over the workload engine (`repro_torch.workloads`); port
of the reference package's `core/ssd/workloads.py`.

The synthesizer, trace IR, parsers, generators and compiled-trace cache
live in `repro_torch.workloads`; this module keeps the historical
`core.ssd.workloads` surface — `TRACES`, `make_trace`, `stack_traces`,
`truncate_trace`, `PAD_OPS` — as re-exports, so callers written against
the reference's module path find the same names. New code imports from
`repro_torch.workloads` directly.
"""
from __future__ import annotations

from repro_torch.workloads import stack_traces, truncate_trace
from repro_torch.workloads.ir import (PAD_OPS, repad_ops as _repad,
                                      requests_to_ops as _to_ops)
from repro_torch.workloads.synth import (TRACES, TRACE_NAMES, TraceStats,
                                         _zipf_like, make_trace, synthesize)

__all__ = ["TRACES", "TRACE_NAMES", "TraceStats", "PAD_OPS", "synthesize",
           "make_trace", "stack_traces", "truncate_trace"]
