"""Workload engine of the port: the single source of traces for the
simulator, fleet and sweep layers — numpy copies of the reference
package's `workloads` modules, every array identical to the reference's.

  ir          — Trace IR (page-level ops + provenance + transforms) and
                the pad/truncate/repad contract with the simulator
  synth       — MSR-Cambridge-like statistical synthesizer
  parsers     — real trace files: MSR CSV, generic CSV, fio iolog,
                blktrace (`load_trace(path, mode=..., max_ops=...)`)
  generators  — parametric scenarios (zipf_hot, diurnal, read_burst,
                gc_pressure, tenant_mix, flush_burst, adv_ips_base) and
                the multi-tenant mixer
  stats       — fit `TraceStats` from any Trace; round trip through the
                synthesizer
  cache       — the port's content-addressed compiled-trace cache (memory
                and `$REPRO_TORCH_TRACE_CACHE_DIR`)
  compress    — pad-tail trimming and (S, K) hazard-resolved segments

A workload *spec* is one string, resolved by `spec_kind` as the
reference resolves it: an MSR trace name goes to the synthesizer, a
scenario name to the generators, a path to the parsers.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

from repro_torch.workloads import ir
from repro_torch.workloads.cache import TraceCache, file_digest
from repro_torch.workloads.compress import (SEG_LANES, TRIM_QUANTUM,
                                            CompressedOps, compress_ops)
from repro_torch.workloads.generators import (SCENARIO_NAMES, SCENARIOS,
                                              mix_traces)
from repro_torch.workloads.ir import PAD_OPS, Trace
from repro_torch.workloads.parsers import load_trace
from repro_torch.workloads.stats import fit_stats, synthesize_like
from repro_torch.workloads.synth import (TRACE_NAMES, TRACES, TraceStats,
                                         make_trace, synth_trace, synthesize)

__all__ = [
    "PAD_OPS", "Trace", "TraceStats", "TRACES", "TRACE_NAMES",
    "SCENARIOS", "SCENARIO_NAMES", "TraceCache",
    "CompressedOps", "compress_ops", "SEG_LANES", "TRIM_QUANTUM",
    "spec_kind", "known_specs", "build_trace", "build_ops", "trace_recipe",
    "stack_traces", "truncate_trace",
    "make_trace", "synth_trace", "synthesize", "load_trace", "mix_traces",
    "fit_stats", "synthesize_like",
]

truncate_trace = ir.truncate_ops


def spec_kind(spec: str) -> str:
    """Classify a workload spec: 'synth' | 'scenario' | 'file'."""
    if spec in TRACES:
        return "synth"
    if spec in SCENARIOS:
        return "scenario"
    if os.sep in spec or "/" in spec or os.path.isfile(spec):
        return "file"
    raise ValueError(
        f"unknown workload spec {spec!r}: not an MSR trace "
        f"({', '.join(TRACE_NAMES)}), not a scenario "
        f"({', '.join(SCENARIO_NAMES)}), and not a file path")


def known_specs() -> tuple:
    """All resolvable non-file spec names (CLI validation)."""
    return TRACE_NAMES + SCENARIO_NAMES


def build_trace(spec: str, total_logical_pages: int, *,
                mode: str = "daily", seed: int = 0,
                capacity_pages: Optional[int] = None,
                repeat: int = 1) -> Trace:
    """The Trace IR record for any workload spec. MSR names keep repeat
    and mode at request level; scenarios and files apply the IR-level
    `repeat` and `to_bursty` transforms in the reference's order. `seed`
    is a no-op for file-backed traces."""
    kind = spec_kind(spec)
    if kind == "synth":
        return synth_trace(spec, total_logical_pages, mode, seed,
                           capacity_pages, repeat)
    if kind == "scenario":
        tr = SCENARIOS[spec](total_logical_pages, capacity_pages, seed)
    else:
        tr = load_trace(spec, "daily",
                        total_logical_pages=total_logical_pages)
    if repeat > 1:
        tr = tr.repeat(repeat)
    if mode == "bursty":
        tr = tr.to_bursty(total_logical_pages)
    elif mode != "daily":
        raise ValueError(mode)
    return tr


def trace_recipe(spec: str, total_logical_pages: int, *,
                 mode: str = "daily", seed: int = 0,
                 capacity_pages: Optional[int] = None,
                 repeat: int = 1) -> Dict:
    """Content-addressed build recipe for `build_ops` (the cache key):
    MSR recipes embed the trace's published stats, scenario recipes the
    generator `VERSION`, file recipes a digest of the file contents."""
    from dataclasses import astuple
    kind = spec_kind(spec)
    recipe = {"kind": kind, "spec": spec, "mode": mode, "seed": seed,
              "repeat": repeat, "n_logical": total_logical_pages,
              "capacity": capacity_pages}
    if kind == "synth":
        recipe["stats"] = astuple(TRACES[spec])
    elif kind == "scenario":
        from repro_torch.workloads.generators import VERSION
        recipe["gen_version"] = VERSION
    else:
        recipe["digest"] = file_digest(spec)
    return recipe


def build_ops(spec: str, total_logical_pages: int, *,
              mode: str = "daily", seed: int = 0,
              capacity_pages: Optional[int] = None, repeat: int = 1,
              cache: Optional[TraceCache] = None) -> Dict:
    """Compiled (padded) op arrays for any workload spec, memoized
    through `cache` when one is given."""
    def builder():
        return build_trace(spec, total_logical_pages, mode=mode, seed=seed,
                           capacity_pages=capacity_pages,
                           repeat=repeat).compile()
    if cache is None:
        return builder()
    recipe = trace_recipe(spec, total_logical_pages, mode=mode, seed=seed,
                          capacity_pages=capacity_pages, repeat=repeat)
    return cache.get_or_build(recipe, builder)


def stack_traces(specs: Sequence[str], total_logical_pages: int,
                 mode: str = "daily", seeds=(0,),
                 capacity_pages: Optional[int] = None, repeat: int = 1,
                 max_ops: Optional[int] = None,
                 cache: Optional[TraceCache] = None):
    """The (C, T) trace stack of a fleet: one cell per (spec, seed), all
    re-padded to the group's common length. Returns (cells, traces)."""
    cells, traces = [], []
    for spec in specs:
        for seed in seeds:
            tr = build_ops(spec, total_logical_pages, mode=mode, seed=seed,
                           capacity_pages=capacity_pages, repeat=repeat,
                           cache=cache)
            if max_ops is not None:
                tr = ir.truncate_ops(tr, max_ops)
            cells.append((spec, seed))
            traces.append(tr)
    target = max(len(t["arrival_ms"]) for t in traces)
    traces = [ir.repad_ops(t, target) for t in traces]
    return cells, traces
