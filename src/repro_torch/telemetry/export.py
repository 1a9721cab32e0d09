"""Timeline/span export: timeline payloads and Chrome trace files.

Copy (stdlib only) of the reference package's `telemetry/export.py`.
Two artifact shapes:

* `timeline_payload` — the `BENCH_torch_timeline.json` document body:
  one per-window series block per sweep cell (keyed by `SweepPoint.key`),
  each carrying its detected cliff, plus the run's span list and
  per-name span totals. Written through `sweep.store.save_bench`, so it
  shares the run-metadata schema (git SHA, torch version, device) with
  every other `BENCH_torch_*` artifact.
* `chrome_trace` — the span list re-encoded as Chrome trace-event JSON
  ("X" complete events, microsecond timestamps), loadable directly in
  `chrome://tracing` or Perfetto for a flame view of a sweep run.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional

__all__ = ["timeline_payload", "chrome_trace", "round_floats"]


def round_floats(obj, ndigits: int = 5):
    """Recursively round floats in a JSON-ready structure (artifact-size
    control for per-window series)."""
    if isinstance(obj, float):
        return round(obj, ndigits)
    if isinstance(obj, dict):
        return {k: round_floats(v, ndigits) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [round_floats(v, ndigits) for v in obj]
    return obj


def timeline_payload(cells: Dict[str, Dict], *, window_ops: int,
                     tracer=None, extra: Optional[Dict] = None) -> Dict:
    """The timeline document body.

    cells: {cell key: series dict} from `telemetry.timeline.series`;
    `tracer` (a `telemetry.spans.Tracer`) contributes the span list and
    per-name totals; `extra` is merged in verbatim (grid name, overhead
    measurements, ...)."""
    n_cliffs = sum(1 for s in cells.values()
                   if s.get("cliff", {}).get("detected"))
    doc = {
        "window_ops": window_ops,
        "n_cells": len(cells),
        "n_cliffs": n_cliffs,
        "cells": cells,
        "spans": tracer.to_json() if tracer is not None else [],
        "span_totals": tracer.totals() if tracer is not None else {},
    }
    if extra:
        doc.update(extra)
    return doc


def chrome_trace(spans: List[Dict], path: str) -> str:
    """Write a span list (telemetry.spans schema) as a Chrome
    trace-event file; returns the path. Atomic (temp + rename) like
    every other artifact writer."""
    events = []
    for rec in spans:
        ev = {
            "name": rec["name"],
            "cat": rec.get("cat") or "repro_torch",
            "ph": "X" if rec.get("dur_s", 0.0) > 0 else "i",
            "ts": round(rec["t0_s"] * 1e6, 1),      # µs
            "pid": 0,
            "tid": 0,
            "args": rec.get("args", {}),
        }
        if ev["ph"] == "X":
            ev["dur"] = round(rec["dur_s"] * 1e6, 1)
        else:
            ev["s"] = "t"                           # instant: thread scope
        events.append(ev)
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".trace.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return path
