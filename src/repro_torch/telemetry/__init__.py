"""Telemetry of the port: windowed timelines, cliff detection, span
tracing, profiling and the perf-regression history; the counterpart of
the reference package's `telemetry` package.

* `spans` — a nested context-manager span tracer (stdlib only); the
  sweep runner's `dispatch_s`/`block_s` are views over its spans.
* `probe` — the probe's torch side (imports torch; NOT imported by this
  package root): `TimelineState`, the per-op row of the plain version,
  and the window assembly (`windowed`, `windowed_prefix`,
  `windowed_segments`) that turns the rows the `ssd_step` kernel (or its
  plain version) emits into a `WindowedTimeline`.
* `timeline` / `export` — numpy-only analysis (per-window series,
  histogram percentiles, cliff detection) and artifact export (timeline
  payloads, Chrome trace-event files).
* `history` — the append-only, git-SHA-keyed `BENCH_torch_history.json`
  ledger (stdlib only), gated by
  `python -m repro_torch.telemetry.history --check`.
* `profiling` — opt-in `torch.profiler` capture and allocator and launch
  counters posted as span events (torch imported lazily).

The package root loads no CUDA library.
"""
from repro_torch.telemetry.export import (chrome_trace, round_floats,
                                          timeline_payload)
from repro_torch.telemetry.spans import Tracer, active_tracer, event, span
from repro_torch.telemetry.timeline import (cell_timeline, detect_cliff,
                                            percentile, series,
                                            timeline_to_numpy)

__all__ = [
    "Tracer", "active_tracer", "span", "event",
    "timeline_to_numpy", "cell_timeline", "series", "detect_cliff",
    "percentile", "timeline_payload", "chrome_trace", "round_floats",
    "append_record", "check_regression", "load_history",
]

_HISTORY_NAMES = ("append_record", "check_regression", "load_history")


def __getattr__(name):
    # history stays un-imported at package import so that
    # `python -m repro_torch.telemetry.history` is not a runpy
    # double-import
    if name in _HISTORY_NAMES:
        from repro_torch.telemetry import history
        return getattr(history, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
