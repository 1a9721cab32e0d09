"""Opt-in device profiling hooks on `torch.profiler` and the CUDA caching
allocator.

The counterpart of the reference package's `telemetry/profiling.py`,
which wraps `jax.profiler`; this one is written for torch, not
translated. The span tracer (`telemetry.spans`) sees host wall-clock
only — it can say a sweep's launch took 60 ms, not what the card did
meanwhile. This module bridges the gap without making profiling a
dependency:

* `profile(trace_dir)` — context manager around `torch.profiler.profile`
  with the CPU and (when a card is present) CUDA activities; on exit the
  capture is exported as a Chrome trace, `trace_dir/torch_trace.json`
  (Perfetto / `chrome://tracing`). Paired `profile.start` /
  `profile.stop` span events mark the captured region in the host span
  tree. A missing profiler backend degrades to a no-op with a
  `profile.unavailable` event — profiling never fails a run.
* `device_memory_stats()` — per-device allocator counters
  (`torch.cuda.memory_stats`; empty without a card).
* `dispatch_stats()` — the `ssd_step` kernel's launch count (the port
  has no compilation cache to count) and the bytes the allocator holds
  in use and at peak.
* `emit_device_events(tag)` — posts the above as an instant event on the
  active tracer.

torch is imported inside the functions: the telemetry package root
loads no CUDA library.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

from repro_torch.telemetry import spans

__all__ = ["profile", "device_memory_stats", "dispatch_stats",
           "emit_device_events", "TRACE_FILE"]

TRACE_FILE = "torch_trace.json"


@contextlib.contextmanager
def profile(trace_dir: Optional[str]):
    """Capture a `torch.profiler` trace of the enclosed region and export
    it to `trace_dir/torch_trace.json` (None — and any backend failure —
    degrades to a no-op). Yields True when a capture is running."""
    if trace_dir is None:
        yield False
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:             # missing backend, double start, ...
        spans.event("profile.unavailable", "profile", error=str(e))
        yield False
        return
    spans.event("profile.start", "profile", trace_dir=trace_dir,
                activities=",".join(a.name for a in activities))
    try:
        yield True
    finally:
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(trace_dir, TRACE_FILE)
            prof.export_chrome_trace(path)
        except Exception as e:
            spans.event("profile.stop_failed", "profile", error=str(e))
        else:
            spans.event("profile.stop", "profile", trace_dir=trace_dir,
                        path=path)


def device_memory_stats() -> Dict[str, Dict]:
    """{device: allocator counters} for every CUDA device; empty without
    one (callers treat absence as 'not supported', never as zero)."""
    try:
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    except Exception:
        return {}
    out: Dict[str, Dict] = {}
    for i in range(n):
        try:
            stats = torch.cuda.memory_stats(i)
        except Exception:
            stats = None
        if stats:
            out[f"cuda:{i}"] = {k: int(v) for k, v in stats.items()
                                if isinstance(v, (int, float))}
    return out


def dispatch_stats() -> Dict:
    """Cheap per-dispatch device-side indicators: the `ssd_step` kernel's
    launches since its last reset, and the allocator's bytes in use and
    at peak where a card reports them."""
    out: Dict = {}
    try:
        from repro_torch.kernels.ssd_step import ops as ssd_step
        out["ssd_step_launches"] = ssd_step.launches
    except Exception:
        pass
    mem = device_memory_stats()
    if mem:
        out["bytes_in_use"] = sum(m.get("allocated_bytes.all.current", 0)
                                  for m in mem.values())
        peak = sum(m.get("allocated_bytes.all.peak", 0)
                   for m in mem.values())
        if peak:
            out["peak_bytes_in_use"] = peak
    return out


def emit_device_events(tag: str = "") -> Optional[Dict]:
    """Post `dispatch_stats()` as an instant event on the active tracer
    (no-op without one)."""
    stats = dispatch_stats()
    return spans.event("device.stats", "profile", tag=tag, **stats)
