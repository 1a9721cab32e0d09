"""Span tracer: nested, named wall-clock spans with one active tracer.

A verbatim copy (stdlib only) of the reference package's
`telemetry/spans.py`. One schema for every span:

    {"name", "cat", "t0_s", "dur_s", "depth", "parent", "args"}

`t0_s` is relative to the tracer's construction; `parent` is the index of
the enclosing span in the tracer's `spans` list (None at top level);
instant events (`event`) carry `dur_s == 0.0`.

Instrumented call sites use the module-level `span(...)` / `event(...)`
helpers, which record into the process's *active* tracer when one is
installed (`Tracer.activate()`, a context manager) and otherwise degrade
to a plain measurement: `span` always yields a mutable record dict whose
`dur_s` is filled on exit, so callers that feed derived views (the
runner's `dispatch_s`/`block_s`) read the same number whether or not
anybody is tracing.
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Dict, List, Optional

__all__ = ["Tracer", "active_tracer", "span", "event"]

_ACTIVE: contextvars.ContextVar[Optional["Tracer"]] = \
    contextvars.ContextVar("repro_torch_telemetry_tracer", default=None)


def active_tracer() -> Optional["Tracer"]:
    """The currently installed tracer, or None."""
    return _ACTIVE.get()


class Tracer:
    """Collects nested spans; one instance is installed as the process's
    active tracer via `activate()` and harvested with `to_json()` /
    `totals()` after the traced region completes."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._stack: List[int] = []
        self.spans: List[Dict] = []

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def activate(self):
        """Install as the active tracer for the dynamic extent."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", **args):
        """Record a nested span; yields the mutable record dict (callers
        may add `args` entries — e.g. a compile count known only at
        exit — before the span closes)."""
        rec = {"name": name, "cat": cat,
               "t0_s": time.perf_counter() - self._t0, "dur_s": 0.0,
               "depth": len(self._stack),
               "parent": self._stack[-1] if self._stack else None,
               "args": dict(args)}
        idx = len(self.spans)
        self.spans.append(rec)
        self._stack.append(idx)
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            rec["dur_s"] = time.perf_counter() - t0
            self._stack.pop()

    def event(self, name: str, cat: str = "", **args) -> Dict:
        """Record an instant event (a zero-duration span)."""
        rec = {"name": name, "cat": cat,
               "t0_s": time.perf_counter() - self._t0, "dur_s": 0.0,
               "depth": len(self._stack),
               "parent": self._stack[-1] if self._stack else None,
               "args": dict(args)}
        self.spans.append(rec)
        return rec

    # ------------------------------------------------------------------
    def totals(self) -> Dict[str, Dict]:
        """Per-name aggregate: {"name": {"total_s", "count"}} — the
        derived view legacy wall-clock keys are computed from."""
        out: Dict[str, Dict] = {}
        for rec in self.spans:
            d = out.setdefault(rec["name"], {"total_s": 0.0, "count": 0})
            d["total_s"] += rec["dur_s"]
            d["count"] += 1
        for d in out.values():
            d["total_s"] = round(d["total_s"], 6)
        return out

    def to_json(self) -> List[Dict]:
        """JSON-ready span list (durations rounded; args stringified
        only if a value is not JSON-native)."""
        out = []
        for rec in self.spans:
            args = {k: (v if isinstance(v, (int, float, str, bool,
                                            type(None))) else str(v))
                    for k, v in rec["args"].items()}
            out.append({**rec, "t0_s": round(rec["t0_s"], 6),
                        "dur_s": round(rec["dur_s"], 6), "args": args})
        return out


@contextlib.contextmanager
def span(name: str, cat: str = "", **args):
    """Measure a span against the active tracer, or standalone when none
    is installed. Always yields the record dict (dur_s filled on exit)."""
    tracer = _ACTIVE.get()
    if tracer is not None:
        with tracer.span(name, cat, **args) as rec:
            yield rec
        return
    rec = {"name": name, "cat": cat, "t0_s": 0.0, "dur_s": 0.0,
           "depth": 0, "parent": None, "args": dict(args)}
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        rec["dur_s"] = time.perf_counter() - t0


def event(name: str, cat: str = "", **args) -> Optional[Dict]:
    """Record an instant event on the active tracer; no-op when none."""
    tracer = _ACTIVE.get()
    if tracer is None:
        return None
    return tracer.event(name, cat, **args)
