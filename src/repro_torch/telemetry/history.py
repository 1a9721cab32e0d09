"""Perf-regression history: an append-only, git-SHA-keyed run ledger.

Copy (stdlib only) of the reference package's `telemetry/history.py`,
writing the port's own `BENCH_torch_history.json` and never the
reference's `BENCH_history.json`. Every port sweep appends one compact
record (throughput, fidelity geomeans, kernel launches) keyed by the
commit SHA that produced it, and `check_regression` compares the latest
record of each (kind, config) series against the median of its trailing
same-config baseline — >20% throughput drop or *any* geomean-fidelity
drift fails. `python -m repro_torch.telemetry.history --check` is the
command-line gate.

Appends are atomic (write-temp + `os.replace`) and serialized against
concurrent appenders with an advisory `fcntl` lock where the platform has
one, so parallel runs each land a complete document.

Records never assert on their own — a record with `ops_per_s=None`
participates in geomean drift checks but is skipped by the throughput
gate. Configs are free-form strings chosen by the writer
(`sweep:paper:...`): two records compare only when both `kind` and
`config` match exactly, so changing a grid or workload starts a fresh
baseline instead of poisoning an old one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from typing import Dict, List, Optional

__all__ = ["HISTORY_FILE", "append_record", "load_history",
           "check_regression", "history_path"]

HISTORY_FILE = "BENCH_torch_history.json"
SCHEMA_VERSION = 1

# regression gates (check_regression defaults): throughput is noisy —
# allow 20%; fidelity geomeans are bit-identity-backed — allow only
# float-printing jitter
MAX_THROUGHPUT_DROP = 0.20
GEOMEAN_RTOL = 1e-9


def history_path(directory: str = ".") -> str:
    return os.path.join(directory, HISTORY_FILE)


def _empty_doc() -> Dict:
    return {"name": "history", "schema_version": SCHEMA_VERSION,
            "records": []}


def load_history(directory: str = ".") -> Dict:
    """The history document ({"records": [...]}); empty when absent or
    unreadable (a corrupt ledger must not block a run — appends rebuild
    it)."""
    try:
        with open(history_path(directory)) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return _empty_doc()
    if not isinstance(doc, dict) or not isinstance(
            doc.get("records"), list):
        return _empty_doc()
    return doc


def append_record(kind: str, config: str, *, directory: str = ".",
                  ops_per_s: Optional[float] = None,
                  cells_per_s: Optional[float] = None,
                  geomeans: Optional[Dict[str, float]] = None,
                  compiles: Optional[int] = None,
                  shard_skipped: Optional[int] = None,
                  git_sha: Optional[str] = None,
                  meta: Optional[Dict] = None) -> Dict:
    """Append one run record to `BENCH_torch_history.json` and return
    it.

    kind: the producing entry point ("sweep");
    config: the writer's stable series key — records regress-compare
    only within an exact (kind, config) match. `git_sha` defaults to the
    working tree's HEAD (`sweep.store._git_sha`); `compiles` counts the
    kernel specialisations built or, for a sweep, its launches. The append is atomic
    and lock-serialized; the ledger is append-only by construction
    (existing records are never rewritten, only re-serialized)."""
    if git_sha is None:
        from repro_torch.sweep.store import _git_sha
        git_sha = _git_sha()
    rec = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "git_sha": git_sha,
        "kind": str(kind),
        "config": str(config),
        "ops_per_s": None if ops_per_s is None else float(ops_per_s),
        "cells_per_s": (None if cells_per_s is None
                        else float(cells_per_s)),
        "geomeans": ({} if geomeans is None
                     else {k: float(v) for k, v in geomeans.items()}),
        "compiles": None if compiles is None else int(compiles),
        "shard_skipped": (None if shard_skipped is None
                          else int(shard_skipped)),
        "meta": dict(meta) if meta else {},
    }
    path = history_path(directory)
    lock_path = path + ".lock"
    lock_fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        try:
            import fcntl
            fcntl.flock(lock_fd, fcntl.LOCK_EX)
        except (ImportError, OSError):
            pass                       # best-effort: atomicity still holds
        doc = load_history(directory)
        doc["records"].append(rec)
        fd, tmp = tempfile.mkstemp(dir=directory or ".",
                                   prefix=".BENCH_torch_history.", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
    finally:
        os.close(lock_fd)
    return rec


def check_regression(records: List[Dict], *, baseline_n: int = 5,
                     max_throughput_drop: float = MAX_THROUGHPUT_DROP,
                     geomean_rtol: float = GEOMEAN_RTOL) -> List[str]:
    """Regression verdicts over a record list: for each (kind, config)
    series the LATEST record is compared against its trailing baseline —
    the median `ops_per_s` of up to `baseline_n` preceding same-series
    records (median: one slow CI machine must not fail the next run) and
    the most recent preceding record's fidelity geomeans (bit-identity
    contract: any drift beyond float-printing jitter is a failure, in
    either direction). Returns a list of human-readable failure lines —
    empty means no regression. Series with no preceding record pass
    trivially (first run seeds the baseline)."""
    failures: List[str] = []
    series: Dict[tuple, List[Dict]] = {}
    for rec in records:
        series.setdefault((rec.get("kind"), rec.get("config")),
                          []).append(rec)
    for (kind, config), recs in sorted(series.items()):
        if len(recs) < 2:
            continue
        latest, prior = recs[-1], recs[:-1]
        label = f"{kind}:{config}"
        base_tp = [r["ops_per_s"] for r in prior[-baseline_n:]
                   if r.get("ops_per_s")]
        if base_tp and latest.get("ops_per_s"):
            base = statistics.median(base_tp)
            drop = 1.0 - latest["ops_per_s"] / base
            if drop > max_throughput_drop:
                failures.append(
                    f"{label}: throughput {latest['ops_per_s']:.1f} "
                    f"ops/s is {drop:.1%} below the trailing median "
                    f"{base:.1f} (gate {max_throughput_drop:.0%}, "
                    f"baseline of {len(base_tp)})")
        prev_gm = next((r["geomeans"] for r in reversed(prior)
                        if r.get("geomeans")), None)
        gm = latest.get("geomeans") or {}
        if prev_gm:
            for key in sorted(set(prev_gm) & set(gm)):
                a, b = float(prev_gm[key]), float(gm[key])
                if abs(a - b) > geomean_rtol * max(abs(a), abs(b), 1e-30):
                    failures.append(
                        f"{label}: geomean '{key}' drifted "
                        f"{a!r} -> {b!r} (fidelity is bit-identity-"
                        f"backed; any drift is a regression)")
    return failures


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.history",
        description="Inspect / gate the BENCH_torch_history.json run ledger.")
    ap.add_argument("--path", default=".",
                    help="directory holding BENCH_torch_history.json")
    ap.add_argument("--check", action="store_true",
                    help="fail (exit 1) on >20%% throughput drop or any "
                         "geomean-fidelity drift vs the trailing baseline")
    ap.add_argument("--list", action="store_true",
                    help="print one line per record")
    ap.add_argument("--baseline-n", type=int, default=5)
    ap.add_argument("--max-drop", type=float, default=MAX_THROUGHPUT_DROP)
    args = ap.parse_args(argv)

    doc = load_history(args.path)
    records = doc["records"]
    if args.list or not args.check:
        for r in records:
            gm = ",".join(f"{k}={v:.6g}" for k, v in
                          sorted((r.get("geomeans") or {}).items()))
            tp = r.get("ops_per_s")
            print(f"{r.get('ts')} {str(r.get('git_sha'))[:12]:>12} "
                  f"{r.get('kind')}:{r.get('config')} "
                  f"ops/s={tp if tp is None else round(tp, 1)} {gm}")
        if not records:
            print("(no records)")
    if not args.check:
        return 0
    if not records:
        print("history --check: no records to check")
        return 0
    failures = check_regression(records, baseline_n=args.baseline_n,
                                max_throughput_drop=args.max_drop)
    if failures:
        for line in failures:
            print(f"REGRESSION {line}")
        return 1
    print(f"history --check: {len(records)} record(s), no regression")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
